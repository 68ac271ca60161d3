"""Scene model layer: materials, camera, geometry, scene schema, registry.

Counterpart of ``path_tracer_tpu.models``: numpy only, with the same
JSON/OFF formats and byte-equal packed scene buffers.
"""
