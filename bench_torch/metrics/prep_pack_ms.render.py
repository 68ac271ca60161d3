"""prep_pack_ms.render: the host time of a render's scene packing, in ms: the
mean over the traced renders of the summed ``render.prepare.pack`` spans in
each (``models.scene.pack_scene`` inside ``pipeline.prepare_render``). Read
from the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``), grouped by the span's
unit, in a ``--trace 1`` run: a profiled host time, so compare it only with
other traced readings. A program without the span reports nothing."""

SPAN = "render.prepare.pack"


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    per_unit: dict = {}
    for s in profiling.spans():
        if s.name == SPAN and s.end_ns and s.unit:
            per_unit[s.unit] = per_unit.get(s.unit, 0) + s.end_ns - s.start_ns
    return 1e-6 * sum(per_unit.values()) / len(per_unit) if per_unit else None
