"""OFF mesh loader.

Parity: ``load_off`` (``src/render/load_off.rs:8-85``): skips comments and
blank lines, requires the ``OFF`` magic, reads ``nv nf ne`` counts, scales
vertices by ``scale``, accepts triangle faces only (face count != 3 is an
error, matching ``load_off.rs:73-76``).

Counterpart of ``path_tracer_tpu.models.off``. ``load_off`` parses through
the native runtime (``path_tracer_tpu_torch.native``, ``csrc/pt_native.cpp``)
where it builds; the pure-Python ``parse_off`` is the fallback and the
correctness oracle.
"""

from __future__ import annotations

import numpy as np

from path_tracer_tpu_torch.models.geometry import Mesh


class OffParseError(ValueError):
    pass


def _useful_lines(text: str):
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        yield line


def parse_off(text: str, scale: float = 1.0) -> np.ndarray:
    """Parse OFF text → float32 triangle array [T,3,3] (vertices pre-scaled)."""
    lines = _useful_lines(text)
    try:
        header = next(lines)
    except StopIteration:
        raise OffParseError("empty OFF file") from None
    if header != "OFF":
        raise OffParseError("Invalid header")

    try:
        counts = next(lines).split()
    except StopIteration:
        raise OffParseError("Invalid element counts") from None
    if len(counts) != 3:
        raise OffParseError("Invalid element counts")
    nv, nf = int(counts[0]), int(counts[1])

    verts = np.empty((nv, 3), np.float32)
    for i in range(nv):
        try:
            coords = next(lines).split()
        except StopIteration:
            raise OffParseError("Invalid vertex coordinates") from None
        if len(coords) != 3:
            raise OffParseError("Invalid vertex coordinates")
        verts[i] = [float(c) for c in coords]
    verts *= np.float32(scale)

    tris = np.empty((nf, 3, 3), np.float32)
    for i in range(nf):
        try:
            line = next(lines)
        except StopIteration:
            raise OffParseError("Invalid face") from None
        idx = line.split()
        if len(idx) < 4:
            raise OffParseError(f"Invalid face: {line}")
        count = int(idx[0])
        if count != 3:  # only triangles are supported (load_off.rs:73-76)
            raise OffParseError(f"Invalid face: {line}")
        a, b, c = int(idx[1]), int(idx[2]), int(idx[3])
        tris[i, 0], tris[i, 1], tris[i, 2] = verts[a], verts[b], verts[c]
    return tris


def load_off(path: str, scale: float = 1.0) -> Mesh:
    """Load an OFF file into a Mesh (bounds recomputed, like ``Mesh::new``)."""
    from path_tracer_tpu_torch.native import native_parse_off

    tris = native_parse_off(path, scale)
    if tris is None:
        with open(path, "r") as f:
            tris = parse_off(f.read(), scale)
    return Mesh.from_triangles(tris, file={"path": path, "scale": np.float32(scale)})
