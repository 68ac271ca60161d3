#!/usr/bin/env python3
"""Convert a binary STL mesh to a triangle OFF file, exactly.

    python3 scripts/stl_to_off.py IN.stl OUT.off

A binary STL is an 80-byte header, a little-endian uint32 triangle count,
then 50 bytes a triangle: a float32 normal, three float32 vertices and a
uint16 attribute. The OFF file keeps the triangles in the STL's order with
their vertices bit for bit: a vertex is shared by every triangle that has
its three float32 coordinates bit for bit (so ``-0.0`` and ``0.0`` stay
apart), and vertices are numbered in the order the triangles first use
them. Coordinates are written with ``%.9g``, which a float32 parse reads
back exactly; the header is ``OFF`` then ``nv nf 0``, faces ``3 i j k``.
The STL's normals and attributes are dropped: the renderer takes a
triangle's normal from its vertices.

The benchmark's ``mesh13k`` configuration is the visual mesh of the Franka
Emika Panda arm's second link as Gymnasium-Robotics 1.4.1 ships it
(``gymnasium_robotics/envs/assets/kitchen_franka/franka_assets/meshes/
visual/link2.stl``, 12,716 triangles):

    python3 scripts/stl_to_off.py .../visual/link2.stl \\
        bench_torch/configs/mesh13k/meshes/panda_link2.off

The ``panda_arm`` configuration's eleven parts, posed and placed, are made
by ``scripts/panda_to_off.py``, which reads each STL with ``read_stl``,
shares vertices with ``index`` and writes with ``write``.
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

RECORD = np.dtype([("normal", "<f4", 3), ("verts", "<f4", (3, 3)), ("attr", "<u2")])


def read_stl(data: bytes) -> np.ndarray:
    """The triangles of a binary STL, float32 [T, 3, 3]."""
    if len(data) < 84:
        raise ValueError("not a binary STL: shorter than its header")
    (n,) = struct.unpack("<I", data[80:84])
    if len(data) != 84 + RECORD.itemsize * n:
        raise ValueError(f"not a binary STL of {n} triangles: {len(data)} bytes")
    return np.frombuffer(data, RECORD, count=n, offset=84)["verts"].copy()


def index(tris: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(vertices [V, 3], faces [T, 3]): the triangles' corners shared by
    their bits, numbered in order of first use."""
    corners = np.ascontiguousarray(tris, np.float32).reshape(-1, 3)
    keys = corners.view(np.uint32)
    _, first, inverse = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first, kind="stable")  # unique rows by first use
    number = np.empty_like(order)
    number[order] = np.arange(len(order))
    return corners[first[order]], number[inverse.reshape(-1)].reshape(-1, 3)


def write(verts: np.ndarray, faces: np.ndarray) -> str:
    """OFF text: ``OFF``, ``nv nf 0``, vertices in ``%.9g``, ``3 i j k``."""
    parts = ["OFF\n", f"{len(verts)} {len(faces)} 0\n"]
    parts += ["%.9g %.9g %.9g\n" % tuple(float(c) for c in v) for v in verts]
    parts += ["3 %d %d %d\n" % tuple(int(i) for i in f) for f in faces]
    return "".join(parts)


def convert(data: bytes) -> str:
    """The OFF text of a binary STL's bytes."""
    return write(*index(read_stl(data)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)
    with open(args.src, "rb") as fh:
        text = convert(fh.read())
    with open(args.dst, "w") as fh:
        fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
