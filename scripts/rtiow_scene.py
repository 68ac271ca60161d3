#!/usr/bin/env python3
"""Write the final scene of Peter Shirley's *Ray Tracing in One Weekend*
(v3.2.3, raytracing.github.io, "A Final Render") in the program's scene
format.

    python3 scripts/rtiow_scene.py [--seed N] [--out PATH]

It follows the book's ``random_scene()`` loop and its draws in source
order, from ``numpy.random.default_rng(seed)``: for each cell ``a, b`` of
``[-11, 11)``, ``choose_mat``, then the centre ``(a + 0.9 u, 0.2, b + 0.9
u)``; a centre within 0.9 of ``(4, 0.2, 0)`` is skipped, else a
radius-0.2 sphere is added, diffuse below 0.8 (albedo ``random() *
random()``, three draws each), metal below 0.95 (albedo ``random(0.5,
1)``, then the fuzz ``random(0, 0.5)``), glass otherwise. Then the
book's three radius-1 spheres: glass at ``(0, 1, 0)``, diffuse ``(0.4,
0.2, 0.1)`` at ``(-4, 1, 0)`` and metal ``(0.7, 0.6, 0.5)`` at ``(4, 1,
0)``. The book's own draws come from a default-seeded ``std::mt19937``
whose argument order C++ leaves unspecified, so the exact positions are
not the book's; the loop, the distributions and the counts are.

Where the scene format cannot say what the book says:

- the ground, a radius-1,000 sphere at ``(0, -1000, 0)``, is a quad at
  y = 0 over x, z in [-100, 100] (two triangles, an inline ``Mesh`` with
  its derived bounds), diffuse 0.5: at |o - c|^2 ~ 1e6 float32's ulp is
  0.0625, and a point on the ground would misjudge its own sphere by
  ~3e-5 units, next to the 1e-4 root cutoff;
- the sky gradient is an emissive sphere of radius 100 about the origin,
  colour 0 (a path that reaches it ends), emission ``(0.75, 0.85, 1.0)``,
  the gradient's value at the horizon;
- metal is ``Specular`` with the drawn albedo: the format has no fuzz (it
  is still drawn, so that later draws keep their order);
- the camera is a pinhole (the format has no aperture) at ``(13, 2, 3)``
  looking at the origin, vfov 20 degrees: ``focal_length`` 0.012 / tan 10
  degrees beside a 0.036-wide sensor at aspect 1.5.

Objects are written in the book's order (the ground, the small spheres,
the three large ones), the sky last. Prints the sphere counts by material
as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from path_tracer_tpu_torch.models.camera import Camera, normalize_f32  # noqa: E402
from path_tracer_tpu_torch.models.geometry import single_quad_mesh  # noqa: E402
from path_tracer_tpu_torch.models.material import Material, ReflectType  # noqa: E402
from path_tracer_tpu_torch.models.scene import (  # noqa: E402
    SceneDescriptor, SceneObject, dumps_scene_json,
)

SEED = 323
OUT = os.path.join(ROOT, "bench_torch", "configs", "rtiow_final", "rtiow_final.json")
GROUND_HALF = 100.0
SKY_RADIUS = 100.0
SKY = (0.75, 0.85, 1.0)


def _sphere(centre, radius, color, kind, emission=(0.0, 0.0, 0.0)):
    return SceneObject.sphere(centre, radius, Material(color, emission, kind))


def build(seed: int) -> tuple[SceneDescriptor, dict]:
    """The scene and its sphere counts by material."""
    rng = np.random.default_rng(seed)
    rand = rng.random
    objects = [SceneObject.from_mesh(
        (0.0, 0.0, 0.0), single_quad_mesh(GROUND_HALF, GROUND_HALF, 1, True),
        Material((0.5, 0.5, 0.5), (0.0, 0.0, 0.0), ReflectType.DIFFUSE))]
    counts = {"diffuse": 0, "metal": 0, "glass": 0}
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rand()
            centre = (a + 0.9 * rand(), 0.2, b + 0.9 * rand())
            if math.dist(centre, (4.0, 0.2, 0.0)) <= 0.9:
                continue
            if choose_mat < 0.8:
                c1 = (rand(), rand(), rand())
                c2 = (rand(), rand(), rand())
                albedo = tuple(x * y for x, y in zip(c1, c2))
                objects.append(_sphere(centre, 0.2, albedo, ReflectType.DIFFUSE))
                counts["diffuse"] += 1
            elif choose_mat < 0.95:
                albedo = (0.5 + 0.5 * rand(), 0.5 + 0.5 * rand(), 0.5 + 0.5 * rand())
                rand()  # the fuzz, random(0, 0.5): the format has none
                objects.append(_sphere(centre, 0.2, albedo, ReflectType.SPECULAR))
                counts["metal"] += 1
            else:
                objects.append(_sphere(centre, 0.2, (1.0, 1.0, 1.0),
                                       ReflectType.REFRACT))
                counts["glass"] += 1
    objects += [
        _sphere((0.0, 1.0, 0.0), 1.0, (1.0, 1.0, 1.0), ReflectType.REFRACT),
        _sphere((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), ReflectType.DIFFUSE),
        _sphere((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), ReflectType.SPECULAR),
        _sphere((0.0, 0.0, 0.0), SKY_RADIUS, (0.0, 0.0, 0.0), ReflectType.DIFFUSE,
                SKY),
    ]
    small = sum(counts.values())
    counts.update(small=small, spheres=small + 4)
    camera = Camera(position=(13.0, 2.0, 3.0),
                    direction=normalize_f32(np.array([-13.0, -2.0, -3.0], np.float32)),
                    focal_length=0.012 / math.tan(math.radians(10.0)),
                    sensor_width=0.036, aspect_ratio=1.5)
    return SceneDescriptor("rtiow_final", objects, camera), counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    scene, counts = build(args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(dumps_scene_json(scene.to_json()))
    print(json.dumps(dict(counts, seed=args.seed, out=os.path.relpath(args.out, ROOT))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
