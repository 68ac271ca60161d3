"""Triangles, meshes, bounds, tessellation.

Parity notes (vs ``src/render/mod.rs``):

- ``Mesh.from_triangles`` keeps the reference's bounding-sphere-center bug
  (``min + max*0.5`` instead of ``(min+max)*0.5``, ``mod.rs:478-482``) because
  the bounding sphere is used as a *pre-test mask* in scene intersection
  (``mod.rs:265-279``) — it changes which triangle hits count, so RMSE parity
  requires replicating it.
- The AABB is triangulated into 12 triangles with the exact vertex/winding
  table of ``bounding_box_to_triangles`` (``mod.rs:501-536``); it is used for
  viewport orbit-point picking (``intersect_bounds``).
- ``single_quad_mesh`` reproduces the wall-quad construction of the built-in
  Cornell scenes (``scenes.rs:321-367``).

Triangles are stored SoA as a float32 ``[T, 3, 3]`` array (triangle, vertex,
xyz) — the natural device layout — rather than a list of structs.
- UV-sphere tessellation (16 stacks × 32 slices with pole handling,
  ``mod.rs:346-404``) backs the raster preview.

Counterpart of ``path_tracer_tpu.models.geometry``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

F32 = np.float32
PI = F32(3.141592653589793)


@dataclass(frozen=True)
class Triangle:
    """A single triangle (host-side convenience; bulk storage is ``[T,3,3]``)."""

    a: np.ndarray
    b: np.ndarray
    c: np.ndarray

    def as_array(self) -> np.ndarray:
        return np.stack([self.a, self.b, self.c]).astype(np.float32)

    @staticmethod
    def from_json(obj: dict) -> "Triangle":
        return Triangle(
            np.asarray(obj["a"], np.float32),
            np.asarray(obj["b"], np.float32),
            np.asarray(obj["c"], np.float32),
        )


def triangles_to_array(triangles) -> np.ndarray:
    """List of Triangle (or [3,3] arrays) → float32 [T,3,3]."""
    if len(triangles) == 0:
        return np.zeros((0, 3, 3), np.float32)
    rows = [
        t.as_array() if isinstance(t, Triangle) else np.asarray(t, np.float32)
        for t in triangles
    ]
    return np.stack(rows).astype(np.float32)


def triangles_to_json(tris: np.ndarray) -> list[dict]:
    return [{"a": t[0], "b": t[1], "c": t[2]} for t in np.asarray(tris, np.float32)]


def mesh_bounds(tris: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned (min, max) over all vertices."""
    verts = np.asarray(tris, np.float32).reshape(-1, 3)
    return verts.min(axis=0), verts.max(axis=0)


def buggy_bounding_sphere(
    min_vert: np.ndarray, max_vert: np.ndarray
) -> tuple[np.ndarray, np.float32]:
    """Reference bounding sphere incl. the center bug (``mod.rs:478-492``):
    center = min + max*0.5 (componentwise), radius = max distance to the two
    extreme corners only."""
    min_vert = np.asarray(min_vert, np.float32)
    max_vert = np.asarray(max_vert, np.float32)
    center = (min_vert + max_vert * F32(0.5)).astype(np.float32)
    r = max(
        F32(np.sqrt(np.sum((min_vert - center) ** 2, dtype=np.float32))),
        F32(np.sqrt(np.sum((max_vert - center) ** 2, dtype=np.float32))),
    )
    return center, F32(r)


def bounding_box_to_triangles(
    min_vert: np.ndarray, max_vert: np.ndarray
) -> np.ndarray:
    """AABB → 12 triangles, exact vertex/index table of ``mod.rs:501-536``."""
    mn, mx = np.asarray(min_vert, np.float32), np.asarray(max_vert, np.float32)
    v = np.array(
        [
            [mn[0], mn[1], mn[2]],
            [mx[0], mn[1], mn[2]],
            [mx[0], mx[1], mn[2]],
            [mn[0], mx[1], mn[2]],
            [mn[0], mn[1], mx[2]],
            [mx[0], mn[1], mx[2]],
            [mx[0], mx[1], mx[2]],
            [mn[0], mx[1], mx[2]],
        ],
        np.float32,
    )
    idx = [
        (0, 1, 2), (0, 2, 3),  # front
        (4, 6, 5), (4, 7, 6),  # back
        (0, 4, 5), (0, 5, 1),  # bottom
        (3, 2, 6), (3, 6, 7),  # top
        (1, 5, 6), (1, 6, 2),  # right
        (0, 3, 7), (0, 7, 4),  # left
    ]
    return np.stack([np.stack([v[i], v[j], v[k]]) for i, j, k in idx]).astype(
        np.float32
    )


@dataclass
class Mesh:
    """Triangle mesh + derived bounds.

    ``triangles``: float32 [T,3,3]. ``bounding_sphere``: (center[3], radius).
    ``bounding_box``: float32 [12,3,3] triangulated AABB.
    """

    triangles: np.ndarray
    bounding_sphere_center: np.ndarray
    bounding_sphere_radius: np.float32
    bounding_box: np.ndarray
    file: dict | None = field(default=None)  # {"path", "scale"} if from OFF

    @staticmethod
    def from_triangles(triangles, file: dict | None = None) -> "Mesh":
        tris = (
            triangles
            if isinstance(triangles, np.ndarray)
            else triangles_to_array(triangles)
        )
        tris = np.asarray(tris, np.float32)
        if tris.ndim != 3 or tris.shape[1:] != (3, 3):
            raise ValueError(f"triangles must be [T,3,3], got {tris.shape}")
        mn, mx = mesh_bounds(tris)
        center, radius = buggy_bounding_sphere(mn, mx)
        return Mesh(
            triangles=tris,
            bounding_sphere_center=center,
            bounding_sphere_radius=radius,
            bounding_box=bounding_box_to_triangles(mn, mx),
            file=file,
        )

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    # --- JSON (inline-Mesh descriptor parity: serializes derived bounds too) ---

    @staticmethod
    def from_json(obj: dict) -> "Mesh":
        tris = triangles_to_array([Triangle.from_json(t) for t in obj["triangles"]])
        bs = obj["bounding_sphere"]
        return Mesh(
            triangles=tris,
            bounding_sphere_center=np.asarray(bs["position"], np.float32),
            bounding_sphere_radius=F32(bs["radius"]),
            bounding_box=triangles_to_array(
                [Triangle.from_json(t) for t in obj["bounding_box"]]
            ),
        )

    def to_json(self) -> dict:
        return {
            "triangles": triangles_to_json(self.triangles),
            "bounding_sphere": {
                "position": self.bounding_sphere_center,
                "radius": F32(self.bounding_sphere_radius),
            },
            "bounding_box": triangles_to_json(self.bounding_box),
        }


def sphere_to_triangles(radius: float, steps: int = 16) -> np.ndarray:
    """UV-sphere tessellation for the raster preview (``mod.rs:346-404``):
    ``steps`` stacks × ``2*steps`` slices, single triangles at the poles."""
    radius = F32(radius)
    tris: list[np.ndarray] = []

    def pt(theta: F32, phi: F32) -> np.ndarray:
        return np.array(
            [
                radius * np.sin(theta) * np.cos(phi),
                radius * np.cos(theta),
                radius * np.sin(theta) * np.sin(phi),
            ],
            np.float32,
        )

    for i in range(steps):
        theta1 = PI * F32(i) / F32(steps)
        theta2 = PI * F32(i + 1) / F32(steps)
        for j in range(steps * 2):
            phi1 = F32(2.0) * PI * F32(j) / F32(steps * 2)
            phi2 = F32(2.0) * PI * F32(j + 1) / F32(steps * 2)
            p1, p2 = pt(theta1, phi1), pt(theta2, phi1)
            p3, p4 = pt(theta2, phi2), pt(theta1, phi2)
            if i == 0:
                tris.append(np.stack([p1, p3, p4]))
            elif i + 1 == steps:
                tris.append(np.stack([p1, p2, p3]))
            else:
                tris.append(np.stack([p1, p2, p4]))
                tris.append(np.stack([p2, p3, p4]))
    return np.stack(tris).astype(np.float32)


def single_quad_mesh(size_x: float, size_y: float, axis: int, flip: bool) -> Mesh:
    """Axis-aligned quad (two triangles) — wall-quad helper, parity with
    ``scenes.rs:321-367`` including winding order."""
    size_x, size_y = F32(size_x), F32(size_y)
    vertices = []
    for i in range(2):
        for j in range(2):
            pos = np.zeros(3, np.float32)
            idx1 = (axis + 1) % 3
            idx2 = (axis + 2) % 3
            pos[idx1] = -size_x if i == 0 else size_x
            pos[idx2] = -size_y if j == 0 else size_y
            vertices.append(pos)
    v = vertices
    if flip:
        tris = [np.stack([v[0], v[1], v[2]]), np.stack([v[2], v[1], v[3]])]
    else:
        tris = [np.stack([v[0], v[2], v[1]]), np.stack([v[1], v[2], v[3]])]
    return Mesh.from_triangles(np.stack(tris).astype(np.float32))
