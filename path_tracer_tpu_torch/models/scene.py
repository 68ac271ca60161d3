"""Scene schema: JSON descriptors <-> runtime objects <-> packed SoA buffers.

Format parity with the reference (``src/render/mod.rs:85-156,236-324``):

- ``SceneDescriptor`` JSON: ``{id, objects: [{type_, position, material}],
  camera}`` where ``type_`` is one of ``{"Sphere": {radius}}``,
  ``{"MeshFile": {path, scale}}``, or an inline ``{"Mesh": {triangles,
  bounding_sphere, bounding_box}}`` (derived bounds are serialized too).
- unknown keys (e.g. the legacy ``"updating_direction"`` camera key) are
  ignored on load; ``emmission`` (sic) spelling is preserved.
- floats are written as shortest-roundtrip f32 (serde_json/Ryū behaviour) so
  saved scenes match the reference's files textually where values agree.

``pack_scene`` flattens a scene into padded SoA buffers. Objects are packed
in **reversed object order** (triangles of one mesh stay in forward order)
because the reference's ``intersect_scene`` scans objects in reverse keeping
strictly-closer hits (``mod.rs:631-659``) — with this layout a sequential
first-wins scan reproduces its tie-breaking exactly.

Counterpart of ``path_tracer_tpu.models.scene``; the packed buffers are
byte-equal to the JAX package's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from path_tracer_tpu_torch.models.camera import Camera
from path_tracer_tpu_torch.models.geometry import Mesh, mesh_bounds
from path_tracer_tpu_torch.models.material import Material

F32 = np.float32

FAR_AWAY = np.float32(1e30)  # padding sentinel: guaranteed-miss position


def _vec3(x) -> np.ndarray:
    v = np.asarray(x, dtype=np.float32)
    if v.shape != (3,):
        raise ValueError(f"expected 3-vector, got shape {v.shape}")
    return v


# ---------------------------------------------------------------------------
# JSON float formatting (shortest-roundtrip f32, like serde_json's Ryū)
# ---------------------------------------------------------------------------


def _fmt_f32(v) -> str:
    f = np.float32(v)
    if not np.isfinite(f):
        raise ValueError(f"non-finite float in scene JSON: {f}")
    a = abs(float(f))
    if a != 0.0 and (a >= 1e16 or a < 1e-5):
        s = np.format_float_scientific(f, unique=True, trim="0")
        # numpy prints exponents as 'e+30'/'e-07'; serde_json: 'e30'/'e-7'
        return s.replace("e+0", "e").replace("e+", "e").replace("e-0", "e-")
    return np.format_float_positional(f, unique=True, trim="0")


def _to_jsonable(obj):
    """Recursively convert numpy values into JSON-writable structures, with
    f32 floats wrapped so the encoder emits shortest-f32 text."""
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [_to_jsonable(v) for v in obj.tolist()] if obj.ndim else _F32Str(obj)
    if isinstance(obj, (np.floating, float)):
        return _F32Str(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    return obj


class _F32Str(float):
    """float subclass whose json encoding is shortest-f32."""

    def __new__(cls, v):
        return super().__new__(cls, float(np.float32(v)))

    def __repr__(self):
        return _fmt_f32(self)


def dumps_scene_json(obj: dict) -> str:
    # The stdlib json C encoder calls float.__repr__ directly, bypassing the
    # _F32Str subclass — a manual pretty-printer keeps full control of both
    # float formatting and serde_json-style layout.
    return _pretty(_to_jsonable(obj), 0)


def _pretty(o, indent: int) -> str:
    pad = "  " * indent
    pad2 = "  " * (indent + 1)
    if isinstance(o, dict):
        if not o:
            return "{}"
        items = ",\n".join(
            f'{pad2}"{k}": {_pretty(v, indent + 1)}' for k, v in o.items()
        )
        return "{\n" + items + "\n" + pad + "}"
    if isinstance(o, list):
        if not o:
            return "[]"
        items = ",\n".join(f"{pad2}{_pretty(v, indent + 1)}" for v in o)
        return "[\n" + items + "\n" + pad + "]"
    if isinstance(o, _F32Str):
        return _fmt_f32(o)
    if isinstance(o, bool):
        return "true" if o else "false"
    if o is None:
        return "null"
    if isinstance(o, str):
        return json.dumps(o)
    return repr(o)


# ---------------------------------------------------------------------------
# Runtime scene objects
# ---------------------------------------------------------------------------


@dataclass
class SceneObject:
    """A sphere or a (possibly file-backed) triangle mesh with a material."""

    position: np.ndarray
    material: Material
    radius: float | None = None  # sphere
    mesh: Mesh | None = None  # mesh

    def __post_init__(self):
        self.position = _vec3(self.position)
        if (self.radius is None) == (self.mesh is None):
            raise ValueError("SceneObject must be exactly one of sphere / mesh")
        if self.radius is not None:
            self.radius = F32(self.radius)

    @property
    def is_sphere(self) -> bool:
        return self.radius is not None

    @staticmethod
    def sphere(position, radius, material: Material) -> "SceneObject":
        return SceneObject(position=position, material=material, radius=radius)

    @staticmethod
    def from_mesh(position, mesh: Mesh, material: Material) -> "SceneObject":
        return SceneObject(position=position, material=material, mesh=mesh)

    # --- JSON ---

    @staticmethod
    def from_json(obj: dict, base_dir: str | None = None) -> "SceneObject":
        t = obj["type_"]
        position = _vec3(obj["position"])
        material = Material.from_json(obj["material"])
        if "Sphere" in t:
            return SceneObject.sphere(position, F32(t["Sphere"]["radius"]), material)
        if "MeshFile" in t:
            from path_tracer_tpu_torch.models.off import load_off

            path = t["MeshFile"]["path"]
            scale = F32(t["MeshFile"]["scale"])
            resolved = path
            if not os.path.exists(resolved) and base_dir is not None:
                cand = os.path.join(base_dir, path)
                if os.path.exists(cand):
                    resolved = cand
            mesh = load_off(resolved, scale)
            mesh.file = {"path": path, "scale": scale}
            return SceneObject.from_mesh(position, mesh, material)
        if "Mesh" in t:
            return SceneObject.from_mesh(position, Mesh.from_json(t["Mesh"]), material)
        raise ValueError(f"unknown scene object type: {list(t.keys())}")

    def to_json(self) -> dict:
        if self.is_sphere:
            type_ = {"Sphere": {"radius": F32(self.radius)}}
        elif self.mesh.file is not None:
            type_ = {
                "MeshFile": {
                    "path": self.mesh.file["path"],
                    "scale": F32(self.mesh.file["scale"]),
                }
            }
        else:
            type_ = {"Mesh": self.mesh.to_json()}
        return {
            "type_": type_,
            "position": self.position,
            "material": self.material.to_json(),
        }


@dataclass
class SceneDescriptor:
    """A named scene: objects + camera. Loads/saves reference-format JSON."""

    id: str
    objects: list[SceneObject] = field(default_factory=list)
    camera: Camera = field(default_factory=Camera)

    @staticmethod
    def from_json_dict(d: dict, base_dir: str | None = None) -> "SceneDescriptor":
        return SceneDescriptor(
            id=d["id"],
            objects=[SceneObject.from_json(o, base_dir) for o in d["objects"]],
            camera=Camera.from_json(d["camera"]),
        )

    @staticmethod
    def load(scene_id: str, scene_dir: str = "scenes") -> "SceneDescriptor":
        path = os.path.join(scene_dir, f"{scene_id}.json")
        with open(path, "r") as f:
            d = json.load(f)
        base_dir = os.path.dirname(os.path.abspath(scene_dir))
        return SceneDescriptor.from_json_dict(d, base_dir=base_dir)

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "objects": [o.to_json() for o in self.objects],
            "camera": self.camera.to_json(),
        }

    def save(self, scene_dir: str = "scenes") -> str:
        os.makedirs(scene_dir, exist_ok=True)
        path = os.path.join(scene_dir, f"{self.id}.json")
        with open(path, "w") as f:
            f.write(dumps_scene_json(self.to_json()))
        return path

    @property
    def num_objects(self) -> int:
        return len(self.objects)


# ---------------------------------------------------------------------------
# Packed SoA scene (device layout)
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass
class ScenePacked:
    """Flat, padded SoA buffers for the wavefront tracer.

    Packing order is reversed-object (tie-break parity, see module docstring).
    Padded entries are guaranteed misses: spheres at FAR_AWAY with radius 0,
    degenerate far-away triangles (zero determinant).

    Spheres                      Triangles
    -------                      ---------
    sph_center  [S,3] f32        tri_v      [T,3,3] f32 (pre-translated)
    sph_radius  [S]   f32        tri_normal [T,3]  f32 (normalized e1 x e2)
    sph_color   [S,3] f32        tri_color  [T,3]  f32
    sph_emis    [S,3] f32        tri_emis   [T,3]  f32
    sph_rtype   [S]   i32        tri_rtype  [T]    i32
    sph_order   [S]   i32        tri_order  [T]    i32 (reverse-scan rank)
    sph_obj     [S]   i32        tri_obj    [T]    i32 (original object idx)
                                 tri_mesh   [T]    i32 (bounding-sphere id)
    Mesh bounding spheres (pre-test masks, mod.rs:265-279):
    bnd_center [M,3] f32, bnd_radius [M] f32
    """

    num_spheres: int
    num_triangles: int
    num_meshes: int
    num_objects: int
    sph_center: np.ndarray
    sph_radius: np.ndarray
    sph_color: np.ndarray
    sph_emis: np.ndarray
    sph_rtype: np.ndarray
    sph_order: np.ndarray
    sph_obj: np.ndarray
    tri_v: np.ndarray
    tri_normal: np.ndarray
    tri_color: np.ndarray
    tri_emis: np.ndarray
    tri_rtype: np.ndarray
    tri_order: np.ndarray
    tri_obj: np.ndarray
    tri_mesh: np.ndarray
    bnd_center: np.ndarray
    bnd_radius: np.ndarray

    def buffers(self) -> dict[str, np.ndarray]:
        """The device-transferable arrays as a flat dict (a JAX pytree)."""
        return {
            k: getattr(self, k)
            for k in (
                "sph_center sph_radius sph_color sph_emis sph_rtype sph_order "
                "sph_obj tri_v tri_normal tri_color tri_emis tri_rtype "
                "tri_order tri_obj tri_mesh bnd_center bnd_radius"
            ).split()
        }


def _unit_normals(v: np.ndarray) -> np.ndarray:
    """e1 x e2 over its length for triangles [n, 3, 3] float32, left as it is
    where the length is 0 (zero-area triangles). Each row's squared length
    is a [1,3] @ [3,1] product: numpy hands that to BLAS's dot, as it does
    ``np.dot(n, n)`` of one row, so the bits are the JAX package's per-row
    ones; ``(n * n).sum(-1)`` rounds differently in ~10% of random rows. A
    length past float32's range is inf, as the per-row dot gives it, but
    silently."""
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]).astype(np.float32)
    with np.errstate(over="ignore"):
        norm = np.sqrt(n[:, None, :] @ n[:, :, None])[:, 0]
    return np.divide(n, norm, out=n.copy(), where=norm > 0)


def pack_scene(
    scene: SceneDescriptor, sphere_pad: int = 8, tri_pad: int = 32
) -> ScenePacked:
    """Flatten a scene into ScenePacked (see class docstring for layout)."""
    n_obj = len(scene.objects)
    spheres: list[tuple] = []  # (center, radius, mat, order, obj_idx)
    meshes: list[tuple] = []  # (verts[n,3,3], mat, order, obj_idx, mesh_idx)
    bounds: list[tuple] = []  # (center, radius)

    # Reversed object order = the reference's scan order; `order` is the rank
    # in that scan so smaller order wins distance ties.
    for order, obj_idx in enumerate(range(n_obj - 1, -1, -1)):
        obj = scene.objects[obj_idx]
        if obj.is_sphere:
            spheres.append((obj.position, obj.radius, obj.material, order, obj_idx))
        else:
            mesh_idx = len(bounds)
            bounds.append(
                (
                    obj.mesh.bounding_sphere_center + obj.position,
                    obj.mesh.bounding_sphere_radius,
                )
            )
            moved = obj.mesh.triangles + obj.position[None, None, :]
            meshes.append((moved.astype(np.float32), obj.material, order,
                           obj_idx, mesh_idx))
    n_tris = sum(len(m[0]) for m in meshes)

    S = max(_round_up(len(spheres), sphere_pad), sphere_pad)
    T = max(_round_up(n_tris, tri_pad), tri_pad)
    M = max(_round_up(len(bounds), sphere_pad), sphere_pad)

    sph_center = np.full((S, 3), FAR_AWAY, np.float32)
    sph_radius = np.zeros(S, np.float32)
    sph_color = np.zeros((S, 3), np.float32)
    sph_emis = np.zeros((S, 3), np.float32)
    sph_rtype = np.zeros(S, np.int32)
    sph_order = np.full(S, 2**30, np.int32)
    sph_obj = np.full(S, -1, np.int32)
    for i, (c, r, mat, order, obj_idx) in enumerate(spheres):
        sph_center[i] = c
        sph_radius[i] = r
        sph_color[i] = mat.color
        sph_emis[i] = mat.emission
        sph_rtype[i] = int(mat.reflect_type)
        sph_order[i] = order
        sph_obj[i] = obj_idx

    tri_v = np.full((T, 3, 3), FAR_AWAY, np.float32)  # degenerate: a == b == c
    tri_normal = np.zeros((T, 3), np.float32)
    tri_color = np.zeros((T, 3), np.float32)
    tri_emis = np.zeros((T, 3), np.float32)
    tri_rtype = np.zeros(T, np.int32)
    tri_order = np.full(T, 2**30, np.int32)
    tri_obj = np.full(T, -1, np.int32)
    tri_mesh = np.full(T, M - 1 if len(bounds) < M else 0, np.int32)
    i = 0
    for v, mat, order, obj_idx, mesh_idx in meshes:
        rows = slice(i, i + len(v))
        i += len(v)
        tri_v[rows] = v
        tri_normal[rows] = _unit_normals(v)
        tri_color[rows] = mat.color
        tri_emis[rows] = mat.emission
        tri_rtype[rows] = int(mat.reflect_type)
        tri_order[rows] = order
        tri_obj[rows] = obj_idx
        tri_mesh[rows] = mesh_idx

    bnd_center = np.full((M, 3), FAR_AWAY, np.float32)
    bnd_radius = np.zeros(M, np.float32)
    for i, (c, r) in enumerate(bounds):
        bnd_center[i] = c
        bnd_radius[i] = r

    return ScenePacked(
        num_spheres=len(spheres),
        num_triangles=n_tris,
        num_meshes=len(bounds),
        num_objects=n_obj,
        sph_center=sph_center,
        sph_radius=sph_radius,
        sph_color=sph_color,
        sph_emis=sph_emis,
        sph_rtype=sph_rtype,
        sph_order=sph_order,
        sph_obj=sph_obj,
        tri_v=tri_v,
        tri_normal=tri_normal,
        tri_color=tri_color,
        tri_emis=tri_emis,
        tri_rtype=tri_rtype,
        tri_order=tri_order,
        tri_obj=tri_obj,
        tri_mesh=tri_mesh,
        bnd_center=bnd_center,
        bnd_radius=bnd_radius,
    )



def scene_bounds(scene: SceneDescriptor) -> tuple[np.ndarray, np.ndarray]:
    """World AABB over all objects (min, max), float32."""
    mins, maxs = [], []
    for obj in scene.objects:
        if obj.is_sphere:
            mins.append(obj.position - obj.radius)
            maxs.append(obj.position + obj.radius)
        else:
            mn, mx = mesh_bounds(obj.mesh.triangles)
            mins.append(mn + obj.position)
            maxs.append(mx + obj.position)
    if not mins:
        return np.zeros(3, np.float32), np.zeros(3, np.float32)
    return (
        np.min(np.stack(mins), axis=0).astype(np.float32),
        np.max(np.stack(maxs), axis=0).astype(np.float32),
    )
