"""Ray/scene intersection over the packed scene, in two forms.

Counterpart of ``path_tracer_tpu.ops.intersect`` (semantics parity with
``src/render/mod.rs:412-438,554-616,631-659``):

- Sphere: smallpt quadratic, eps = 1e-4, nearer root first, outward normal.
- Triangle: Möller–Trumbore, determinant eps 1e-4, culling off, u,v in
  [0,1] inclusive, u+v <= 1, distance strictly > ``eps_tri_t`` (1e-4, or 0
  for the literal estimator), closest hit, face normal
  ``normalize((b-a)×(c-a))``.
- Mesh objects are gated by a bounding-sphere pre-test (including the
  reference's buggy sphere center — see models.geometry).
- Scene scan order: objects in reverse index order keeping strictly-closer
  hits. The packed buffers are laid out in that order (models.scene), so a
  first-wins argmin reproduces the tie-breaking exactly; ``torch.argmin``
  returns the first minimal index.

Two forms with identical semantics:

- ``exact``: the literal arithmetic grouping of the reference, with
  ``[R,P,3]`` intermediates;
- ``fast``: every Möller–Trumbore quantity is affine in the per-ray feature
  vector ``[d, o×d, o, 1]``, so ray×triangle intersection is a handful of
  ``[R,3]@[3,T]`` products (``torch.matmul`` in float32) and elementwise
  work; the sphere quadratic regroups the same way. These products must
  stay float32: ``check_fp32_matmul`` refuses TF32, whose 10-bit mantissa
  would move ``t`` and flip hits.

The JAX package reads each winner's attributes through one-hot matmuls
(TPU tuning, ``_first_min_onehot``/``_read``); the port reads them with
``argmin`` and ``gather``. An all-inf row picks column 0, and everything is
then gated by ``found``, as there.

Scenes are dicts of tensors on one device: ``ScenePacked.buffers()`` as
tensors (``scene_tensors``), with ``tri_coeffs`` for the fast form.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EPS_SPHERE = 1e-4
EPS_TRI_DET = 1e-4
# Minimum accepted triangle-hit distance. The reference accepts any t > 0
# (mod.rs:592), whose f32-rounded hit points phantom-re-hit the departed
# triangle at t≈0⁺; the shipped estimator uses the sphere path's epsilon
# and excludes the departed triangle (estimator="literal" keeps t > 0).
EPS_TRI_T = 1e-4
INF = float("inf")


class Hit(NamedTuple):
    """Per-ray closest hit over the whole scene (misses: t = inf)."""

    t: torch.Tensor  # [R] distance (inf = miss)
    found: torch.Tensor  # [R] bool
    point: torch.Tensor  # [R,3] intersection
    normal: torch.Tensor  # [R,3] geometric outward normal (as the reference)
    color: torch.Tensor  # [R,3] material color
    emission: torch.Tensor  # [R,3]
    rtype: torch.Tensor  # [R] i32 ReflectType
    obj: torch.Tensor  # [R] i32 original object index (-1 = miss)
    tri: torch.Tensor  # [R] i32 packed triangle index of the hit (-1 = sphere/miss)


def check_fp32_matmul(device) -> None:
    """Raise if float32 matmuls on ``device`` may run in TF32: the fast
    form's products need the full mantissa."""
    if torch.device(device).type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the fast intersection form needs float32 matmuls: TF32 is on "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); turn it off or use "
            "backend 'exact'")


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def scene_tensors(packed, device) -> dict:
    """``ScenePacked.buffers()`` as tensors on ``device``, with the fast
    form's ``tri_coeffs``."""
    bufs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in packed.buffers().items()}
    bufs["tri_coeffs"] = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in triangle_coeffs_np(packed.tri_v).items()}
    return bufs


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------


def sphere_distances_exact(o, d, center, radius):
    """Literal reference grouping: op = c - o, b = op·d. [R,S]."""
    op = center[None, :, :] - o[:, None, :]  # [R,S,3]
    b = _dot(op, d[:, None, :])  # [R,S]
    det = b * b - _dot(op, op) + (radius * radius)[None, :]
    return _select_root(b, det, radius)


def sphere_distances_fast(o, d, center, radius):
    """Regrouped (matmul) form: identical semantics, no [R,S,3] buffers."""
    cd = torch.matmul(d, center.T)  # [R,S]
    oc = torch.matmul(o, center.T)  # [R,S]
    od = _dot(o, d)[:, None]  # [R,1]
    oo = _dot(o, o)[:, None]
    cc = _dot(center, center)[None, :]
    b = cd - od
    det = b * b - (cc - 2.0 * oc + oo) + (radius * radius)[None, :]
    return _select_root(b, det, radius)


def _select_root(b, det, radius):
    """Nearer-root-first with eps (mod.rs:414-428); miss → inf. radius == 0
    marks padding entries (their 1e30 centers make the quadratic degenerate
    to inf/nan) — forced miss."""
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    t_near = b - sq
    t_far = b + sq
    t = torch.where(t_near >= EPS_SPHERE, t_near,
                    torch.where(t_far >= EPS_SPHERE, t_far, INF))
    return torch.where((det < 0.0) | (radius[None, :] <= 0.0), INF, t)


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------


def triangle_distances_exact(o, d, tri_v, eps_tri_t: float = EPS_TRI_T):
    """Literal Möller–Trumbore with [R,T,3] intermediates. Returns t [R,T].
    eps_tri_t = 0.0 gives the reference's literal ``t > 0`` acceptance."""
    a = tri_v[:, 0]
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    pvec = _cross(d[:, None, :], e2[None, :, :])  # [R,T,3]
    det = _dot(e1[None, :, :], pvec)  # [R,T]
    valid = torch.abs(det) >= EPS_TRI_DET
    inv_det = 1.0 / torch.where(valid, det, 1.0)
    tvec = o[:, None, :] - a[None, :, :]  # [R,T,3]
    u = _dot(tvec, pvec) * inv_det
    valid &= (u >= 0.0) & (u <= 1.0)
    qvec = _cross(tvec, e1[None, :, :])  # [R,T,3]
    v = _dot(d[:, None, :], qvec) * inv_det
    valid &= (v >= 0.0) & (u + v <= 1.0)
    t = _dot(e2[None, :, :], qvec) * inv_det
    valid &= t > eps_tri_t
    return torch.where(valid, t, INF)


def triangle_coeffs(tri_v):
    """The per-triangle affine coefficients of the fast form ([T,3] / [T]
    tensors):

        det = -d·n,  u·det = (o×d)·e2 - d·(e2×a),
        v·det = -(o×d)·e1 - d·(a×e1),  t·det = o·n - a·n  (n = e1×e2)."""
    a = tri_v[:, 0]
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    n = _cross(e1, e2)
    return {"n": n, "e1": e1, "e2": e2, "e2xa": _cross(e2, a),
            "axe1": _cross(a, e1), "na": _dot(n, a)}


def triangle_coeffs_np(tri_v):
    """``triangle_coeffs`` in float32 numpy, for host-side scene
    preparation (the kernels' tables and ``scene_tensors``)."""
    tri_v = np.asarray(tri_v, np.float32)
    a = tri_v[:, 0]
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    n = np.cross(e1, e2)
    return {
        "n": n,
        "e1": e1,
        "e2": e2,
        "e2xa": np.cross(e2, a),
        "axe1": np.cross(a, e1),
        "na": (n * a).sum(axis=1),
    }


def triangle_distances_fast(o, d, coeffs, eps_tri_t: float = EPS_TRI_T):
    """Matmul form: six [R,3]@[3,T] products, no [R,T,3] buffers."""
    m = _cross(o, d)  # [R,3]
    det = -torch.matmul(d, coeffs["n"].T)  # [R,T]
    udet = torch.matmul(m, coeffs["e2"].T) - torch.matmul(d, coeffs["e2xa"].T)
    vdet = -torch.matmul(m, coeffs["e1"].T) - torch.matmul(d, coeffs["axe1"].T)
    tdet = torch.matmul(o, coeffs["n"].T) - coeffs["na"][None, :]

    valid = torch.abs(det) >= EPS_TRI_DET
    inv_det = 1.0 / torch.where(valid, det, 1.0)
    u = udet * inv_det
    v = vdet * inv_det
    t = tdet * inv_det
    valid &= ((u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > eps_tri_t))
    return torch.where(valid, t, INF)


# ---------------------------------------------------------------------------
# Scene intersection over packed buffers
# ---------------------------------------------------------------------------


def _first_min(t):
    """(min value, first argmin) along axis 1 — first-wins tie-break."""
    i = torch.argmin(t, dim=1)
    return torch.gather(t, 1, i[:, None])[:, 0], i


def intersect_scene(o, d, scene: dict, mode: str = "fast", prev_tri=None,
                    eps_tri_t: float = EPS_TRI_T) -> Hit:
    """Closest hit of rays o, d [R,3] against a packed scene
    (``scene_tensors``), with the mesh bounding-sphere pre-test mask.

    prev_tri [R] int (optional): packed triangle index each ray departed
    from (-1 = none); that triangle is excluded, since in f32 the plane
    equation cancels at the origin and gives phantom t≈0⁺ self-hits. Spheres
    are never excluded: re-hits there are real (glass interior bounces)."""
    sphere_fn = sphere_distances_fast if mode == "fast" else sphere_distances_exact

    t_sph = sphere_fn(o, d, scene["sph_center"], scene["sph_radius"])  # [R,S]
    d_s, i_s = _first_min(t_sph)

    # Mesh bounding-sphere pre-test: any root accepted == "is_some()"
    t_bnd = sphere_fn(o, d, scene["bnd_center"], scene["bnd_radius"])  # [R,M]
    tri_gate = torch.isfinite(t_bnd)[:, scene["tri_mesh"].long()]

    if mode == "fast":
        coeffs = scene.get("tri_coeffs") or triangle_coeffs(scene["tri_v"])
        t_tri = triangle_distances_fast(o, d, coeffs, eps_tri_t)
    else:
        t_tri = triangle_distances_exact(o, d, scene["tri_v"], eps_tri_t)
    t_tri = torch.where(tri_gate, t_tri, INF)
    if prev_tri is not None:
        tri_ids = torch.arange(t_tri.shape[1], device=o.device)[None, :]
        t_tri = torch.where(tri_ids == prev_tri[:, None], INF, t_tri)
    d_t, i_t = _first_min(t_tri)

    # Merge: strictly-closer wins; on exact ties, smaller reverse-scan rank
    # (the packed `order`) wins — reference reverse-object-scan semantics.
    order_s = scene["sph_order"][i_s]
    order_t = scene["tri_order"][i_t]
    sph_wins = (d_s < d_t) | ((d_s == d_t) & (order_s < order_t))

    t = torch.where(sph_wins, d_s, d_t)
    found = torch.isfinite(t)
    point = o + d * t[:, None]

    sph_n = point - scene["sph_center"][i_s]
    sph_n = sph_n * torch.rsqrt(torch.clamp(_dot(sph_n, sph_n), min=1e-30))[:, None]
    sw3 = sph_wins[:, None]
    normal = torch.where(sw3, sph_n, scene["tri_normal"][i_t])

    def pick(name):
        a = scene["sph_" + name][i_s]
        b = scene["tri_" + name][i_t]
        return torch.where(sw3 if a.ndim == 2 else sph_wins, a, b)

    obj = torch.where(found, pick("obj"), -1).to(torch.int32)
    tri = torch.where(found & ~sph_wins, i_t, -1).to(torch.int32)
    # Sanitize miss lanes (t=inf would poison point/normal with nan/inf).
    point = torch.where(found[:, None], point, 0.0)
    normal = torch.where(found[:, None], normal, 0.0)
    return Hit(t=t, found=found, point=point, normal=normal,
               color=pick("color"), emission=pick("emis"),
               rtype=pick("rtype").to(torch.int32), obj=obj, tri=tri)


def intersect_bounds(o, d, scene: dict, bbox_tris: dict):
    """Parity with ``SceneObjectData::intersect_bounds`` (mod.rs:282-290):
    spheres intersect normally, meshes intersect their AABB-as-12-triangles
    (``bbox_tris``: 'tri_v', 'tri_order', 'tri_obj' tensors). Used by
    viewport orbit picking. Returns (t [R], obj [R] i32, -1 = miss)."""
    t_sph = sphere_distances_exact(o, d, scene["sph_center"], scene["sph_radius"])
    d_s, i_s = _first_min(t_sph)
    t_tri = triangle_distances_exact(o, d, bbox_tris["tri_v"])
    d_t, i_t = _first_min(t_tri)
    order_s = scene["sph_order"][i_s]
    order_t = bbox_tris["tri_order"][i_t]
    sph_wins = (d_s < d_t) | ((d_s == d_t) & (order_s < order_t))
    t = torch.where(sph_wins, d_s, d_t)
    obj = torch.where(
        torch.isfinite(t),
        torch.where(sph_wins, scene["sph_obj"][i_s], bbox_tris["tri_obj"][i_t]),
        -1,
    ).to(torch.int32)
    return t, obj
