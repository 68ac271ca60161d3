"""The plain reference: a path tracer in plain PyTorch operations.

It decides ``correct``: the benchmark holds the program's images and
preview frames to it. It imports nothing of the program and takes nothing
the program made: it reads the scene file itself, packs its own tables and
draws its own numbers. Its semantics are the reference renderer's
(smallpt-style ``radiance``) as the program states them:

- a scene is spheres and triangle meshes, each with a material (diffuse,
  specular or refractive) and an emission; objects are scanned in reverse
  order, a hit has to be strictly closer to win, and a mesh is tested only
  when its bounding sphere (with the reference's center, ``min + max / 2``)
  is hit;
- spheres accept a root at ``t >= 1e-4``; triangles are Moller-Trumbore with
  ``|det| >= 1e-4``, ``t > 1e-4``, and the triangle a ray leaves excluded;
- a path runs at most ``max_depth`` segments, with Russian roulette on the
  largest color channel once the depth exceeds ``rr_start_depth``;
- the camera ray of a sample is tent-filtered on a 2x2 subpixel grid;
- every random number is a counter hash of (seed, pixel, sample, depth,
  slot): murmur3's finalizer folded over the key, the top 23 bits as a
  float in [0, 1). The same sample draws the same numbers in the program, so
  the two trace the same paths and part only where rounding parts them.

``dtype`` sets the precision of every float operation (the random bits stay
integer): float32 is the configuration's; bfloat16 makes the control that
the comparison has to fail.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

F32 = np.float32
MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1
MIX_ADD = 0x7F4A7C15
SLOT_STRIDE = 8  # counter = depth * SLOT_STRIDE + slot
EPS_SPHERE = 1e-4
EPS_TRI_DET = 1e-4
EPS_TRI_T = 1e-4
INF = float("inf")
NC, NT = 1.0, 1.5  # indices of refraction: air, glass
REFLECT = {"Diffuse": 0, "Specular": 1, "Refract": 2}
LANE_BYTES = 1 << 29  # the largest [lanes, triangles, 3] buffer of a chunk


# ---------------------------------------------------------------------------
# Scene file -> tables
# ---------------------------------------------------------------------------


def normalize(v):
    """``v`` over its length in float32, as a camera normalizes its direction."""
    v = np.asarray(v, F32)
    return (v * F32(1.0 / np.sqrt(np.dot(v, v), dtype=F32))).astype(F32)


def _read_off(path: str, scale) -> np.ndarray:
    """The triangles [T, 3, 3] of an OFF file, vertices times ``scale``."""
    with open(path) as fh:
        lines = [ln.strip() for ln in fh]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if lines[0] != "OFF":
        raise ValueError(f"{path}: not an OFF file")
    nv, nf = (int(x) for x in lines[1].split()[:2])
    verts = np.array([[float(c) for c in ln.split()] for ln in lines[2:2 + nv]],
                     F32) * F32(scale)
    faces = [ln.split() for ln in lines[2 + nv:2 + nv + nf]]
    if any(f[0] != "3" for f in faces):
        raise ValueError(f"{path}: only triangle faces are supported")
    idx = np.array([[int(x) for x in f[1:4]] for f in faces])
    return verts[idx].astype(F32)


def _bounding_sphere(tris: np.ndarray):
    """The reference's bounding sphere of a mesh: center ``min + max * 0.5``
    (its bug, kept: the sphere gates which triangles count), radius the
    larger distance to the two extreme corners."""
    mn = tris.reshape(-1, 3).min(axis=0)
    mx = tris.reshape(-1, 3).max(axis=0)
    c = (mn + mx * F32(0.5)).astype(F32)
    r = max(F32(np.sqrt(np.sum((mn - c) ** 2, dtype=F32))),
            F32(np.sqrt(np.sum((mx - c) ** 2, dtype=F32))))
    return c, F32(r)


def load_scene(path: str, camera: dict | None = None) -> dict:
    """Tables (numpy) of the scene file at ``path``; ``MeshFile`` paths are
    taken relative to the file's directory. ``camera`` (``position``,
    ``direction``, the direction normalized as a camera move makes it)
    replaces the file's camera."""
    with open(path) as fh:
        desc = json.load(fh)
    base = os.path.dirname(os.path.abspath(path))
    sph, tri, bnd = [], [], []
    objects = desc["objects"]
    for order, idx in enumerate(range(len(objects) - 1, -1, -1)):
        obj = objects[idx]
        kind = obj["type_"]
        pos = np.asarray(obj["position"], F32)
        mat = obj["material"]
        attrs = (np.asarray(mat["color"], F32), np.asarray(mat["emmission"], F32),
                 REFLECT[mat["reflect_type"]], order)
        if "Sphere" in kind:
            sph.append((pos, F32(kind["Sphere"]["radius"])) + attrs)
            continue
        if "MeshFile" in kind:
            tris = _read_off(os.path.join(base, kind["MeshFile"]["path"]),
                             F32(kind["MeshFile"]["scale"]))
            center, radius = _bounding_sphere(tris)
        else:
            m = kind["Mesh"]
            tris = np.array([[t["a"], t["b"], t["c"]] for t in m["triangles"]], F32)
            center = np.asarray(m["bounding_sphere"]["position"], F32)
            radius = F32(m["bounding_sphere"]["radius"])
        bnd.append(((center + pos).astype(F32), radius))
        for t in (tris + pos[None, None, :]).astype(F32):
            tri.append((t, len(bnd) - 1) + attrs)
    # one radius-0 sphere stands for none: it never hits
    sph = sph or [(np.full(3, 1e30, F32), F32(0), np.zeros(3, F32),
                   np.zeros(3, F32), 0, 1 << 30)]
    tv = np.stack([t[0] for t in tri]).astype(F32)
    normals = []
    for v in tv:
        n = np.cross(v[1] - v[0], v[2] - v[0]).astype(F32)
        norm = F32(np.sqrt(np.dot(n, n)))
        normals.append(n / norm if norm > 0 else n)
    cam = desc["camera"] if camera is None else camera
    return {
        "sph_center": np.stack([s[0] for s in sph]),
        "sph_radius": np.array([s[1] for s in sph], F32),
        "sph_color": np.stack([s[2] for s in sph]),
        "sph_emis": np.stack([s[3] for s in sph]),
        "sph_rtype": np.array([s[4] for s in sph], np.int64),
        "sph_order": np.array([s[5] for s in sph], np.int64),
        "tri_v": tv,
        "tri_normal": np.stack(normals).astype(F32),
        "tri_mesh": np.array([t[1] for t in tri], np.int64),
        "tri_color": np.stack([t[2] for t in tri]),
        "tri_emis": np.stack([t[3] for t in tri]),
        "tri_rtype": np.array([t[4] for t in tri], np.int64),
        "tri_order": np.array([t[5] for t in tri], np.int64),
        "bnd_center": np.stack([b[0] for b in bnd]),
        "bnd_radius": np.array([b[1] for b in bnd], F32),
        "camera": camera_basis(cam),
        "camera_file": desc["camera"],
    }


def camera_basis(cam: dict) -> dict:
    """Sensor origin, the two sensor-plane vectors and the lens center of a
    pinhole camera (focal length 0.035, sensor 0.036 wide, 3:2 unless the
    camera says otherwise), in float32."""
    pos = np.asarray(cam["position"], F32)
    d = np.asarray(cam["direction"], F32)
    focal = F32(cam.get("focal_length", 0.035))
    width = F32(cam.get("sensor_width", 0.036))
    height = F32(width / F32(cam.get("aspect_ratio", 1.5)))
    up = np.array([0, 1, 0], F32) if abs(float(d[1])) < 0.9 else np.array([0, 0, 1], F32)
    su = normalize(np.cross(d, up).astype(F32))
    sv = np.cross(su, d).astype(F32)
    return {"origin": pos, "su": (su * width).astype(F32),
            "sv": (sv * height).astype(F32),
            "lens": (pos + d * focal).astype(F32)}


# ---------------------------------------------------------------------------
# Random numbers
# ---------------------------------------------------------------------------


def _mul32(a, c: int):
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & MASK32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _mix(h, x):
    if not isinstance(x, torch.Tensor):
        x = torch.full_like(h, int(x) & MASK32)
    return _fmix32(h ^ ((_mul32(x & MASK32, GOLDEN) + MIX_ADD) & MASK32))


def path_key(seed: int, pixel, sample):
    h = _mix(torch.zeros_like(pixel, dtype=torch.int64), int(seed) & MASK32)
    return _mix(_mix(h, pixel.to(torch.int64)), sample.to(torch.int64))


def uniform(key, depth: int, slot: int, dtype):
    bits = _mix(key, depth * SLOT_STRIDE + slot)
    return ((bits >> 9).to(torch.float32) * (2.0 ** -23)).to(dtype)


# ---------------------------------------------------------------------------
# Camera rays, intersection, scattering
# ---------------------------------------------------------------------------


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _tent(u):
    r = 2.0 * u
    return torch.where(r < 1.0, torch.sqrt(r) - 1.0,
                       1.0 - torch.sqrt(torch.clamp(2.0 - r, min=0.0)))


def camera_rays(cam: dict, pixel, sample, key, width: int, height: int, dtype):
    """Rays (o, d) of (pixel, sample) pairs: pixel p is column p % width of
    row height - 1 - p // width, sample s takes subpixel (s % 2, s // 2 % 2)."""
    dev = pixel.device
    y = (height - 1 - torch.div(pixel, width, rounding_mode="floor")).to(dtype)
    x = torch.remainder(pixel, width).to(dtype)
    ysub = torch.remainder(torch.div(sample, 2, rounding_mode="floor"), 2).to(dtype)
    xsub = torch.remainder(sample, 2).to(dtype)
    xf = _tent(uniform(key, 0, 4, dtype))
    yf = _tent(uniform(key, 0, 5, dtype))
    size = torch.tensor([float(width), float(height)], dtype=dtype, device=dev)
    sx = (x + 0.5 * (0.5 + xsub + xf)) / size[0] - 0.5
    sy = (y + 0.5 * (0.5 + ysub + yf)) / size[1] - 0.5
    so, su, sv, lc = (np.asarray(cam[k], F32).tolist()
                      for k in ("origin", "su", "sv", "lens"))
    dd = [lc[k] - (so[k] + su[k] * sx + sv[k] * sy) for k in range(3)]
    dl = torch.rsqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
    d = torch.stack([dd[k] * dl for k in range(3)], dim=1)
    o = torch.tensor(lc, dtype=dtype, device=dev).expand(d.shape[0], 3)
    return o.contiguous(), d


def _sphere_t(o, d, center, radius):
    """[R, S] distances of the nearer accepted root, inf for none."""
    op = center[None, :, :] - o[:, None, :]
    b = _dot(op, d[:, None, :])
    det = b * b - _dot(op, op) + (radius * radius)[None, :]
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    t = torch.where(b - sq >= EPS_SPHERE, b - sq,
                    torch.where(b + sq >= EPS_SPHERE, b + sq, INF))
    return torch.where((det < 0.0) | (radius[None, :] <= 0.0), INF, t)


def _triangle_t(o, d, tv):
    """[R, T] Moller-Trumbore distances, inf for none."""
    a, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    pvec = torch.linalg.cross(d[:, None, :], e2[None, :, :], dim=-1)
    det = _dot(e1[None], pvec)
    ok = torch.abs(det) >= EPS_TRI_DET
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvec = o[:, None, :] - a[None, :, :]
    u = _dot(tvec, pvec) * inv
    ok &= (u >= 0.0) & (u <= 1.0)
    qvec = torch.linalg.cross(tvec, e1[None, :, :], dim=-1)
    v = _dot(d[:, None, :], qvec) * inv
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = _dot(e2[None], qvec) * inv
    ok &= t > EPS_TRI_T
    return torch.where(ok, t, INF)


def _first_min(t):
    i = torch.argmin(t, dim=1)
    return torch.gather(t, 1, i[:, None])[:, 0], i


def intersect(o, d, sc: dict, prev_tri):
    """Closest hit: (found, point, normal, color, emission, rtype, tri)."""
    d_s, i_s = _first_min(_sphere_t(o, d, sc["sph_center"], sc["sph_radius"]))
    gate = torch.isfinite(_sphere_t(o, d, sc["bnd_center"], sc["bnd_radius"]))
    t_tri = torch.where(gate[:, sc["tri_mesh"]], _triangle_t(o, d, sc["tri_v"]), INF)
    ids = torch.arange(t_tri.shape[1], device=o.device)[None, :]
    t_tri = torch.where(ids == prev_tri[:, None], INF, t_tri)
    d_t, i_t = _first_min(t_tri)
    sph = (d_s < d_t) | ((d_s == d_t) & (sc["sph_order"][i_s] < sc["tri_order"][i_t]))
    t = torch.where(sph, d_s, d_t)
    found = torch.isfinite(t)
    point = o + d * t[:, None]
    sn = point - sc["sph_center"][i_s]
    sn = sn * torch.rsqrt(torch.clamp(_dot(sn, sn), min=1e-30))[:, None]
    normal = torch.where(sph[:, None], sn, sc["tri_normal"][i_t])
    point = torch.where(found[:, None], point, 0.0)
    normal = torch.where(found[:, None], normal, 0.0)

    def pick(name):
        a, b = sc["sph_" + name][i_s], sc["tri_" + name][i_t]
        return torch.where(sph[:, None] if a.ndim == 2 else sph, a, b)

    tri = torch.where(found & ~sph, i_t, -1)
    return found, point, normal, pick("color"), pick("emis"), pick("rtype"), tri


def _normalize(v):
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30))


def scatter(d, n, nl, rtype, u1, u2, ub):
    """Next direction and weight: cosine-weighted diffuse, mirror, or glass
    (Schlick's Fresnel, one branch picked with P = 0.25 + Re / 2)."""
    dt = d.dtype
    r1, r2s = 2.0 * math.pi * u1, torch.sqrt(u2)
    use_y = torch.abs(nl[:, 0:1]) > 0.1
    up = torch.where(use_y, torch.tensor([[0.0, 1.0, 0.0]], dtype=dt, device=d.device),
                     torch.tensor([[1.0, 0.0, 0.0]], dtype=dt, device=d.device))
    su = _normalize(torch.linalg.cross(up.expand_as(nl), nl, dim=-1))
    sv = torch.linalg.cross(nl, su, dim=-1)
    diffuse = _normalize(su * (torch.cos(r1) * r2s) + sv * (torch.sin(r1) * r2s)
                         + nl * torch.sqrt(1.0 - u2))
    refl = d - n * (2.0 * _dot(n, d)[:, None])
    into = _dot(n, nl)[:, None] > 0.0
    nnt = torch.where(into, torch.tensor(NC / NT, dtype=dt, device=d.device), NT / NC)
    ddn = _dot(d, nl)[:, None]
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tdir = _normalize(d * nnt - nl * (ddn * nnt + torch.sqrt(torch.clamp(cos2t, min=0.0))))
    r0 = ((NT - NC) / (NT + NC)) ** 2
    c = 1.0 - torch.where(into, -ddn, _dot(tdir, n)[:, None])
    c2 = c * c
    re = r0 + (1.0 - r0) * (c * (c2 * c2))
    p = 0.25 + 0.5 * re
    pick = ub < p
    glass = torch.where(pick, refl, tdir)
    gw = torch.where(pick, re / p, (1.0 - re) / (1.0 - p))
    tir = cos2t < 0.0
    glass = torch.where(tir, refl, glass)
    gw = torch.where(tir, 1.0, gw)
    rt = rtype[:, None]
    direction = torch.where(rt == 0, diffuse, torch.where(rt == 1, _normalize(refl), glass))
    return direction, torch.where(rt == 2, gw, 1.0)


def trace(o, d, key, sc: dict, *, max_depth: int, rr_start_depth: int):
    """Radiance [N, 3] of the paths that start with rays (o, d)."""
    n, dev, dt = o.shape[0], o.device, o.dtype
    o, d = o.clone(), d.clone()
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    acc = torch.zeros((n, 3), dtype=dt, device=dev)
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    for s in range(max_depth):
        if lanes.numel() == 0:
            break
        lo, ld, lthr = o[lanes], d[lanes], thr[lanes]
        found, point, normal, color, emis, rtype, tri = intersect(lo, ld, sc, prev[lanes])
        nl = torch.where((_dot(normal, ld) < 0.0)[:, None], normal, -normal)
        k = key[lanes]
        u = [uniform(k, s, slot, dt) for slot in range(4)]
        depth = s + 1
        max_refl = torch.amax(color, dim=-1)
        rr = depth > rr_start_depth
        survive = (u[0] < max_refl) & (depth < max_depth)
        scale = torch.where(rr & survive, 1.0 / torch.clamp(max_refl, min=1e-30), 1.0)
        acc[lanes] += torch.where(found[:, None], lthr * emis, 0.0)
        direction, weight = scatter(ld, normal, nl, rtype, u[1][:, None],
                                    u[2][:, None], u[3][:, None])
        thr_new = lthr * (color * scale[:, None]) * weight
        alive = found & ~(rr & ~survive) & (torch.amax(thr_new, dim=-1) > 0.0)
        keep = lanes[alive]
        o[keep], d[keep] = point[alive], direction[alive]
        thr[keep], prev[keep] = thr_new[alive], tri[alive]
        lanes = keep
    return acc


def to_device(tables: dict, device, dtype) -> dict:
    out = {}
    for k, v in tables.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
        elif v.dtype == np.int64:
            out[k] = torch.from_numpy(v).to(device)
        else:
            out[k] = torch.from_numpy(v).to(device=device, dtype=dtype)
    return out


def pixel_sums(sc: dict, pixels, first: int, count: int, *, seed: int, width: int,
               height: int, max_depth: int = 12, rr_start_depth: int = 5):
    """Radiance summed over the samples ``first .. first + count - 1`` of
    each pixel in ``pixels`` ([P] int64 tensor): [P, 3] in the tables'
    dtype (``to_device``), traced in chunks that keep a [lanes, triangles,
    3] buffer under LANE_BYTES."""
    dev, dt = pixels.device, sc["sph_center"].dtype
    per_lane = 3 * 4 * (sc["tri_v"].shape[0] + sc["sph_center"].shape[0])
    chunk_pix = max(1, (LANE_BYTES // per_lane) // count)
    out = torch.zeros((pixels.shape[0], 3), dtype=dt, device=dev)
    samples = torch.arange(first, first + count, device=dev, dtype=torch.int64)
    for start in range(0, pixels.shape[0], chunk_pix):
        pix = pixels[start:start + chunk_pix]
        p = pix.repeat_interleave(count)
        s = samples.repeat(pix.shape[0])
        key = path_key(seed, p, s)
        o, d = camera_rays(sc["camera"], p, s, key, width, height, dt)
        rad = trace(o, d, key, sc, max_depth=max_depth, rr_start_depth=rr_start_depth)
        out[start:start + pix.shape[0]] = rad.reshape(pix.shape[0], count, 3).sum(dim=1)
    return out


def quantize(x):
    """Gamma 2.2 and 0..255 with +0.5 floor rounding, the pow in float64."""
    g = torch.pow(torch.clamp(x.to(torch.float64), 0.0, 1.0), 1.0 / 2.2)
    return (255.0 * g + 0.5).to(torch.int32)
