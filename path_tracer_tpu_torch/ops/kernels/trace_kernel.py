"""Pieces of the regenerative traces, the table-driven scene, K4, K6, K7, K9.

Counterpart of ``path_tracer_tpu.ops.pallas.trace_kernel``:

- ``detect_quad_pairs``: the wall-quad collapse (host, numpy);
- ``make_raygen``: in-kernel camera sampling on the 2x2 subpixel grid;
- ``shade_phase``: Russian roulette, emission, BSDF sampling;
- ``regen_loop``: lanes own pixels and restart samples until a quota is
  done (K1's and K4's loop);
- ``kernel_scene_buffers`` (host, numpy, byte-equal to the JAX tables) and
  ``KernelScene``, its device form: the table-driven scene of any size;
- ``isect_full_plain``: the full-scene intersector (the JAX ``make_isect``)
  that K3 and K4 share, ``csrc/isect_full.cuh`` on the card;
- K4 ``trace_regen_prim`` (``csrc/trace_regen_prim.cu``) and its plain
  version ``trace_regen_prim_plain``: the regenerative loop over the
  full scene, the JAX package's ``pallasr:`` route;
- K6 ``trace_stepped`` (``csrc/trace_stepped.cu``) and its plain version
  ``trace_stepped_plain``: the stepped trace of given rays over the full
  scene (the JAX ``trace_pallas``), with the state, call loop and draws it
  shares with K5 (``trace_v2.trace_stepped``);
- K7 ``trace_resolve`` (``pt_trace_resolve`` of ``csrc/trace_stepped.cu``)
  and ``trace_resolve_plain``: one full-scene bounce at each ray's own depth
  (the JAX ``trace_pallas_resolve``), the portal schedulers' resolve;
- K9 ``trace_sorted`` and ``trace_sorted_plain``: K6 in calls of
  ``sort_every`` steps with the wavefront sorted by ``ray_sort_keys``
  between calls (the JAX ``trace_pallas_sorted``).

The torch functions are the plain versions of what the CUDA kernels compute
per thread: vectorised over [N] lanes, every branch a ``torch.where``,
operations in the JAX functions' order so they agree lane for lane under
the same uniforms. Per-ray values are lists of three [N] tensors (x, y, z),
as in the JAX functions.

Not ported, being TPU loop tuning: the all-done sync cadence
(``SYNC_EVERY``), ``WHILE_UNROLL``, the loop-style probe, ``CULL_CHUNK``,
``FORCE_TILES`` and the ablation switches; nor ``with_meta``'s
``tile_uniform_mat`` (the MXU one-hot fetch, bitwise-neutral). A CUDA thread
simply leaves its loop when its quota is done.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from path_tracer_tpu_torch.models.scene import ScenePacked
from path_tracer_tpu_torch.ops import rng
from path_tracer_tpu_torch.ops.kernels.build import check_launch, load_kernel
from path_tracer_tpu_torch.render.raygen import tent_filter

F32 = torch.float32

_PI = np.float32(np.pi)
_TWO_PI = float(np.float32(2.0) * _PI)
_R0 = np.float32((1.5 - 1.0) ** 2 / (1.5 + 1.0) ** 2)
_ONE_MINUS_R0 = float(np.float32(1.0) - _R0)
_INV_IOR = float(np.float32(1.0 / 1.5))


def detect_quad_pairs(packed: ScenePacked):
    """Find consecutive triangle pairs (in packed order) that form a
    parallelogram with identical material — collapsible into ONE quad
    primitive whose Möller–Trumbore acceptance is u,v ∈ [0,1]² instead of
    u+v ≤ 1. Exact-parity argument: the pair shares a plane, so the quad's
    t/normal equal the triangles' (bitwise for the axis-aligned wall quads
    of scenes.rs:321-367); the parallelogram is exactly the union of the
    two triangles; and excluding the departed QUAD is equivalent to
    excluding the departed triangle because the coplanar partner is always
    rejected by the t > EPS_TRI_T test. The first triangle is rotated so
    the parallelogram corner (its vertex not shared with the partner)
    comes first; the partner's unique vertex must equal p1 + p2 - p0 in
    exact f32 (conservative: approximate quads stay as triangles).

    Returns (quads, covered): quads maps first-triangle packed index →
    rotated [3,3] vertices; covered is the set of consumed indices."""
    nt = packed.num_triangles
    tv = np.asarray(packed.tri_v[:nt], np.float32)
    color = np.asarray(packed.tri_color[:nt])
    emis = np.asarray(packed.tri_emis[:nt])
    rtype = np.asarray(packed.tri_rtype[:nt])
    mesh = np.asarray(packed.tri_mesh[:nt])
    quads: dict[int, np.ndarray] = {}
    covered: set[int] = set()
    i = 0
    while i + 1 < nt:
        j = i + 1
        if (
            mesh[i] == mesh[j]
            and np.array_equal(color[i], color[j])
            and np.array_equal(emis[i], emis[j])
            and rtype[i] == rtype[j]
        ):
            A, B = tv[i], tv[j]
            bset = {tuple(v) for v in B}
            uniq = [k for k in range(3) if tuple(A[k]) not in bset]
            if len(uniq) == 1:
                k = uniq[0]
                p0, p1, p2 = A[k], A[(k + 1) % 3], A[(k + 2) % 3]
                shared = {tuple(p1), tuple(p2)}
                uniq_b = [tuple(v) for v in B if tuple(v) not in shared]
                q = p1 + p2 - p0  # f32 arithmetic, exact-match required
                if len(uniq_b) == 1 and np.array_equal(
                    np.asarray(uniq_b[0], np.float32), q
                ):
                    quads[i] = np.stack([p0, p1, p2])
                    covered.update((i, j))
                    i += 2
                    continue
        i += 1
    return quads, covered


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def shade_phase(d, nrm, color, emis, rtype, found, thr, acc, u4,
                new_depth, max_depth, rr_start_depth):
    """Russian roulette + emission + BSDF sample + throughput update.

    Semantics: mod.rs:676-788 with the always-RR refraction branch, and the
    unconditional max-depth cut. Returns (acc', thr', d_new, alive_mask)."""
    u_rr, u1, u2, u_br = u4

    nd = _dot(nrm, d)
    to_ray = nd < 0.0
    nl = [torch.where(to_ray, nrm[k], -nrm[k]) for k in range(3)]

    # --- Russian roulette (mod.rs:676-683) ---
    max_refl = torch.maximum(color[0], torch.maximum(color[1], color[2]))
    rr_on = new_depth > rr_start_depth
    survive = (u_rr < max_refl) & (new_depth < max_depth)
    die_rr = rr_on & ~survive
    scale = torch.where(
        rr_on & survive, 1.0 / torch.clamp(max_refl, min=1e-30), 1.0)

    fm = found.to(F32)
    acc = [acc[k] + thr[k] * emis[k] * fm for k in range(3)]

    # --- diffuse: cosine-weighted around nl (mod.rs:687-715) ---
    r1 = _TWO_PI * u1
    r2s = torch.sqrt(u2)
    w = nl
    use_y = torch.abs(w[0]) > 0.1
    upy = use_y.to(F32)
    upx = (~use_y).to(F32)
    ux = upy * w[2]
    uy = -upx * w[2]
    uz = upx * w[1] - upy * w[0]
    ul = torch.rsqrt(torch.clamp(ux * ux + uy * uy + uz * uz, min=1e-30))
    ux, uy, uz = ux * ul, uy * ul, uz * ul
    vx = w[1] * uz - w[2] * uy
    vy = w[2] * ux - w[0] * uz
    vz = w[0] * uy - w[1] * ux
    cr1 = torch.cos(r1) * r2s
    sr1 = torch.sin(r1) * r2s
    wz = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    dd0 = ux * cr1 + vx * sr1 + w[0] * wz
    dd1 = uy * cr1 + vy * sr1 + w[1] * wz
    dd2 = uz * cr1 + vz * sr1 + w[2] * wz
    dl = torch.rsqrt(torch.clamp(dd0 * dd0 + dd1 * dd1 + dd2 * dd2, min=1e-30))
    d_diff = [dd0 * dl, dd1 * dl, dd2 * dl]

    # --- specular mirror ---
    d_spec = [d[k] - nrm[k] * 2.0 * nd for k in range(3)]

    # --- refract (mod.rs:729-788; always-RR branch, weights Re/P, Tr/(1-P)) ---
    into = to_ray
    nnt = torch.where(into, _INV_IOR, 1.5)
    ddn = _dot(nl, d)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    tsc = ddn * nnt + torch.sqrt(torch.clamp(cos2t, min=0.0))
    td = [d[k] * nnt - nl[k] * tsc for k in range(3)]
    tl = torch.rsqrt(torch.clamp(
        td[0] * td[0] + td[1] * td[1] + td[2] * td[2], min=1e-30))
    td = [x * tl for x in td]
    tdn = _dot(td, nrm)
    c_ = 1.0 - torch.where(into, -ddn, tdn)
    c2 = c_ * c_
    c5 = c_ * (c2 * c2)  # lax.integer_pow's square-and-multiply order
    re = float(_R0) + _ONE_MINUS_R0 * c5
    p_ = 0.25 + 0.5 * re
    lo = u_br < p_
    pick_refl = lo | tir
    d_refr = [torch.where(pick_refl, d_spec[k], td[k]) for k in range(3)]
    w_num = torch.where(lo, re, 1.0 - re)
    w_den = torch.where(lo, p_, 1.0 - p_)
    w_refr = torch.where(tir, 1.0, w_num / w_den)

    is_diff = rtype < 0.5
    is_spec = (rtype >= 0.5) & (rtype < 1.5)
    d_new = [
        torch.where(is_diff, d_diff[k], torch.where(is_spec, d_spec[k], d_refr[k]))
        for k in range(3)
    ]
    wgt = torch.where(is_diff | is_spec, 1.0, w_refr)

    thr_new = [thr[k] * color[k] * scale * wgt for k in range(3)]
    thr_max = torch.maximum(thr_new[0], torch.maximum(thr_new[1], thr_new[2]))
    # unconditional max-depth cut: every sample ends within max_depth steps
    die_depth = new_depth >= max_depth
    alive_new = found & ~die_rr & ~die_depth & (thr_max > 0.0)
    return acc, thr_new, d_new, alive_new


def make_raygen(cam, pix: torch.Tensor):
    """Camera sampling: integer pixel indices [N] → (raygen, lens_center3)
    where raygen(s_idx, u1, u2) → direction3 for the global sample indices
    s_idx [N] (the 2x2 subpixel grid cycles s_idx mod 4).

    cam: ``trace_v2.CameraConsts``. The pixel→(x, y) mapping (with the
    y flip) is integer arithmetic: the JAX kernel's float fix-ups give the
    same values for up to 2^24 pixels."""
    so, su, sv, lc, inv_w, inv_h = cam.floats()
    row = torch.div(pix, cam.width, rounding_mode="floor")
    x = (pix - row * cam.width).to(F32)
    y = (cam.height - 1 - row).to(F32)

    def raygen(s_idx, u1, u2):
        xsub = (s_idx & 1).to(F32)
        ysub = ((s_idx >> 1) & 1).to(F32)
        xf = tent_filter(u1)
        yf = tent_filter(u2)
        sx = (x + 0.5 * (0.5 + xsub + xf)) * inv_w - 0.5
        sy = (y + 0.5 * (0.5 + ysub + yf)) * inv_h - 0.5
        sp = [so[k] + su[k] * sx + sv[k] * sy for k in range(3)]
        dx, dy, dz = lc[0] - sp[0], lc[1] - sp[1], lc[2] - sp[2]
        dl = torch.rsqrt(dx * dx + dy * dy + dz * dz)
        return [dx * dl, dy * dl, dz * dl]

    return raygen, lc


def regen_loop(sample_base, pix, isect, draw, cam, quota, max_depth,
               rr_start_depth):
    """Plain regenerative loop: each lane owns pixel ``pix[i]`` and traces
    ``quota`` full samples, restarting the moment its path dies.

    isect(o, d, prev, alive) → (found, point, nrm, color, emis, rtype,
    new_prev); draw(sample_idx, depth) → six [N] uniforms in slot order
    (u_rr, u1, u2, u_br, raygen u1, raygen u2) for each lane's current
    sample and segment. Returns (acc3, segments [N] i64, done [N] i64).

    Segments count as in the JAX regen_loop: every live lane after
    regeneration adds one per step."""
    raygen, lc = make_raygen(cam, pix)
    n = pix.shape[0]
    dev = pix.device
    zero = torch.zeros(n, dtype=F32, device=dev)
    o = [zero + lc[0], zero + lc[1], zero + lc[2]]
    d = [zero, zero, zero + 1.0]
    thr = [zero, zero, zero]
    acc = [zero, zero, zero]
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.int64, device=dev)
    counts = torch.zeros(n, dtype=torch.int64, device=dev)

    for _ in range(quota * max_depth):
        if not bool((done < quota).any()):
            break
        need = ~alive & (done < quota)
        depth = torch.where(need, 0, depth)
        s_global = sample_base + done
        u = draw(s_global, depth)
        d_new = raygen(s_global, u[4], u[5])
        o = [torch.where(need, lc[k], o[k]) for k in range(3)]
        d = [torch.where(need, d_new[k], d[k]) for k in range(3)]
        thr = [torch.where(need, 1.0, thr[k]) for k in range(3)]
        prev = torch.where(need, -1, prev)
        live = alive | need
        counts = counts + live

        found, point, nrm, color, emis, rtype, new_prev = isect(o, d, prev, live)
        new_depth = depth + 1
        acc, thr_new, d2, alive_new = shade_phase(
            d, nrm, color, emis, rtype, found, thr, acc, u[:4],
            new_depth, max_depth, rr_start_depth,
        )
        am = alive_new.to(F32)
        done = done + (live & ~alive_new)
        o = [torch.where(alive_new, point[k], o[k]) for k in range(3)]
        d = [torch.where(alive_new, d2[k], d[k]) for k in range(3)]
        thr = [thr_new[k] * am for k in range(3)]
        prev = torch.where(alive_new, new_prev, -1)
        depth = new_depth
        alive = alive_new
    return acc, counts, done


# ---------------------------------------------------------------------------
# Table-driven scenes of any size (K3's and K4's full-scene intersector)
# ---------------------------------------------------------------------------

BIG = 3.0e38  # miss sentinel
EPS_SPHERE = 1e-4
EPS_TRI_DET = 1e-4
EPS_TRI_T = 1e-4

QUOTA_CAP_PRIM = 64  # most samples per pixel in one K4 launch

TRI_TILE = 64  # triangles per culling tile
TILE_THRESHOLD = 192  # tile + cull only above this many triangles

# Row layout of KernelScene.sph ([S, SPH_F]), csrc/isect_full.cuh mirrors it
S_CENTER, S_RAD2, S_COLOR, S_EMIS, S_RTYPE, S_ORDER = 0, 3, 4, 7, 10, 11
SPH_F = 12
# Row layout of KernelScene.tri ([T, TRI_F]): the affine feature form
T_N, T_E1, T_E2, T_E2XA, T_AXE1, T_NA = 0, 3, 6, 9, 12, 15
T_NORMAL, T_COLOR, T_EMIS, T_RTYPE, T_ORDER = 16, 19, 22, 25, 26
T_QUAD, T_PID, T_GATE = 27, 28, 29
TRI_F = 32
# T_GATE: -1 ungated; m >= 0 needs bounding sphere m; -2 never valid (a
# gate-matrix column of zeros: padding rows under the pre-test)
GATE_NONE, GATE_NEVER = -1.0, -2.0

_SPH_KEYS = "sph_center sph_rad2 sph_color sph_emis sph_rtype sph_order".split()
_BND_KEYS = "bnd_center bnd_rad2 gate".split()
_TILE_KEYS = "tile_lo tile_hi".split()
_TRI_KEYS = (
    "tri_n tri_e1 tri_e2 tri_e2xa tri_axe1 tri_na "
    "tri_normal tri_color tri_emis tri_rtype tri_order tri_quad tri_pid"
).split()


def _scene_keys(bufs: dict) -> list[str]:
    """The tables that reach the kernel, in the JAX kernel's order."""
    keys = list(_SPH_KEYS)
    if "gate" in bufs:
        keys += _BND_KEYS
    if "tile_lo" in bufs:
        keys += _TILE_KEYS
    return keys + _TRI_KEYS


def _pad_to(x: np.ndarray, n: int, axis: int, fill: float) -> np.ndarray:
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def triangle_coeffs_np(tri_v):
    """Affine feature form of each triangle, in float32 numpy."""
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


def _morton3d(norm: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in [0, 1)^3 (10 bits an axis)."""
    q = (norm * 1024).astype(np.uint32)

    def expand(v):
        v = (v * 0x00010001) & 0xFF0000FF
        v = (v * 0x00000101) & 0x0F00F00F
        v = (v * 0x00000011) & 0xC30C30C3
        v = (v * 0x00000005) & 0x49249249
        return v

    return (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])


def kernel_scene_buffers(packed: ScenePacked) -> dict[str, np.ndarray]:
    """Scene tables for the full-scene intersector, as numpy arrays byte-equal
    to ``path_tracer_tpu.ops.pallas.trace_kernel.kernel_scene_buffers``:
    [3,P] / [1,P] columns, primitives padded with guaranteed misses.

    - Wall-quad pairs collapse into quads (``detect_quad_pairs``); each row
      keeps the canonical packed triangle id (``tri_pid``; padding -2).
    - Above TILE_THRESHOLD triangles, and only when every bounding sphere
      contains its mesh, triangles are sorted by centroid Morton code into
      tiles of TRI_TILE rows with padded AABBs (``tile_lo``/``tile_hi``
      [3, C]); triangles nearly as large as the scene (walls) form an
      always-tested base set at the front, padded to a multiple of 8.
    - A bounding sphere that does not contain its mesh gates its triangles:
      ``bnd_center``/``bnd_rad2`` and the [M, T] 0/1 ``gate`` matrix.
    - ``aabb_lo``/``aabb_inv_span`` (the scene box) ride along as in JAX.
    """
    S = packed.sph_radius.shape[0]
    M = packed.bnd_radius.shape[0]

    def prep(x, P, fill=0.0):
        x = np.asarray(x, np.float32)
        x = x[None, :] if x.ndim == 1 else x.T  # [P,k] -> [k,P]
        return _pad_to(x, P, 1, fill)

    sc = packed
    contained = True
    for m_idx in range(sc.num_meshes):
        sel = np.asarray(sc.tri_mesh[: sc.num_triangles]) == m_idx
        if not sel.any():
            continue
        verts = np.asarray(sc.tri_v[: sc.num_triangles])[sel].reshape(-1, 3)
        c = sc.bnd_center[m_idx]
        r = float(sc.bnd_radius[m_idx])
        dmax = float(np.sqrt(((verts - c) ** 2).sum(axis=1)).max())
        if dmax > r * (1.0 + 1e-5) + 1e-6:
            contained = False
            break

    quads, covered = detect_quad_pairs(sc)
    keep = [i for i in range(sc.num_triangles)
            if i not in covered or i in quads]
    nt = len(keep)
    T = max(((nt + 7) // 8) * 8, 8)

    def collapse(src, fill, verts=False):
        a = np.asarray(src, np.float32)
        out = np.full((T,) + a.shape[1:], fill, np.float32)
        for row, i in enumerate(keep):
            out[row] = quads[i] if (verts and i in quads) else a[i]
        return out

    tri_v = collapse(sc.tri_v, 1e30, verts=True)
    tri_normal = collapse(sc.tri_normal, 0.0)
    tri_color = collapse(sc.tri_color, 0.0)
    tri_emis = collapse(sc.tri_emis, 0.0)
    tri_rtype = collapse(sc.tri_rtype, 0.0)
    tri_order = collapse(np.minimum(np.asarray(sc.tri_order), 2**24), 1.0e9)
    tri_quad = np.zeros(T, np.float32)
    tri_pid = np.full(T, -2.0, np.float32)
    for row, i in enumerate(keep):
        tri_quad[row] = 1.0 if i in quads else 0.0
        tri_pid[row] = float(i)
    tri_mesh_c = np.asarray(sc.tri_mesh)[keep] if nt else np.zeros(0, np.int64)

    tiles = None
    if contained and nt > TILE_THRESHOLD:
        verts_all = tri_v[:nt]
        cent = verts_all.mean(axis=1)
        tri_rad = np.sqrt(((verts_all - cent[:, None, :]) ** 2).sum(-1)).max(1)
        scene_diag = float(np.linalg.norm(
            verts_all.reshape(-1, 3).max(0) - verts_all.reshape(-1, 3).min(0)))
        big = tri_rad > 0.125 * scene_diag
        small_idx = np.where(~big)[0]

        lo = cent[small_idx].min(axis=0)
        span = np.maximum(cent[small_idx].max(axis=0) - lo, 1e-9)
        norm = np.clip((cent[small_idx] - lo) / span, 0.0, 0.999999).astype(
            np.float32)
        codes = _morton3d(norm)
        small_sorted = small_idx[np.argsort(codes, kind="stable")]

        n_base = int(big.sum())
        base_pad = max(((n_base + 7) // 8) * 8, 8)
        C = -(-len(small_sorted) // TRI_TILE)
        T = base_pad + C * TRI_TILE
        order = np.concatenate([np.where(big)[0], small_sorted])
        dst = np.concatenate(
            [np.arange(n_base), base_pad + np.arange(len(small_sorted))])

        def reorder(a, fill=0.0):
            out = np.full((T,) + a.shape[1:], fill, a.dtype)
            out[dst] = a[:nt][order]
            return out

        tri_v = reorder(tri_v, 1e30)
        tri_normal = reorder(tri_normal)
        tri_color = reorder(tri_color)
        tri_emis = reorder(tri_emis)
        tri_rtype = reorder(tri_rtype)
        tri_order = reorder(tri_order, 1.0e9)
        tri_quad = reorder(tri_quad)
        tri_pid = reorder(tri_pid, -2.0)

        # slop keeps the cull conservative under float32 rounding
        tile_lo = np.full((C, 3), 1e30, np.float32)
        tile_hi = np.full((C, 3), -1e30, np.float32)
        for c in range(C):
            verts = tri_v[base_pad + c * TRI_TILE: base_pad + (c + 1) * TRI_TILE]
            verts = verts[verts[:, 0, 0] < 1e29].reshape(-1, 3)
            if len(verts) == 0:
                continue
            span = verts.max(0) - verts.min(0)
            slop = np.maximum(span, np.abs(verts).max()) * 1e-5 + 1e-6
            tile_lo[c] = verts.min(axis=0) - slop
            tile_hi[c] = verts.max(axis=0) + slop
        tiles = (tile_lo, tile_hi)

    coeffs = triangle_coeffs_np(tri_v)
    order_fill = 1.0e9
    bufs = {
        "sph_center": prep(sc.sph_center, S, 1e30),
        "sph_rad2": prep(np.asarray(sc.sph_radius) ** 2, S),
        "sph_color": prep(sc.sph_color, S),
        "sph_emis": prep(sc.sph_emis, S),
        "sph_rtype": prep(sc.sph_rtype.astype(np.float32), S),
        "sph_order": prep(
            np.minimum(sc.sph_order, 2**24).astype(np.float32), S, order_fill),
        "tri_n": prep(coeffs["n"], T),
        "tri_e1": prep(coeffs["e1"], T),
        "tri_e2": prep(coeffs["e2"], T),
        "tri_e2xa": prep(coeffs["e2xa"], T),
        "tri_axe1": prep(coeffs["axe1"], T),
        "tri_na": prep(coeffs["na"], T),
        "tri_normal": prep(tri_normal, T),
        "tri_color": prep(tri_color, T),
        "tri_emis": prep(tri_emis, T),
        "tri_rtype": prep(tri_rtype, T),
        "tri_order": prep(tri_order, T, order_fill),
        "tri_quad": prep(tri_quad, T),
        "tri_pid": prep(tri_pid, T, -2.0),
    }
    if tiles is not None:
        tile_lo, tile_hi = tiles
        bufs["tile_lo"] = prep(tile_lo, tile_lo.shape[0])
        bufs["tile_hi"] = prep(tile_hi, tile_hi.shape[0])
    if not contained:
        gate = np.zeros((M, T), np.float32)
        for t in range(nt):
            gate[tri_mesh_c[t], t] = 1.0
        bufs["bnd_center"] = prep(sc.bnd_center, M, 1e30)
        bufs["bnd_rad2"] = prep(np.asarray(sc.bnd_radius) ** 2, M)
        bufs["gate"] = gate

    pts = [tri_v[tri_v[:, 0, 0] < 1e29].reshape(-1, 3)]
    srad = np.asarray(sc.sph_radius, np.float32)
    scen = np.asarray(sc.sph_center, np.float32)
    real = srad > 0.0
    if real.any():
        pts += [scen[real] - srad[real, None], scen[real] + srad[real, None]]
    pts = np.concatenate(pts) if pts[0].size or len(pts) > 1 else np.zeros((1, 3))
    lo = pts.min(axis=0).astype(np.float32)
    span = np.maximum(pts.max(axis=0) - lo, 1e-6).astype(np.float32)
    bufs["aabb_lo"] = lo.reshape(3, 1)
    bufs["aabb_inv_span"] = (1.0 / span).reshape(3, 1)
    return bufs


@dataclass(frozen=True)
class KernelScene:
    """A table-driven scene on one device, one row per primitive:

    - ``sph`` [S, SPH_F]: center, r² (0 marks padding), color, emission,
      reflect type, packed order;
    - ``bnd`` [M, 4]: bounding spheres (center, r²) that gate triangles;
    - ``tri`` [T, TRI_F]: n, e1, e2, e2×a, a×e1, a·n, unit normal, color,
      emission, reflect type, packed order, quad flag, packed id, gate;
    - ``tiles`` [C, 6]: each culling tile's AABB (lo, hi); tile c holds
      rows ``tile_base + c*TRI_TILE ..`` and rows below ``tile_base`` are
      the always-tested base set (``tile_base`` is 0 without tiles);
    - ``aabb_lo``, ``aabb_inv_span``: the scene box (host floats), which
      K9's sort keys grid.
    """

    sph: torch.Tensor
    bnd: torch.Tensor
    tri: torch.Tensor
    tiles: torch.Tensor
    tile_base: int
    aabb_lo: tuple = (0.0, 0.0, 0.0)
    aabb_inv_span: tuple = (1.0, 1.0, 1.0)

    def to(self, device) -> "KernelScene":
        return KernelScene(self.sph.to(device), self.bnd.to(device),
                           self.tri.to(device), self.tiles.to(device),
                           self.tile_base, self.aabb_lo, self.aabb_inv_span)


def kernel_scene_from_jax(bufs: dict) -> KernelScene:
    """``kernel_scene_buffers``' tables (the JAX package's or the port's,
    as numpy arrays) → KernelScene on the CPU. The [M, T] gate matrix
    becomes one gate index per triangle row; a column with more than one
    bounding sphere has no such form and raises."""
    b = {k: np.asarray(bufs[k], np.float32) for k in _scene_keys(bufs)}
    S = b["sph_rad2"].shape[1]
    sph = np.zeros((S, SPH_F), np.float32)
    sph[:, S_CENTER:S_CENTER + 3] = b["sph_center"].T
    sph[:, S_RAD2] = b["sph_rad2"][0]
    sph[:, S_COLOR:S_COLOR + 3] = b["sph_color"].T
    sph[:, S_EMIS:S_EMIS + 3] = b["sph_emis"].T
    sph[:, S_RTYPE] = b["sph_rtype"][0]
    sph[:, S_ORDER] = b["sph_order"][0]

    T = b["tri_na"].shape[1]
    tri = np.zeros((T, TRI_F), np.float32)
    for key, col in (("tri_n", T_N), ("tri_e1", T_E1), ("tri_e2", T_E2),
                     ("tri_e2xa", T_E2XA), ("tri_axe1", T_AXE1),
                     ("tri_normal", T_NORMAL), ("tri_color", T_COLOR),
                     ("tri_emis", T_EMIS)):
        tri[:, col:col + 3] = b[key].T
    for key, col in (("tri_na", T_NA), ("tri_rtype", T_RTYPE),
                     ("tri_order", T_ORDER), ("tri_quad", T_QUAD),
                     ("tri_pid", T_PID)):
        tri[:, col] = b[key][0]
    tri[:, T_GATE] = GATE_NONE
    bnd = np.zeros((0, 4), np.float32)
    if "gate" in b:
        gate = b["gate"]
        per_col = gate.sum(axis=0)
        if (per_col > 1).any() or not np.isin(gate, (0.0, 1.0)).all():
            raise ValueError("a triangle gated by more than one bounding sphere")
        tri[:, T_GATE] = np.where(per_col > 0, gate.argmax(axis=0), GATE_NEVER)
        bnd = np.concatenate([b["bnd_center"].T, b["bnd_rad2"].T], axis=1)

    tiles = np.zeros((0, 6), np.float32)
    tile_base = 0
    if "tile_lo" in b:
        tiles = np.concatenate([b["tile_lo"].T, b["tile_hi"].T], axis=1)
        tile_base = T - tiles.shape[0] * TRI_TILE
    box = {}
    if "aabb_lo" in bufs:
        box = {k: tuple(float(x) for x in np.asarray(bufs[k], np.float32).ravel())
               for k in ("aabb_lo", "aabb_inv_span")}
    return KernelScene(torch.from_numpy(sph), torch.from_numpy(bnd),
                       torch.from_numpy(tri), torch.from_numpy(tiles),
                       int(tile_base), **box)


def build_kernel_scene(packed: ScenePacked) -> KernelScene:
    """ScenePacked → KernelScene on the CPU."""
    return kernel_scene_from_jax(kernel_scene_buffers(packed))


def _sphere_t(cen, rad2, o, d):
    """The expanded sphere test of the JAX intersector: cen, rad2 [P] (or
    per-lane [N]) against rays 3×[N, 1] → t [N, P] (BIG = miss)."""
    cd = 0.0 + cen[0] * d[0] + cen[1] * d[1] + cen[2] * d[2]
    co = 0.0 + cen[0] * o[0] + cen[1] * o[1] + cen[2] * o[2]
    cc = 0.0 + cen[0] * cen[0] + cen[1] * cen[1] + cen[2] * cen[2]
    od = 0.0 + o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
    oo = 0.0 + o[0] * o[0] + o[1] * o[1] + o[2] * o[2]
    b = cd - od
    det = b * b - (cc - 2.0 * co + oo) + rad2
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    t_near = b - sq
    t_far = b + sq
    t = torch.where(t_near >= EPS_SPHERE, t_near,
                    torch.where(t_far >= EPS_SPHERE, t_far, BIG))
    # r² == 0 marks padding, whose far-away center makes b² - |op|² cancel
    return torch.where((det < 0.0) | (rad2 <= 0.0), BIG, t)


def isect_full_plain(ks: KernelScene, o, d, prev, alive, work=None):
    """Closest hit against the whole table-driven scene: the plain torch
    version of ``trace_kernel.make_isect`` (JAX) and of
    ``csrc/isect_full.cuh``. o, d: 3 lists of [N] f32; prev [N] packed
    triangle id of the departed surface (-1 none); alive [N] bool.
    Returns (found, point3, nrm3, color3, emis3, rtype, new_prev [N] f32).

    - Spheres: the expanded test, first minimum in table order.
    - Triangles and quads: the affine feature form; u, v ≥ 0, u ≤ 1 and
      u + v ≤ 1 (quads v ≤ 1); t > EPS; the departed triangle is excluded;
      a gated triangle needs its bounding sphere hit. Strictly closer wins
      in table order, so the first row wins ties.
    - Culling: the base set is always tested; tile c only where the lane
      is alive and its ray enters the tile's AABB (t_ex ≥ t_en, t_ex ≥ 0)
      closer than the best hit so far (triangles or spheres). A tile the
      ray cannot enter closer holds no strictly closer hit, so this per-lane
      skip is the JAX kernel's per-block skip lane by lane.
    - Spheres against triangles: the closer wins; an exact tie goes to the
      lower packed order. new_prev is the hit triangle's packed id, -1 for
      a sphere or a miss.

    ``work`` (a dict, optional) counts the tests that live lanes need:
    "sph" sphere tests, "tri" triangle rows, "slab" tile AABB tests.
    """
    n = o[0].shape[0]
    dev = o[0].device
    prevf = prev.to(F32)
    oc = [x[:, None] for x in o]
    dc = [x[:, None] for x in d]

    sph = ks.sph
    t_s = _sphere_t([sph[:, S_CENTER + k] for k in range(3)], sph[:, S_RAD2],
                    oc, dc)
    d_s, i_s = torch.min(t_s, dim=1)  # first index of the minimum

    gate_ok = None
    if ks.bnd.shape[0]:
        bnd = ks.bnd
        t_b = _sphere_t([bnd[:, k] for k in range(3)], bnd[:, 3], oc, dc)
        gate_ok = t_b < BIG  # [N, M]

    m = [
        oc[1] * dc[2] - oc[2] * dc[1],
        oc[2] * dc[0] - oc[0] * dc[2],
        oc[0] * dc[1] - oc[1] * dc[0],
    ]

    def tri_block(lo, hi):
        """(best t [N], best row [N]) over rows [lo, hi)."""
        tab = ks.tri[lo:hi]

        def col(c):
            return tab[:, c]

        def dot_t(c, vec):
            return col(c) * vec[0] + col(c + 1) * vec[1] + col(c + 2) * vec[2]

        det = -dot_t(T_N, dc)
        udet = dot_t(T_E2, m) - dot_t(T_E2XA, dc)
        vdet = -dot_t(T_E1, m) - dot_t(T_AXE1, dc)
        tdet = dot_t(T_N, oc) - col(T_NA)
        dvalid = torch.abs(det) >= EPS_TRI_DET
        inv = 1.0 / torch.where(dvalid, det, 1.0)
        u_ = udet * inv
        v_ = vdet * inv
        t_ = tdet * inv
        uv_hi = torch.where(col(T_QUAD) > 0.5, v_, u_ + v_)
        valid = (
            dvalid
            & (u_ >= 0.0) & (u_ <= 1.0)
            & (v_ >= 0.0) & (uv_hi <= 1.0)
            & (t_ > EPS_TRI_T)
            & (col(T_PID) != prevf[:, None])
        )
        gate = col(T_GATE)
        if gate_ok is not None:
            g_idx = torch.clamp(gate, min=0.0).to(torch.int64)
            ok = torch.gather(gate_ok, 1, g_idx[None, :].expand(n, -1))
            valid = valid & ((gate == GATE_NONE) | ((gate >= 0.0) & ok))
        t_tri = torch.where(valid, t_, BIG)
        best, row = torch.min(t_tri, dim=1)
        return best, row + lo

    n_tiles = ks.tiles.shape[0]
    T = ks.tri.shape[0]
    d_t, r_t = tri_block(0, ks.tile_base if n_tiles else T)
    if work is not None:
        live = int(alive.sum())
        work["sph"] = work.get("sph", 0) + live * (sph.shape[0] + ks.bnd.shape[0])
        work["tri"] = work.get("tri", 0) + live * (ks.tile_base if n_tiles else T)
        work["slab"] = work.get("slab", 0) + live * n_tiles
    if n_tiles:
        inv = [1.0 / torch.where(torch.abs(d[k]) < 1e-30, 1e-30, d[k])
               for k in range(3)]
        tiles = ks.tiles
        for c in range(n_tiles):
            t_en = torch.zeros(n, dtype=F32, device=dev)
            t_ex = torch.full((n,), BIG, dtype=F32, device=dev)
            for k in range(3):
                ta = (tiles[c, k] - o[k]) * inv[k]
                tb = (tiles[c, 3 + k] - o[k]) * inv[k]
                t_en = torch.maximum(t_en, torch.minimum(ta, tb))
                t_ex = torch.minimum(t_ex, torch.maximum(ta, tb))
            bound = torch.minimum(d_t, d_s)
            cand = (t_ex >= t_en) & (t_ex >= 0.0) & alive & (t_en < bound)
            if work is not None:
                work["tri"] += int(cand.sum()) * TRI_TILE
            if not bool(cand.any()):
                continue
            lo = ks.tile_base + c * TRI_TILE
            res_t, res_r = tri_block(lo, lo + TRI_TILE)
            better = cand & (res_t < d_t)
            d_t = torch.where(better, res_t, d_t)
            r_t = torch.where(better, res_r, r_t)

    srow = sph[i_s]  # [N, SPH_F]
    trow = ks.tri[r_t]  # [N, TRI_F]
    sph_wins = (d_s < d_t) | ((d_s == d_t) & (srow[:, S_ORDER] < trow[:, T_ORDER]))
    t = torch.where(sph_wins, d_s, d_t)
    found = (t < BIG) & alive
    point = [o[k] + d[k] * t for k in range(3)]
    sn = [point[k] - srow[:, S_CENTER + k] for k in range(3)]
    sl = torch.rsqrt(torch.clamp(sn[0] * sn[0] + sn[1] * sn[1] + sn[2] * sn[2],
                                 min=1e-30))
    nrm = [torch.where(sph_wins, sn[k] * sl, trow[:, T_NORMAL + k])
           for k in range(3)]
    color = [torch.where(sph_wins, srow[:, S_COLOR + k], trow[:, T_COLOR + k])
             for k in range(3)]
    emis = [torch.where(sph_wins, srow[:, S_EMIS + k], trow[:, T_EMIS + k])
            for k in range(3)]
    rtype = torch.where(sph_wins, srow[:, S_RTYPE], trow[:, T_RTYPE])
    new_prev = torch.where(found & ~sph_wins, trow[:, T_PID], -1.0)
    return found, point, nrm, color, emis, rtype, new_prev


def _check_regen_args(pixel_idx, quota, max_depth, uniforms, quota_cap):
    n = pixel_idx.shape[0]
    if pixel_idx.dim() != 1 or pixel_idx.dtype != torch.int32:
        raise ValueError("pixel_idx must be a 1-D int32 tensor")
    if not 0 <= quota <= quota_cap or max_depth < 1:
        raise ValueError(f"need 0 <= quota <= {quota_cap} and max_depth >= 1 "
                         f"(got {quota}, {max_depth})")
    if uniforms is not None and (
        uniforms.shape != (rng.N_SLOTS, n) or uniforms.dtype != torch.float32
    ):
        raise ValueError(f"uniforms must be [{rng.N_SLOTS}, {n}] float32")


def regen_draw(seed, pix, uniforms):
    """draw(sample_idx, depth) for regen_loop: the counter generator keyed
    by (seed, pixel, sample, depth, slot), or the per-lane table
    ``uniforms`` [6, N] at every step."""
    if uniforms is not None:
        table = [uniforms[k] for k in range(rng.N_SLOTS)]
        return lambda sample_idx, depth: table

    def draw(sample_idx, depth):
        key = rng.path_key(seed, pix, sample_idx)
        return [rng.uniform(key, depth, k) for k in range(rng.N_SLOTS)]

    return draw


def trace_regen_prim_plain(ks: KernelScene, cam, pixel_idx: torch.Tensor, *,
                           seed: int, sample_base: int, quota: int,
                           max_depth: int = 12, rr_start_depth: int = 5,
                           uniforms: torch.Tensor | None = None, work=None):
    """Plain torch version of K4, the regenerative loop over the full
    table-driven scene (the JAX package's ``trace_pallas_regen_prim``): K1's
    ``regen_loop`` with ``isect_full_plain`` as its intersector. Lane i owns
    pixel ``pixel_idx[i]`` and traces ``quota`` (at most QUOTA_CAP_PRIM)
    samples, global indices ``sample_base ..``; cam is a
    ``trace_v2.CameraConsts``; ``work`` as in isect_full_plain. Returns (radiance sum [N,3] f32, segments
    [N] i32, finished samples [N] i32)."""
    _check_regen_args(pixel_idx, quota, max_depth, uniforms, QUOTA_CAP_PRIM)
    pix = pixel_idx.to(torch.int64)

    def isect(o, d, prev, alive):
        return isect_full_plain(ks, o, d, prev, alive, work)

    acc, counts, done = regen_loop(
        sample_base, pix, isect, regen_draw(seed, pix, uniforms), cam, quota,
        max_depth, rr_start_depth)
    return (torch.stack(acc, dim=1), counts.to(torch.int32),
            done.to(torch.int32))


CSRC_REGEN_PRIM = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc", "trace_regen_prim.cu")


@functools.lru_cache(maxsize=2)
def _prim_library(fmad: bool = True):
    built = load_kernel(CSRC_REGEN_PRIM, fmad)
    fn = built.lib.pt_trace_regen_prim
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # sph, S
        ctypes.c_void_p, ctypes.c_int,  # bnd, M
        ctypes.c_void_p, ctypes.c_int,  # tri, T
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # tiles, C, tile_base
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # camera (host), W, H
        ctypes.c_void_p, ctypes.c_int,  # pixel_idx, n
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int,  # seed, base, quota
        ctypes.c_int, ctypes.c_int,  # max_depth, rr_start_depth
        ctypes.c_void_p,  # uniforms [6, n] or NULL
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rad, segs, done
        ctypes.c_void_p,  # stream
    ]
    return built


def trace_regen_prim(ks: KernelScene, cam, pixel_idx: torch.Tensor, *,
                     seed: int, sample_base: int, quota: int,
                     max_depth: int = 12, rr_start_depth: int = 5,
                     uniforms: torch.Tensor | None = None, fmad: bool = True):
    """K4 (see trace_regen_prim_plain for the contract). CPU tensors run the
    plain version; CUDA tensors launch ``csrc/trace_regen_prim.cu`` or
    raise. ``fmad=False`` builds the kernel without FMA contraction."""
    dev = pixel_idx.device
    if dev.type == "cpu":
        return trace_regen_prim_plain(
            ks, cam, pixel_idx, seed=seed, sample_base=sample_base,
            quota=quota, max_depth=max_depth, rr_start_depth=rr_start_depth,
            uniforms=uniforms)
    if dev.type != "cuda":
        raise ValueError(f"trace_regen_prim runs on cpu or cuda, not {dev}")
    _check_regen_args(pixel_idx, quota, max_depth, uniforms, QUOTA_CAP_PRIM)
    _check_on("trace_regen_prim (K4)", dev, [ks.sph, ks.bnd, ks.tri, ks.tiles]
              + ([uniforms] if uniforms is not None else []), (pixel_idx,))
    n = pixel_idx.shape[0]
    rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    segs = torch.empty(n, dtype=torch.int32, device=dev)
    done = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return rad, segs, done
    built = _prim_library(fmad)
    params = cam.params.to(torch.float32).contiguous()  # host memory
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = built.lib.pt_trace_regen_prim(
            *_scene_args(ks), params.data_ptr(), cam.width, cam.height,
            pixel_idx.data_ptr(), n,
            int(seed) & rng.MASK32, int(sample_base), int(quota),
            int(max_depth), int(rr_start_depth), _ptr(uniforms),
            rad.data_ptr(), segs.data_ptr(), done.data_ptr(), stream)
    check_launch(built, code, "trace_regen_prim")
    trace_regen_prim.launches += 1
    return rad, segs, done


trace_regen_prim.launches = 0


# ---------------------------------------------------------------------------
# Stepped traces of given rays: K5 (trace_v2.trace_stepped) and K6 (here)
# ---------------------------------------------------------------------------

# Rows of the stepped state [STATE_ROWS, N] float32 (csrc/trace_stepped.cu
# mirrors them): origin, direction, throughput, radiance (3 rows each), alive
# (1.0 or 0.0) and the departed triangle's packed id (-1 for none): the six
# state rows of the JAX kernels, in one tensor.
ROW_O, ROW_D, ROW_THR, ROW_ACC, ROW_ALIVE, ROW_PREV = 0, 3, 6, 9, 12, 13
STATE_ROWS = 14

CSRC_STEPPED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc", "trace_stepped.cu")


def check_stepped_args(o, d, pixel_idx, sample_idx, max_depth, steps_per_call,
                       uniforms):
    """Argument checks shared by K5 and K6 and their plain versions."""
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or o.dtype != F32 or d.dtype != F32:
        raise ValueError("o and d must be [N, 3] float32")
    for name, t in (("pixel_idx", pixel_idx), ("sample_idx", sample_idx)):
        if t.shape != (n,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a [N] int32 tensor")
    if max_depth < 1 or steps_per_call < 1:
        raise ValueError(f"need max_depth >= 1 and steps_per_call >= 1 "
                         f"(got {max_depth}, {steps_per_call})")
    if uniforms is not None:
        if uniforms.shape != (max_depth * 4, n) or uniforms.dtype != F32:
            raise ValueError(f"uniforms must be [{max_depth * 4}, {n}] float32")
        if max_depth % min(steps_per_call, max_depth):
            raise ValueError(f"with injected uniforms, steps_per_call="
                             f"{steps_per_call} must divide max_depth={max_depth}")


def stepped_draw(seed, pixel_idx, sample_idx, uniforms):
    """draw(depth) → the four shading uniforms (u_rr, u1, u2, u_br) of every
    ray at segment ``depth``: the counter generator keyed by (seed, pixel,
    sample, depth, slot 0-3), the draws K1 makes for the same sample, or the
    rows ``depth * 4 ..`` of the injected ``uniforms`` [max_depth * 4, N]."""
    if uniforms is not None:
        return lambda depth: [uniforms[depth * 4 + k] for k in range(4)]
    key = rng.path_key(seed, pixel_idx.to(torch.int64), sample_idx.to(torch.int64))
    return lambda depth: [rng.uniform(key, depth, k) for k in range(4)]


def stepped_call_plain(isect, draw, state, counts, *, depth0, n_steps,
                       max_depth, rr_start_depth):
    """One call of the plain stepped trace: up to ``n_steps`` bounces at
    segment depths ``depth0 ..`` over ``state`` [STATE_ROWS, N] (updated in
    place); ``counts`` [N] i32 gains one for each step a ray starts alive.

    isect(o, d, prev, alive) → (found, point3, nrm3, color3, emis3, rtype,
    new_prev [N] f32). The step is the JAX kernels' body (``trace_v2.
    _make_kernel_v2``, ``trace_kernel._make_kernel``): shade, move o and d
    only if the path lives on, zero thr on death, prev := new_prev. A ray
    that is dead is left as it is, as a CUDA thread leaves its loop: the JAX
    kernel's all-dead block skip (``trace_kernel.py:1064-1082``) lane by
    lane. INVARIANT (the JAX kernel's): a ray keeps the prev and thr it had
    at death, where a step run over a dead lane would reset them; dead rays
    never come back in a stepped trace, so nothing reads them, and state
    rows compare only for live rays."""
    o = [state[ROW_O + k] for k in range(3)]
    d = [state[ROW_D + k] for k in range(3)]
    thr = [state[ROW_THR + k] for k in range(3)]
    acc = [state[ROW_ACC + k] for k in range(3)]
    alive = state[ROW_ALIVE] > 0.0
    prev = state[ROW_PREV]
    for s in range(n_steps):
        if not bool(alive.any()):
            break
        counts += alive
        found, point, nrm, color, emis, rtype, new_prev = isect(o, d, prev, alive)
        depth = depth0 + s
        new_depth = torch.tensor(depth + 1, device=prev.device)
        acc, thr_new, d_new, alive_new = shade_phase(
            d, nrm, color, emis, rtype, found, thr, acc, draw(depth),
            new_depth, max_depth, rr_start_depth)
        am = alive_new.to(F32)
        o = [torch.where(alive_new, point[k], o[k]) for k in range(3)]
        d = [torch.where(alive_new, d_new[k], d[k]) for k in range(3)]
        thr = [torch.where(alive, thr_new[k] * am, thr[k]) for k in range(3)]
        prev = torch.where(alive, new_prev, prev)
        alive = alive_new
    state[ROW_O:ROW_O + 3] = torch.stack(o)
    state[ROW_D:ROW_D + 3] = torch.stack(d)
    state[ROW_THR:ROW_THR + 3] = torch.stack(thr)
    state[ROW_ACC:ROW_ACC + 3] = torch.stack(acc)
    state[ROW_ALIVE] = alive.to(F32)
    state[ROW_PREV] = prev


def stepped_trace(run_call, o, d, max_depth, steps_per_call):
    """The JAX wrappers' call loop: ``ceil(max_depth / steps)`` calls of
    ``steps = min(steps_per_call, max_depth)`` bounces, call c starting at
    depth ``c * steps``, over a fresh state (thr 1, radiance 0, alive, prev
    -1). run_call(state, counts, depth0, steps) runs one call. Returns
    (radiance [N,3] f32, rays traced as an int64 scalar tensor)."""
    n = o.shape[0]
    steps = min(steps_per_call, max_depth)
    state = torch.empty((STATE_ROWS, n), dtype=F32, device=o.device)
    state[ROW_O:ROW_O + 3] = o.T
    state[ROW_D:ROW_D + 3] = d.T
    state[ROW_THR:ROW_THR + 3] = 1.0
    state[ROW_ACC:ROW_ACC + 3] = 0.0
    state[ROW_ALIVE] = 1.0
    state[ROW_PREV] = -1.0
    counts = torch.zeros(n, dtype=torch.int32, device=o.device)
    for c in range(-(-max_depth // steps)):
        run_call(state, counts, c * steps, steps)
    return state[ROW_ACC:ROW_ACC + 3].T.contiguous(), counts.sum(dtype=torch.int64)


def trace_stepped_plain(ks: KernelScene, o, d, *, seed: int, pixel_idx,
                        sample_idx, max_depth: int = 12, rr_start_depth: int = 5,
                        steps_per_call: int = 12, uniforms=None, work=None):
    """Plain torch version of K6, the JAX package's ``trace_pallas``: trace
    the rays o, d [N,3] through the table-driven scene, ``steps_per_call``
    bounces a call (``stepped_call_plain``, ``stepped_trace``). Ray i draws
    as sample ``sample_idx[i]`` of pixel ``pixel_idx[i]`` ([N] int32) under
    ``seed``, or from the injected ``uniforms`` [max_depth * 4, N]; ``work``
    as in isect_full_plain. Returns (radiance [N,3] f32, rays traced)."""
    check_stepped_args(o, d, pixel_idx, sample_idx, max_depth, steps_per_call,
                       uniforms)
    draw = stepped_draw(seed, pixel_idx, sample_idx, uniforms)

    def isect(o_, d_, prev, alive):
        return isect_full_plain(ks, o_, d_, prev, alive, work)

    def run_call(state, counts, depth0, steps):
        stepped_call_plain(isect, draw, state, counts, depth0=depth0,
                           n_steps=steps, max_depth=max_depth,
                           rr_start_depth=rr_start_depth)

    return stepped_trace(run_call, o, d, max_depth, steps_per_call)


@functools.lru_cache(maxsize=2)
def stepped_library(fmad: bool = True):
    """``csrc/trace_stepped.cu`` (K5 and K6) built and bound; ``fmad=False``
    builds it without FMA contraction."""
    built = load_kernel(CSRC_STEPPED, fmad)
    tail = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pixel, sample, n
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int,  # seed, depth0, n_steps
        ctypes.c_int, ctypes.c_int,  # max_depth, rr_start_depth
        ctypes.c_void_p,  # uniforms [max_depth * 4, n] or NULL
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # state, counts, stream
    ]
    fn = built.lib.pt_trace_stepped_static
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,  # prims, n_prims
                   ctypes.c_void_p, ctypes.c_int] + tail  # gates, n_gates
    scene = [
        ctypes.c_void_p, ctypes.c_int,  # sph, S
        ctypes.c_void_p, ctypes.c_int,  # bnd, M
        ctypes.c_void_p, ctypes.c_int,  # tri, T
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # tiles, C, tile_base
    ]
    fn = built.lib.pt_trace_stepped_prim
    fn.restype = ctypes.c_int
    fn.argtypes = scene + tail
    fn = built.lib.pt_trace_resolve
    fn.restype = ctypes.c_int
    fn.argtypes = scene + [
        ctypes.c_void_p, ctypes.c_void_p,  # in, out [RESOLVE_ROWS, n]
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pixel, sample, n
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int,  # seed, depth, rr start
        ctypes.c_void_p, ctypes.c_void_p,  # uniforms [4, n] or NULL, stream
    ]
    return built


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def _check_on(name: str, dev, floats, ints=()):
    for t in floats:
        if t.device != dev or t.dtype != F32 or not t.is_contiguous():
            raise ValueError(f"{name}: scene, rays and uniforms must be "
                             f"contiguous float32 tensors on {dev}")
    for t in ints:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: pixel_idx and sample_idx must be "
                             f"contiguous tensors on {dev}")


def _scene_args(ks: KernelScene):
    return (ks.sph.data_ptr(), ks.sph.shape[0], _ptr(ks.bnd), ks.bnd.shape[0],
            ks.tri.data_ptr(), ks.tri.shape[0], _ptr(ks.tiles),
            ks.tiles.shape[0], ks.tile_base)


def stepped_launcher(name: str, entry: str, scene_args, *, seed, max_depth,
                     rr_start_depth, fmad, counter):
    """launch(state, counts, depth0, steps, pixel_idx, sample_idx, uniforms):
    one launch of K5's or K6's ``entry`` over the state [STATE_ROWS, N] on
    the state's device (one call of ``stepped_call_plain``); each adds one
    to ``counter.launches``."""
    built = stepped_library(fmad)
    fn = getattr(built.lib, entry)

    def launch(state, counts, depth0, steps, pixel_idx, sample_idx, uniforms):
        dev = state.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(*scene_args, pixel_idx.data_ptr(), sample_idx.data_ptr(),
                      state.shape[1], int(seed) & rng.MASK32, depth0, steps,
                      max_depth, rr_start_depth, _ptr(uniforms),
                      state.data_ptr(), counts.data_ptr(), stream)
        check_launch(built, code, name)
        counter.launches += 1

    return launch


def launch_stepped(name: str, entry: str, scene_args, tables, o, d, *, seed,
                   pixel_idx, sample_idx, max_depth, rr_start_depth,
                   steps_per_call, uniforms, fmad, counter):
    """K5's or K6's call loop on the card: checks, then one launch of
    ``entry`` per call over the state (``stepped_trace``); each launch adds
    one to ``counter.launches``."""
    dev = o.device
    _check_on(name, dev, [*tables, o, d] + (
        [uniforms] if uniforms is not None else []), (pixel_idx, sample_idx))
    if o.shape[0] == 0:
        return (torch.empty((0, 3), dtype=F32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    launch = stepped_launcher(name, entry, scene_args, seed=seed,
                              max_depth=max_depth,
                              rr_start_depth=rr_start_depth, fmad=fmad,
                              counter=counter)

    def run_call(state, counts, depth0, steps):
        launch(state, counts, depth0, steps, pixel_idx, sample_idx, uniforms)

    return stepped_trace(run_call, o, d, max_depth, steps_per_call)


def trace_stepped(ks: KernelScene, o, d, *, seed: int, pixel_idx, sample_idx,
                  max_depth: int = 12, rr_start_depth: int = 5,
                  steps_per_call: int = 12, uniforms=None, fmad: bool = True):
    """K6 (see trace_stepped_plain for the contract). CPU tensors run the
    plain version; CUDA tensors launch ``pt_trace_stepped_prim`` of
    ``csrc/trace_stepped.cu`` once per call, or raise. ``fmad=False`` builds
    the kernel without FMA contraction."""
    dev = o.device
    kw = dict(seed=seed, pixel_idx=pixel_idx, sample_idx=sample_idx,
              max_depth=max_depth, rr_start_depth=rr_start_depth,
              steps_per_call=steps_per_call, uniforms=uniforms)
    if dev.type == "cpu":
        return trace_stepped_plain(ks, o, d, **kw)
    if dev.type != "cuda":
        raise ValueError(f"trace_stepped runs on cpu or cuda, not {dev}")
    check_stepped_args(o, d, pixel_idx, sample_idx, max_depth, steps_per_call,
                       uniforms)
    return launch_stepped(
        "trace_stepped (K6)", "pt_trace_stepped_prim", _scene_args(ks),
        (ks.sph, ks.bnd, ks.tri, ks.tiles), o, d, fmad=fmad,
        counter=trace_stepped, **kw)


trace_stepped.launches = 0


# ---------------------------------------------------------------------------
# K7: one full-scene bounce at each ray's own depth (the portal resolve)
# ---------------------------------------------------------------------------

# K7's rows after the state rows: the depth (bounces completed) and, on
# output, the count (1.0 where the ray was alive on entry)
ROW_DEPTH, ROW_COUNT = 14, 15
RESOLVE_ROWS = 16


def path_uniforms(seed, pixel_idx, sample_idx, depth, slots):
    """The counter generator's uniforms of each path's segment ``depth``
    (a per-lane tensor) in the given slots, keyed by (seed, pixel, sample)."""
    key = rng.path_key(seed, pixel_idx.to(torch.int64), sample_idx.to(torch.int64))
    dep = depth.to(torch.int64)
    return [rng.uniform(key, dep, s) for s in slots]


def _check_resolve_args(state, pixel_idx, sample_idx, max_depth, uniforms):
    rows = (("o", 3), ("d", 3), ("thr", 3), ("acc", 3), ("alive", 1),
            ("prev", 1), ("depth", 1))
    n = state[0].shape[-1]
    for (name, k), t in zip(rows, state):
        if t.shape != (k, n) or t.dtype != F32:
            raise ValueError(f"{name} must be [{k}, {n}] float32")
    for name, t in (("pixel_idx", pixel_idx), ("sample_idx", sample_idx)):
        if t.shape != (n,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a [{n}] int32 tensor")
    if max_depth < 1:
        raise ValueError(f"need max_depth >= 1, got {max_depth}")
    if uniforms is not None and (uniforms.shape != (4, n) or uniforms.dtype != F32):
        raise ValueError(f"uniforms must be [4, {n}] float32")


def trace_resolve_plain(ks: KernelScene, o, d, thr, acc, alive, prev, depth, *,
                        pixel_idx, sample_idx, seed: int, max_depth: int = 12,
                        rr_start_depth: int = 5, uniforms=None, work=None):
    """Plain torch version of K7, the JAX package's ``trace_pallas_resolve``:
    one full-scene bounce of rays whose depths differ. o, d, thr, acc [3, n];
    alive, prev, depth [1, n] (depth = bounces completed); ray i draws as
    sample ``sample_idx[i]`` of pixel ``pixel_idx[i]`` ([n] int32) at its
    own depth, or from ``uniforms`` [4, n]; ``work`` as in isect_full_plain.

    Per ray (``trace_kernel.py:1040-1053`` of the JAX package): shading at
    new depth = depth + 1; o and d move only if the path lives on; thr is
    zeroed on death; prev := the hit triangle (-1 for a sphere or a miss);
    depth += alive; alive := lives on. A dead ray is cleaned as a dead lane
    of a live JAX block is (thr 0, prev -1). Returns the seven arrays in
    the same shapes and counts [1, n] (the alive row on entry)."""
    _check_resolve_args((o, d, thr, acc, alive, prev, depth), pixel_idx,
                        sample_idx, max_depth, uniforms)
    alive_f, dep = alive[0], depth[0]
    dl = [d[k] for k in range(3)]
    found, point, nrm, color, emis, rtype, new_prev = isect_full_plain(
        ks, [o[k] for k in range(3)], dl, prev[0], alive_f > 0.0, work)
    u4 = ([uniforms[k] for k in range(4)] if uniforms is not None else
          path_uniforms(seed, pixel_idx, sample_idx, dep, range(4)))
    acc_n, thr_new, d_new, alive_new = shade_phase(
        dl, nrm, color, emis, rtype, found, [thr[k] for k in range(3)],
        [acc[k] for k in range(3)], u4, dep + 1.0, max_depth, rr_start_depth)
    am = alive_new.to(F32)
    return (torch.stack([torch.where(alive_new, point[k], o[k]) for k in range(3)]),
            torch.stack([torch.where(alive_new, d_new[k], d[k]) for k in range(3)]),
            torch.stack([thr_new[k] * am for k in range(3)]),
            torch.stack(acc_n), am[None], new_prev[None], (dep + alive_f)[None],
            alive_f[None].clone())


def trace_resolve(ks: KernelScene, o, d, thr, acc, alive, prev, depth, *,
                  pixel_idx, sample_idx, seed: int, max_depth: int = 12,
                  rr_start_depth: int = 5, uniforms=None, fmad: bool = True):
    """K7 (see trace_resolve_plain for the contract). CPU tensors run the
    plain version; CUDA tensors launch ``pt_trace_resolve`` of
    ``csrc/trace_stepped.cu`` once, or raise. The rays are copied into one
    [RESOLVE_ROWS, n] buffer the kernel reads once and writes once; the
    results are views of the output. ``fmad=False`` builds the kernel
    without FMA contraction."""
    state = (o, d, thr, acc, alive, prev, depth)
    kw = dict(pixel_idx=pixel_idx, sample_idx=sample_idx, seed=seed,
              max_depth=max_depth, rr_start_depth=rr_start_depth,
              uniforms=uniforms)
    dev = o.device
    if dev.type == "cpu":
        return trace_resolve_plain(ks, *state, **kw)
    if dev.type != "cuda":
        raise ValueError(f"trace_resolve runs on cpu or cuda, not {dev}")
    _check_resolve_args(state, pixel_idx, sample_idx, max_depth, uniforms)
    n = o.shape[1]
    buf = torch.empty((RESOLVE_ROWS, n), dtype=F32, device=dev)
    torch.cat(state, out=buf[:ROW_COUNT])
    out = torch.empty_like(buf)
    name = "trace_resolve (K7)"
    _check_on(name, dev, [ks.sph, ks.bnd, ks.tri, ks.tiles] + (
        [uniforms] if uniforms is not None else []), (pixel_idx, sample_idx))
    if n:
        built = stepped_library(fmad)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = built.lib.pt_trace_resolve(
                *_scene_args(ks), buf.data_ptr(), out.data_ptr(),
                pixel_idx.data_ptr(), sample_idx.data_ptr(), n,
                int(seed) & rng.MASK32, int(max_depth), int(rr_start_depth),
                _ptr(uniforms), stream)
        check_launch(built, code, name)
        trace_resolve.launches += 1
    return (out[ROW_O:ROW_O + 3], out[ROW_D:ROW_D + 3], out[ROW_THR:ROW_THR + 3],
            out[ROW_ACC:ROW_ACC + 3], out[ROW_ALIVE:ROW_ALIVE + 1],
            out[ROW_PREV:ROW_PREV + 1], out[ROW_DEPTH:ROW_DEPTH + 1],
            out[ROW_COUNT:ROW_COUNT + 1])


trace_resolve.launches = 0


# ---------------------------------------------------------------------------
# K9: K6's stepped trace with the wavefront sorted between calls
# ---------------------------------------------------------------------------

_DEAD_KEY = 1 << 30  # dead rays sort last


def _spread6(v):
    """Interleave the low 6 bits of v (int64 tensor) into every 3rd bit: the
    JAX uint32 Morton spread, in int64 with the same masks (every product
    stays below 2^32)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0x30C30C3
    return (v * 0x00000005) & 0x9249249


def ray_sort_keys(o, d, alive, lo, inv_span, dir_major: bool = False):
    """int32 sort key per ray, the JAX package's ``ray_sort_keys``: the
    18-bit Morton cell of the origin (64³ grid over the scene box lo,
    inv_span, 3-tuples of floats) and the 3-bit direction octant; dead rays
    get _DEAD_KEY. o, d [3, n]; alive [1, n]. dir_major puts the octant in
    the high bits."""
    q = [torch.clamp((o[k] - lo[k]) * inv_span[k] * 64.0, 0.0, 63.0).to(torch.int64)
         for k in range(3)]
    morton = (_spread6(q[0]) << 2) | (_spread6(q[1]) << 1) | _spread6(q[2])
    octant = ((d[0] < 0.0).to(torch.int64) * 4 + (d[1] < 0.0).to(torch.int64) * 2
              + (d[2] < 0.0).to(torch.int64))
    key = (octant << 18) | morton if dir_major else (morton << 3) | octant
    return torch.where(alive[0] > 0.0, key, _DEAD_KEY).to(torch.int32)


def sorted_trace(run_call, ks: KernelScene, o, d, pixel_idx, sample_idx,
                 uniforms, max_depth, sort_every, dir_major):
    """K9's call loop around ``stepped_trace``'s state: before every call but
    the first, argsort the rays by ray_sort_keys (stable, as jnp.argsort)
    and permute the state columns, pixel_idx, sample_idx, the ray ids and
    the uniform columns. run_call(state, counts, depth0, steps, pixel_idx,
    sample_idx, uniforms) runs one call. Returns (radiance [N,3] in the
    caller's order, rays traced)."""
    ids = torch.arange(o.shape[0], device=o.device)

    def call(state, counts, depth0, steps):
        nonlocal ids, pixel_idx, sample_idx, uniforms
        if depth0:
            perm = torch.argsort(ray_sort_keys(
                state[ROW_O:ROW_O + 3], state[ROW_D:ROW_D + 3],
                state[ROW_ALIVE:ROW_ALIVE + 1], ks.aabb_lo, ks.aabb_inv_span,
                dir_major), stable=True)
            state.copy_(state[:, perm])
            ids, pixel_idx = ids[perm], pixel_idx[perm]
            sample_idx = sample_idx[perm]
            if uniforms is not None:
                uniforms = uniforms[:, perm]
        run_call(state, counts, depth0, steps, pixel_idx, sample_idx, uniforms)

    acc, total = stepped_trace(call, o, d, max_depth, sort_every)
    rad = torch.empty_like(acc)
    rad[ids] = acc
    return rad, total


def trace_sorted_plain(ks: KernelScene, o, d, *, seed: int, pixel_idx,
                       sample_idx, max_depth: int = 12, rr_start_depth: int = 5,
                       sort_every: int = 1, dir_major: bool = False,
                       uniforms=None, work=None):
    """Plain torch version of K9, the JAX package's ``trace_pallas_sorted``:
    K6's trace (``trace_stepped_plain``) in calls of ``sort_every`` steps
    with the wavefront sorted between calls (``sorted_trace``). Draws are
    keyed by ray (or the injected rows ride the permutation), so the
    radiance equals K6's ray for ray. Returns (radiance [N,3] in the
    caller's order, rays traced)."""
    check_stepped_args(o, d, pixel_idx, sample_idx, max_depth, sort_every,
                       uniforms)

    def isect(o_, d_, prev, alive):
        return isect_full_plain(ks, o_, d_, prev, alive, work)

    def run_call(state, counts, depth0, steps, pix, smp, uni):
        stepped_call_plain(isect, stepped_draw(seed, pix, smp, uni), state,
                           counts, depth0=depth0, n_steps=steps,
                           max_depth=max_depth, rr_start_depth=rr_start_depth)

    return sorted_trace(run_call, ks, o, d, pixel_idx, sample_idx, uniforms,
                        max_depth, sort_every, dir_major)


def trace_sorted(ks: KernelScene, o, d, *, seed: int, pixel_idx, sample_idx,
                 max_depth: int = 12, rr_start_depth: int = 5,
                 sort_every: int = 1, dir_major: bool = False, uniforms=None,
                 fmad: bool = True):
    """K9 (see trace_sorted_plain for the contract). CPU tensors run the
    plain version; CUDA tensors launch K6's ``pt_trace_stepped_prim`` once
    per call, counted on ``trace_sorted.launches``, with the sort in torch
    between calls (as XLA composes it around the JAX kernel), or raise."""
    dev = o.device
    kw = dict(seed=seed, pixel_idx=pixel_idx, sample_idx=sample_idx,
              max_depth=max_depth, rr_start_depth=rr_start_depth,
              sort_every=sort_every, dir_major=dir_major, uniforms=uniforms)
    if dev.type == "cpu":
        return trace_sorted_plain(ks, o, d, **kw)
    if dev.type != "cuda":
        raise ValueError(f"trace_sorted runs on cpu or cuda, not {dev}")
    check_stepped_args(o, d, pixel_idx, sample_idx, max_depth, sort_every,
                       uniforms)
    name = "trace_sorted (K9)"
    _check_on(name, dev, [ks.sph, ks.bnd, ks.tri, ks.tiles, o, d] + (
        [uniforms] if uniforms is not None else []), (pixel_idx, sample_idx))
    if o.shape[0] == 0:
        return (torch.empty((0, 3), dtype=F32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    launch = stepped_launcher(name, "pt_trace_stepped_prim", _scene_args(ks),
                              seed=seed, max_depth=max_depth,
                              rr_start_depth=rr_start_depth, fmad=fmad,
                              counter=trace_sorted)
    return sorted_trace(launch, ks, o, d, pixel_idx, sample_idx, uniforms,
                        max_depth, sort_every, dir_major)


trace_sorted.launches = 0
