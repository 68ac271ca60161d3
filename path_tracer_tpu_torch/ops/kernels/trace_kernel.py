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
  that K3 and K4 share, ``csrc/isect_full.cuh`` on the card, and
  ``tile_entry_keys``, K3's sort key (its slab test without the cull);
- K4 ``trace_regen_prim`` (``csrc/trace_regen_prim.cu``) and its plain
  version ``trace_regen_prim_plain``: the regenerative loop over the
  full scene, the JAX package's ``pallasr:`` route; ``regen_prim_config``
  (its launch configuration) and ``K4_SHARED_BUDGET``, the size rule that
  stages a scene's tables in shared memory;
- K6 ``trace_stepped`` (``csrc/trace_stepped.cu``) and its plain version
  ``trace_stepped_plain``: the stepped trace of given rays over the full
  scene (the JAX ``trace_pallas``), with the state, call loop and draws it
  shares with K5 (``trace_v2.trace_stepped``); ``trace_camera`` and
  ``trace_camera_plain``: its camera entry, which makes the preview's
  camera rays in the kernel; ``K6_SHARED_BUDGET``, the size rule that
  stages a scene's tables in shared memory;
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
from path_tracer_tpu_torch.native import native_morton3d
from path_tracer_tpu_torch.ops import rng
from path_tracer_tpu_torch.ops.intersect import triangle_coeffs_np
from path_tracer_tpu_torch.ops.kernels.build import check_launch, load_kernel
from path_tracer_tpu_torch.render.raygen import (
    camera_rays, preview_cam_params, tent_filter,
)
from path_tracer_tpu_torch.utils import profiling

F32 = torch.float32

_PI = np.float32(np.pi)
_TWO_PI = float(np.float32(2.0) * _PI)
_R0 = np.float32((1.5 - 1.0) ** 2 / (1.5 + 1.0) ** 2)
_ONE_MINUS_R0 = float(np.float32(1.0) - _R0)
_INV_IOR = float(np.float32(1.0 / 1.5))


def _eq3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact equality of the 3-vectors on the last axis (broadcast)."""
    return ((a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])
            & (a[..., 2] == b[..., 2]))


def quad_pair_arrays(packed: ScenePacked) -> tuple[np.ndarray, np.ndarray]:
    """``detect_quad_pairs`` as arrays: the pairs' first packed indices,
    ascending [Q] int64, and their rotated vertices [Q, 3, 3] float32.

    Vertices compare by exact float32 equality (``-0.0 == 0.0``, a NaN
    equals nothing), as the loop's tuple sets compare them. A pair (i, i+1)
    is a candidate when it shares mesh, color, emission and reflect type,
    exactly one vertex of A is not among B's (the corner p0, followed by p1
    and p2 in A's cyclic order), exactly one vertex of B is neither p1 nor
    p2, and that vertex equals p1 + p2 - p0 in float32. The loop takes
    candidates greedily from the left, each consuming its partner: within a
    run of consecutive candidates starting at s, those at an even distance
    from s."""
    nt = packed.num_triangles
    if nt < 2:
        return np.zeros(0, np.int64), np.zeros((0, 3, 3), np.float32)
    tv = np.asarray(packed.tri_v[:nt], np.float32)
    color = np.asarray(packed.tri_color[:nt])
    emis = np.asarray(packed.tri_emis[:nt])
    rtype = np.asarray(packed.tri_rtype[:nt])
    mesh = np.asarray(packed.tri_mesh[:nt])
    A, B = tv[:-1], tv[1:]
    cand = ((mesh[:-1] == mesh[1:]) & (rtype[:-1] == rtype[1:])
            & _eq3(color[:-1], color[1:]) & _eq3(emis[:-1], emis[1:]))
    # same[p, k, l]: vertex k of A equals vertex l of B
    same = _eq3(A[:, :, None], B[:, None])
    uniq_a = ~same.any(2)
    cand &= uniq_a.sum(1) == 1
    k = uniq_a.argmax(1)
    rows = np.arange(nt - 1)
    rot = A[rows[:, None], (k[:, None] + np.arange(3)) % 3]  # p0, p1, p2
    p0, p1, p2 = rot[:, 0], rot[:, 1], rot[:, 2]
    uniq_b = ~(_eq3(B, p1[:, None]) | _eq3(B, p2[:, None]))
    cand &= uniq_b.sum(1) == 1
    q = p1 + p2 - p0  # f32 arithmetic, exact-match required
    cand &= _eq3(B[rows, uniq_b.argmax(1)], q)
    # greedy pairing: the distance of each candidate from its run's start
    idx = np.flatnonzero(cand)
    starts = np.ones(len(idx), bool)
    starts[1:] = idx[1:] != idx[:-1] + 1
    run_start = idx[starts][np.cumsum(starts) - 1]
    first = idx[(idx - run_start) % 2 == 0]
    return first, np.ascontiguousarray(rot[first])


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
    rotated [3,3] vertices; covered is the set of consumed indices
    (``quad_pair_arrays`` finds them)."""
    first, verts = quad_pair_arrays(packed)
    keys = first.tolist()
    quads = dict(zip(keys, verts))
    covered = set(keys) | {i + 1 for i in keys}
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
# tiles a run of K4's group level (KernelScene.tile_groups): a warp's width,
# one slab test a lane (csrc/isect_full.cuh TILE_GROUP)
TILE_GROUP = 32
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
# The compact hit-test rows (KernelScene.hit [T, HIT_F]) that K3 stages into
# shared memory: the 19 columns of a TRI_F row that the distance test reads
# (n, e1, e2, e2×a, a×e1, a·n, then quad flag, packed id, gate) and a zero
# pad to 80 bytes; csrc/isect_full.cuh H_* mirrors it
HIT_COLS = tuple(range(T_N, T_NA + 1)) + (T_QUAD, T_PID, T_GATE)
HIT_F = 20

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


def _morton3d(norm: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in [0, 1)^3 (10 bits an axis): the
    native runtime's ``pt_morton3d`` where it builds, else numpy."""
    codes = native_morton3d(norm)
    if codes is not None:
        return codes
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

    first, quad_v = quad_pair_arrays(sc)
    keep_mask = np.ones(sc.num_triangles, bool)
    keep_mask[first + 1] = False  # a pair's second triangle is consumed
    keep = np.flatnonzero(keep_mask)
    quad_rows = np.searchsorted(keep, first)
    nt = len(keep)
    T = max(((nt + 7) // 8) * 8, 8)

    def collapse(src, fill):
        a = np.asarray(src, np.float32)
        out = np.full((T,) + a.shape[1:], fill, np.float32)
        out[:nt] = a[keep]
        return out

    tri_v = collapse(sc.tri_v, 1e30)
    tri_v[quad_rows] = quad_v
    tri_normal = collapse(sc.tri_normal, 0.0)
    tri_color = collapse(sc.tri_color, 0.0)
    tri_emis = collapse(sc.tri_emis, 0.0)
    tri_rtype = collapse(sc.tri_rtype, 0.0)
    tri_order = collapse(np.minimum(np.asarray(sc.tri_order), 2**24), 1.0e9)
    tri_quad = np.zeros(T, np.float32)
    tri_quad[quad_rows] = 1.0
    tri_pid = np.full(T, -2.0, np.float32)
    tri_pid[:nt] = keep
    tri_mesh_c = np.asarray(sc.tri_mesh)[keep]

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

        # each tile's box over its real rows (padding rows sit at 1e30);
        # slop keeps the cull conservative under float32 rounding
        verts = tri_v[base_pad:].reshape(C, TRI_TILE, 3, 3)
        real = verts[:, :, 0, 0] < 1e29
        inside = real[:, :, None, None]
        v_lo = np.where(inside, verts, np.inf).min(axis=(1, 2))
        v_hi = np.where(inside, verts, -np.inf).max(axis=(1, 2))
        v_abs = np.where(inside, np.abs(verts), 0.0).max(axis=(1, 2, 3))
        slop = np.maximum(v_hi - v_lo, v_abs[:, None]) * 1e-5 + 1e-6
        filled = real.any(axis=1)
        tile_lo = np.full((C, 3), 1e30, np.float32)
        tile_hi = np.full((C, 3), -1e30, np.float32)
        tile_lo[filled] = (v_lo - slop)[filled]
        tile_hi[filled] = (v_hi + slop)[filled]
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
        gate[tri_mesh_c, np.arange(nt)] = 1.0
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
      K9's sort keys grid;
    - ``hit`` [T, HIT_F]: ``tri``'s HIT_COLS and a zero pad, the compact
      rows K3 reads its distance tests from (built from ``tri`` when not
      given); ``hit_tiles`` [C, HIT_F, TRI_TILE] the tiles' rows of it
      field by field, and ``tile_groups`` [ceil(C / TILE_GROUP), 6] the
      boxes K4 tests above the tiles, both made on first use on the
      scene's device.
    """

    sph: torch.Tensor
    bnd: torch.Tensor
    tri: torch.Tensor
    tiles: torch.Tensor
    tile_base: int
    aabb_lo: tuple = (0.0, 0.0, 0.0)
    aabb_inv_span: tuple = (1.0, 1.0, 1.0)
    hit: torch.Tensor | None = None

    def __post_init__(self):
        if self.hit is None:
            hit = torch.zeros((self.tri.shape[0], HIT_F), dtype=F32,
                              device=self.tri.device)
            hit[:, :len(HIT_COLS)] = self.tri[:, list(HIT_COLS)]
            object.__setattr__(self, "hit", hit)

    @functools.cached_property
    def sph_rows(self) -> int:
        """The sphere rows up to the last with r² > 0, at least one: the
        rows after it are padding (r² 0), which misses every ray, so a scan
        of these rows finds what a scan of all finds."""
        real = torch.nonzero(self.sph[:, S_RAD2] > 0.0)
        return int(real.max()) + 1 if real.numel() else 1

    @functools.cached_property
    def hit_tiles(self) -> torch.Tensor:
        """The tiles' compact rows field by field, [C, HIT_F, TRI_TILE]:
        field f of row ``tile_base + c*TRI_TILE + j`` at [c, f, j], so that
        lanes reading one field of consecutive rows read consecutive floats:
        K3's group split and K4's warp queries where the rows are read from
        device memory (csrc/isect_full.cuh ``tile_group_rows``)."""
        c = self.tiles.shape[0]
        rows = self.hit[self.tile_base:self.tile_base + c * TRI_TILE]
        return rows.reshape(c, TRI_TILE, HIT_F).transpose(1, 2).contiguous()

    @functools.cached_property
    def tile_groups(self) -> torch.Tensor:
        """One box a run of TILE_GROUP consecutive tiles (the level K4
        tests above the tiles): ``tile_group_boxes(tiles)``."""
        return tile_group_boxes(self.tiles)

    @property
    def nbytes(self) -> int:
        """The bytes of its tables, which ``to`` copies (not ``hit_tiles``
        or ``tile_groups``, made on the device)."""
        return sum(t.nbytes for t in (self.sph, self.bnd, self.tri, self.tiles,
                                      self.hit))

    def to(self, device) -> "KernelScene":
        return KernelScene(self.sph.to(device), self.bnd.to(device),
                           self.tri.to(device), self.tiles.to(device),
                           self.tile_base, self.aabb_lo, self.aabb_inv_span,
                           self.hit.to(device))


def tile_group_boxes(tiles: torch.Tensor) -> torch.Tensor:
    """One box for each run of TILE_GROUP consecutive tiles of ``tiles``
    [C, 6] (lo, hi), the last run holding the rest: [ceil(C / TILE_GROUP),
    6], the elementwise min of the run's lo corners and max of its hi
    corners. Float32 min and max are exact, so a box is the least that
    holds its run's boxes: a line that enters a tile enters its run's box,
    and no later (``(box - o) * inv`` is monotone under rounding)."""
    c = tiles.shape[0]
    g = -(-c // TILE_GROUP)
    pad = g * TILE_GROUP - c
    lo = torch.cat([tiles[:, :3], tiles.new_full((pad, 3), float("inf"))])
    hi = torch.cat([tiles[:, 3:], tiles.new_full((pad, 3), float("-inf"))])
    return torch.cat([lo.view(g, TILE_GROUP, 3).amin(dim=1),
                      hi.view(g, TILE_GROUP, 3).amax(dim=1)], dim=1).contiguous()


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
    hit = np.zeros((T, HIT_F), np.float32)
    hit[:, :len(HIT_COLS)] = tri[:, HIT_COLS]
    return KernelScene(torch.from_numpy(sph), torch.from_numpy(bnd),
                       torch.from_numpy(tri), torch.from_numpy(tiles),
                       int(tile_base), **box, hit=torch.from_numpy(hit))


@profiling.spanned("render.prepare.kscene")
def build_kernel_scene(packed: ScenePacked) -> KernelScene:
    """ScenePacked → KernelScene on the CPU: the column tables
    (``kernel_scene_buffers``, span ``render.prepare.kscene.rows``), then
    the rows (``kernel_scene_from_jax``, span
    ``render.prepare.kscene.table``)."""
    with profiling.span("render.prepare.kscene.rows"):
        bufs = kernel_scene_buffers(packed)
    with profiling.span("render.prepare.kscene.table"):
        return kernel_scene_from_jax(bufs)


def _sphere_t(cen, rad2, o, d):
    """The sphere test of the reference renderer (smallpt's, ``op = c - o``
    first): cen, rad2 [P] (or per-lane [N]) against rays 3×[N, 1] → t [N,
    P] (BIG = miss). The JAX intersector expands |c - o|² into
    |c|² - 2 c·o + |o|², which cancels: a radius-0.2 sphere 13 units from
    the origin then misjudges a ray leaving its own surface by more than
    the 1e-4 root cutoff."""
    op = [cen[k] - o[k] for k in range(3)]
    b = op[0] * d[0] + op[1] * d[1] + op[2] * d[2]
    det = b * b - (op[0] * op[0] + op[1] * op[1] + op[2] * op[2]) + rad2
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    t_near = b - sq
    t_far = b + sq
    t = torch.where(t_near >= EPS_SPHERE, t_near,
                    torch.where(t_far >= EPS_SPHERE, t_far, BIG))
    # r² == 0 marks padding, whose far-away center overflows |op|²
    return torch.where((det < 0.0) | (rad2 <= 0.0), BIG, t)


def _inv_dir(d):
    return [1.0 / torch.where(torch.abs(d[k]) < 1e-30, 1e-30, d[k])
            for k in range(3)]


def _tile_slab(box, o, inv):
    """The slab test of one tile AABB ``box`` [6] (lo, hi): (entry distance
    t_en [N], whether the ray's line enters the box ahead of it [N]). Boxes
    [6, 1, B] against rays [N, 1] test every pair: [N, B] each."""
    t_en = t_ex = None
    for k in range(3):
        ta = (box[k] - o[k]) * inv[k]
        tb = (box[3 + k] - o[k]) * inv[k]
        if t_en is None:
            t_en, t_ex = torch.zeros_like(ta), torch.full_like(ta, BIG)
        t_en = torch.maximum(t_en, torch.minimum(ta, tb))
        t_ex = torch.minimum(t_ex, torch.maximum(ta, tb))
    return t_en, (t_ex >= t_en) & (t_ex >= 0.0)


# lanes x tiles in one block of isect_full_plain's slab tests
SLAB_BLOCK = 1 << 20

# tiles a tile-entry key holds (csrc/isect_full.cuh): 31, so that every
# key sorts below SORT_PAD, the key that pads K3's and K6's chunk sorts
KEY_TILES = 31
SORT_PAD = 0xFFFFFFFF


def tile_entry_keys(ks: KernelScene, o, d) -> torch.Tensor:
    """K3's sort key of each ray: bit c set where the ray enters tile c's
    AABB (``isect_full_plain``'s slab test without the distance cull), for
    the first KEY_TILES tiles. o, d: 3 lists of [N] f32 → [N] int64 (0
    without tiles). Known before any triangle is tested."""
    key = torch.zeros(o[0].shape[0], dtype=torch.int64, device=o[0].device)
    inv = _inv_dir(d)
    for c in range(min(ks.tiles.shape[0], KEY_TILES)):
        key |= _tile_slab(ks.tiles[c], o, inv)[1].to(torch.int64) << c
    return key


def isect_full_plain(ks: KernelScene, o, d, prev, alive, work=None,
                     tiles_out=None):
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
    "sph" sphere and bounding-sphere tests (every row a live lane, K4's
    fourth counter), "tri" triangle rows, "slab" tile AABB tests, and
    K4's other three: "query" the live lanes whose line enters a tile
    (its warp queries), "tiles" the tiles whose rows they test and
    "groups" the runs of TILE_GROUP tiles whose slabs they test: a query
    tests a run's tiles where its line enters the run's box
    (``tile_groups``) closer than its bound at the run's first tile.
    ``tiles_out`` (a list, optional) receives each tile's [N] bool mask of
    the lanes that test its rows.

    The slab tests run a block of tiles at once; a tile that no lane enters
    closer than its bound at the block's start is skipped, since the bound
    only falls. Each other tile is culled in order, as above.
    """
    n = o[0].shape[0]
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
        inv = _inv_dir(d)
        oc_, ic_ = [x[:, None] for x in o], [x[:, None] for x in inv]
        step = max(1, min(n_tiles, SLAB_BLOCK // max(n, 1)))
        queries = torch.zeros(n, dtype=torch.bool, device=alive.device)
        opened = []  # each run's lanes that enter its box closer than their bound
        for c0 in range(0, n_tiles, step):
            boxes = ks.tiles[c0:c0 + step].T[:, None, :]  # [6, 1, B]
            t_en, enters = _tile_slab(boxes, oc_, ic_)  # [N, B]
            enters = enters & alive[:, None]
            queries |= enters.any(dim=1)
            hot = (enters & (t_en < torch.minimum(d_t, d_s)[:, None])).any(dim=0).tolist()
            for j in range(enters.shape[1]):
                if work is not None and (c0 + j) % TILE_GROUP == 0:
                    box = ks.tile_groups[(c0 + j) // TILE_GROUP]
                    t_g, in_g = _tile_slab(box, o, inv)
                    opened.append(in_g & alive & (t_g < torch.minimum(d_t, d_s)))
                if not hot[j]:
                    if tiles_out is not None:
                        tiles_out.append(torch.zeros_like(alive))
                    continue
                cand = enters[:, j] & (t_en[:, j] < torch.minimum(d_t, d_s))
                if tiles_out is not None:
                    tiles_out.append(cand)
                if work is not None:
                    tested = int(cand.sum())
                    work["tri"] += tested * TRI_TILE
                    work["tiles"] = work.get("tiles", 0) + tested
                lo = ks.tile_base + (c0 + j) * TRI_TILE
                res_t, res_r = tri_block(lo, lo + TRI_TILE)
                better = cand & (res_t < d_t)
                d_t = torch.where(better, res_t, d_t)
                r_t = torch.where(better, res_r, r_t)
        if work is not None:
            work["query"] = work.get("query", 0) + int(queries.sum())
            work["groups"] = work.get("groups", 0) + int(
                (torch.stack(opened) & queries).sum())

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
def prim_library(fmad: bool = True):
    """``csrc/trace_regen_prim.cu`` (K4) built and bound; ``fmad=False``
    builds it without FMA contraction."""
    built = load_kernel(CSRC_REGEN_PRIM, fmad)
    fn = built.lib.pt_trace_regen_prim
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # sph, S
        ctypes.c_void_p, ctypes.c_int,  # bnd, M
        ctypes.c_void_p, ctypes.c_int,  # tri, T
        ctypes.c_void_p,  # hit [T, HIT_F] or NULL
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # tiles, C, tile_base
        ctypes.c_void_p,  # tile_groups [ceil(C / TILE_GROUP), 6]
        ctypes.c_void_p,  # hit_tiles [C, HIT_F, TRI_TILE] or NULL
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # camera (host), W, H
        ctypes.c_void_p, ctypes.c_int,  # pixel_idx, n
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int,  # seed, base, quota
        ctypes.c_int, ctypes.c_int,  # max_depth, rr_start_depth
        ctypes.c_void_p,  # uniforms [6, n] or NULL
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rad, segs, done
        ctypes.c_void_p, ctypes.c_void_p,  # next (zeroed), work or NULL
        ctypes.c_void_p,  # stream
    ]
    fn = built.lib.pt_trace_regen_prim_config
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return built


# K4's counters (trace_regen_prim's ``work``, csrc/trace_regen_prim.cu
# work[0..3]) as the plain version's ``work`` keys
WORK_KEYS = ("query", "tiles", "groups", "sph")

# K4 stages a scene's tables in a block's shared memory when they take at
# most this many bytes: an H100 block may opt in to 227 KB (232,448 bytes),
# of which K4's queries take 34 KB at 1,024 threads; a larger scene reads
# its rows through the read-only path
K4_SHARED_BUDGET = 192 * 1024


def k4_shared_table(ks: KernelScene) -> bool:
    """Whether K4 scans ``ks`` from shared memory: its tables
    (``k6_table_bytes``, the same layout) fit K4_SHARED_BUDGET. Decided
    from the table's size before a launch."""
    return k6_table_bytes(ks) <= K4_SHARED_BUDGET


def k4_table(ks: KernelScene, device) -> str:
    """Where K4 reads the rows of ``ks`` from: ``"shared"`` (staged in a
    block's shared memory, ``k4_shared_table``) or ``"global"`` (the
    read-only path from device memory) on the card; ``"plain"`` off it,
    where the plain version runs."""
    if torch.device(device).type != "cuda":
        return "plain"
    return "shared" if k4_shared_table(ks) else "global"


def regen_prim_config(ks: KernelScene, *, fmad: bool = True) -> dict:
    """K4's launch configuration for ``ks`` on the current card: dynamic
    shared memory a block takes (bytes), resident blocks per SM, threads a
    block, SMs, registers and local (spill) bytes a thread, the shared
    memory a block may opt in to, the static shared memory a block takes,
    and whether the table is in shared memory."""
    built = prim_library(fmad)
    out = (ctypes.c_int * 8)()
    shared = k4_shared_table(ks)
    code = built.lib.pt_trace_regen_prim_config(
        ks.sph.shape[0], ks.bnd.shape[0], ks.tri.shape[0], ks.tiles.shape[0],
        int(shared), out)
    check_launch(built, code, "trace_regen_prim (K4) configuration")
    keys = ("smem_bytes", "blocks_per_sm", "threads", "sms", "registers",
            "local_bytes", "smem_optin", "static_smem_bytes")
    return dict(zip(keys, out), shared_table=shared)


def trace_regen_prim(ks: KernelScene, cam, pixel_idx: torch.Tensor, *,
                     seed: int, sample_base: int, quota: int,
                     max_depth: int = 12, rr_start_depth: int = 5,
                     uniforms: torch.Tensor | None = None, fmad: bool = True,
                     work=None):
    """K4 (see trace_regen_prim_plain for the contract). CPU tensors run the
    plain version; CUDA tensors launch ``csrc/trace_regen_prim.cu`` or
    raise. ``fmad=False`` builds the kernel without FMA contraction.

    ``work`` (optional, an int64 [4] tensor on ``pixel_idx``'s device) has
    K4's counters added to it: the warp queries (segments whose line enters
    a tile), the tiles whose rows they tested, the runs of tiles whose
    slabs they tested and the sphere and bounding-sphere rows the scans
    tested; on the card by the launch, without a sync, on the CPU from the
    plain version's ``work`` (``WORK_KEYS``)."""
    dev = pixel_idx.device
    if work is not None and (work.shape != (len(WORK_KEYS),)
                             or work.dtype != torch.int64 or work.device != dev):
        raise ValueError(f"work must be an int64 [{len(WORK_KEYS)}] tensor on {dev}")
    if dev.type == "cpu":
        counts = {}
        out = trace_regen_prim_plain(
            ks, cam, pixel_idx, seed=seed, sample_base=sample_base,
            quota=quota, max_depth=max_depth, rr_start_depth=rr_start_depth,
            uniforms=uniforms, work=counts)
        if work is not None:
            work += torch.tensor([counts.get(k, 0) for k in WORK_KEYS])
        return out
    if dev.type != "cuda":
        raise ValueError(f"trace_regen_prim runs on cpu or cuda, not {dev}")
    _check_regen_args(pixel_idx, quota, max_depth, uniforms, QUOTA_CAP_PRIM)
    # the read-only path's warp queries read their tiles' rows tile-major;
    # a scene staged in shared memory never builds them
    hit_tiles = (ks.hit_tiles if ks.tiles.shape[0] and not k4_shared_table(ks)
                 else None)
    _check_on("trace_regen_prim (K4)", dev,
              [ks.sph, ks.bnd, ks.tri, ks.tiles, ks.hit, ks.tile_groups]
              + [t for t in (hit_tiles, uniforms) if t is not None],
              (pixel_idx,))
    n = pixel_idx.shape[0]
    rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    segs = torch.empty(n, dtype=torch.int32, device=dev)
    done = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return rad, segs, done
    built = prim_library(fmad)
    params = cam.params.to(torch.float32).contiguous()  # host memory
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the refill counter
        code = built.lib.pt_trace_regen_prim(
            *_prim_scene_args(ks, K4_SHARED_BUDGET), _ptr(ks.tile_groups),
            _ptr(hit_tiles), params.data_ptr(), cam.width,
            cam.height, pixel_idx.data_ptr(), n,
            int(seed) & rng.MASK32, int(sample_base), int(quota),
            int(max_depth), int(rr_start_depth), _ptr(uniforms),
            rad.data_ptr(), segs.data_ptr(), done.data_ptr(), nxt.data_ptr(),
            _ptr(work), stream)
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


def _check_ray_args(n, pixel_idx, sample_idx, max_depth, steps_per_call,
                    uniforms):
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


def check_stepped_args(o, d, pixel_idx, sample_idx, max_depth, steps_per_call,
                       uniforms):
    """Argument checks shared by K5 and K6 and their plain versions."""
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or o.dtype != F32 or d.dtype != F32:
        raise ValueError("o and d must be [N, 3] float32")
    _check_ray_args(n, pixel_idx, sample_idx, max_depth, steps_per_call,
                    uniforms)


def check_camera_args(pixel_idx, sample_idx, width, height, max_depth,
                      steps_per_call, uniforms):
    """Argument checks of K5's and K6's camera entries."""
    if pixel_idx.dim() != 1:
        raise ValueError("pixel_idx must be a [N] int32 tensor")
    if width < 1 or height < 1:
        raise ValueError(f"need an image of at least 1x1 (got {width}x{height})")
    _check_ray_args(pixel_idx.shape[0], pixel_idx, sample_idx, max_depth,
                    steps_per_call, uniforms)


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


def call_loop(start, run_call, n, dev, max_depth, steps_per_call):
    """The JAX wrappers' call loop: ``ceil(max_depth / steps)`` calls of
    ``steps = min(steps_per_call, max_depth)`` bounces, call c starting at
    depth ``c * steps``. start(state, counts, steps) makes the first call and
    fills every row of the state [STATE_ROWS, n] and the counts [n] it is
    given uninitialised; run_call(state, counts, depth0, steps) makes each
    later one. Returns (radiance [N,3] f32, rays traced as an int64 scalar
    tensor)."""
    steps = min(steps_per_call, max_depth)
    state = torch.empty((STATE_ROWS, n), dtype=F32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    start(state, counts, steps)
    for c in range(1, -(-max_depth // steps)):
        run_call(state, counts, c * steps, steps)
    return state[ROW_ACC:ROW_ACC + 3].T.contiguous(), counts.sum(dtype=torch.int64)


def stepped_trace(run_call, o, d, max_depth, steps_per_call):
    """``call_loop`` over the rays o, d [N,3]: a fresh state (thr 1, radiance
    0, alive, prev -1) and zero counts, then run_call(state, counts, depth0,
    steps) for every call, the first included."""

    def start(state, counts, steps):
        state[ROW_O:ROW_O + 3] = o.T
        state[ROW_D:ROW_D + 3] = d.T
        state[ROW_THR:ROW_THR + 3] = 1.0
        state[ROW_ACC:ROW_ACC + 3] = 0.0
        state[ROW_ALIVE] = 1.0
        state[ROW_PREV] = -1.0
        counts.zero_()
        run_call(state, counts, 0, steps)

    return call_loop(start, run_call, o.shape[0], o.device, max_depth,
                     steps_per_call)


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


def trace_camera_plain(ks: KernelScene, cam: dict, *, width: int, height: int,
                       seed: int, pixel_idx, sample_idx, max_depth: int = 12,
                       rr_start_depth: int = 5, steps_per_call: int = 12,
                       uniforms=None, work=None):
    """Plain torch version of K6's camera entry: the preview's camera rays
    of the (pixel, sample) pairs pixel_idx, sample_idx ([N] int32) at
    ``width`` x ``height`` (``raygen.camera_rays``; cam: ``camera_arrays``),
    traced by ``trace_stepped_plain``. Returns (radiance [N,3] f32, rays
    traced)."""
    check_camera_args(pixel_idx, sample_idx, width, height, max_depth,
                      steps_per_call, uniforms)
    o, d = camera_rays(cam, pixel_idx, sample_idx, seed=seed, width=width,
                       height=height)
    return trace_stepped_plain(ks, o, d, seed=seed, pixel_idx=pixel_idx,
                               sample_idx=sample_idx, max_depth=max_depth,
                               rr_start_depth=rr_start_depth,
                               steps_per_call=steps_per_call,
                               uniforms=uniforms, work=work)


@functools.lru_cache(maxsize=None)
def stepped_library(fmad: bool = True, defines: tuple[str, ...] = ()):
    """``csrc/trace_stepped.cu`` (K5, K6 and K7) built and bound;
    ``fmad=False`` builds it without FMA contraction, ``defines`` with other
    design choices for K6 (its ``K6_*`` -D defines)."""
    built = load_kernel(CSRC_STEPPED, fmad, defines)
    cam = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # cam or NULL, W, H
    rays = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pixel, sample, n
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int,  # seed, depth0, n_steps
        ctypes.c_int, ctypes.c_int,  # max_depth, rr_start_depth
        ctypes.c_void_p,  # uniforms [max_depth * 4, n] or NULL
        ctypes.c_void_p, ctypes.c_void_p,  # state, counts
    ]
    fn = built.lib.pt_trace_stepped_static
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,  # split table, n_prims
                   ctypes.c_int, ctypes.c_int,  # its sphere rows, rcp_safe
                   ctypes.c_void_p, ctypes.c_int,  # gates, n_gates
                   ctypes.c_void_p,  # hit table
                   *cam, *rays, ctypes.c_void_p]  # stream
    fn = built.lib.pt_trace_stepped_static_config
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    scene = [
        ctypes.c_void_p, ctypes.c_int,  # sph, S
        ctypes.c_void_p, ctypes.c_int,  # bnd, M
        ctypes.c_void_p, ctypes.c_int,  # tri, T
    ]
    tiles = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # tiles, C, tile_base
    fn = built.lib.pt_trace_stepped_prim
    fn.restype = ctypes.c_int
    fn.argtypes = [*scene, ctypes.c_void_p, *tiles,  # hit [T, HIT_F] or NULL
                   *cam, *rays, ctypes.c_void_p, ctypes.c_void_p]  # next, stream
    fn = built.lib.pt_trace_stepped_prim_config
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn = built.lib.pt_trace_resolve_config
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn = built.lib.pt_trace_resolve
    fn.restype = ctypes.c_int
    fn.argtypes = scene + [ctypes.c_void_p] + tiles + [  # hit or NULL
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


# K6 stages a scene's tables in a block's shared memory when they take at
# most this many bytes (an H100 block may opt in to 227 KB, 232,448 bytes;
# the rest is left to the kernel's static shared memory); a larger scene
# reads its rows through the read-only path
K6_SHARED_BUDGET = 216 * 1024


def k6_table_bytes(ks: KernelScene) -> int:
    """The shared memory K6 stages ``ks``'s tables in (``csrc/isect_full.cuh``
    scene_layout): the compact rows, spheres, bounding spheres and tile
    AABBs, each 16-byte aligned."""
    return sum(-(-t.numel() * 4 // 16) * 16
               for t in (ks.hit, ks.sph, ks.bnd, ks.tiles))


def k6_shared_table(ks: KernelScene) -> bool:
    """Whether K6 scans ``ks`` from shared memory: its tables fit
    K6_SHARED_BUDGET. Decided from the table's size before a launch."""
    return k6_table_bytes(ks) <= K6_SHARED_BUDGET


def _prim_scene_args(ks: KernelScene, budget: int = K6_SHARED_BUDGET):
    """The table-driven scene's launch arguments, the compact rows where
    the tables fit ``budget`` bytes of shared memory (K6's, or K4's)."""
    hit = ks.hit.data_ptr() if k6_table_bytes(ks) <= budget else None
    return (ks.sph.data_ptr(), ks.sph.shape[0], _ptr(ks.bnd), ks.bnd.shape[0],
            ks.tri.data_ptr(), ks.tri.shape[0], hit, _ptr(ks.tiles),
            ks.tiles.shape[0], ks.tile_base)


def stepped_prim_config(ks: KernelScene, *, camera: bool = False,
                        fmad: bool = True, library=None) -> dict:
    """K6's launch configuration for ``ks`` on the current card: dynamic
    shared memory a block takes (bytes), resident blocks per SM, threads a
    block, SMs, registers and local (spill) bytes a thread, the refill
    threshold, whether the refill grid is persistent, the shared memory a
    block may opt in to, whether the chunk sort runs and its rays a chunk,
    the static shared memory a block takes, and whether the table is in
    shared memory. ``camera`` asks for the camera entry's kernel."""
    built = library or stepped_library(fmad)
    out = (ctypes.c_int * 12)()
    shared = k6_shared_table(ks)
    code = built.lib.pt_trace_stepped_prim_config(
        ks.sph.shape[0], ks.bnd.shape[0], ks.tri.shape[0], ks.tiles.shape[0],
        int(shared), int(camera), out)
    check_launch(built, code, "trace_stepped (K6) configuration")
    keys = ("smem_bytes", "blocks_per_sm", "threads", "sms", "registers",
            "local_bytes", "refill_min", "persistent", "smem_optin", "sort",
            "window", "static_smem_bytes")
    return dict(zip(keys, out), shared_table=shared)


def stepped_launcher(name: str, entry: str, scene_args, *, seed, max_depth,
                     rr_start_depth, fmad, counter, cam=None, library=None):
    """launch(state, counts, depth0, steps, pixel_idx, sample_idx, uniforms,
    camera=False): one launch of K5's or K6's ``entry`` over the state
    [STATE_ROWS, N] on the state's device (one call of
    ``stepped_call_plain``), or with ``camera`` its camera entry, which
    starts the rays from ``cam`` (12 host floats, ``preview_cam_params``;
    width; height); each adds one to ``counter.launches``. K6's refill
    schedule gets a zeroed ray counter a launch."""
    built = library or stepped_library(fmad)
    fn = getattr(built.lib, entry)
    prim = entry == "pt_trace_stepped_prim"
    counter_arg = prim and not ctypes.c_int.in_dll(
        built.lib, "pt_trace_stepped_prim_sort").value

    def launch(state, counts, depth0, steps, pixel_idx, sample_idx, uniforms,
               camera=False):
        dev = state.device
        cam_args = (cam[0].data_ptr(), cam[1], cam[2]) if camera else (None, 0, 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            nxt = torch.zeros(1, dtype=torch.int32, device=dev) if counter_arg else None
            code = fn(*scene_args, *cam_args, pixel_idx.data_ptr(),
                      sample_idx.data_ptr(), state.shape[1],
                      int(seed) & rng.MASK32, depth0, steps, max_depth,
                      rr_start_depth, _ptr(uniforms), state.data_ptr(),
                      counts.data_ptr(), *([_ptr(nxt)] if prim else []), stream)
        check_launch(built, code, name)
        counter.launches += 1

    return launch


def launch_stepped(name: str, entry: str, scene_args, tables, *, seed,
                   pixel_idx, sample_idx, max_depth, rr_start_depth,
                   steps_per_call, uniforms, fmad, counter, o=None, d=None,
                   cam=None, width=0, height=0, library=None):
    """K5's or K6's call loop on the card: checks, then one launch of
    ``entry`` per call, over the rays o, d (``stepped_trace``) or, with a
    camera ``cam`` (``camera_arrays``) at ``width`` x ``height``, from the
    camera entry on (``call_loop``); each launch adds one to
    ``counter.launches``."""
    dev = pixel_idx.device
    rays = [o, d] if cam is None else []
    _check_on(name, dev, [*tables, *rays] + (
        [uniforms] if uniforms is not None else []), (pixel_idx, sample_idx))
    n = pixel_idx.shape[0]
    if n == 0:
        return (torch.empty((0, 3), dtype=F32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    host_cam = None if cam is None else (preview_cam_params(cam), width, height)
    launch = stepped_launcher(name, entry, scene_args, seed=seed,
                              max_depth=max_depth,
                              rr_start_depth=rr_start_depth, fmad=fmad,
                              counter=counter, cam=host_cam, library=library)

    def run_call(state, counts, depth0, steps):
        launch(state, counts, depth0, steps, pixel_idx, sample_idx, uniforms)

    if cam is None:
        return stepped_trace(run_call, o, d, max_depth, steps_per_call)

    def start(state, counts, steps):
        launch(state, counts, 0, steps, pixel_idx, sample_idx, uniforms,
               camera=True)

    return call_loop(start, run_call, n, dev, max_depth, steps_per_call)


def trace_stepped(ks: KernelScene, o, d, *, seed: int, pixel_idx, sample_idx,
                  max_depth: int = 12, rr_start_depth: int = 5,
                  steps_per_call: int = 12, uniforms=None, fmad: bool = True,
                  library=None):
    """K6 (see trace_stepped_plain for the contract). CPU tensors run the
    plain version; CUDA tensors launch ``pt_trace_stepped_prim`` of
    ``csrc/trace_stepped.cu`` once per call, or raise. ``fmad=False`` builds
    the kernel without FMA contraction; ``library`` is another build of the
    source (``stepped_library``)."""
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
        "trace_stepped (K6)", "pt_trace_stepped_prim", _prim_scene_args(ks),
        (ks.sph, ks.bnd, ks.tri, ks.hit, ks.tiles), o=o, d=d, fmad=fmad,
        counter=trace_stepped, library=library, **kw)


trace_stepped.launches = 0


def trace_camera(ks: KernelScene, cam: dict, *, width: int, height: int,
                 seed: int, pixel_idx, sample_idx, max_depth: int = 12,
                 rr_start_depth: int = 5, steps_per_call: int = 12,
                 uniforms=None, fmad: bool = True, library=None):
    """K6's camera entry (see trace_camera_plain for the contract): the
    first call makes the rays in the kernel. CPU tensors run the plain
    version; CUDA tensors launch ``pt_trace_stepped_prim`` once per call,
    counted on ``trace_stepped.launches``, or raise."""
    kw = dict(seed=seed, pixel_idx=pixel_idx, sample_idx=sample_idx,
              max_depth=max_depth, rr_start_depth=rr_start_depth,
              steps_per_call=steps_per_call, uniforms=uniforms)
    dev = pixel_idx.device
    if dev.type == "cpu":
        return trace_camera_plain(ks, cam, width=width, height=height, **kw)
    if dev.type != "cuda":
        raise ValueError(f"trace_camera runs on cpu or cuda, not {dev}")
    check_camera_args(pixel_idx, sample_idx, width, height, max_depth,
                      steps_per_call, uniforms)
    return launch_stepped(
        "trace_camera (K6)", "pt_trace_stepped_prim", _prim_scene_args(ks),
        (ks.sph, ks.bnd, ks.tri, ks.hit, ks.tiles), cam=cam, width=width,
        height=height, fmad=fmad, counter=trace_stepped, library=library,
        **kw)


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


# K7 stages a scene's tables in a block's shared memory beside its 40 KB of
# queries when they take at most this many bytes (of the 227 KB a block may
# opt in to); a larger scene reads its rows through the read-only path
K7_SHARED_BUDGET = 184 * 1024


def k7_scene_args(ks: KernelScene):
    """K7's scene arguments: ``_prim_scene_args`` under K7_SHARED_BUDGET,
    with the sphere rows up to the last real sphere (``sph_rows``): the
    padding after it, which misses every ray, is not scanned."""
    args = list(_prim_scene_args(ks, K7_SHARED_BUDGET))
    args[1] = ks.sph_rows
    return tuple(args)


def k7_shared_table(ks: KernelScene) -> bool:
    """Whether K7 scans ``ks`` from shared memory: its tables
    (``k6_table_bytes``, the same layout) fit K7_SHARED_BUDGET. Decided from
    the table's size before a launch."""
    return k6_table_bytes(ks) <= K7_SHARED_BUDGET


def resolve_config(ks: KernelScene, *, fmad: bool = True) -> dict:
    """K7's launch configuration for ``ks`` on the current card: dynamic
    shared memory a block takes (bytes), resident blocks per SM, threads a
    block, SMs, registers and local (spill) bytes a thread, the shared
    memory a block may opt in to, the static shared memory a block takes,
    the lanes that trace a ray whose line enters a tile, and whether the
    table is in shared memory."""
    built = stepped_library(fmad)
    out = (ctypes.c_int * 9)()
    shared = k7_shared_table(ks)
    code = built.lib.pt_trace_resolve_config(
        ks.sph_rows, ks.bnd.shape[0], ks.tri.shape[0], ks.tiles.shape[0],
        int(shared), out)
    check_launch(built, code, "trace_resolve (K7) configuration")
    keys = ("smem_bytes", "blocks_per_sm", "threads", "sms", "registers",
            "local_bytes", "smem_optin", "static_smem_bytes", "group")
    return dict(zip(keys, out), shared_table=shared)


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
    results are views of the output. The scene's compact rows go to shared
    memory where its tables fit K7_SHARED_BUDGET (``k7_shared_table``).
    ``fmad=False`` builds the kernel without FMA contraction."""
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
    _check_on(name, dev, [ks.sph, ks.bnd, ks.tri, ks.hit, ks.tiles] + (
        [uniforms] if uniforms is not None else []), (pixel_idx, sample_idx))
    if n:
        built = stepped_library(fmad)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = built.lib.pt_trace_resolve(
                *k7_scene_args(ks), buf.data_ptr(), out.data_ptr(),
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
    _check_on(name, dev, [ks.sph, ks.bnd, ks.tri, ks.hit, ks.tiles, o, d] + (
        [uniforms] if uniforms is not None else []), (pixel_idx, sample_idx))
    if o.shape[0] == 0:
        return (torch.empty((0, 3), dtype=F32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    launch = stepped_launcher(name, "pt_trace_stepped_prim", _prim_scene_args(ks),
                              seed=seed, max_depth=max_depth,
                              rr_start_depth=rr_start_depth, fmad=fmad,
                              counter=trace_sorted)
    return sorted_trace(launch, ks, o, d, pixel_idx, sample_idx, uniforms,
                        max_depth, sort_every, dir_major)


trace_sorted.launches = 0
