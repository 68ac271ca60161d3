"""Portal-deferred mesh tracing: the pool layouts, host prep, K2, K3, K8.

Counterpart of ``path_tracer_tpu.ops.pallas.portal`` for the paths that the
JAX package's portal schedulers take (``render.portal``):

- K2 ``trace_cheap_regen`` advances a pixel-pinned pool of paths through the
  cheap geometry (everything but the heavy mesh, at most 128 primitives, the
  K1 scan) with in-kernel regeneration, and freezes a segment whose ray could
  reach the heavy mesh's padded AABB (the "portal"); a frozen path parks in
  one of ``park_k`` per-slot buffers while the slot starts its next sample.
- K3 ``trace_resolve_pool`` gives the active path and every frozen parked
  path one full-scene bounce (the table-driven intersector of
  ``trace_kernel``), with the retire/park bookkeeping done in the kernel.
- K8 ``trace_cheap_blocked`` is the v1 scheduler's cheap kernel: bounces
  through the cheap geometry until death or a portal freeze, voted per
  group of lanes (``trace_cheap_blocked_plain``).

All take the pool as one [rows, n] float32 matrix, one column per slot,
launch ``csrc/portal_cheap.cu``, ``csrc/portal_resolve.cu`` and
``csrc/portal_cheap_blocked.cu`` for CUDA tensors and run their plain torch
versions for CPU tensors; each returns a new pool and leaves the one it was
given as it was. K3's plain version is K7's (``trace_kernel.
trace_resolve_plain``) applied part by part.

Pool rows. The JAX package's layout, row for row (``ROW_*``, ``V2_*``,
``V3_*``, ``BUF_*``), then rows the port adds AFTER it, so that every JAX row
keeps its index and compares directly:

- ``sample_row(park_k)``: the global sample index of the slot's active path;
- ``sample_row(park_k, j)``: the sample index of the path parked in buffer j;
- v1: ``V1_ROW_SAMPLE`` after the 16 rows of ``ROWS``.

The port keys every random number by (seed, pixel, sample, depth, slot)
(``ops.rng``), so a path carries its sample index wherever it goes: its
random numbers do not depend on which kernel takes which bounce, on the step
budget, the park depth, compaction or redistribution. A portal render and a
``pallasr:`` (K4) render of one seed are then the same image up to ulps.
Each kernel also takes a per-lane table instead of the generator
(``uniforms``); a table of zeros reproduces the JAX interpreter's PRNG stub.
Integer-valued rows (pix, done, quota, started, the sample rows) stay exact
in float32 below 2^24.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from path_tracer_tpu_torch.models.scene import ScenePacked
from path_tracer_tpu_torch.ops import rng
from path_tracer_tpu_torch.ops.kernels.build import check_launch, load_kernel
from path_tracer_tpu_torch.ops.kernels.trace_kernel import (
    BIG, KernelScene, make_raygen, path_uniforms, shade_phase,
    trace_resolve_plain,
)
from path_tracer_tpu_torch.ops.kernels.trace_v2 import (
    CameraConsts, SceneConsts, build_scene_consts, f, prim_scan,
)

F32 = torch.float32

# a mesh this big (triangles) makes the scene portal-eligible
PORTAL_MIN_TRIS = 65

# pool rows shared with the JAX package
ROW_O = 0
ROW_D = 3
ROW_THR = 6
ROW_ACC = 9
ROW_ALIVE = 12
ROW_PREV = 13
ROW_DEPTH = 14
V2_ROW_DONE = 15
V2_ROW_PIX = 16
V2_ROW_QUOTA = 17
V2_ROWS = 18
PARK_K = 3  # park buffers per slot in renders
MAX_PARK_K = 3  # the kernels are compiled for park depths 0..3
V3_ROW_STARTED = 18
V3_BUF_BASE = 19
BUF_O = 0
BUF_D = 3
BUF_THR = 6
BUF_PREV = 9
BUF_DEPTH = 10
BUF_STATE = 11  # 0 empty, 1 frozen (awaiting resolve), 2 ready
BUF_ROWS = 12

# K2's loop bound is checked every STEP_GRANULE steps, as the JAX kernel's
# unrolled while loop does: a call runs a multiple of it
STEP_GRANULE = 8

# The v1 pool (K8 and the v1 scheduler): the JAX package's 16 rows, the first
# 15 as above and the slot's pixel (-1 for a free slot), then the port's row
# of the path's global sample index
ROW_PIX = 15
ROWS = 16
V1_ROW_SAMPLE = 16
V1_PORT_ROWS = 17
# K8's lanes vote in groups of this many (the CUDA block; a multiple of 32)
BLOCKED_GROUP = 128

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")


def buf_row(j: int, r: int = 0) -> int:
    return V3_BUF_BASE + j * BUF_ROWS + r


def pool_rows(park_k: int) -> int:
    """Rows of the JAX package's pool."""
    return V3_BUF_BASE + park_k * BUF_ROWS if park_k else V2_ROWS


def sample_row(park_k: int, j: int | None = None) -> int:
    """The port's sample-index row: the active path's, or buffer j's."""
    return pool_rows(park_k) + (0 if j is None else 1 + j)


def port_rows(park_k: int) -> int:
    """Rows of the port's pool: the JAX rows plus 1 + park_k sample rows."""
    return pool_rows(park_k) + 1 + park_k


@dataclass(frozen=True)
class PortalConsts:
    """The cheap scene (K1's form) and the heavy mesh's padded AABB."""

    scene: SceneConsts
    lo: tuple
    hi: tuple

    def to(self, device) -> "PortalConsts":
        return PortalConsts(self.scene.to(device), self.lo, self.hi)

    def aabb(self) -> list[float]:
        return [*self.lo, *self.hi]


def build_portal_consts(packed: ScenePacked):
    """Split a packed scene into (PortalConsts, heavy mesh index), or None
    when no mesh has PORTAL_MIN_TRIS triangles or the cheap remainder has
    more than 128 primitives. The AABB is padded (1e-4 relative + 1e-5
    absolute) so the slab test is conservative under float32 rounding: a
    false positive costs a resolve, a false negative would lose a hit."""
    nt = packed.num_triangles
    if nt == 0:
        return None
    tm = np.asarray(packed.tri_mesh[:nt])
    counts = np.bincount(tm, minlength=packed.num_meshes or 1)
    heavy = int(np.argmax(counts))
    if counts[heavy] < PORTAL_MIN_TRIS:
        return None
    sel = tm == heavy
    keep = ~sel
    n_keep = int(keep.sum())

    def filt(a):
        a = np.asarray(a)
        out = np.zeros((max(n_keep, 1),) + a.shape[1:], a.dtype)
        out[:n_keep] = a[:nt][keep]
        return out

    cheap = dataclasses.replace(
        packed,
        num_triangles=n_keep,
        tri_v=filt(packed.tri_v),
        tri_normal=filt(packed.tri_normal),
        tri_color=filt(packed.tri_color),
        tri_emis=filt(packed.tri_emis),
        tri_rtype=filt(packed.tri_rtype),
        tri_order=filt(packed.tri_order),
        tri_obj=filt(packed.tri_obj),
        tri_mesh=filt(packed.tri_mesh),
    )
    scene = build_scene_consts(cheap)
    if scene is None:
        return None
    verts = np.asarray(packed.tri_v[:nt], np.float64)[sel].reshape(-1, 3)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    slop = np.maximum(np.abs(verts).max(axis=0), hi - lo) * 1e-4 + 1e-5
    return PortalConsts(scene, tuple(map(f, lo - slop)),
                        tuple(map(f, hi + slop))), heavy


def portal_consts_from_jax(consts) -> PortalConsts:
    """The JAX package's portal consts (prims, bnd, (lo, hi))."""
    from path_tracer_tpu_torch.ops.kernels.trace_v2 import scene_from_jax_consts

    prims, bnd, (lo, hi) = consts
    return PortalConsts(scene_from_jax_consts(prims, bnd), tuple(lo), tuple(hi))


def cheap_steps(quota: int, step_cap: int, max_depth: int) -> int:
    """Steps K2 runs per lane in one call at most: the JAX kernel's bound
    min(step_cap, quota*max_depth + 8) (step_cap 0: no cap), rounded up to
    STEP_GRANULE."""
    bound = quota * max_depth + 8
    if step_cap > 0:
        bound = min(step_cap, bound)
    return -(-bound // STEP_GRANULE) * STEP_GRANULE


def _check_pool(pool, park_k):
    if pool.dim() != 2 or pool.dtype != F32:
        raise ValueError("pool must be a 2-D float32 tensor")
    if not 0 <= park_k <= MAX_PARK_K:
        raise ValueError(f"park_k must be in 0..{MAX_PARK_K}, got {park_k}")
    if pool.shape[0] != port_rows(park_k):
        raise ValueError(f"pool has {pool.shape[0]} rows; park_k={park_k} "
                         f"needs {port_rows(park_k)}")


def _check_table(uniforms, rows, n):
    if uniforms is not None and (
        uniforms.shape != (rows, n) or uniforms.dtype != F32
    ):
        raise ValueError(f"uniforms must be [{rows}, {n}] float32")


def _portal_blocked(lo, hi, o, d, alive):
    """Live lanes whose ray could reach the heavy mesh's AABB, and the
    entry distance."""
    t_en = torch.zeros_like(o[0])
    t_ex = torch.full_like(o[0], BIG)
    for k in range(3):
        inv = 1.0 / torch.where(torch.abs(d[k]) < 1e-30, 1e-30, d[k])
        ta = (lo[k] - o[k]) * inv
        tb = (hi[k] - o[k]) * inv
        t_en = torch.maximum(t_en, torch.minimum(ta, tb))
        t_ex = torch.minimum(t_ex, torch.maximum(ta, tb))
    return (t_ex >= t_en) & (t_ex > 0.0) & alive, t_en


def trace_cheap_regen_plain(pc: PortalConsts, cam: CameraConsts,
                            pool: torch.Tensor, *, seed: int, quota: int,
                            sample_base: int, step_cap: int = 0,
                            park_k: int, max_depth: int = 12,
                            rr_start_depth: int = 5,
                            uniforms: torch.Tensor | None = None, work=None):
    """Plain torch version of K2. Every slot advances its paths through the
    cheap scene, step by step:

    1. with park_k > 0, a dead lane re-activates a ready parked path
       (BUF_STATE 2 → 0), lowest j first;
    2. a dead lane regenerates while ``issued < quota row`` (issued is the
       started row with park_k > 0, the done row without), sample index
       ``sample_base + issued``;
    3. the portal slab test against the padded AABB; a live segment whose
       entry is not beyond its cheap hit freezes (ties freeze) and keeps its
       state, every other live segment is processed (counted) and shaded;
    4. with park_k > 0, a freezing path parks in the lane's first empty
       buffer (state 1) and the lane goes on; a lane stalls only when its
       path and all its buffers are frozen.

    A lane stops at ``cheap_steps(quota, step_cap, max_depth)`` steps or as
    soon as it cannot advance (stalled, or dead with nothing to start): it
    then cleans the scratch of a dead path (thr 0, prev -1, depth 0), as the
    JAX kernel's next step would. The JAX kernel steps a block of lanes
    until none can advance; a lane that cannot advance is a fixed point, so
    per lane the two agree, except that a dead lane's scratch rows may stay
    uncleaned in JAX when its block stops at once. ``quota`` is the pass
    cap (the loop bound); the per-slot quota is the pool's quota row.

    Uniforms: the counter generator, or ``uniforms`` [6, n], one row per
    slot of ``rng``, used at every step. ``work`` (a dict, optional) counts
    "scan" live lane-steps (a slab test and a cheap-scene scan each),
    "shade" shaded hits and "regen" camera rays. Returns (pool', processed
    segments per slot [n] int32)."""
    _check_pool(pool, park_k)
    n = pool.shape[1]
    _check_table(uniforms, rng.N_SLOTS, n)
    pool = pool.clone()

    def rows(r, k=3):
        return [pool[r + i].clone() for i in range(k)]

    st = {
        "o": rows(ROW_O), "d": rows(ROW_D), "thr": rows(ROW_THR),
        "acc": rows(ROW_ACC), "alive": pool[ROW_ALIVE].clone(),
        "prev": pool[ROW_PREV].clone(), "depth": pool[ROW_DEPTH].clone(),
        "done": pool[V2_ROW_DONE].clone(),
        "sample": pool[sample_row(park_k)].clone(),
    }
    if park_k:
        st["started"] = pool[V3_ROW_STARTED].clone()
    bufs = [{
        "o": rows(buf_row(j, BUF_O)), "d": rows(buf_row(j, BUF_D)),
        "thr": rows(buf_row(j, BUF_THR)),
        "prev": pool[buf_row(j, BUF_PREV)].clone(),
        "depth": pool[buf_row(j, BUF_DEPTH)].clone(),
        "ps": pool[buf_row(j, BUF_STATE)].clone(),
        "sample": pool[sample_row(park_k, j)].clone(),
    } for j in range(park_k)]
    pix = pool[V2_ROW_PIX].to(torch.int64)
    qrow = pool[V2_ROW_QUOTA]
    raygen, lc = make_raygen(cam, pix)
    lo, hi = pc.lo, pc.hi
    counts = torch.zeros(n, dtype=torch.int32, device=pool.device)
    frozen = torch.zeros(n, dtype=torch.bool, device=pool.device)
    path_keys = ("o", "d", "thr", "prev", "depth", "sample")

    def put(mask, dst, src):
        for key in path_keys:
            if isinstance(dst[key], list):
                dst[key] = [torch.where(mask, a, b)
                            for a, b in zip(src[key], dst[key])]
            else:
                dst[key] = torch.where(mask, src[key], dst[key])

    def step():
        nonlocal counts, frozen
        if park_k:
            vacant = st["alive"] <= 0.0
            for pj in bufs:
                pull = vacant & (pj["ps"] > 1.5)
                put(pull, st, pj)
                st["alive"] = torch.where(pull, 1.0, st["alive"])
                pj["ps"] = torch.where(pull, 0.0, pj["ps"])
                vacant = vacant & ~pull

        issued = st["started"] if park_k else st["done"]
        need = (st["alive"] <= 0.0) & (issued < qrow)
        s_new = sample_base + issued
        if uniforms is not None:
            u45 = [uniforms[4], uniforms[5]]
        else:
            u45 = path_uniforms(seed, pix, s_new, torch.zeros_like(s_new),
                                (4, 5))
        d_new = raygen(s_new.to(torch.int64), *u45)
        for k in range(3):
            st["o"][k] = torch.where(need, lc[k], st["o"][k])
            st["d"][k] = torch.where(need, d_new[k], st["d"][k])
            st["thr"][k] = torch.where(need, 1.0, st["thr"][k])
        st["prev"] = torch.where(need, -1.0, st["prev"])
        st["depth"] = torch.where(need, 0.0, st["depth"])
        st["alive"] = torch.where(need, 1.0, st["alive"])
        st["sample"] = torch.where(need, s_new, st["sample"])
        if park_k:
            st["started"] = st["started"] + need.to(F32)

        o, d = st["o"], st["d"]
        live = st["alive"] > 0.0
        if work is not None:
            work["scan"] = work.get("scan", 0) + int(live.sum())
            work["regen"] = work.get("regen", 0) + int(need.sum())
        hit_box, t_en = _portal_blocked(lo, hi, o, d, live)
        tmin, h_color, h_emis, h_aux, h_rtype, h_sph, h_prev = prim_scan(
            pc.scene, o, d, st["prev"])
        needs = hit_box & (t_en <= tmin)  # ties freeze (conservative)
        proc = live & ~needs
        counts = counts + proc.to(torch.int32)

        found = (tmin < BIG) & proc
        if work is not None:
            work["shade"] = work.get("shade", 0) + int(found.sum())
        point = [o[k] + d[k] * tmin for k in range(3)]
        sn = [point[k] - h_aux[k] for k in range(3)]
        sl = torch.rsqrt(torch.clamp(
            sn[0] * sn[0] + sn[1] * sn[1] + sn[2] * sn[2], min=1e-30))
        nrm = [torch.where(h_sph > 0.5, sn[k] * sl, h_aux[k]) for k in range(3)]
        new_prev = torch.where(found, h_prev.to(F32), -1.0)
        if uniforms is not None:
            u4 = [uniforms[k] for k in range(4)]
        else:
            u4 = path_uniforms(seed, pix, st["sample"], st["depth"], range(4))
        new_depth = st["depth"] + 1.0
        acc, thr_new, d2, alive_new = shade_phase(
            d, nrm, h_color, h_emis, h_rtype, found, st["thr"], st["acc"], u4,
            new_depth, max_depth, rr_start_depth)
        am = alive_new.to(F32)
        st["done"] = st["done"] + (proc & ~alive_new).to(F32)
        st["acc"] = acc
        st["o"] = [torch.where(alive_new, point[k], o[k]) for k in range(3)]
        st["d"] = [torch.where(alive_new, d2[k], d[k]) for k in range(3)]
        st["thr"] = [torch.where(needs, st["thr"][k], thr_new[k] * am)
                     for k in range(3)]
        st["prev"] = torch.where(needs, st["prev"], new_prev)
        st["alive"] = torch.where(needs, st["alive"], am)
        st["depth"] = torch.where(needs, st["depth"], new_depth * am)

        if park_k:
            to_park = needs & live
            for pj in bufs:
                park = to_park & (pj["ps"] < 0.5)
                put(park, pj, st)
                pj["ps"] = torch.where(park, 1.0, pj["ps"])
                to_park = to_park & ~park
            parked = needs & live & ~to_park
            st["alive"] = torch.where(parked, 0.0, st["alive"])
            stalled = to_park
        else:
            stalled = needs
        frozen = live & stalled

    for _ in range(cheap_steps(quota, step_cap, max_depth)):
        can_start = (st["started"] if park_k else st["done"]) < qrow
        for pj in bufs:
            can_start = can_start | (pj["ps"] > 1.5)
        runnable = torch.where(st["alive"] > 0.0, ~frozen, can_start)
        if not bool(runnable.any()):
            step()  # the scratch cleanup of lanes that just stopped
            break
        step()

    for k in range(3):
        pool[ROW_O + k] = st["o"][k]
        pool[ROW_D + k] = st["d"][k]
        pool[ROW_THR + k] = st["thr"][k]
        pool[ROW_ACC + k] = st["acc"][k]
    pool[ROW_ALIVE] = st["alive"]
    pool[ROW_PREV] = st["prev"]
    pool[ROW_DEPTH] = st["depth"]
    pool[V2_ROW_DONE] = st["done"]
    pool[sample_row(park_k)] = st["sample"]
    if park_k:
        pool[V3_ROW_STARTED] = st["started"]
    for j, pj in enumerate(bufs):
        for k in range(3):
            pool[buf_row(j, BUF_O + k)] = pj["o"][k]
            pool[buf_row(j, BUF_D + k)] = pj["d"][k]
            pool[buf_row(j, BUF_THR + k)] = pj["thr"][k]
        pool[buf_row(j, BUF_PREV)] = pj["prev"]
        pool[buf_row(j, BUF_DEPTH)] = pj["depth"]
        pool[buf_row(j, BUF_STATE)] = pj["ps"]
        pool[sample_row(park_k, j)] = pj["sample"]
    return pool, counts


def _check_v1_pool(pool, group, uniforms):
    if pool.dim() != 2 or pool.dtype != F32 or pool.shape[0] != V1_PORT_ROWS:
        raise ValueError(f"pool must be a [{V1_PORT_ROWS}, n] float32 tensor")
    if group < 1:
        raise ValueError(f"group must be positive, got {group}")
    _check_table(uniforms, 4, pool.shape[1])


def trace_cheap_blocked_plain(pc: PortalConsts, pool: torch.Tensor, *,
                              seed: int, max_depth: int = 12,
                              rr_start_depth: int = 5,
                              group: int = BLOCKED_GROUP,
                              uniforms: torch.Tensor | None = None,
                              work=None):
    """Plain torch version of K8, the JAX package's ``trace_cheap_blocked``:
    up to ``max_depth`` cheap-scene steps over the v1 pool [V1_PORT_ROWS, n].

    Lanes vote in groups of ``group`` consecutive lanes (the JAX block; the
    CUDA block on the card; a ragged last group votes alone): a step runs
    for a group only if one of its lanes is alive and its ray misses the
    heavy mesh's padded AABB (the slab test alone, JAX ``portal.py:265-275``).
    Once a group's vote fails its lanes never change again. In a step that
    runs, every lane of the group goes through the JAX body
    (``portal.py:224-263``): a live segment whose AABB entry is not beyond
    its cheap hit freezes (ties freeze) and keeps its state; every other
    live segment is processed: counted, shaded at new depth = depth + 1,
    depth += 1; a dead lane is cleaned (thr 0, prev -1). The pix and sample
    rows pass through.

    Uniforms: the counter generator keyed by (seed, pix row, sample row,
    depth), or ``uniforms`` [4, n] used at every step. ``work`` (a dict,
    optional) counts "scan" live lane-steps of running groups (a slab test
    and a cheap-scene scan each) and "shade" shaded hits. Returns (pool',
    processed segments per lane [n] int32)."""
    _check_v1_pool(pool, group, uniforms)
    n = pool.shape[1]
    out = pool.clone()
    o = [out[ROW_O + k] for k in range(3)]
    d = [out[ROW_D + k] for k in range(3)]
    thr = [out[ROW_THR + k] for k in range(3)]
    acc = [out[ROW_ACC + k] for k in range(3)]
    alive_f, prev, depth = out[ROW_ALIVE], out[ROW_PREV], out[ROW_DEPTH]
    pix = pool[ROW_PIX].to(torch.int32)
    sample = pool[V1_ROW_SAMPLE].to(torch.int32)
    lo, hi = pc.lo, pc.hi
    counts = torch.zeros(n, dtype=torch.int32, device=pool.device)
    n_groups = -(-n // group)
    pad = n_groups * group - n

    for _ in range(max_depth):
        alive = alive_f > 0.0
        hit_box, t_en = _portal_blocked(lo, hi, o, d, alive)
        runnable = torch.nn.functional.pad(alive & ~hit_box, (0, pad))
        run = runnable.view(n_groups, group).any(dim=1)
        if not bool(run.any()):
            break
        run = run.repeat_interleave(group)[:n]

        tmin, h_color, h_emis, h_aux, h_rtype, h_sph, h_prev = prim_scan(
            pc.scene, o, d, prev)
        needs = hit_box & (t_en <= tmin)  # ties freeze (conservative)
        proc = alive & ~needs & run
        counts = counts + proc.to(torch.int32)
        found = (tmin < BIG) & proc
        if work is not None:
            work["scan"] = work.get("scan", 0) + int((run & alive).sum())
            work["shade"] = work.get("shade", 0) + int(found.sum())
        point = [o[k] + d[k] * tmin for k in range(3)]
        sn = [point[k] - h_aux[k] for k in range(3)]
        sl = torch.rsqrt(torch.clamp(
            sn[0] * sn[0] + sn[1] * sn[1] + sn[2] * sn[2], min=1e-30))
        nrm = [torch.where(h_sph > 0.5, sn[k] * sl, h_aux[k]) for k in range(3)]
        new_prev = torch.where(found, h_prev.to(F32), -1.0)
        u4 = ([uniforms[k] for k in range(4)] if uniforms is not None else
              path_uniforms(seed, pix, sample, depth, range(4)))
        acc_n, thr_new, d2, alive_new = shade_phase(
            d, nrm, h_color, h_emis, h_rtype, found, thr, acc, u4,
            depth + 1.0, max_depth, rr_start_depth)
        am = alive_new.to(F32)
        keep = needs | ~run  # a frozen lane, or a lane of a group at rest
        acc = [torch.where(run, acc_n[k], acc[k]) for k in range(3)]
        o = [torch.where(alive_new, point[k], o[k]) for k in range(3)]
        d = [torch.where(alive_new, d2[k], d[k]) for k in range(3)]
        thr = [torch.where(keep, thr[k], thr_new[k] * am) for k in range(3)]
        prev = torch.where(keep, prev, new_prev)
        alive_f = torch.where(keep, alive_f, am)
        depth = depth + proc.to(F32)

    for k in range(3):
        out[ROW_O + k] = o[k]
        out[ROW_D + k] = d[k]
        out[ROW_THR + k] = thr[k]
        out[ROW_ACC + k] = acc[k]
    out[ROW_ALIVE] = alive_f
    out[ROW_PREV] = prev
    out[ROW_DEPTH] = depth
    return out, counts


def trace_resolve_pool_plain(ks: KernelScene, pool: torch.Tensor, *,
                             seed: int, parts: int, park_k: int,
                             max_depth: int = 12, rr_start_depth: int = 5,
                             uniforms: torch.Tensor | None = None, work=None):
    """Plain torch version of K3: one full-scene bounce over the active path
    (part 0) and parked buffers 0 .. parts-2 (parts 1 ..), in part order:

    - part 0: bounce; done += 1 where the path ended;
    - part j ≥ 1 (buffer j-1): bounce only the frozen paths (BUF_STATE 1)
      with acc = 0; add that acc to the slot's acc; done += 1 where the path
      ended; BUF_STATE 1 → 2 (ready) or 0 (empty). Empty and ready buffers
      are left as they are.

    A dead active path is not traced, but its scratch is cleaned (thr 0,
    prev -1) as the JAX kernel's bounce does in any block with a live lane;
    the JAX kernel skips a block of 1024 lanes with none alive, leaving that
    scratch as it was.

    Uniforms: the counter generator keyed by each path's own sample row, or
    ``uniforms`` [4, parts*n] in the JAX package's part-major layout
    (part j's lanes at columns j*n ..). ``work`` as in
    ``trace_kernel.isect_full_plain``. Returns (pool', traced segments per
    slot [n] int32)."""
    _check_pool(pool, park_k)
    if not 1 <= parts <= park_k + 1:
        raise ValueError(f"parts must be in 1..{park_k + 1}, got {parts}")
    n = pool.shape[1]
    _check_table(uniforms, 4, parts * n)
    out = pool.clone()
    pix = pool[V2_ROW_PIX].to(torch.int32)
    counts = torch.zeros(n, dtype=torch.int32, device=pool.device)

    def bounce(j, o, d, thr, acc, alive_f, prev, depth, sample):
        o, d, thr, acc, alive, prev, depth, _ = trace_resolve_plain(
            ks, o, d, thr, acc, alive_f[None], prev[None], depth[None],
            pixel_idx=pix, sample_idx=sample.to(torch.int32), seed=seed,
            max_depth=max_depth, rr_start_depth=rr_start_depth,
            uniforms=None if uniforms is None else uniforms[:, j * n:(j + 1) * n],
            work=work)
        return o, d, thr, acc, alive[0] > 0.0, prev[0], depth[0]

    def rows(r, k=3):
        return pool[r:r + k]

    alive_in = pool[ROW_ALIVE]
    o, d, thr, acc, alive_new, prev, depth = bounce(
        0, rows(ROW_O), rows(ROW_D), rows(ROW_THR), rows(ROW_ACC), alive_in,
        pool[ROW_PREV], pool[ROW_DEPTH], pool[sample_row(park_k)])
    counts += (alive_in > 0.0).to(torch.int32)
    for k in range(3):
        out[ROW_O + k] = o[k]
        out[ROW_D + k] = d[k]
        out[ROW_THR + k] = thr[k]
        out[ROW_ACC + k] = acc[k]
    out[ROW_ALIVE] = alive_new.to(F32)
    out[ROW_PREV] = prev
    out[ROW_DEPTH] = depth
    out[V2_ROW_DONE] = pool[V2_ROW_DONE] + (
        (alive_in > 0.0) & ~alive_new).to(F32)

    zero3 = torch.zeros((3, n), dtype=F32, device=pool.device)
    for j in range(1, parts):
        b = buf_row(j - 1)
        ps = pool[b + BUF_STATE]
        proc = (ps > 0.5) & (ps < 1.5)
        o, d, thr, acc, alive_new, prev, depth = bounce(
            j, rows(b + BUF_O), rows(b + BUF_D), rows(b + BUF_THR), zero3,
            proc.to(F32), pool[b + BUF_PREV], pool[b + BUF_DEPTH],
            pool[sample_row(park_k, j - 1)])
        counts += proc.to(torch.int32)
        for k in range(3):
            out[b + BUF_O + k] = torch.where(proc, o[k], pool[b + BUF_O + k])
            out[b + BUF_D + k] = torch.where(proc, d[k], pool[b + BUF_D + k])
            out[b + BUF_THR + k] = torch.where(proc, thr[k],
                                               pool[b + BUF_THR + k])
            out[ROW_ACC + k] = out[ROW_ACC + k] + acc[k]
        out[b + BUF_PREV] = torch.where(proc, prev, pool[b + BUF_PREV])
        out[b + BUF_DEPTH] = torch.where(proc, depth, pool[b + BUF_DEPTH])
        out[b + BUF_STATE] = torch.where(
            proc, torch.where(alive_new, 2.0, 0.0), ps)
        out[V2_ROW_DONE] = out[V2_ROW_DONE] + (proc & ~alive_new).to(F32)
    return out, counts


def _device_args(dev, tensors, what):
    for t in tensors:
        if t.device != dev or t.dtype != F32 or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous float32 tensors on {dev}")


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


@functools.lru_cache(maxsize=2)
def _cheap_library(fmad: bool = True):
    built = load_kernel(os.path.join(CSRC_DIR, "portal_cheap.cu"), fmad)
    fn = built.lib.pt_cheap_regen
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # prims, n_prims
        ctypes.c_void_p, ctypes.c_int,  # gates, n_gates
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # camera (host), W, H
        ctypes.c_void_p,  # aabb (host): lo, hi
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pool in, out, n
        ctypes.c_int, ctypes.c_uint32, ctypes.c_int,  # park_k, seed, base
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # steps, depth, rr start
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # uniforms, counts, stream
    ]
    return built


@functools.lru_cache(maxsize=2)
def _resolve_library(fmad: bool = True):
    built = load_kernel(os.path.join(CSRC_DIR, "portal_resolve.cu"), fmad)
    fn = built.lib.pt_resolve_pool
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # sph, S
        ctypes.c_void_p, ctypes.c_int,  # bnd, M
        ctypes.c_void_p, ctypes.c_int,  # tri, T
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # tiles, C, tile_base
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pool in, out, n
        ctypes.c_int, ctypes.c_int, ctypes.c_uint32,  # park_k, parts, seed
        ctypes.c_int, ctypes.c_int,  # max_depth, rr_start_depth
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # uniforms, counts, stream
    ]
    return built


def trace_cheap_regen(pc: PortalConsts, cam: CameraConsts, pool: torch.Tensor,
                      *, seed: int, quota: int, sample_base: int,
                      step_cap: int = 0, park_k: int, max_depth: int = 12,
                      rr_start_depth: int = 5,
                      uniforms: torch.Tensor | None = None, fmad: bool = True):
    """K2 (see trace_cheap_regen_plain for the contract). CPU tensors run
    the plain version; CUDA tensors launch ``csrc/portal_cheap.cu`` or
    raise. ``fmad=False`` builds the kernel without FMA contraction."""
    dev = pool.device
    kw = dict(seed=seed, quota=quota, sample_base=sample_base,
              step_cap=step_cap, park_k=park_k, max_depth=max_depth,
              rr_start_depth=rr_start_depth, uniforms=uniforms)
    if dev.type == "cpu":
        return trace_cheap_regen_plain(pc, cam, pool, **kw)
    if dev.type != "cuda":
        raise ValueError(f"trace_cheap_regen runs on cpu or cuda, not {dev}")
    _check_pool(pool, park_k)
    n = pool.shape[1]
    _check_table(uniforms, rng.N_SLOTS, n)
    tensors = [pc.scene.prims, pc.scene.gates, pool]
    _device_args(dev, tensors + ([uniforms] if uniforms is not None else []),
                 "scene, pool and uniforms")
    out = torch.empty_like(pool)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out, counts
    built = _cheap_library(fmad)
    cam_params = cam.params.to(F32).contiguous()  # host memory
    aabb = torch.tensor(pc.aabb(), dtype=F32)  # host memory
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = built.lib.pt_cheap_regen(
            pc.scene.prims.data_ptr(), pc.scene.prims.shape[0],
            _ptr(pc.scene.gates), pc.scene.gates.shape[0],
            cam_params.data_ptr(), cam.width, cam.height, aabb.data_ptr(),
            pool.data_ptr(), out.data_ptr(), n, park_k,
            int(seed) & rng.MASK32, int(sample_base),
            cheap_steps(quota, step_cap, max_depth), int(max_depth),
            int(rr_start_depth), _ptr(uniforms), counts.data_ptr(), stream)
    check_launch(built, code, "trace_cheap_regen")
    trace_cheap_regen.launches += 1
    return out, counts


trace_cheap_regen.launches = 0


def trace_resolve_pool(ks: KernelScene, pool: torch.Tensor, *, seed: int,
                       parts: int, park_k: int, max_depth: int = 12,
                       rr_start_depth: int = 5,
                       uniforms: torch.Tensor | None = None,
                       fmad: bool = True):
    """K3 (see trace_resolve_pool_plain for the contract). CPU tensors run
    the plain version; CUDA tensors launch ``csrc/portal_resolve.cu`` or
    raise. ``fmad=False`` builds the kernel without FMA contraction."""
    dev = pool.device
    kw = dict(seed=seed, parts=parts, park_k=park_k, max_depth=max_depth,
              rr_start_depth=rr_start_depth, uniforms=uniforms)
    if dev.type == "cpu":
        return trace_resolve_pool_plain(ks, pool, **kw)
    if dev.type != "cuda":
        raise ValueError(f"trace_resolve_pool runs on cpu or cuda, not {dev}")
    _check_pool(pool, park_k)
    if not 1 <= parts <= park_k + 1:
        raise ValueError(f"parts must be in 1..{park_k + 1}, got {parts}")
    n = pool.shape[1]
    _check_table(uniforms, 4, parts * n)
    tensors = [ks.sph, ks.bnd, ks.tri, ks.tiles, pool]
    _device_args(dev, tensors + ([uniforms] if uniforms is not None else []),
                 "scene, pool and uniforms")
    out = torch.empty_like(pool)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out, counts
    built = _resolve_library(fmad)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = built.lib.pt_resolve_pool(
            ks.sph.data_ptr(), ks.sph.shape[0], _ptr(ks.bnd), ks.bnd.shape[0],
            ks.tri.data_ptr(), ks.tri.shape[0], _ptr(ks.tiles),
            ks.tiles.shape[0], ks.tile_base,
            pool.data_ptr(), out.data_ptr(), n, park_k, parts,
            int(seed) & rng.MASK32, int(max_depth), int(rr_start_depth),
            _ptr(uniforms), counts.data_ptr(), stream)
    check_launch(built, code, "trace_resolve_pool")
    trace_resolve_pool.launches += 1
    return out, counts


trace_resolve_pool.launches = 0


@functools.lru_cache(maxsize=2)
def _blocked_library(fmad: bool = True):
    built = load_kernel(os.path.join(CSRC_DIR, "portal_cheap_blocked.cu"), fmad)
    fn = built.lib.pt_cheap_blocked
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # prims, n_prims
        ctypes.c_void_p, ctypes.c_int,  # gates, n_gates
        ctypes.c_void_p,  # aabb (host): lo, hi
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pool in, out, n
        ctypes.c_int, ctypes.c_uint32,  # group, seed
        ctypes.c_int, ctypes.c_int,  # max_depth, rr_start_depth
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # uniforms, counts, stream
    ]
    return built


def trace_cheap_blocked(pc: PortalConsts, pool: torch.Tensor, *, seed: int,
                        max_depth: int = 12, rr_start_depth: int = 5,
                        group: int = BLOCKED_GROUP,
                        uniforms: torch.Tensor | None = None,
                        fmad: bool = True):
    """K8 (see trace_cheap_blocked_plain for the contract). CPU tensors run
    the plain version; CUDA tensors launch ``csrc/portal_cheap_blocked.cu``
    with ``group`` threads a block (a multiple of 32, at most 1024), or
    raise. ``fmad=False`` builds the kernel without FMA contraction."""
    dev = pool.device
    kw = dict(seed=seed, max_depth=max_depth, rr_start_depth=rr_start_depth,
              group=group, uniforms=uniforms)
    if dev.type == "cpu":
        return trace_cheap_blocked_plain(pc, pool, **kw)
    if dev.type != "cuda":
        raise ValueError(f"trace_cheap_blocked runs on cpu or cuda, not {dev}")
    _check_v1_pool(pool, group, uniforms)
    if group % 32 or group > 1024:
        raise ValueError(f"group must be a multiple of 32 up to 1024, got {group}")
    n = pool.shape[1]
    _device_args(dev, [pc.scene.prims, pc.scene.gates, pool] + (
        [uniforms] if uniforms is not None else []), "scene, pool and uniforms")
    out = torch.empty_like(pool)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out, counts
    built = _blocked_library(fmad)
    aabb = torch.tensor(pc.aabb(), dtype=F32)  # host memory
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = built.lib.pt_cheap_blocked(
            pc.scene.prims.data_ptr(), pc.scene.prims.shape[0],
            _ptr(pc.scene.gates), pc.scene.gates.shape[0], aabb.data_ptr(),
            pool.data_ptr(), out.data_ptr(), n, int(group),
            int(seed) & rng.MASK32, int(max_depth), int(rr_start_depth),
            _ptr(uniforms), counts.data_ptr(), stream)
    check_launch(built, code, "trace_cheap_blocked")
    trace_cheap_blocked.launches += 1
    return out, counts


trace_cheap_blocked.launches = 0
