"""The portal schedulers: pools of mesh paths cycled through the portal
kernels, the counterpart of the JAX package's ``render.portal``.

v2, the default (``make_portal_pass_runner_v2``): slot i of a pixel-pinned
pool owns pixel ``pix`` row i; each cycle runs

    K2 trace_cheap_regen  (cheap bounces, in-kernel regeneration, portal
                           freeze, parking; at most step_cap steps a slot)
    K3 trace_resolve_pool (one full-scene bounce of the active path and every
                           frozen parked path, retire/park bookkeeping)

and the host polls the unfinished-slot count every few cycles. As the pass
drains, the unfinished tail is compacted down a ladder of narrower pools
(``TAIL_LADDER``), and finished slots adopt the upper half of laggards'
remaining sample ranges (``redistribute_samples``). At pass end every
stage's acc rows add into the framebuffer keyed by their pix row; per-pixel
sample counts are exact by construction. With ``POOL_RESOLVE`` off
(PT_TPU_POOL_RESOLVE=0) the resolve is the glue branch instead: K7
``trace_resolve`` over the active paths and buffers side by side, and the
bookkeeping in torch (``glue_lanes``, ``_resolve_glue``).

v1 (``make_portal_pass_runner``, PT_TPU_PORTAL_V1): a pool of free slots;
each cycle runs K8 ``trace_cheap_blocked``, compacts the frozen paths to
the front, resolves them with K7, retires dead paths into the framebuffer
and refills free slots with fresh samples (``portal_cycle``). It cancels
and checkpoints only between passes.

Not ported, each for its reason (ROADMAP.md, Slice 2 crosswalk):
``portal_cycles_v2`` (fusing cycles into one dispatch amortised a ~1.75 ms
remote-TPU dispatch), narrow resolves (``PT_TPU_NARROW_BUFS``), the
resolve-lane sorts (``sort_lanes``, ``_tile_slab_masks``,
``_resolve_sort_order``, ``_counting_positions``: measured dead),
``freeze_pixel_order`` (measured neutral) and ``make_pool_v2``'s slot-order
option (no render passes one); the sharded runner's ``flush_pix`` and
``pix_offset`` arguments wait for the sharded scheduler (Slice 4).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from path_tracer_tpu_torch.ops.kernels import portal as pm
from path_tracer_tpu_torch.ops.kernels.portal import (
    BUF_STATE, ROW_ACC, ROW_ALIVE, ROW_PIX, ROW_PREV, V1_PORT_ROWS,
    V1_ROW_SAMPLE, V2_ROW_DONE, V2_ROW_PIX, V2_ROW_QUOTA, V3_ROW_STARTED,
    buf_row, port_rows, trace_cheap_blocked, trace_cheap_regen,
    trace_resolve_pool,
)
from path_tracer_tpu_torch.ops.kernels.trace_kernel import (
    make_raygen, path_uniforms, trace_resolve,
)
from path_tracer_tpu_torch.render import drive

F32 = torch.float32
CHEAP_BLOCK = 2048  # pool widths are multiples of this
RESOLVE_BLOCK = 1024  # v1: K7's lane count is a multiple of this
# v1 pool capacity (lanes): 1M lanes = 68 MB of pool state
DEFAULT_POOL = 1 << 20

# The v2 resolve: K3 (True) or the glue branch, K7 and torch (False). Read
# once at import from PT_TPU_POOL_RESOLVE, as the JAX package does; tests
# and chip_smoke.py set the attribute, which drive_pool_v2 reads per drive.
POOL_RESOLVE = os.environ.get("PT_TPU_POOL_RESOLVE", "1") != "0"

# tail-compaction ladder: fixed pool widths the unfinished tail is squeezed
# into once it fits, so that late cycles cost in proportion to the tail
TAIL_LADDER = (524288, 393216, 262144, 131072, 98304, 65536, 32768,
               16384, 8192, 2048)

# K2's per-call step budget, and the cycles between unfinished-count polls;
# read at call time (tests lower them)
STEP_CAP = 64
CHECK_EVERY = 4


def _round_block(n: int) -> int:
    return max(((n + CHEAP_BLOCK - 1) // CHEAP_BLOCK) * CHEAP_BLOCK,
               CHEAP_BLOCK)


def _unfinished(pool):
    return (pool[V2_ROW_DONE] < pool[V2_ROW_QUOTA]).sum()


def glue_lanes(pool, park_k: int):
    """K7's input on the glue route: the active paths and the park_k
    buffers of a v2 pool concatenated along the lane axis ((park_k + 1) * n
    lanes, part-major, as the JAX package's ``render/portal.py:462-487``).
    A buffer lane counts as alive only where it holds a frozen path, with a
    zero acc. Returns (the seven state arrays, pixel_idx, sample_idx, the
    buffers' frozen masks)."""
    n = pool.shape[1]

    def part_rows(r0, rb, k):
        return torch.cat([pool[r0:r0 + k]]
                         + [pool[buf_row(j, rb):buf_row(j, rb) + k]
                            for j in range(park_k)], dim=1)

    frozen = [(pool[buf_row(j, BUF_STATE)] > 0.5)
              & (pool[buf_row(j, BUF_STATE)] < 1.5) for j in range(park_k)]
    acc_in = torch.cat([pool[ROW_ACC:ROW_ACC + 3],
                        torch.zeros((3, park_k * n), dtype=F32,
                                    device=pool.device)], dim=1)
    alive_in = torch.cat([pool[ROW_ALIVE]] + [f.to(F32) for f in frozen])[None]
    state = (part_rows(pm.ROW_O, pm.BUF_O, 3), part_rows(pm.ROW_D, pm.BUF_D, 3),
             part_rows(pm.ROW_THR, pm.BUF_THR, 3), acc_in, alive_in,
             part_rows(ROW_PREV, pm.BUF_PREV, 1),
             part_rows(pm.ROW_DEPTH, pm.BUF_DEPTH, 1))
    pix = pool[V2_ROW_PIX].to(torch.int32).repeat(park_k + 1)
    smp = torch.cat([pool[pm.sample_row(park_k)]] + [
        pool[pm.sample_row(park_k, j)] for j in range(park_k)]).to(torch.int32)
    return state, pix, smp, frozen


def _resolve_glue(pool, ks, *, seed: int, park_k: int, max_depth: int,
                  rr_start_depth: int, uniforms=None):
    """The resolve phase composed in torch around K7, the JAX package's
    glue branch (``render/portal.py:462-564``): K7 over ``glue_lanes``,
    then K3's bookkeeping. Slot acc and done add the parts in part order,
    as K3 does, so the pool equals K3's bit for bit. ``uniforms`` [4,
    (park_k + 1) * n] as K3's."""
    n = pool.shape[1]
    state, pix, smp, frozen = glue_lanes(pool, park_k)
    o, d, thr, acc, alive, prev, depth, c2 = trace_resolve(
        ks, *state, pixel_idx=pix, sample_idx=smp, seed=seed,
        max_depth=max_depth, rr_start_depth=rr_start_depth, uniforms=uniforms)

    def part(x, j):  # part 0 the active path, part j >= 1 buffer j-1
        return x[:, j * n:(j + 1) * n]

    out = pool.clone()
    ended = (pool[ROW_ALIVE] > 0.0) & (part(alive, 0)[0] <= 0.0)
    out[pm.ROW_O:pm.ROW_O + 3] = part(o, 0)
    out[pm.ROW_D:pm.ROW_D + 3] = part(d, 0)
    out[pm.ROW_THR:pm.ROW_THR + 3] = part(thr, 0)
    out[ROW_ACC:ROW_ACC + 3] = part(acc, 0)
    out[ROW_ALIVE] = part(alive, 0)[0]
    out[ROW_PREV] = part(prev, 0)[0]
    out[pm.ROW_DEPTH] = part(depth, 0)[0]
    out[V2_ROW_DONE] = pool[V2_ROW_DONE] + ended.to(F32)
    for j in range(park_k):
        proc = frozen[j]
        b = buf_row(j)
        for r0, src, k in ((pm.BUF_O, o, 3), (pm.BUF_D, d, 3),
                           (pm.BUF_THR, thr, 3), (pm.BUF_PREV, prev, 1),
                           (pm.BUF_DEPTH, depth, 1)):
            out[b + r0:b + r0 + k] = torch.where(
                proc, part(src, j + 1), pool[b + r0:b + r0 + k])
        out[ROW_ACC:ROW_ACC + 3] = out[ROW_ACC:ROW_ACC + 3] + part(acc, j + 1)
        lives = part(alive, j + 1)[0] > 0.0
        out[b + BUF_STATE] = torch.where(
            proc, torch.where(lives, 2.0, 0.0), pool[b + BUF_STATE])
        out[V2_ROW_DONE] = out[V2_ROW_DONE] + (proc & ~lives).to(F32)
    return out, c2.sum().to(torch.int64)


def portal_resolve_phase(pool, ks, *, seed: int, park_k: int, max_depth: int,
                         rr_start_depth: int, pool_resolve: bool = True,
                         uniforms=None):
    """The resolve half of a cycle over the active path and every parked
    buffer: K3, or with ``pool_resolve=False`` or injected ``uniforms`` (K3's
    [4, (park_k + 1) * n] layout) the glue branch, K7 and torch
    (``_resolve_glue``), as the JAX package chooses. Returns (pool',
    segments traced, unfinished slots), the last two as scalar tensors on
    the pool's device."""
    if pool_resolve and uniforms is None:
        pool, counts = trace_resolve_pool(
            ks, pool, seed=seed, parts=park_k + 1, park_k=park_k,
            max_depth=max_depth, rr_start_depth=rr_start_depth)
        rays = counts.sum(dtype=torch.int64)
    else:
        pool, rays = _resolve_glue(pool, ks, seed=seed, park_k=park_k,
                                   max_depth=max_depth,
                                   rr_start_depth=rr_start_depth,
                                   uniforms=uniforms)
    return pool, rays, _unfinished(pool)


def portal_cycle_v2(pool, pc, cam, ks, *, quota: int, sample_base: int,
                    seed: int, step_cap: int, park_k: int, max_depth: int,
                    rr_start_depth: int, pool_resolve: bool = True):
    """One cycle: K2 until every slot is frozen (parked park_k deep), out of
    samples or step-capped, then the resolve phase (K3, or K7 and torch with
    ``pool_resolve=False``). A capped but unfrozen path just has its next
    segment traced by the full scene (which contains the cheap scene).
    Returns (pool', segments traced, unfinished slots)."""
    pool, c1 = trace_cheap_regen(
        pc, cam, pool, seed=seed, quota=quota, sample_base=sample_base,
        step_cap=step_cap, park_k=park_k, max_depth=max_depth,
        rr_start_depth=rr_start_depth)
    pool, c2, unfin = portal_resolve_phase(
        pool, ks, seed=seed, park_k=park_k, max_depth=max_depth,
        rr_start_depth=rr_start_depth, pool_resolve=pool_resolve)
    return pool, c1.sum(dtype=torch.int64) + c2, unfin


def _redist_min(quota: int) -> int:
    """Minimum un-issued samples a redistribution split leaves on each half:
    quota // 16, in [2, 16]."""
    return min(16, max(2, quota // 16))


def redistribute_samples(pool, flush, min_rem: int = 64, *, park_k: int):
    """Mid-pass work redistribution: a DONOR slot (done ≥ quota, path dead,
    all park buffers empty) takes over a LAGGARD's un-issued upper range. The
    donor gets (pix = laggard's pix, started = done = split, quota =
    laggard's quota) and the laggard's quota shrinks to split = quota -
    floor(rem / 2), so sample ids stay exactly partitioned. Matching is rank
    k to rank k in slot order. The donor's retired radiance goes into
    ``flush`` ([n, 4]: rgb + count credit, keyed by its OLD pixel) before its
    pix changes; the count column banks +done at the old pixel and -split at
    the new one, so summing raw done over stages plus flush[:, 3] gives the
    true per-pixel retired count at any time. Returns (pool', flush',
    pairs)."""
    quota = pool[V2_ROW_QUOTA]
    done = pool[V2_ROW_DONE]
    started = pool[V3_ROW_STARTED] if park_k else done
    C = pool.shape[1]
    dev = pool.device
    idx = torch.arange(C, dtype=torch.int64, device=dev)

    rem = quota - started
    finished = (done >= quota) & (pool[ROW_ALIVE] <= 0.0)
    for j in range(park_k):
        finished &= pool[buf_row(j, BUF_STATE)] <= 0.5
    lag = rem >= float(2 * min_rem)

    don_rank = torch.cumsum(finished.to(torch.int64), 0) - 1
    lag_rank = torch.cumsum(lag.to(torch.int64), 0) - 1
    n_pairs = torch.minimum(don_rank[-1] + 1, lag_rank[-1] + 1)

    laggards_at = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    laggards_at[torch.where(lag, lag_rank, C)] = idx  # slot C absorbs the rest
    laggards_at = laggards_at[:C]

    split = quota - torch.floor(rem * 0.5)
    new_quota = torch.where(lag & (lag_rank < n_pairs), split, quota)
    take = finished & (don_rank < n_pairs)
    src = laggards_at[torch.clamp(don_rank, 0, C - 1)]
    pix = pool[V2_ROW_PIX]
    sp = split[src]

    last = float(flush.shape[0] - 1)
    takef = take.to(F32)
    flush = flush.clone()
    fpix = torch.where(take, pix, last).to(torch.int64)
    contrib = torch.cat([
        torch.where(take[None], pool[ROW_ACC:ROW_ACC + 3], 0.0),
        (takef * done)[None],
    ])
    flush.index_add_(0, fpix, contrib.T)
    npix_new = torch.where(take, pix[src], last).to(torch.int64)
    flush[:, 3].index_add_(0, npix_new, -takef * sp)

    out = pool.clone()
    out[V2_ROW_QUOTA] = torch.where(take, quota[src], new_quota)
    out[V2_ROW_PIX] = torch.where(take, pix[src], pix)
    out[V2_ROW_DONE] = torch.where(take, sp, done)
    if park_k:
        out[V3_ROW_STARTED] = torch.where(take, sp, started)
    out[ROW_ACC:ROW_ACC + 3] *= 1.0 - takef
    return out, flush, n_pairs


def _flush_stage(flush):
    """The redistribution flush ([n, 4] rgb + count keyed by row = pixel) as
    one synthetic stage, so the ordinary pix/acc merge retires it."""
    n = flush.shape[0]
    st = torch.zeros((pm.V2_ROWS, n), dtype=F32, device=flush.device)
    st[ROW_ACC:ROW_ACC + 3] = flush[:, :3].T
    st[V2_ROW_PIX] = torch.arange(n, dtype=F32, device=flush.device)
    return st


def _scatter_stages(stages, flush, out_rows: int, *, live_last: bool,
                    with_rad: bool, device):
    cnt = torch.zeros(out_rows, dtype=F32, device=device)
    rad = torch.zeros((out_rows, 3), dtype=F32, device=device) if with_rad else None
    for i, st in enumerate(stages):
        pix = st[V2_ROW_PIX].to(torch.int64)
        if with_rad:
            rad.index_add_(0, pix, st[ROW_ACC:ROW_ACC + 3].T)
        done = st[V2_ROW_DONE]
        if not (live_last and i + 1 == len(stages)):
            done = torch.where(done >= st[V2_ROW_QUOTA], done, 0.0)
        cnt.index_add_(0, pix, done)
    if flush is not None:
        if with_rad:
            rad[: flush.shape[0]] += flush[:, :3]
        cnt[: flush.shape[0]] += flush[:, 3]
    return rad, cnt


def _snapshot_stages(stages, flush, *, out_rows: int):
    """Mid-pass partial image: every stage's retired radiance and sample
    counts scattered by pixel id into [out_rows, 3] / [out_rows]. ``stages``
    is the drive's retired stages plus the live pool last: a retired stage
    counts only its done ≥ quota slots (the others moved on into a later
    stage), the live pool all its done counts. The live pool's acc includes
    the in-flight samples' partial sums (preview grade); the pass-end merge
    is exact."""
    return _scatter_stages(stages, flush, out_rows, live_last=True,
                           with_rad=True, device=stages[-1].device)


def _with_cnt_base(rad_cnt, cnt_base):
    """Add the retired counts of stages merged at earlier pauses of this pass
    (cnt_base [npix], or None) over the overlap with the snapshot's counts."""
    if cnt_base is None:
        return rad_cnt
    rad, cnt = rad_cnt
    n = min(cnt.shape[0], cnt_base.shape[0])
    cnt = cnt.clone()
    cnt[:n] += cnt_base[:n]
    return rad, cnt


def _retired_counts(stages, flush, *, out_rows: int, device="cpu"):
    """Per-pixel retired counts of a drive's retired stages (not the live
    pool) plus the flush credits: the counts that a pause's merge-and-discard
    would otherwise lose."""
    return _scatter_stages(stages, flush, out_rows, live_last=False,
                           with_rad=False, device=device)[1]


def _compact_tail(pool, idx, valid):
    """Gather slots idx of `pool` into a smaller pool and zero their acc in
    the source, so radiance lives in exactly one pool at all times. idx is
    padded to the ladder width; `valid` masks the real entries, and padding
    lanes are zeroed whole (dead, no radiance, done == quota == 0: born
    retired)."""
    small = pool[:, idx]
    v = valid.to(F32)
    moved = torch.zeros(pool.shape[1], dtype=F32, device=pool.device)
    moved = moved.scatter_reduce(0, idx, v, reduce="amax")
    pool = pool.clone()
    pool[ROW_ACC:ROW_ACC + 3] *= 1.0 - moved[None]
    return pool, small * v[None]


def _compact_tail_auto(pool, *, target: int):
    """_compact_tail with the indices found on the device: the unfinished
    slots, stably partitioned to the front, then padding."""
    unfin = pool[V2_ROW_DONE] < pool[V2_ROW_QUOTA]
    order = torch.argsort(torch.where(unfin, 0, 1), stable=True)
    idx = order[:target]
    valid = torch.arange(target, device=pool.device) < unfin.sum()
    return _compact_tail(pool, idx, valid)


def make_pool_v2(npix: int, n_pad: int, k_pass: int, park_k: int | None = None,
                 device="cpu"):
    """Fresh pixel-pinned pool: slot i owns pixel min(i, npix-1); padding
    slots (i ≥ npix) are born retired as done == quota == 0, so they never
    issue and count nothing."""
    if park_k is None:
        park_k = pm.PARK_K
    pool = torch.zeros((port_rows(park_k), n_pad), dtype=F32, device=device)
    pool[ROW_PREV] = -1.0
    pool[V2_ROW_PIX] = torch.clamp(
        torch.arange(n_pad, dtype=F32, device=device), max=float(npix - 1))
    real = torch.arange(n_pad, device=device) < npix
    pool[V2_ROW_QUOTA] = torch.where(real, float(k_pass), 0.0)
    return pool


def _pool_from_rows(pix, done, quota, *, n_pad: int, park_k: int,
                    device="cpu"):
    """Pool whose first len(pix) slots continue the given per-slot sample
    ranges [done, quota) (resume from a mid-pass checkpoint, thaw after a
    pause); the other slots are born retired (done == quota == 0, pix 0)."""
    m = len(pix)
    pool = torch.zeros((port_rows(park_k), n_pad), dtype=F32, device=device)
    pool[ROW_PREV] = -1.0
    for row, vals in ((V2_ROW_PIX, pix), (V2_ROW_DONE, done),
                      (V2_ROW_QUOTA, quota)):
        pool[row, :m] = torch.as_tensor(np.asarray(vals, np.float32),
                                        device=device)
    if park_k:
        pool[V3_ROW_STARTED] = pool[V2_ROW_DONE]
    return pool


def _pm_park_k() -> int:
    """The parked-buffer depth, read at call time (tests lower it)."""
    return pm.PARK_K


def _stall_limits(k_pass, max_depth):
    """(stall_limit polls, hard_limit cycles), the drive's two runaway
    backstops; both scale with the quota (no slot retires until deep into
    a big pass)."""
    return 20 * max(1, k_pass // 64), 256 + 4 * k_pass * (max_depth + 4)


def drive_pool_v2(pool, k_pass: int, sample_base: int, *, pc, cam, ks,
                  seed: int, max_depth: int, rr_start_depth: int,
                  check_every: int = 4, ladder=TAIL_LADDER, park_k: int,
                  adaptive_polls: bool = True, on_check=None, cycle0: int = 0,
                  npix: int | None = None, cnt_base=None):
    """Cycle a pixel-pinned pool until every slot retires its quota,
    compacting the unfinished tail down the width ``ladder`` as it shrinks
    and redistributing samples when no rung fits.

    Returns the drive.DriveResult: its stages (the original pool and one per
    compaction) and its redistribution flush, merged by merge_stages,
    reconstruct the retired radiance exactly. ``on_check(cycle, width,
    unfin[, snapshot])`` is the poll hook (see render.drive)."""
    step_cap = STEP_CAP
    pool_resolve = POOL_RESOLVE
    redist_min = _redist_min(k_pass)
    redist = k_pass >= 2 * redist_min  # a laggard needs 2 * redist_min left
    # flush and snapshot buffers are keyed by global pixel id: they cover
    # npix even when the pool is narrower (a thawed or resumed pool)
    c0 = max(pool.shape[1], npix) if npix is not None else pool.shape[1]
    stall_limit, hard_limit = _stall_limits(k_pass, max_depth)

    def run_cycles(pool, cycle, steps):
        rays = 0
        unfin = None
        for _ in range(steps):
            pool, r, unfin = portal_cycle_v2(
                pool, pc, cam, ks, quota=k_pass, sample_base=sample_base,
                seed=seed, step_cap=step_cap, park_k=park_k,
                max_depth=max_depth, rr_start_depth=rr_start_depth,
                pool_resolve=pool_resolve)
            rays = rays + r
        return pool, rays, unfin

    def poll(unfin):
        u = int(unfin)
        return u, u

    def compact_fn(pool, u):
        target = None
        for w in sorted(ladder, reverse=True):
            if u <= w < pool.shape[1]:
                target = w  # the smallest rung that fits the tail
        if target is None:
            return None
        return _compact_tail_auto(pool, target=target)

    return drive.drive_loop(
        pool,
        run_cycles=run_cycles,
        poll=poll,
        compact_fn=compact_fn,
        redistribute_fn=(
            (lambda p, fl: redistribute_samples(
                p, fl, redist_min, park_k=park_k)[:2])
            if redist else None),
        new_flush=lambda: torch.zeros((c0, 4), dtype=F32, device=pool.device),
        snapshot_fn=lambda sts, fl: _with_cnt_base(
            _snapshot_stages(sts, fl, out_rows=c0), cnt_base),
        k_pass=k_pass, max_depth=max_depth, step_cap=step_cap,
        park_k=park_k, check_every=check_every,
        batch_polls=adaptive_polls, stall_limit=stall_limit,
        hard_limit=hard_limit, on_check=on_check, cycle0=cycle0,
    )


def merge_stages(accum, stages, flush):
    """Add every stage's acc rows (and the flush) into accum [npix, 3] by the
    stage's pix row, in place. On the card the adds are atomic and their
    order varies from run to run (float sums agree to rounding)."""
    npix = accum.shape[0]
    for st in list(stages) + ([_flush_stage(flush)] if flush is not None else []):
        pix = st[V2_ROW_PIX].to(torch.int64)
        keep = pix < npix  # the flush stage covers max(pool width, npix) rows
        accum.index_add_(0, pix[keep], st[ROW_ACC:ROW_ACC + 3].T[keep])
    return accum


def make_portal_pass_runner_v2(pc, cam, ks, *, npix: int, k_full: int,
                               seed: int, max_depth: int = 12,
                               rr_start_depth: int = 5, on_check=None,
                               on_pause=None, device="cpu"):
    """The portal pass runner: ``runner(accum, pass_idx, k_pass)`` gives
    every pixel slot a quota of k_pass samples (global indices pass_idx *
    k_full ..), cycles the pool until every slot retires its quota, adds the
    retired radiance into accum [npix, 3] (pixel order) and returns (accum,
    segments traced).

    on_check(cycle, width, unfin): the poll hook. Falsy continues; "pause"
    asks for a mid-pass checkpoint; any other truthy value cancels. Both
    stop by freeze-and-drain (render.drive), so every started sample
    retires and merges exactly:

    - cancel: ``.last_cancelled`` flips and ``.last_partial_counts`` holds
      the exact per-pixel retired counts [npix] of the pass;
    - pause: on_pause(accum, (pix, done, quota) slot rows, pass_idx, k_pass)
      persists the checkpoint, and the pass goes on from the thawed pool.

    Resume: set ``.resume_slots = (pix, done, quota)`` (and
    ``.resume_cycle0``) before the call; the pool continues exactly those
    per-slot sample ranges. ``.set_hooks(on_check=, on_pause=)`` rebinds
    the hooks."""
    n_pad = _round_block(npix)
    hooks = {"on_check": on_check, "on_pause": on_pause}
    device = torch.device(device)

    def set_hooks(on_check=None, on_pause=None):
        if on_check is not None:
            hooks["on_check"] = on_check
        if on_pause is not None:
            hooks["on_pause"] = on_pause

    def pass_runner(accum, pass_idx, k_pass):
        pass_runner.last_cancelled = False
        pass_runner.last_partial_counts = None
        sample_base = pass_idx * k_full
        park_k = _pm_park_k()

        resume = pass_runner.resume_slots
        pass_runner.resume_slots = None
        cycle0 = int(pass_runner.resume_cycle0 or 0) if resume is not None else 0
        pass_runner.resume_cycle0 = None
        if resume is not None:
            pix_r, done_r, quota_r = (np.asarray(a) for a in resume)
            pool = _pool_from_rows(pix_r, done_r, quota_r,
                                   n_pad=_round_block(len(pix_r)),
                                   park_k=park_k, device=device)
        else:
            pool = make_pool_v2(npix, n_pad, k_pass, park_k=park_k,
                                device=device)

        rays = torch.zeros((), dtype=torch.int64, device=device)
        cnt_pass = None  # retired counts of stages merged at pauses
        while True:
            res = drive_pool_v2(
                pool, k_pass, sample_base, pc=pc, cam=cam, ks=ks, seed=seed,
                max_depth=max_depth, rr_start_depth=rr_start_depth,
                check_every=CHECK_EVERY, park_k=park_k,
                # poll batching is remote-device economics; on the CPU a
                # burst of cycles only hides the polls
                adaptive_polls=device.type == "cuda",
                on_check=hooks["on_check"], cycle0=cycle0,
                npix=npix, cnt_base=cnt_pass,
            )
            rays = rays + res.rays
            pass_runner.total_cycles += res.cycles - cycle0
            pass_runner.total_polls += res.polls
            merge_stages(accum, res.stages, res.flush)
            if res.outcome == drive.DONE:
                return accum, rays
            if res.outcome == drive.CANCEL:
                _, cnt = _snapshot_stages(
                    tuple(res.stages), res.flush,
                    out_rows=max(npix, res.stages[0].shape[1]))
                if cnt_pass is not None:
                    cnt[:npix] += cnt_pass[:npix]
                pass_runner.last_cancelled = True
                pass_runner.last_partial_counts = cnt[:npix]
                return accum, rays
            # PAUSE: the radiance is merged; persist the slot rows and go on
            live = res.stages[-1]
            delta = _retired_counts(
                tuple(res.stages[:-1]), res.flush,
                out_rows=max(npix, live.shape[1]), device=live.device)[:npix]
            cnt_pass = delta if cnt_pass is None else cnt_pass + delta
            if hooks["on_pause"] is not None:
                pass_runner.last_pause_cycles = res.cycles
                slot_rows = drive.drained_slot_state(live, res.frozen_quota)
                hooks["on_pause"](accum, slot_rows, pass_idx, k_pass)
            pool = drive.thaw_pool(live, res.frozen_quota, park_k=park_k)
            cycle0 = res.cycles

    pass_runner.last_cancelled = False
    pass_runner.last_partial_counts = None
    pass_runner.resume_slots = None
    pass_runner.resume_cycle0 = None
    pass_runner.last_pause_cycles = 0
    pass_runner.total_cycles = 0  # cycles and polls over every pass
    pass_runner.total_polls = 0
    pass_runner.set_hooks = set_hooks
    pass_runner.total_slots = npix
    pass_runner.slot_layout = "single"
    return pass_runner


# ---------------------------------------------------------------------------
# v1: a pool of free-floating path slots, compacted and refilled each cycle
# ---------------------------------------------------------------------------


def _round_resolve(n: int) -> int:
    return max(((n + RESOLVE_BLOCK - 1) // RESOLVE_BLOCK) * RESOLVE_BLOCK,
               RESOLVE_BLOCK)


def portal_cycle(pool, accum, counts, issued, *, limit: int, sample_base: int,
                 pc, cam, ks, seed: int, npix: int, max_depth: int,
                 rr_start_depth: int, F_cap: int):
    """One v1 cycle over the pool [V1_PORT_ROWS, C] (the JAX package's
    ``portal_cycle``, ``render/portal.py:54-162``):

    1. K8 ``trace_cheap_blocked``: cheap bounces until each lane is dead or
       frozen at the portal;
    2. a stable partition putting the alive (frozen) lanes first: one
       gather of the pool's columns;
    3. K7 ``trace_resolve`` on the first F_cap lanes: one full-scene bounce
       (trailing dead lanes there are inert);
    4. retire: every dead occupied slot (pix >= 0) adds its acc into accum
       [npix, 3] and one into counts [npix] at its pixel, then pix := -1;
    5. refill: free slot of rank r takes pass-local sample id issued + r
       while it is below ``limit``: pixel id % npix, global sample
       ``sample_base + id // npix``, a camera ray from the kernels' camera
       sampling (``make_raygen``, the rays K2 and K4 make) drawn at depth 0.

    Every kernel draws under (seed, pixel, sample, depth), so a path's
    random numbers do not depend on the cycle. accum and counts are
    updated in place. Returns (pool', issued', retired this cycle,
    segments traced), the last three as scalar tensors."""
    pool, c1 = trace_cheap_blocked(pc, pool, seed=seed, max_depth=max_depth,
                                   rr_start_depth=rr_start_depth)
    perm = torch.argsort((pool[ROW_ALIVE] <= 0.0).to(torch.int32), stable=True)
    pool = pool[:, perm]
    front = pool[:, :F_cap]
    *state, c2 = trace_resolve(
        ks, front[pm.ROW_O:pm.ROW_O + 3], front[pm.ROW_D:pm.ROW_D + 3],
        front[pm.ROW_THR:pm.ROW_THR + 3], front[ROW_ACC:ROW_ACC + 3],
        front[ROW_ALIVE:ROW_ALIVE + 1], front[ROW_PREV:ROW_PREV + 1],
        front[pm.ROW_DEPTH:pm.ROW_DEPTH + 1],
        pixel_idx=front[ROW_PIX].to(torch.int32),
        sample_idx=front[V1_ROW_SAMPLE].to(torch.int32), seed=seed,
        max_depth=max_depth, rr_start_depth=rr_start_depth)
    pool[:ROW_PIX, :F_cap] = torch.cat(state)

    pix_row = pool[ROW_PIX]
    dead = (pool[ROW_ALIVE] <= 0.0) & (pix_row >= 0.0)
    pix_i = torch.clamp(pix_row.to(torch.int64), 0, npix - 1)
    accum.index_add_(0, pix_i, torch.where(
        dead[None], pool[ROW_ACC:ROW_ACC + 3], 0.0).T)
    deadf = dead.to(F32)
    counts.index_add_(0, pix_i, deadf)
    pool[ROW_PIX] = torch.where(dead, -1.0, pix_row)

    free = pool[ROW_PIX] < 0.0
    sid = issued + torch.cumsum(free.to(torch.int64), 0) - 1
    can = free & (sid < limit)
    pixel = torch.remainder(sid, npix)
    samp = sample_base + torch.div(sid, npix, rounding_mode="floor")
    raygen, lc = make_raygen(cam, pixel)
    d0 = raygen(samp, *path_uniforms(seed, pixel, samp,
                                     torch.zeros_like(samp), (4, 5)))
    fresh = {pm.ROW_THR: 1.0, ROW_ACC: 0.0}
    for k in range(3):
        pool[pm.ROW_O + k] = torch.where(can, lc[k], pool[pm.ROW_O + k])
        pool[pm.ROW_D + k] = torch.where(can, d0[k], pool[pm.ROW_D + k])
        for r, v in fresh.items():
            pool[r + k] = torch.where(can, v, pool[r + k])
    for r, v in ((ROW_ALIVE, 1.0), (ROW_PREV, -1.0), (pm.ROW_DEPTH, 0.0),
                 (ROW_PIX, pixel.to(F32)), (V1_ROW_SAMPLE, samp.to(F32))):
        pool[r] = torch.where(can, v, pool[r])
    issued = issued + can.sum()
    rays = c1.sum(dtype=torch.int64) + c2.sum().to(torch.int64)
    return pool, issued, dead.sum(), rays


def make_portal_pass_runner(pc, cam, ks, *, npix: int, k_full: int,
                            seed: int, max_depth: int = 12,
                            rr_start_depth: int = 5, device="cpu"):
    """The v1 portal pass runner (the JAX package's
    ``make_portal_pass_runner``, ``render/portal.py:165-221``):
    ``runner(accum, pass_idx, k_pass)`` pushes npix * k_pass fresh samples
    (global indices pass_idx * k_full ..) through a pool of
    C = max(min(DEFAULT_POOL, npix * min(k_full, 4) rounded to CHEAP_BLOCK),
    CHEAP_BLOCK) slots, K7 resolving F_cap = C / 2 (rounded to
    RESOLVE_BLOCK) lanes a cycle, until every sample retired; adds the
    radiance into accum [npix, 3] (pixel order) and returns (accum,
    segments traced).

    The host reads the retired count every CHECK_EVERY cycles; more
    than 64 + total * (max_depth + 2) * 4 / C cycles raise RuntimeError (a
    stalled scheduler). A pass retires every sample once: the pass's
    per-pixel counts (``.last_counts``) must equal k_pass, else
    RuntimeError. v1 has no poll hook: it cancels and checkpoints only at
    pass boundaries."""
    C = max(min(DEFAULT_POOL, _round_block(npix * min(k_full, 4))),
            CHEAP_BLOCK)
    F_cap = max(RESOLVE_BLOCK, _round_resolve(C // 2))
    device = torch.device(device)

    def pass_runner(accum, pass_idx, k_pass):
        total = npix * k_pass
        pool = torch.zeros((V1_PORT_ROWS, C), dtype=F32, device=device)
        pool[ROW_PIX] = -1.0
        counts = torch.zeros(npix, dtype=F32, device=device)
        issued = torch.zeros((), dtype=torch.int64, device=device)
        retired = torch.zeros((), dtype=torch.int64, device=device)
        rays = torch.zeros((), dtype=torch.int64, device=device)
        cycles = 0
        hard_limit = 64 + (total * (max_depth + 2) * 4) // C
        while True:
            for _ in range(CHECK_EVERY):
                pool, issued, r, c = portal_cycle(
                    pool, accum, counts, issued, limit=total,
                    sample_base=pass_idx * k_full, pc=pc, cam=cam, ks=ks,
                    seed=seed, npix=npix, max_depth=max_depth,
                    rr_start_depth=rr_start_depth, F_cap=F_cap)
                retired = retired + r
                rays = rays + c
                cycles += 1
            pass_runner.total_polls += 1
            done = int(retired)
            if done >= total:
                break
            if cycles > hard_limit:
                raise RuntimeError(
                    f"portal scheduler stalled: {done}/{total} samples "
                    f"retired after {cycles} cycles")
        pass_runner.total_cycles += cycles
        pass_runner.last_counts = counts
        if done != total or not bool((counts == k_pass).all()):
            raise RuntimeError(
                f"portal v1 pass retired {done} of {total} samples with "
                f"per-pixel counts in [{float(counts.min())}, "
                f"{float(counts.max())}], want {k_pass}")
        return accum, rays

    pass_runner.last_cancelled = False  # v1 cancels only between passes
    pass_runner.last_partial_counts = None
    pass_runner.last_counts = None
    pass_runner.total_cycles = 0  # cycles and polls over every pass
    pass_runner.total_polls = 0
    pass_runner.total_slots = npix
    pass_runner.slot_layout = "v1"  # no mid-pass checkpoint resumes into v1
    pass_runner.pool_width, pass_runner.resolve_width = C, F_cap
    return pass_runner
