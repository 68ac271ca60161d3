"""The portal scheduler: a pool of mesh paths cycled through the portal
kernels, the counterpart of the JAX package's ``render.portal`` (its v2
scheduler).

Slot i of a pixel-pinned pool owns pixel ``pix`` row i; each cycle runs

    K2 trace_cheap_regen  (cheap bounces, in-kernel regeneration, portal
                           freeze, parking; at most step_cap steps a slot)
    K3 trace_resolve_pool (one full-scene bounce of the active path and every
                           frozen parked path, retire/park bookkeeping)

and the host polls the unfinished-slot count every few cycles. As the pass
drains, the unfinished tail is compacted down a ladder of narrower pools
(``TAIL_LADDER``), and finished slots adopt the upper half of laggards'
remaining sample ranges (``redistribute_samples``). At pass end every
stage's acc rows add into the framebuffer keyed by their pix row; per-pixel
sample counts are exact by construction. ``PortalPasses`` runs a render's
passes and keeps K3's counters.

Not ported, each for its reason (ROADMAP.md, Slice 2 crosswalk):
the v1 scheduler (``portal_cycle``, ``make_portal_pass_runner``) and the
glue resolve (K7 and torch around it), which this scheduler beat or tied
wherever they were measured on the card (their kernels K8 and K7 stay,
with no route);
``portal_cycles_v2`` (fusing cycles into one dispatch amortised a ~1.75 ms
remote-TPU dispatch), narrow resolves (``PT_TPU_NARROW_BUFS``), the
resolve-lane sorts (``sort_lanes``, ``_tile_slab_masks``,
``_resolve_sort_order``, ``_counting_positions``: measured dead),
``freeze_pixel_order`` (measured neutral) and ``make_pool_v2``'s slot-order
option (no render passes one); the sharded runner's ``flush_pix`` and
``pix_offset`` arguments wait for the sharded scheduler (Slice 4).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from path_tracer_tpu_torch.ops.kernels import portal as pm
from path_tracer_tpu_torch.ops.kernels.portal import (
    BUF_STATE, ROW_ACC, ROW_ALIVE, ROW_PREV, V2_ROW_DONE, V2_ROW_PIX,
    V2_ROW_QUOTA, V3_ROW_STARTED, buf_row, port_rows, trace_cheap_regen,
    trace_resolve_pool,
)
from path_tracer_tpu_torch.render import drive
from path_tracer_tpu_torch.utils import profiling

F32 = torch.float32
CHEAP_BLOCK = 2048  # pool widths are multiples of this

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


def portal_resolve_phase(pool, ks, *, seed: int, park_k: int, max_depth: int,
                         rr_start_depth: int, uniforms=None, group_items=None):
    """The resolve half of a cycle: K3 (``trace_resolve_pool``) over the
    active path and every parked buffer, drawing from injected ``uniforms``
    ([4, (park_k + 1) * n]) where given, and adding the items it traces
    with a group of lanes to ``group_items`` where given. Returns (pool',
    segments traced, unfinished slots), the last two as scalar tensors on
    the pool's device."""
    pool, counts = trace_resolve_pool(
        ks, pool, seed=seed, parts=park_k + 1, park_k=park_k,
        max_depth=max_depth, rr_start_depth=rr_start_depth, uniforms=uniforms,
        group_items=group_items)
    return pool, counts.sum(dtype=torch.int64), _unfinished(pool)


def resolve_table(ks, device) -> str:
    """Where K3 reads the compact hit table of ``ks`` from: ``"shared"``
    (staged in a block's shared memory) or ``"global"`` (the read-only
    path from device memory), as ``resolve_pool_config`` decides on the
    current card; ``"plain"`` off the card, where the plain version runs."""
    if torch.device(device).type != "cuda":
        return "plain"
    return "shared" if pm.resolve_pool_config(ks)["shared_table"] else "global"


def resolve_group(ks, device) -> str:
    """The lanes K3 traces an item whose line enters a tile with on the
    current card (``resolve_pool_config``'s ``group``: the build's K3_GROUP
    where the tiles of ``ks`` outnumber the key, else 1); ``"plain"`` off
    the card."""
    if torch.device(device).type != "cuda":
        return "plain"
    return str(pm.resolve_pool_config(ks)["group"])


def portal_cycle_v2(pool, pc, cam, ks, *, quota: int, sample_base: int,
                    seed: int, step_cap: int, park_k: int, max_depth: int,
                    rr_start_depth: int, group_items=None):
    """One cycle: K2 until every slot is frozen (parked park_k deep), out of
    samples or step-capped, then the resolve phase (K3). A capped but
    unfrozen path just has its next segment traced by the full scene
    (which contains the cheap scene).
    Returns (pool', segments traced, unfinished slots): the segments an
    int64 [2] tensor, K2's and K3's, the slots a scalar tensor."""
    pool, c1 = trace_cheap_regen(
        pc, cam, pool, seed=seed, quota=quota, sample_base=sample_base,
        step_cap=step_cap, park_k=park_k, max_depth=max_depth,
        rr_start_depth=rr_start_depth)
    pool, c2, unfin = portal_resolve_phase(
        pool, ks, seed=seed, park_k=park_k, max_depth=max_depth,
        rr_start_depth=rr_start_depth, group_items=group_items)
    return pool, torch.stack([c1.sum(dtype=torch.int64), c2]), unfin


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


def _retired_counts(stages, flush, *, out_rows: int, device):
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
                 *, device):
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


def _pool_from_rows(pix, done, quota, *, n_pad: int, park_k: int, device):
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


def _stall_limits(k_pass, max_depth):
    """(stall_limit polls, hard_limit cycles), the drive's two runaway
    backstops; both scale with the quota (no slot retires until deep into
    a big pass)."""
    return 20 * max(1, k_pass // 64), 256 + 4 * k_pass * (max_depth + 4)


def drive_pool_v2(pool, k_pass: int, sample_base: int, *, pc, cam, ks,
                  seed: int, max_depth: int, rr_start_depth: int,
                  check_every: int = 4, ladder=TAIL_LADDER, park_k: int,
                  adaptive_polls: bool = True, on_check=None, cycle0: int = 0,
                  npix: int | None = None, cnt_base=None,
                  group_items=None):
    """Cycle a pixel-pinned pool until every slot retires its quota,
    compacting the unfinished tail down the width ``ladder`` as it shrinks
    and redistributing samples when no rung fits.

    Returns the drive.DriveResult: its stages (the original pool and one per
    compaction) and its redistribution flush, merged by merge_stages,
    reconstruct the retired radiance exactly; its rays are the segments
    traced as portal_cycle_v2 counts them, [K2's, K3's].
    ``on_check(cycle, width, unfin[, snapshot])`` is the poll hook (see
    render.drive); ``group_items`` goes to every K3 launch
    (``portal_resolve_phase``)."""
    step_cap = STEP_CAP
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
                group_items=group_items)
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
        with profiling.span("portal.merge.wait"):  # the masks' sizes sync
            accum.index_add_(0, pix[keep], st[ROW_ACC:ROW_ACC + 3].T[keep])
    return accum


def is_mid_pass(ck) -> bool:
    """Does the checkpoint ``ck`` (an ``np.load`` of its file) resume into
    a pass, from a portal pass's pause?"""
    return "mid_pass" in ck.files and bool(int(ck["mid_pass"]))


class PortalPasses:
    """The portal route's pass runner: ``runner(accum, pass_idx, k_pass)``
    gives every pixel slot a quota of k_pass samples (global indices
    pass_idx * k_full ..), cycles the pool until every slot retires its
    quota, adds the retired radiance into accum [npix, 3] (pixel order)
    and returns (accum, segments traced), the segments an int64 [2]
    tensor: K2's and K3's.

    The runner keeps K3's counters: its segments and the live items it
    traced with a group of lanes (``group_items``, an int32 [1] tensor on
    the device that every launch adds to). ``segments`` reads both with
    the passes' counts in one transfer; ``checkpoint_fields`` and
    ``resume`` carry them through a checkpoint; ``report`` puts them, the
    cycles and polls into a render's stats and notes.

    ``hooks(on_check, on_pause)`` holds the poll hooks while the passes run.
    on_check(cycle, width, unfin[, snapshot]): falsy continues; "pause" asks
    for a mid-pass checkpoint; any other truthy value cancels. Both stop
    by freeze-and-drain (render.drive), so every started sample retires and
    merges exactly:

    - cancel: ``.last_partial_counts`` holds the exact per-pixel retired
      counts [npix] of the pass (None after a pass that ran to its end);
    - pause: on_pause(accum, pass_idx, fields) persists a checkpoint, with
      ``fields`` the remaining per-slot sample ranges and the cycle count,
      and the pass goes on from the thawed pool.

    ``resume`` of such a file makes the next call continue exactly those
    per-slot ranges (``.resume_slots`` (pix, done, quota), from cycle
    ``.resume_cycle0``)."""

    slot_layout = "single"  # a mid-pass file's slot rows: one pool
    # K3's counters, in the order every checkpoint keeps them (the lane
    # routes write them as 0)
    COUNTERS = ("resolve_segments", "resolve_group_items")

    def __init__(self, pc, cam, ks, *, npix: int, k_full: int, seed: int,
                 max_depth: int = 12, rr_start_depth: int = 5, device):
        self.pc, self.cam, self.ks = pc, cam, ks
        self.rows = self.npix = npix  # accum rows: pixels, in pixel order
        self.k = k_full
        self.seed, self.max_depth = seed, max_depth
        self.rr_start_depth = rr_start_depth
        self.device = torch.device(device)
        self.on_check = self.on_pause = None
        self.last_partial_counts = None
        self.resume_slots = self.resume_cycle0 = None
        self.total_cycles = self.total_polls = 0  # over every pass
        # where the last pass's K3 read its rows (``resolve_table``) and
        # the lanes it traced a tile-entering item with (``resolve_group``)
        self.resolve_table = self.resolve_group = None
        self.group_items = torch.zeros(1, dtype=torch.int32, device=self.device)
        # K3's segments, a share of the render's, and its group items; None
        # once a resume from a file without one leaves its count unknown
        self.resolve_segments: int | None = 0
        self.resolve_group_items: int | None = 0

    @contextlib.contextmanager
    def hooks(self, on_check=None, on_pause=None):
        """The poll hooks of the passes run inside the block, dropped when
        it ends: a caller's hooks may hold the runner, and kept they would
        make a reference cycle of it."""
        self.on_check, self.on_pause = on_check, on_pause
        try:
            yield
        finally:
            self.on_check = self.on_pause = None

    def __call__(self, accum, pass_idx, k_pass):
        self.last_partial_counts = None
        sample_base = pass_idx * self.k
        park_k = pm.PARK_K  # read at call time: tests lower it
        device = self.device

        resume, self.resume_slots = self.resume_slots, None
        cycle0 = int(self.resume_cycle0 or 0) if resume is not None else 0
        self.resume_cycle0 = None
        if resume is not None:
            pix_r, done_r, quota_r = (np.asarray(a) for a in resume)
            pool = _pool_from_rows(pix_r, done_r, quota_r,
                                   n_pad=_round_block(len(pix_r)),
                                   park_k=park_k, device=device)
        else:
            pool = make_pool_v2(self.npix, _round_block(self.npix), k_pass,
                                park_k=park_k, device=device)

        self.resolve_table = resolve_table(self.ks, device)
        self.resolve_group = resolve_group(self.ks, device)
        rays = torch.zeros(2, dtype=torch.int64, device=device)
        cnt_pass = None  # retired counts of stages merged at pauses
        while True:
            res = drive_pool_v2(
                pool, k_pass, sample_base, pc=self.pc, cam=self.cam,
                ks=self.ks, seed=self.seed, max_depth=self.max_depth,
                rr_start_depth=self.rr_start_depth, check_every=CHECK_EVERY,
                park_k=park_k,
                # poll batching is remote-device economics; on the CPU a
                # burst of cycles only hides the polls
                adaptive_polls=device.type == "cuda",
                on_check=self.on_check, cycle0=cycle0, npix=self.npix,
                cnt_base=cnt_pass, group_items=self.group_items,
            )
            rays = rays + res.rays
            self.total_cycles += res.cycles - cycle0
            self.total_polls += res.polls
            with profiling.span("portal.merge"):
                merge_stages(accum, res.stages, res.flush)
                if res.outcome == drive.DONE:
                    return accum, rays
                if res.outcome == drive.CANCEL:
                    _, cnt = _snapshot_stages(
                        tuple(res.stages), res.flush,
                        out_rows=max(self.npix, res.stages[0].shape[1]))
                    if cnt_pass is not None:
                        cnt[:self.npix] += cnt_pass[:self.npix]
                    self.last_partial_counts = cnt[:self.npix]
                    return accum, rays
                # PAUSE: the radiance is merged; persist the slot rows and go on
                live = res.stages[-1]
                delta = _retired_counts(
                    tuple(res.stages[:-1]), res.flush,
                    out_rows=max(self.npix, live.shape[1]),
                    device=live.device)[:self.npix]
                cnt_pass = delta if cnt_pass is None else cnt_pass + delta
                if self.on_pause is not None:
                    pix, done, quota = drive.drained_slot_state(
                        live, res.frozen_quota)
                    self.on_pause(accum, pass_idx, dict(
                        mid_pass=1, cycle0=int(res.cycles),
                        slot_layout=self.slot_layout, slot_pix=pix,
                        slot_done=done, slot_quota=quota))
                pool = drive.thaw_pool(live, res.frozen_quota, park_k=park_k)
                cycle0 = res.cycles

    def segments(self, rays: list) -> int:
        """The segments of the passes' ``rays`` (their [2] tensors), K2's
        and K3's, read in one transfer with the items K3 traced with a
        group of lanes since the last call, whose counter restarts; K3's
        two counts go to ``resolve_segments`` and ``resolve_group_items``."""
        cheap, resolve, group = torch.cat([
            torch.stack(rays).sum(0), self.group_items.to(torch.int64)]).tolist()
        self.group_items.zero_()
        if self.resolve_segments is not None:
            self.resolve_segments += resolve
        if self.resolve_group_items is not None:
            self.resolve_group_items += group
        return cheap + resolve

    def checkpoint_fields(self) -> dict:
        """K3's counters as a checkpoint keeps them, -1 for one unknown."""
        counts = {name: getattr(self, name) for name in self.COUNTERS}
        return {name: -1 if got is None else got for name, got in counts.items()}

    def resume_mismatches(self, ck) -> list[str]:
        """Why the checkpoint ``ck`` cannot resume on this runner, if it
        cannot: a mid-pass file of another slot layout."""
        if not is_mid_pass(ck):
            return []
        got = str(ck["slot_layout"]) if "slot_layout" in ck.files else "single"
        return [] if got == self.slot_layout else [
            f"slot layout {got} != {self.slot_layout}"]

    def resume(self, ck) -> None:
        """Take up K3's counters from the checkpoint ``ck`` (None for one
        the file lacks) and, from a mid-pass file, the slot rows and cycle
        count that the next call continues: every remaining sample id
        renders exactly once."""
        for name in self.COUNTERS:
            got = int(ck[name]) if name in ck.files else -1
            setattr(self, name, got if got >= 0 else None)
        if is_mid_pass(ck):
            self.resume_slots = (ck["slot_pix"], ck["slot_done"],
                                 ck["slot_quota"])
            self.resume_cycle0 = int(ck["cycle0"])

    def unpermute(self, img: torch.Tensor) -> torch.Tensor:
        """``img`` in pixel order: accum's rows are in it already."""
        return img

    def report(self, stats) -> None:
        """The render's counts into ``stats`` (a RenderStats): cycles and
        polls; K3's segments and where it read its rows, and its group
        items, each while every pass of the render is counted, also as the
        ``render.resolve`` and ``render.resolve.group`` notes; two
        dispatches a cycle, K2 and K3."""
        stats.extra.update(cycles=self.total_cycles, polls=self.total_polls)
        if self.resolve_table is not None and self.resolve_segments is not None:
            stats.extra.update(resolve_segments=self.resolve_segments,
                               resolve_table=self.resolve_table)
            profiling.note("render.resolve", self.resolve_segments,
                           self.resolve_table)
            if self.resolve_group_items is not None:
                stats.extra["resolve_group_items"] = self.resolve_group_items
                profiling.note("render.resolve.group",
                               self.resolve_group_items, self.resolve_group)
        stats.num_dispatches = 2 * self.total_cycles


# the name render() builds the portal route's runner by
# (``pipeline.make_pass_runner``), where bench_torch's fault check wraps it
make_portal_pass_runner_v2 = PortalPasses
