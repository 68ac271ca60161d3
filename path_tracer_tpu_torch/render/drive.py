"""Shared drive loop for portal pool scheduling.

Counterpart of ``path_tracer_tpu.render.drive``, in plain torch. The control
loop cycles a pool (``render.portal`` supplies how a cycle runs, how the
unfinished count is read and how a tail compacts): poll batching tiers, the
first-poll futility skip, stall and hard runaway backstops, the
tail-compaction ladder walk, the mid-pass redistribution trigger, the
progress/cancel hook with its optional ``snapshot`` callable, and the
freeze-and-drain protocol.

Freeze-and-drain: when the poll hook asks to stop, the drive does not
discard the pass. It freezes issuance (per-slot quota := samples already
started), keeps cycling until every started sample retires (in-flight paths
have at most max_depth bounces left), and returns exact per-slot retired
state. A cancelled render keeps every started sample, and a checkpoint
written at a poll boundary is exact: the remaining per-slot sample ranges
are [done, quota), resumable through ``thaw_pool``.

The poll batching tiers are the JAX package's, tuned for a ~25 ms round
trip to a remote TPU; they are kept as they are until they are measured on
the card.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

import torch

from path_tracer_tpu_torch.ops.kernels.portal import (
    ROW_ALIVE, ROW_PREV, V2_ROW_DONE, V2_ROW_PIX, V2_ROW_QUOTA, V3_ROW_STARTED,
)

#: outcome values of a drive
DONE = "done"
CANCEL = "cancel"
PAUSE = "pause"


@dataclasses.dataclass
class DriveResult:
    """What a drive returns. ``stages`` always ends with the final pool;
    summing every stage's acc rows keyed by V2_ROW_PIX (plus the flush)
    reconstructs the retired radiance exactly. ``outcome`` is DONE, or
    CANCEL/PAUSE after a freeze-and-drain. ``frozen_quota`` is the final
    pool's pre-freeze quota row (positionally aligned: compaction is off
    while draining), None unless a freeze happened."""

    stages: list
    rays: Any
    flush: Any | None
    outcome: str
    cycles: int
    frozen_quota: Any | None = None
    polls: int = 0  # termination polls (host syncs) the drive made


def freeze_issuance(pool: torch.Tensor, *, park_k: int) -> torch.Tensor:
    """Stop sample issuance: per-slot quota := samples already started.
    Without park buffers there is no started row, and the one possible
    in-flight sample is visible as ROW_ALIVE: it counts as started."""
    if park_k:
        started = pool[V3_ROW_STARTED]
    else:
        started = pool[V2_ROW_DONE] + (pool[ROW_ALIVE] > 0.0).to(pool.dtype)
    pool = pool.clone()
    pool[V2_ROW_QUOTA] = torch.minimum(pool[V2_ROW_QUOTA], started)
    return pool


def thaw_pool(pool: torch.Tensor, frozen_quota, *, park_k: int) -> torch.Tensor:
    """Rebuild a drained pool to continue its unfinished sample ranges: keep
    (pix, done) per slot, restore the pre-freeze quota, zero everything else
    (radiance was merged by the caller; path state and park buffers are
    empty after a drain). started := done."""
    new = torch.zeros_like(pool)
    new[V2_ROW_PIX] = pool[V2_ROW_PIX]
    new[V2_ROW_DONE] = pool[V2_ROW_DONE]
    new[V2_ROW_QUOTA] = torch.as_tensor(frozen_quota, dtype=pool.dtype,
                                        device=pool.device)
    new[ROW_PREV] = -1.0
    if park_k:
        new[V3_ROW_STARTED] = pool[V2_ROW_DONE]
    return new


def hook_wants_snapshot(on_check) -> bool:
    """Does the poll hook take mid-pass partial images (a ``snapshot``
    keyword or **kwargs in its signature)?"""
    if on_check is None:
        return False
    params = inspect.signature(on_check).parameters
    return "snapshot" in params or any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


def poll_steps(w: int, *, k_pass: int, check_every: int, first: bool,
               step_cap: int, park_k: int, max_depth: int,
               batch_polls: bool) -> int:
    """Cycles to run before the next termination poll: small pools batch
    more cycles per poll; the first window also skips the provably futile
    region (a slot's done count rises by at most step_cap + park_k + 1 per
    cycle), capped so the hook still fires early."""
    if not batch_polls:
        return check_every
    if w >= 131072:
        steps = (2 if k_pass >= 256 else 1) * check_every
    elif w >= 16384:
        steps = 2 * check_every
    elif w > 2048:
        steps = 4 * check_every
    else:
        steps = 8 * check_every
    if first:
        per_cycle = (step_cap if step_cap else k_pass * max_depth) + park_k + 1
        steps = max(steps, min(k_pass // max(per_cycle, 1), 16 * check_every))
    return steps


def drive_loop(
    pool,
    *,
    run_cycles: Callable,
    poll: Callable,
    compact_fn: Callable,
    redistribute_fn: Callable | None = None,
    new_flush: Callable | None = None,
    snapshot_fn: Callable | None = None,
    k_pass: int,
    max_depth: int,
    step_cap: int,
    park_k: int,
    check_every: int = 4,
    batch_polls: bool = True,
    stall_limit: int,
    hard_limit: int,
    on_check: Callable | None = None,
    cycle0: int = 0,
) -> DriveResult:
    """Cycle a pool until every slot retires its quota (or a hook stops the
    pass), compacting the unfinished tail and re-tasking idle slots.

    run_cycles(pool, cycle_idx, steps) -> (pool, rays_delta, unfin_raw);
    poll(unfin_raw) -> (u_total, u_ladder) host ints; compact_fn(pool, u) ->
    None | (retired_stage, smaller_pool); redistribute_fn(pool, flush) ->
    (pool, flush), with the flush made lazily by new_flush();
    snapshot_fn(stages, flush) -> (radiance, counts) for the hook.

    on_check(cycle, width, u[, snapshot=...]) fires after each poll: falsy
    continues; "pause" or any other truthy value stops the pass (PAUSE or
    CANCEL) by freeze-and-drain. With batch_polls one un-polled cycle batch
    stays queued beyond the one being polled, so the device never idles on
    a poll; the unfinished count never rises, so acting on a one-batch-old
    count is safe."""
    stages: list = []
    rays = 0
    flush = None
    cycle = cycle0
    draining: str | None = None
    frozen_quota = None
    stalled_polls = 0
    last_u = None
    wants_snapshot = hook_wants_snapshot(on_check)
    first_poll = True
    polls = 0
    inflight: list = []
    while True:
        want = 2 if (batch_polls and draining is None) else 1
        while len(inflight) < want:
            steps = poll_steps(
                pool.shape[1], k_pass=k_pass, check_every=check_every,
                first=first_poll, step_cap=step_cap, park_k=park_k,
                max_depth=max_depth, batch_polls=batch_polls,
            )
            first_poll = False
            pool, r, unfin_raw = run_cycles(pool, cycle, steps)
            rays = rays + r
            cycle += steps
            inflight.append(unfin_raw)
        u, u_ladder = poll(inflight.pop(0))
        polls += 1
        if draining is None and on_check is not None:
            kw = {}
            if wants_snapshot and snapshot_fn is not None:
                sts, fl = tuple(stages) + (pool,), flush
                kw["snapshot"] = lambda: snapshot_fn(sts, fl)
            verdict = on_check(cycle, pool.shape[1], u, **kw)
            # a stop verdict with nothing unfinished is moot
            if verdict and u > 0:
                draining = PAUSE if verdict == PAUSE else CANCEL
                frozen_quota = pool[V2_ROW_QUOTA].clone()
                pool = freeze_issuance(pool, park_k=park_k)
                stalled_polls, last_u = 0, None
                continue
        if u == 0:
            stages.append(pool)
            return DriveResult(stages, rays, flush, draining or DONE, cycle,
                               frozen_quota, polls)
        stalled_polls = stalled_polls + 1 if u == last_u else 0
        last_u = u
        if stalled_polls >= stall_limit or cycle - cycle0 > hard_limit:
            raise RuntimeError(
                f"portal scheduler stalled: {u} slots unfinished after "
                f"{cycle - cycle0} cycles ({stalled_polls} polls without "
                f"progress)")
        if draining is not None:
            continue  # no compaction while draining (frozen_quota aligned)
        moved = compact_fn(pool, u_ladder)
        if moved is not None:
            stage, pool = moved
            stages.append(stage)
        elif redistribute_fn is not None and pool.shape[1] - u >= max(
            2048, pool.shape[1] // 16
        ):
            if flush is None:
                flush = new_flush()
            pool, flush = redistribute_fn(pool, flush)


def drained_slot_state(pool, frozen_quota):
    """(pix, done, quota) numpy arrays of a drained pool: the checkpointable
    remainder of the pass, each slot's un-issued range [done, quota). All
    slots are kept, positionally."""
    rows = torch.stack([pool[V2_ROW_PIX], pool[V2_ROW_DONE],
                        torch.as_tensor(frozen_quota, device=pool.device)])
    rows = rows.cpu().numpy()
    return rows[0], rows[1], rows[2]
