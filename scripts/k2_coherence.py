#!/usr/bin/env python3
"""How much of K2's lane time its warps spend on steps a slot needs: the
coherence model of the portal cheap kernel, measured with the plain
versions.

Runs the v2 cycle as chip_smoke.py's phase 3 does (mesh, park depth 3,
step cap 64, seed 7, quota 256): K2 and K3 through their plain versions,
``--cycles`` cycles of a fresh pool. For every cycle it takes each slot's
runnable steps (``trace_cheap_regen_plain``'s ``work["slot_steps"]``: the
steps a thread that owns the slot executes) and prints

  1. their 10/25/50/75/90th percentiles, the share of slots that run the
     whole budget, and the share of steps that process a segment;
  2. the share of lane-steps that do work under three schedules, in warps
     of 32 lanes:
     - one thread a slot (the parent kernel): a warp of 32 consecutive
       slots runs as long as its slowest slot;
     - a persistent grid of ``resident`` lanes whose warps refill a lane
       whose slot stopped at once (K2_REFILL_MIN 1), taking slots in order
       from a global counter;
     - the same grid refilling only when at least R of a warp's 32 lanes
       are idle (K2_REFILL_MIN R);
     and for the persistent schedules the refills a warp-step (a refill is
     a divergent load and store of the taken slots' 59 rows), the slots a
     refill takes, and the share of the whole grid's lane-steps that do
     work until the last warp ends (the tail included).

Everything counts steps, not time: a refill and the tail cost time that
the lane share does not show. Runs on the CPU at a small size and on a card
at the full one (plain versions on CUDA tensors; the resident lanes are
then the card's, from ``cheap_regen_config``; on the CPU a grid with
``--slots-per-lane`` slots a lane, near the full-size ratio):

  python3 scripts/k2_coherence.py --res 128x96 --device cpu
  python3 scripts/k2_coherence.py --res 1024x768 --device cuda
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from path_tracer_tpu_torch.ops.kernels import portal as pk  # noqa: E402

PARK_K, STEP_CAP, SEED, MAX_DEPTH, QUOTA = 3, 64, 7, 12, 256
WARP = 32
REFILL_MINS = (1, 4, 8, 16, 32)


def cycle_steps(scene, res, dev, cycles: int):
    """[(slot_steps [n], processed counts [n], budget)] of K2 on each of
    ``cycles`` cycles of a fresh drive, from the plain versions."""
    from path_tracer_tpu_torch.render import portal as rp
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    prep = prepare_render(scene, res, dev)
    npix = res.num_pixels
    pool = rp.make_pool_v2(npix, rp._round_block(npix), QUOTA, park_k=PARK_K,
                           device=dev)
    cheap = dict(seed=SEED, quota=QUOTA, sample_base=0, step_cap=STEP_CAP,
                 park_k=PARK_K, max_depth=MAX_DEPTH)
    budget = pk.cheap_steps(QUOTA, STEP_CAP, MAX_DEPTH)
    out = []
    for _ in range(cycles):
        work: dict = {}
        pool, counts = pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool,
                                                  work=work, **cheap)
        out.append((work["slot_steps"], counts, budget))
        pool = pk.trace_resolve_pool_plain(
            prep.kscene, pool, seed=SEED, parts=PARK_K + 1, park_k=PARK_K,
            max_depth=MAX_DEPTH)[0]
    return prep, out


def thread_per_slot(steps: torch.Tensor) -> dict:
    """One thread a slot: warps of 32 consecutive slots, each running as
    long as its slowest."""
    n = steps.numel()
    pad = torch.zeros((-n) % WARP, dtype=steps.dtype, device=steps.device)
    per_warp = torch.cat([steps, pad]).view(-1, WARP).amax(dim=1)
    warp_steps = int(per_warp.sum())
    return {"lane_share": int(steps.sum()) / max(WARP * warp_steps, 1),
            "warp_steps": warp_steps}


def persistent(steps: torch.Tensor, resident: int, refill_min: int) -> dict:
    """A persistent grid of ``resident`` lanes (warps of 32) over slots
    with ``steps`` steps each, as csrc/portal_cheap.cu schedules them: lane
    l of warp w starts on slot 32w + l; then, before each step, every warp
    with at least ``refill_min`` idle lanes takes as many slots from the
    counter (in slot order, warps in turn) and takes again while slots that
    take no step leave lanes idle; a warp steps its busy lanes once."""
    dev = steps.device
    n = steps.numel()
    warps = max(1, min(resident, n + WARP - 1) // WARP)
    lanes = warps * WARP
    idx = torch.arange(lanes, device=dev).view(warps, WARP)
    rem = torch.where(idx < n, steps[idx.clamp(max=n - 1)], 0)
    nxt = lanes
    warp_steps = grid_steps = refills = refill_slots = 0
    while True:
        while nxt < n:
            idle = rem == 0
            k = idle.sum(dim=1)
            want = k >= refill_min
            if not bool(want.any()):
                break
            cnt = torch.where(want, k, 0)
            off = torch.cumsum(cnt, 0) - cnt + nxt
            slot = off[:, None] + torch.cumsum(idle, dim=1) - 1
            take = idle & want[:, None] & (slot < n)
            rem = torch.where(take, steps[slot.clamp(max=n - 1)], rem)
            refills += int(want.sum())
            refill_slots += int(take.sum())
            nxt += int(cnt.sum())
        busy = rem > 0
        alive = int(busy.any(dim=1).sum())
        if alive == 0:
            break
        warp_steps += alive
        grid_steps += 1
        rem = rem - busy.to(rem.dtype)
    total = int(steps.sum())
    return {"lane_share": total / max(WARP * warp_steps, 1),
            "grid_share": total / max(lanes * grid_steps, 1),
            "refills_per_warp_step": refills / max(warp_steps, 1),
            "slots_per_refill": refill_slots / max(refills, 1),
            "warp_steps": warp_steps, "grid_steps": grid_steps,
            "resident_lanes": lanes}


def coherence(steps: torch.Tensor, counts: torch.Tensor, budget: int,
              resident: int, refill_mins=REFILL_MINS) -> dict:
    """The model's numbers for one K2 call (see the module doc)."""
    s = steps.to(torch.int64)
    q = torch.quantile(s.to(torch.float64),
                       torch.tensor([0.1, 0.25, 0.5, 0.75, 0.9],
                                    dtype=torch.float64, device=s.device))
    out = {
        "slots": s.numel(), "budget": budget,
        "steps_p10_25_50_75_90": [float(x) for x in q],
        "mean_steps": float(s.to(torch.float64).mean()),
        "share_at_budget": float((s == budget).to(torch.float64).mean()),
        "share_of_steps_processing": int(counts.sum()) / max(int(s.sum()), 1),
        "thread_per_slot": thread_per_slot(s),
    }
    for r in refill_mins:
        out[f"persistent_refill_{r}"] = persistent(s, resident, r)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="128x96", help="WIDTHxHEIGHT")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--cycles", type=int, default=6)
    ap.add_argument("--slots-per-lane", type=float, default=6.0,
                    help="CPU only: resident lanes = slots / this")
    args = ap.parse_args()
    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.utils.config import Resolution

    w, h = (int(x) for x in args.res.split("x"))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("k2_coherence: no CUDA device", file=sys.stderr)
        return 1
    scene = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    prep, calls = cycle_steps(scene, Resolution(h, w), dev, args.cycles)
    n = calls[0][0].numel()
    if dev.type == "cuda":
        cfg = pk.cheap_regen_config(prep.portal, PARK_K)
        resident = cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"]
        where = f"{torch.cuda.get_device_name(dev)}, {cfg}"
    else:
        resident = int(n / args.slots_per_lane) // WARP * WARP
        where = f"cpu, {args.slots_per_lane} slots a lane"
    res = {"res": args.res, "device": where, "resident_lanes": resident,
           "cycles": [coherence(s, c, b, resident) for s, c, b in calls]}
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
