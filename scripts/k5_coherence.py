#!/usr/bin/env python3
"""K5's lane model: how many of its lanes' steps do work on a cornell
preview frame, under one thread a ray (the kernel) and under the two
schedules that were measured against it, counted with the plain versions.

Traces one preview frame (cornell, 450x300 x ``--spp``, seed 7: the rays
K5's camera entry makes, ``trace_v2.trace_camera_plain``) in one 12-step
call and prints

  1. the distribution of the rays' path lengths (the plain counts);
  2. the rays a resident lane;
  3. the share of lane-steps that do work, in warps of 32 lanes, under
     - one thread a ray: a warp of 32 consecutive rays runs as long as its
       longest path (scripts/k2_coherence.py thread_per_slot);
     - a persistent grid of ``resident`` lanes that refills a lane as soon
       as its ray stops (scripts/k2_coherence.py persistent, refill at 1
       idle lane), and, with ``--schedule``, that grid replayed step by
       step with the plain step (``refill_call``: lanes take indices from
       their warp's reserve of ``--batch``, which a counter refills);
     - blocks of 128, 256 or 512 consecutive rays that pack their live
       rays to their first threads before each step (``compacted``).

``refill_call`` is also the plain model of that persistent schedule: it
traces the rays in the order the lanes take them (or any order of the ray
list), one step at a time at each ray's own depth, and its radiance and
counts equal the plain version's bit for bit (tests/test_torch_k5.py).

Everything counts steps, not time (PERF.md has the times). Runs on the CPU
at a small size and on a card at the full one (plain versions on CUDA
tensors; the resident lanes are then K5's, from
``trace_v2.stepped_static_config``; on the CPU ``--resident`` lanes, by
default as many rays a lane as the card's 135,168 lanes give the 2-spp
frame):

  python3 scripts/k5_coherence.py --res 150x100 --device cpu
  python3 scripts/k5_coherence.py --res 450x300 --device cuda
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_v2 as tv2  # noqa: E402

SEED, SPP, MAX_DEPTH, RR_START = 7, 2, 12, 5
WARP = 32
FULL_RAYS = 450 * 300 * SPP  # the 2-spp preview frame


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K2 = _script("k2_coherence")


def frame(scene, res, dev, spp: int = SPP):
    """(SceneConsts, camera arrays, pixel_idx, sample_idx) of one preview
    frame at ``res``: the rays of ProgressiveRenderer's first frame."""
    from path_tracer_tpu_torch.models.scene import pack_scene
    from path_tracer_tpu_torch.render.integrator import pass_rays
    from path_tracer_tpu_torch.render.raygen import camera_arrays

    sc = tv2.build_scene_consts(pack_scene(scene)).to(dev)
    pix, smp = pass_rays(torch.arange(res.num_pixels, dtype=torch.int32,
                                      device=dev), spp)
    return sc, camera_arrays(scene.camera), pix, smp


def camera_state(cam, pix, smp, *, seed, width, height):
    """The state [STATE_ROWS, N] and zero counts of the camera entry's rays
    before their first step (raygen.camera_rays; thr 1, radiance 0, alive,
    prev -1)."""
    from path_tracer_tpu_torch.render.raygen import camera_rays

    o, d = camera_rays(cam, pix, smp, seed=seed, width=width, height=height)
    n = pix.shape[0]
    state = torch.empty((tk.STATE_ROWS, n), dtype=torch.float32,
                        device=pix.device)
    state[tk.ROW_O:tk.ROW_O + 3] = o.T
    state[tk.ROW_D:tk.ROW_D + 3] = d.T
    state[tk.ROW_THR:tk.ROW_THR + 3] = 1.0
    state[tk.ROW_ACC:tk.ROW_ACC + 3] = 0.0
    state[tk.ROW_ALIVE] = 1.0
    state[tk.ROW_PREV] = -1.0
    return state, torch.zeros(n, dtype=torch.int32, device=pix.device)


def refill_call(scene, state, counts, pix, smp, *, seed, depth0, n_steps,
                lanes, batch=32, order=None, uniforms=None,
                max_depth=MAX_DEPTH, rr_start_depth=RR_START) -> dict:
    """One K5 call of ``n_steps`` steps over ``state`` [STATE_ROWS, N] and
    ``counts`` [N] (both updated in place), run as the persistent grid runs
    it: ``lanes`` lanes in warps of 32; lane L starts on list position L,
    then, each time its ray stops (dead, or n_steps taken), takes the next
    position from its warp's reserve of ``batch`` positions (0: just the
    ones its idle lanes need), which the warp refills from a counter, warps
    in turn; a ray dead on entry leaves its lane idle. ``order`` maps list
    positions to rays (default: position i is ray i). Each step traces the
    busy lanes' rays one bounce at their own depths with the plain step.
    Returns the schedule's counts: warp-steps and lane-steps that do
    work."""
    dev = state.device
    n = state.shape[1]
    ray_of = (torch.arange(n, device=dev) if order is None
              else order.to(dev)).cpu().numpy()
    isect = tv2.stepped_isect(scene)
    warps = max(1, -(-lanes // WARP))
    pos = np.arange(warps * WARP).reshape(warps, WARP)
    alive_row = state[tk.ROW_ALIVE].cpu().numpy() > 0.0
    ray = np.where(pos < n, ray_of[np.minimum(pos, n - 1)], -1)
    has = (ray >= 0) & alive_row[np.maximum(ray, 0)]
    taken = np.zeros((warps, WARP), np.int64)  # steps of the lane's ray
    wave = warps * WARP
    res = np.zeros(warps, np.int64)
    res_end = np.zeros(warps, np.int64)
    dry = np.full(warps, wave >= n)
    nxt = 0  # the counter
    warp_steps = lane_steps = 0
    while True:
        while True:  # the refill: every warp with idle lanes and rays left
            idle = ~has
            k = idle.sum(axis=1)
            act = (k > 0) & ((res < res_end) | ~dry)
            if not act.any():
                break
            avail = res_end - res
            short = act & (avail < k)
            fetch = short & ~dry
            take = np.where(fetch, batch if batch else k - avail, 0)
            b = wave + nxt + np.cumsum(take) - take
            nxt += int(take.sum())
            rank = np.cumsum(idle, axis=1) - 1
            i = res[:, None] + rank
            late = rank >= avail[:, None]
            i = np.where(fetch[:, None] & late, b[:, None] + rank - avail[:, None], i)
            i = np.where((short & ~fetch)[:, None] & late, n, i)
            got = idle & act[:, None] & (i < n)
            new_res_end = np.where(fetch, np.minimum(b + take, n), res_end)
            res = np.where(fetch, np.minimum(b + k - avail, new_res_end),
                           np.where(short, res_end, np.where(act, res + k, res)))
            res_end = new_res_end
            dry = dry | (fetch & (b + take >= n))
            new = ray_of[np.minimum(i, n - 1)]
            ray = np.where(got, new, ray)
            taken = np.where(got, 0, taken)
            has = has | (got & alive_row[np.where(got, new, 0)])
        busy = has
        if not busy.any():
            break
        warp_steps += int(busy.any(axis=1).sum())
        lane_steps += int(busy.sum())
        ids, depth = ray[busy], depth0 + taken[busy]
        for dep in np.unique(depth):
            sel = torch.from_numpy(ids[depth == dep]).to(dev)
            sub = state[:, sel]
            cnt = counts[sel]
            draw = tk.stepped_draw(seed, pix[sel], smp[sel],
                                   None if uniforms is None else uniforms[:, sel])
            tk.stepped_call_plain(isect, draw, sub, cnt, depth0=int(dep),
                                  n_steps=1, max_depth=max_depth,
                                  rr_start_depth=rr_start_depth)
            state[:, sel] = sub
            counts[sel] = cnt
        taken = taken + busy
        alive_row[ray[busy]] = state[tk.ROW_ALIVE, torch.from_numpy(
            ray[busy]).to(dev)].cpu().numpy() > 0.0
        stop = busy & (~alive_row[np.maximum(ray, 0)] | (taken == n_steps))
        has = has & ~stop
    return {"warp_steps": warp_steps, "lane_steps": lane_steps,
            "lane_share": lane_steps / max(WARP * warp_steps, 1),
            "rays_taken": nxt}


def compacted(steps: torch.Tensor, threads: int) -> dict:
    """Blocks of ``threads`` consecutive rays that pack their live rays to
    their first threads before each step: at step s a block runs
    ceil(live / 32) warps."""
    n = steps.numel()
    pad = steps.new_zeros((-n) % threads)
    per = torch.cat([steps, pad]).view(-1, threads)
    live = torch.stack([(per > s).sum(dim=1) for s in range(MAX_DEPTH)])
    warp_steps = int((-(-live // WARP)).sum())
    return {"lane_share": int(steps.sum()) / max(WARP * warp_steps, 1),
            "warp_steps": warp_steps}


def model(steps: torch.Tensor, resident: int) -> dict:
    """The model's numbers for one frame's plain counts (see the module
    doc): path lengths, rays a lane and the lane shares of one thread a ray and
    of the persistent grid at ``resident`` lanes that refills at once."""
    s = steps.to(torch.int64)
    n = s.numel()
    q = torch.quantile(s.to(torch.float64), torch.tensor(
        [0.1, 0.25, 0.5, 0.75, 0.9], dtype=torch.float64, device=s.device))
    p = K2.persistent(s, resident, 1)
    return {
        "rays": n, "steps": int(s.sum()),
        "path_length_histogram_1_to_12": torch.bincount(
            s, minlength=MAX_DEPTH + 1)[1:].tolist(),
        "path_length_p10_25_50_75_90": [float(x) for x in q],
        "mean_path_length": float(s.to(torch.float64).mean()),
        "share_at_max_depth": float((s == MAX_DEPTH).to(torch.float64).mean()),
        "resident_lanes": resident, "rays_per_lane": n / resident,
        "thread_per_ray": K2.thread_per_slot(s),
        "persistent_refill_1": {k: p[k] for k in (
            "lane_share", "grid_share", "warp_steps", "grid_steps")},
        **{f"compacted_{t}": compacted(s, t) for t in (128, 256, 512)},
    }


def parse_res(text: str):
    from path_tracer_tpu_torch.utils.config import Resolution

    w, h = (int(x) for x in text.lower().split("x"))
    return Resolution(h, w)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="150x100")
    ap.add_argument("--spp", type=int, default=SPP)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--resident", type=int, default=None,
                    help="resident lanes (default: K5's on a card, else as "
                    "many rays a lane as 135,168 lanes give the 2-spp frame)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--schedule", action="store_true",
                    help="also replay the persistent schedule (refill_call)")
    args = ap.parse_args()
    import path_tracer_tpu_torch as pt

    dev = torch.device(args.device)
    res = parse_res(args.res)
    scene = pt.load_scene("cornell", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    sc, cam, pix, smp = frame(scene, res, dev, args.spp)
    n = pix.shape[0]
    cfg = None
    if args.resident:
        resident = args.resident
    elif dev.type == "cuda":
        cfg = tv2.stepped_static_config(sc)
        resident = cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"]
    else:
        resident = max(WARP, round(n * 135168 / FULL_RAYS / WARP) * WARP)
    _, counts = tv2.trace_camera_plain(sc, cam, width=res.width,
                                       height=res.height, seed=SEED,
                                       pixel_idx=pix, sample_idx=smp,
                                       max_depth=MAX_DEPTH)
    # the per-ray counts of one 12-step call from the camera entry
    state, per_ray = camera_state(cam, pix, smp, seed=SEED, width=res.width,
                                  height=res.height)
    tk.stepped_call_plain(tv2.stepped_isect(sc), tk.stepped_draw(SEED, pix, smp, None),
                          state, per_ray, depth0=0, n_steps=MAX_DEPTH,
                          max_depth=MAX_DEPTH, rr_start_depth=RR_START)
    assert int(per_ray.sum()) == int(counts)
    out = model(per_ray, resident)
    out["frame"] = f"cornell {res.width}x{res.height} x {args.spp} spp"
    if cfg:
        out["config"] = cfg
        out["waves"] = -(-n // cfg["threads"]) / (cfg["blocks_per_sm"] * cfg["sms"])
    if args.schedule:
        state, cnt = camera_state(cam, pix, smp, seed=SEED, width=res.width,
                                  height=res.height)
        out[f"persistent_schedule_batch_{args.batch}"] = refill_call(
            sc, state, cnt, pix, smp, seed=SEED, depth0=0, n_steps=MAX_DEPTH,
            lanes=resident, batch=args.batch)
        out["persistent_schedule_equals_plain_counts"] = bool(
            torch.equal(cnt, per_ray))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
