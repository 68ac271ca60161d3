#!/usr/bin/env python3
"""How much of K6's work its warps spend on steps and triangle rows a ray
needs: the coherence model of the mesh preview's stepped trace, measured
with the plain versions.

Traces one preview frame (mesh, 450x300 x 2 spp, seed 7: the rays the
preview's camera entry makes, ``trace_kernel.trace_camera_plain``) in one
12-step call, recording for every ray the steps it takes and, at each step,
the tiles its bounce tests (``isect_full_plain``'s per-lane cull) and its
tile-entry key (``tile_entry_keys``). Prints

  1. the distribution of the rays' path lengths (steps a ray takes);
  2. the share of lane-steps that do work, in warps of 32 lanes, under
     - one thread a ray (the parent kernel): a warp of 32 consecutive rays
       runs as long as its longest path;
     - a persistent grid of ``resident`` lanes whose warps take new rays
       from a counter, in ray order, once at least R of their 32 lanes
       stopped (R = 1: at once; scripts/k2_coherence.py's model, which
       csrc/trace_stepped.cu's K6_REFILL_MIN follows);
  3. the share of the triangle rows executed that a lane needs (a warp
     executes the base set and the union of its busy lanes' tiles, as in
     scripts/k3_coherence.py), under one thread a ray and the persistent
     schedules, and with each step's live rays packed and sorted by
     tile-entry key in chunks of ``window`` consecutive rays (K3's chunk
     sort applied per step) or packed alone.

Everything counts steps and rows, not time. Runs on the CPU at a small size
and on a card at the full one (plain versions on CUDA tensors; the resident
lanes are then K6's, from ``stepped_prim_config``; on the CPU a grid with
``--rays-per-lane`` rays a lane, near the full-size ratio):

  python3 scripts/k6_coherence.py --res 90x60 --device cpu
  python3 scripts/k6_coherence.py --res 450x300 --device cuda
"""

import argparse
import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402

SEED, SPP, MAX_DEPTH = 7, 2, 12
WARP = 32
REFILL_MINS = (1, 2, 4, 8)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K2 = _script("k2_coherence")
K3 = _script("k3_coherence")


def frame(scene, res, dev, spp: int = SPP):
    """(KernelScene, camera arrays, pixel_idx, sample_idx) of one preview
    frame at ``res``: the rays of ProgressiveRenderer's first frame."""
    from path_tracer_tpu_torch.models.scene import pack_scene
    from path_tracer_tpu_torch.render.integrator import pass_rays
    from path_tracer_tpu_torch.render.raygen import camera_arrays

    ks = tk.build_kernel_scene(pack_scene(scene)).to(dev)
    pix, smp = pass_rays(torch.arange(res.num_pixels, dtype=torch.int32,
                                      device=dev), spp)
    return ks, camera_arrays(scene.camera), pix, smp


def trace_record(ks, cam, pix, smp, width, height, seed: int = SEED):
    """Trace the frame's camera rays with the plain version. Returns
    (steps [N] int64, tiles [S, N, C] bool: the tiles each ray's bounce
    tests at step s, keys [S, N] int64: its tile-entry key, live [S, N]
    bool: whether it takes step s, radiance [N, 3])."""
    from path_tracer_tpu_torch.render.raygen import camera_rays

    o, d = camera_rays(cam, pix, smp, seed=seed, width=width, height=height)
    tiles, keys, live = [], [], []

    def isect(o_, d_, prev, alive):
        t: list = []
        out = tk.isect_full_plain(ks, o_, d_, prev, alive, tiles_out=t)
        tiles.append(torch.stack(t, dim=1) if t else torch.zeros(
            (alive.shape[0], 0), dtype=torch.bool, device=alive.device))
        keys.append(tk.tile_entry_keys(ks, o_, d_))
        live.append(alive.clone())
        return out

    draw = tk.stepped_draw(seed, pix, smp, None)

    def run_call(state, counts, depth0, steps):
        tk.stepped_call_plain(isect, draw, state, counts, depth0=depth0,
                              n_steps=steps, max_depth=MAX_DEPTH,
                              rr_start_depth=5)

    n = pix.shape[0]
    state = torch.empty((tk.STATE_ROWS, n), dtype=torch.float32, device=pix.device)
    counts = torch.zeros(n, dtype=torch.int32, device=pix.device)
    state[tk.ROW_O:tk.ROW_O + 3] = o.T
    state[tk.ROW_D:tk.ROW_D + 3] = d.T
    state[tk.ROW_THR:tk.ROW_THR + 3] = 1.0
    state[tk.ROW_ACC:tk.ROW_ACC + 3] = 0.0
    state[tk.ROW_ALIVE] = 1.0
    state[tk.ROW_PREV] = -1.0
    run_call(state, counts, 0, MAX_DEPTH)
    return (counts.to(torch.int64), torch.stack(tiles), torch.stack(keys),
            torch.stack(live), state[tk.ROW_ACC:tk.ROW_ACC + 3].T)


def _rows(group, tiles, base_rows):
    return K3._executed_rows(group, tiles, base_rows)[0] if group.numel() else 0


def persistent_rows(steps, tiles, base_rows, resident: int, refill_min: int):
    """scripts/k2_coherence.py's persistent schedule, replayed with each
    busy lane's tiles at its ray's current step: the triangle rows the
    warps execute (32 x (base set + 64 x the union of the busy lanes'
    tiles) a warp-step)."""
    dev = steps.device
    n = steps.numel()
    warps = max(1, min(resident, n + WARP - 1) // WARP)
    lanes = warps * WARP
    idx = torch.arange(lanes, device=dev).view(warps, WARP)
    ray = torch.where(idx < n, idx, -1)
    done = torch.zeros_like(ray)  # steps the lane's ray has taken
    rem = torch.where(ray >= 0, steps[ray.clamp(min=0)], 0)
    nxt = lanes
    rows = 0
    n_tiles = tiles.shape[2]
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
            ray = torch.where(take, slot, ray)
            done = torch.where(take, 0, done)
            rem = torch.where(take, steps[slot.clamp(max=n - 1)], rem)
            nxt += int(cnt.sum())
        busy = rem > 0
        active = busy.any(dim=1)
        if not bool(active.any()):
            break
        if n_tiles:
            t = tiles[done.clamp(max=tiles.shape[0] - 1), ray.clamp(min=0)]
            union = (t & busy[..., None]).any(dim=1)  # [warps, C]
            rows += WARP * (int(active.sum()) * base_rows
                            + tk.TRI_TILE * int(union[active].sum()))
        else:
            rows += WARP * int(active.sum()) * base_rows
        done = done + busy.to(done.dtype)
        rem = rem - busy.to(rem.dtype)
    return rows


def coherence(ks, steps, tiles, keys, live, resident: int,
              refill_mins=REFILL_MINS, windows=(1024,)) -> dict:
    """The model's numbers for one traced frame (see the module doc)."""
    n = steps.numel()
    base_rows = ks.tile_base if ks.tiles.shape[0] else ks.tri.shape[0]
    needed = int(live.sum()) * base_rows + tk.TRI_TILE * int(tiles.sum())
    hist = torch.bincount(steps, minlength=MAX_DEPTH + 1)[1:].tolist()
    q = torch.quantile(steps.to(torch.float64), torch.tensor(
        [0.1, 0.25, 0.5, 0.75, 0.9], dtype=torch.float64, device=steps.device))
    out = {
        "rays": n, "steps": int(steps.sum()),
        "path_length_histogram_1_to_12": hist,
        "path_length_p10_25_50_75_90": [float(x) for x in q],
        "mean_path_length": float(steps.to(torch.float64).mean()),
        "resident_lanes": resident, "base_rows": int(base_rows),
        "n_tiles": int(ks.tiles.shape[0]),
        "tiles_tested_per_step": float(tiles.sum()) / max(int(live.sum()), 1),
    }
    rows = 0
    ray = torch.arange(n, device=steps.device)
    for s in range(live.shape[0]):
        m = live[s]
        rows += _rows((ray[m] // WARP), tiles[s][m], base_rows)
    out["thread_per_ray"] = {
        "lane_share": K2.thread_per_slot(steps)["lane_share"],
        "useful_row_share": needed / max(rows, 1)}
    for r in refill_mins:
        p = K2.persistent(steps, resident, r)
        out[f"persistent_refill_{r}"] = {
            "lane_share": p["lane_share"], "grid_share": p["grid_share"],
            "refills_per_warp_step": p["refills_per_warp_step"],
            "useful_row_share": needed / max(persistent_rows(
                steps, tiles, base_rows, resident, r), 1)}
    for window in windows:
        for sort in (False, True):
            rows = 0
            for s in range(live.shape[0]):
                m = live[s]
                ids = ray[m]
                if not ids.numel():
                    continue
                chunk = ids // window
                order = (torch.argsort(chunk * (1 << 33) + keys[s][m], stable=True)
                         if sort else torch.arange(ids.numel(), device=ids.device))
                c = chunk[order]
                per = torch.bincount(c)
                start = torch.cumsum(per, 0) - per
                rank = torch.arange(ids.numel(), device=ids.device) - start[c]
                wbase = torch.cumsum(-(-per // WARP), 0) - (-(-per // WARP))
                rows += _rows(wbase[c] + rank // WARP, tiles[s][m][order],
                              base_rows)
            out[f"chunks_of_{window}_{'sorted' if sort else 'packed'}"] = {
                "useful_row_share": needed / max(rows, 1)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="90x60", help="WIDTHxHEIGHT")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--rays-per-lane", type=float, default=2.66,
                    help="CPU only: resident lanes = rays / this")
    args = ap.parse_args()
    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.utils.config import Resolution

    w, h = (int(x) for x in args.res.split("x"))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("k6_coherence: no CUDA device", file=sys.stderr)
        return 1
    scene = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    ks, cam, pix, smp = frame(scene, Resolution(h, w), dev)
    steps, tiles, keys, live, _ = trace_record(ks, cam, pix, smp, w, h)
    if dev.type == "cuda":
        cfg = tk.stepped_prim_config(ks, camera=True)
        resident = cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"]
        where = f"{torch.cuda.get_device_name(dev)}, {cfg}"
    else:
        resident = int(pix.shape[0] / args.rays_per_lane) // WARP * WARP
        where = f"cpu, {args.rays_per_lane} rays a lane"
    print(json.dumps({"res": args.res, "device": where,
                      **coherence(ks, steps, tiles, keys, live, resident)},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
