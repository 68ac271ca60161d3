#!/usr/bin/env python3
"""Where the time of a wavefront render goes, on one CUDA device.

The wavefront integrator (backend "fast", plain torch, no kernel) on
cornell 1024x768 at 64 spp and mesh 1024x768 at 4 spp, through
render(device="cuda"), warm (after one untimed render). For each:
  - the render's wall seconds and Mray/s over --reps renders;
  - from torch.profiler over one more render: device time by kernel name,
    the device's busy time and idle share of the render's wall, and the
    device operations a bounce step launches (passes x chunks x steps);
  - the card's name and power limit, and its SM clock and power after.

Run from the repo root:  python3 scripts/profile_torch_wavefront.py [--reps N]
"""

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import path_tracer_tpu_torch as pt  # noqa: E402
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution  # noqa: E402

CASES = (("cornell", 64), ("mesh", 4))


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = smi("name,power.limit")
    res = Resolution(768, 1024)
    for sid, spp in CASES:
        scene = pt.load_scene(sid, os.path.join(ROOT, "scenes"),
                              os.path.join(ROOT, "meshes"))
        cfg = RenderConfig(samples_per_pixel=spp, resolution=res, backend="fast")
        pt.render(scene, cfg, device="cuda", out_dir=None, verbose=False)  # warm
        walls, rates = [], []
        for _ in range(args.reps):
            done = pt.render(scene, cfg, device="cuda", out_dir=None,
                             verbose=False)
            walls.append(done.stats.wall_seconds)
            rates.append(done.stats.mrays_per_sec)
        print(f"{sid} 1024x768 {spp} spp fast, {args.reps} warm renders: wall s "
              f"{[round(w, 4) for w in walls]}, Mray/s "
              f"{[round(r, 1) for r in rates]}, {done.stats.num_rays} segments, "
              f"{done.stats.num_dispatches} dispatches ({card})", flush=True)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            done = pt.render(scene, cfg, device="cuda", out_dir=None,
                             verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = evt.self_cuda_time_total
            rows.append((dev_us, evt.key, evt.count))
        busy_us = sum(r[0] for r in rows)
        ops = sum(r[2] for r in rows)
        steps = done.stats.num_dispatches * cfg.max_depth
        rows.sort(reverse=True)
        print(f"  profiled render: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}, "
              f"{ops} device operations, at least {ops / steps:.1f} a bounce "
              f"step ({steps} steps at most)", flush=True)
        for dev_us, key, count in rows[:10]:
            print(f"  {dev_us / 1e3:10.3f} ms {100 * dev_us / max(busy_us, 1e-9):5.1f}%  "
                  f"x{count:<6d} {key[:80]}", flush=True)
    print(f"after the run: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
