#!/usr/bin/env python3
"""Where the time of a port render of the mesh scene goes, on one CUDA device.

Renders mesh 1024x768 through render(device="cuda") on both routes, warm
(after one untimed render of each), and reports
  - per route, the wall seconds and Mray/s of each rep (the CLI's metric),
    and for the portal its scheduler cycles and termination polls;
  - for one portal render under torch.profiler: device time by kernel name
    (K2 trace_cheap_regen, K3 trace_resolve_pool, the compaction and merge
    ops) and the device's idle share of the render wall;
  - the card's name, power limit, and SM clock and power draw after the run.

Run from the repo root:
  python3 scripts/profile_torch_mesh.py [--spp 1024] [--prim-spp 64] [--reps 3]
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


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--prim-spp", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    scene = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    res = Resolution(768, 1024)
    dev = torch.device("cuda")

    def render(spp):
        return pt.render(scene, RenderConfig(samples_per_pixel=spp, resolution=res),
                         device=dev, out_dir=None, verbose=False)

    for route, spp, env in (("portal", args.spp, None),
                            ("prim", args.prim_spp, "1")):
        if env:
            os.environ["PT_TPU_NO_PORTAL"] = env
        render(spp)  # warm
        walls, rates, extra = [], [], []
        for _ in range(args.reps):
            done = render(spp)
            assert done.stats.extra["route"] == route
            walls.append(done.stats.wall_seconds)
            rates.append(done.stats.mrays_per_sec)
            extra.append({k: v for k, v in done.stats.extra.items() if k != "route"})
        print(f"render mesh 1024x768 {spp} spp, route {route}, {args.reps} warm "
              f"reps: wall s {[round(w, 4) for w in walls]}, Mray/s "
              f"{[round(r, 1) for r in rates]}, segments {done.stats.num_rays}, "
              f"{extra} ({card})", flush=True)
        os.environ.pop("PT_TPU_NO_PORTAL", None)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(args.spp)
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
    rows.sort(reverse=True)
    print(f"profiled portal render (profiler on): wall {wall * 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
    for dev_us, key, count in rows[:12]:
        print(f"  {dev_us / 1e3:10.3f} ms  {dev_us / max(busy_us, 1):6.3f}  "
              f"x{count:<5d} {key[:80]}")
    print(f"after the run: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
