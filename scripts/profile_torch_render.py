#!/usr/bin/env python3
"""Where the time of a port render goes, on one CUDA device.

Renders cornell 1024x768 at 512 spp through render(device="cuda") (warm:
after one untimed render), and reports
  - the render's wall seconds and Mray/s (the CLI's metric);
  - the trace kernel's device time per launch (CUDA events around a direct
    trace_regen call of one 256-spp pass) and its kernel-only Mray/s;
  - device time by kernel name and the device's idle share of the render
    wall, from torch.profiler (CUPTI sees kernels launched through ctypes);
  - the host time render() spends after its timed wall (unpermute, hash);
  - the card's name, power limit, and SM clock and power draw after the run.

Run from the repo root:  python3 scripts/profile_torch_render.py [--reps N]
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import path_tracer_tpu_torch as pt  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_v2  # noqa: E402
from path_tracer_tpu_torch.render.image import Image  # noqa: E402
from path_tracer_tpu_torch.render.pipeline import (  # noqa: E402
    morton_pixel_order, prepare_scene,
)
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution  # noqa: E402


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    scene = pt.load_scene("cornell", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    res = Resolution(768, 1024)
    cfg = RenderConfig(samples_per_pixel=512, resolution=res)
    dev = torch.device("cuda")

    pt.render(scene, cfg, device=dev, out_dir=None, verbose=False)  # warm
    walls, rates = [], []
    for _ in range(args.reps):
        done = pt.render(scene, cfg, device=dev, out_dir=None, verbose=False)
        walls.append(done.stats.wall_seconds)
        rates.append(done.stats.mrays_per_sec)
    print(f"render cornell 1024x768 512 spp, {args.reps} warm reps: wall s "
          f"{[round(w, 4) for w in walls]}, Mray/s {[round(r, 1) for r in rates]}"
          f" ({card})")

    # one 256-spp pass, timed on the device
    scene_c, cam_c = prepare_scene(scene, res, dev)
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(dev)
    kw = dict(seed=0, sample_base=0, quota=256)
    trace_v2.trace_regen(scene_c, cam_c, pix, **kw)
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, segs, _ = trace_v2.trace_regen(scene_c, cam_c, pix, **kw)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    n_seg = int(segs.sum(dtype=torch.int64))
    best = sorted(ms)[1] if len(ms) > 1 else ms[0]
    print(f"kernel, one 256-spp pass: ms {[round(m, 3) for m in ms]}; "
          f"{n_seg} segments; 2nd-best {best:.3f} ms = "
          f"{n_seg / best / 1e3:.1f} Mray/s kernel-only ({card})")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pt.render(scene, cfg, device=dev, out_dir=None, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, memcpys): the CPU ops that launched
    # them carry the same device time again
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
    print(f"profiled render (profiler on, Image.new included): wall "
          f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
    for dev_us, key, count in rows[:8]:
        print(f"  {dev_us / 1e3:10.3f} ms  x{count:<4d} {key[:90]}")
    px = np.random.default_rng(0).random((res.num_pixels, 3), dtype=np.float32)
    inv = morton_pixel_order(res.width, res.height)[1]
    t0 = time.perf_counter()
    Image.new(px[inv], res)
    print(f"host after the timed wall: unpermute + Image.new (hash) "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    print(f"after the run: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
