#!/usr/bin/env python3
"""Where the time of the port's v1 and glue portal routes, and of K9, goes,
on one CUDA device.

Renders mesh 1024x768 at --spp through render(device="cuda") on three
routes, warm (after one untimed render of each): the v2 portal (K2, K3), the
v1 scheduler (PT_TPU_PORTAL_V1: K8, K7) and the v2 glue route
(render.portal.POOL_RESOLVE False: K2, K7). Reports
  - per route, the wall seconds and Mray/s of each rep, cycles and polls;
  - for one render of each route under torch.profiler: device time by
    kernel name and the device's idle share of the render wall;
  - K9 against K6 on one preview frame's mesh rays (450x300 x 2 spp):
    under torch.profiler, the device time of the trace kernel
    (trace_stepped_prim_kernel) and of everything else, for the sorted
    trace every 1 and 3 bounces and K6 in calls of 12 and of 1 step, so
    that the kernel's own time with and without sorting compares;
  - the card's name, power limit, and SM clock and power draw after the run.

Run from the repo root:
  python3 scripts/profile_torch_v1.py [--spp 64] [--reps 3]
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
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.render import portal as rportal  # noqa: E402
from path_tracer_tpu_torch.render.integrator import camera_rays  # noqa: E402
from path_tracer_tpu_torch.render.raygen import camera_arrays  # noqa: E402
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution  # noqa: E402

TRACE_KERNEL = "trace_stepped_prim_kernel"


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def profiled(fn):
    """(wall s, [(device us, kernel name, count)] sorted by time) of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return wall, sorted(rows, reverse=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
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
    cfg = RenderConfig(samples_per_pixel=args.spp, resolution=res)
    routes = {"v2": ({}, True), "v1": ({"PT_TPU_PORTAL_V1": "1"}, True),
              "glue": ({}, False)}

    def render(route):
        env, pool_resolve = routes[route]
        os.environ.update(env)
        rportal.POOL_RESOLVE = pool_resolve
        try:
            return pt.render(scene, cfg, device=dev, out_dir=None, verbose=False)
        finally:
            for k in env:
                os.environ.pop(k)
            rportal.POOL_RESOLVE = True

    for route in routes:
        render(route)  # warm
        walls, rates = [], []
        for _ in range(args.reps):
            done = render(route)
            walls.append(done.stats.wall_seconds)
            rates.append(done.stats.mrays_per_sec)
        print(f"render mesh 1024x768 {args.spp} spp, {route}, {args.reps} warm "
              f"reps: wall s {[round(w, 4) for w in walls]}, Mray/s "
              f"{[round(r, 1) for r in rates]}, segments {done.stats.num_rays}, "
              f"{done.stats.extra} ({card})", flush=True)
    for route in routes:
        wall, rows = profiled(lambda: render(route))
        busy = sum(r[0] for r in rows)
        print(f"profiled {route} render (profiler on): wall {wall * 1e3:.1f} ms, "
              f"device busy {busy / 1e3:.1f} ms, idle share "
              f"{1 - busy / 1e6 / wall:.3f}", flush=True)
        for dev_us, key, count in rows[:10]:
            print(f"  {dev_us / 1e3:10.3f} ms  {dev_us / max(busy, 1):6.3f}  "
                  f"x{count:<5d} {key[:80]}", flush=True)

    # K9 against K6: the trace kernel's own device time, sorted or not
    frame = Resolution(300, 450)
    npix, spp = frame.num_pixels, 2
    pix = torch.arange(npix, dtype=torch.int32, device=dev).repeat_interleave(spp)
    smp = torch.arange(spp, dtype=torch.int32, device=dev).repeat(npix)
    o, d = camera_rays(camera_arrays(scene.camera), pix, smp, seed=0,
                       width=frame.width, height=frame.height)
    ks = tk.build_kernel_scene(pt.pack_scene(scene)).to(dev)
    kw = dict(seed=7, pixel_idx=pix, sample_idx=smp)
    runs = {
        "K9 sorted every 1": lambda: tk.trace_sorted(ks, o, d, sort_every=1, **kw),
        "K9 sorted every 3": lambda: tk.trace_sorted(ks, o, d, sort_every=3, **kw),
        "K6 12 steps a call": lambda: tk.trace_stepped(ks, o, d, steps_per_call=12, **kw),
        "K6 1 step a call": lambda: tk.trace_stepped(ks, o, d, steps_per_call=1, **kw),
    }
    for name, fn in runs.items():
        fn()  # warm
        kernel, other = [], []
        for _ in range(args.reps):
            wall, rows = profiled(fn)
            kernel.append(sum(r[0] for r in rows if TRACE_KERNEL in r[1]) / 1e3)
            other.append(sum(r[0] for r in rows if TRACE_KERNEL not in r[1]) / 1e3)
        print(f"{name}, mesh 450x300 x 2 spp, {args.reps} reps: trace kernel "
              f"{[round(x, 3) for x in kernel]} ms, other device work "
              f"{[round(x, 3) for x in other]} ms ({card})", flush=True)
    print(f"after the run: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
