#!/usr/bin/env python3
"""Where the time of a port preview frame goes, on one CUDA device.

For cornell (K5) and mesh (K6), ProgressiveRenderer(device="cuda") at
450x300 (the reference GUI's preview size) and 2 spp a frame, warm:
  - step_u8's frame time (host clock; the frame ends in its device-to-host
    copy), 2nd best and median of --frames frames;
  - the frame's stages one by one, each ended by a synchronize: the trace
    (K5's or K6's camera entry, which makes the camera rays in the kernel:
    integrator.render_samples) and the rest (accumulate, finalize,
    quantize, fetch);
  - device time by kernel name, device operations a frame and the device's
    idle share over --frames frames, from torch.profiler;
  - one frame's timeline: each device operation in order, its device time
    and the gap before it, in which the device waits for the host;
  - the card's name and power limit, and its SM clock and power draw after
    the run.

Run from the repo root:  python3 scripts/profile_torch_preview.py [--frames N]
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
from path_tracer_tpu_torch.ops import tonemap  # noqa: E402
from path_tracer_tpu_torch.render import integrator  # noqa: E402
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402
from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer  # noqa: E402


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def synced(fn):
    """(result, ms) of fn() ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def stages(r: ProgressiveRenderer) -> dict:
    """One frame of r split into its stages, each timed to a synchronize."""
    res, spp = r.resolution, r.spp_per_frame
    npix = res.num_pixels
    base = r.samples_done
    pix, smp = r._rays
    result, t_trace = synced(lambda: integrator.render_samples(
        r.prep, r._cam, pix, smp + base, seed=r.seed, width=res.width,
        height=res.height, max_depth=r.max_depth))

    def rest():
        r._accum += result.radiance.reshape(npix, spp, 3).sum(dim=1)
        img = integrator.finalize(r._accum, base + spp)
        return tonemap.to_int_with_gamma_correction(img).to(torch.uint8).cpu()

    _, t_rest = synced(rest)
    r._frame += 1
    return {"trace": t_trace, "rest": t_rest}


def timeline(prof, per_frame: int) -> None:
    """The last profiled frame's device operations in order: when each
    starts after the frame's first, its device time, and the gap since the
    previous one ended (device idle)."""
    from torch.autograd import DeviceType

    evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)[-per_frame:]
    if not evts:
        return
    t0 = evts[0].time_range.start
    busy = sum(e.time_range.end - e.time_range.start for e in evts)
    span = evts[-1].time_range.end - t0
    print(f"  the last frame's {len(evts)} device operations over {span:.1f} us, "
          f"{busy:.1f} us busy, {span - busy:.1f} us in gaps:")
    prev = t0
    for e in evts:
        start, end = e.time_range.start, e.time_range.end
        print(f"    +{start - t0:8.1f} us  gap {start - prev:6.1f} us  "
              f"device {end - start:7.1f} us  {e.name[:70]}")
        prev = max(prev, end)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    dev = torch.device("cuda")
    res = Resolution(300, 450)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for sid in ("cornell", "mesh"):
        scene = pt.load_scene(sid, os.path.join(ROOT, "scenes"),
                              os.path.join(ROOT, "meshes"))
        r = ProgressiveRenderer(scene, res, spp_per_frame=2, device=dev)
        for _ in range(3):
            r.step_u8()  # warm
        ts = []
        for _ in range(args.frames):
            t0 = time.perf_counter()
            r.step_u8()
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        print(f"{sid} {res.width}x{res.height} 2 spp route {r.prep.route}: "
              f"step_u8 2nd best {ts[1]:.3f} ms, median {ts[len(ts) // 2]:.3f} ms "
              f"over {args.frames} frames ({card})")
        split = [stages(r) for _ in range(5)]
        best = {k: sorted(s[k] for s in split)[1] for k in split[0]}
        print(f"  stages, each to a synchronize (2nd best of 5): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in best.items()))

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.frames):
                r.step_u8()
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
        busy_us = sum(row[0] for row in rows)
        rows.sort(reverse=True)
        ops = sum(row[2] for row in rows)
        print(f"  profiled {args.frames} frames (profiler on): wall "
              f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms, idle "
              f"share {1 - busy_us / 1e6 / wall:.3f}, {ops} device ops, "
              f"{ops / args.frames:.1f} a frame")
        for dev_us, key, count in rows[:6]:
            print(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:80]}")
        timeline(prof, ops // args.frames)
    print(f"after the run: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
