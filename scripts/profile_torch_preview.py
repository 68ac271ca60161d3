#!/usr/bin/env python3
"""Where the time of a port preview frame goes, on one CUDA device.

For cornell (K5) and mesh (K6), ProgressiveRenderer(device="cuda") at
450x300 (the reference GUI's preview size) and 2 spp a frame, warm:
  - step_u8's frame time (host clock; the frame ends in its device-to-host
    copy), 2nd best and median of --frames frames;
  - the frame's stages one by one, each ended by a synchronize: raygen
    (counter draws and generate_rays), the trace kernel, and the rest
    (accumulate, finalize, quantize, fetch);
  - device time by kernel name and the device's idle share over --frames
    frames, from torch.profiler;
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
    res, spp, dev = r.resolution, r.spp_per_frame, r.device
    npix = res.num_pixels
    base = r.samples_done

    def raygen():
        pix = r._pixels.repeat_interleave(spp)
        smp = torch.arange(base, base + spp, dtype=torch.int32,
                           device=dev).repeat(npix)
        return (*integrator.camera_rays(r._cam, pix, smp, seed=r.seed,
                                        width=res.width, height=res.height),
                pix, smp)

    (o, d, pix, smp), t_raygen = synced(raygen)
    kw = dict(seed=r.seed, pixel_idx=pix, sample_idx=smp, max_depth=r.max_depth)
    if r.prep.route == "stepped":
        trace = lambda: integrator.trace_with_kernel_v2(o, d, r.prep.scene, **kw)  # noqa: E731
    else:
        trace = lambda: integrator.trace_with_kernel(o, d, r.prep.kscene, **kw)  # noqa: E731
    result, t_trace = synced(trace)

    def rest():
        r._accum += result.radiance.reshape(npix, spp, 3).sum(dim=1)
        img = integrator.finalize(r._accum, base + spp)
        return tonemap.to_int_with_gamma_correction(img).to(torch.uint8).cpu()

    _, t_rest = synced(rest)
    r._frame += 1
    return {"raygen": t_raygen, "trace": t_trace, "rest": t_rest}


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
        print(f"  profiled {args.frames} frames (profiler on): wall "
              f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms, idle "
              f"share {1 - busy_us / 1e6 / wall:.3f}, {sum(row[2] for row in rows)} "
              f"device ops")
        for dev_us, key, count in rows[:6]:
            print(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:80]}")
    print(f"after the run: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
