#!/usr/bin/env python3
"""Derive a configuration's essential operations a traced segment from the
work counts of the program's kernels' plain versions, on the CPU.

    python3 bench_torch/derive_ops.py mesh [--res 90x60] [--spp 8] [--frames 2]

It renders the configuration's scene through the program's default routes
on the CPU, where each kernel runs its plain torch version, and counts what
those versions report doing (``work=``): slab tests, cheap-scene scans,
sphere and triangle tests, shaded hits, camera rays. Each count is priced
at the flops of one such test, as ``chip_smoke.py`` prices them (adds,
multiplies, divides and square roots, counted by ``scripts/count_flops.py``):

    triangle or quad row 41, sphere 41, slab 24, shading 152, hit point and
    normal 29, camera ray 40.

The render's work (route ``portal``: K2, the cheap kernel, and K3, the
pool resolve) and the preview's (route ``stepped_prim``: K6's camera
entry) are each divided by the segments traced; the camera rays are
counted apart, ``sample_flops`` (40) a sample. The results are the
``ops.<kind>.segment_flops`` of the configuration's file. They are a
yardstick: later changes to the program do not move them.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

FLOPS_TRI = 41
FLOPS_SPHERE = 41
FLOPS_SLAB = 24
FLOPS_SHADE = 152
FLOPS_HIT = 29
FLOPS_RAYGEN = 40


def isect_flops(work: dict, segments: int) -> float:
    """A full-scene step: shading and the hit for every segment, and every
    sphere, triangle and slab test."""
    return (segments * (FLOPS_SHADE + FLOPS_HIT) + work.get("sph", 0) * FLOPS_SPHERE
            + work.get("tri", 0) * FLOPS_TRI + work.get("slab", 0) * FLOPS_SLAB)


def render_flops(ctx, res, spp: int) -> dict:
    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.ops.kernels import portal as pk
    from path_tracer_tpu_torch.utils.config import RenderConfig

    total = {"regen": 0, "k2": 0.0, "k3": 0.0}
    cheap, resolve = pk.trace_cheap_regen_plain, pk.trace_resolve_pool_plain

    def counted_cheap(pc, cam, pool, **kw):
        work: dict = {}
        out = cheap(pc, cam, pool, work=work, **kw)
        # a slot's runnable step is one slab test and one cheap-scene scan
        f = (int(work["slot_steps"].sum()) * (FLOPS_SLAB + pc.scene.prims.shape[0] * FLOPS_TRI)
             + work.get("shade", 0) * (FLOPS_SHADE + FLOPS_HIT))
        total["k2"] += f
        total["regen"] += work.get("regen", 0)
        return out

    def counted_resolve(ks, pool, **kw):
        work: dict = {}
        out = resolve(ks, pool, work=work, **kw)
        total["k3"] += isect_flops(work, int(out[1].sum()))
        return out

    pk.trace_cheap_regen_plain, pk.trace_resolve_pool_plain = counted_cheap, counted_resolve
    try:
        done = pt.render(ctx.program_scene(), RenderConfig(
            samples_per_pixel=spp, resolution=res, seed=1,
            max_depth=ctx.config["max_depth"], rr_start_depth=ctx.config["rr_start_depth"]),
            device="cpu", out_dir=None, verbose=False)
    finally:
        pk.trace_cheap_regen_plain, pk.trace_resolve_pool_plain = cheap, resolve
    segs = done.stats.num_rays
    return {"route": done.stats.extra["route"], "segments": segs,
            "samples": res.num_pixels * spp, "camera_rays": total["regen"],
            "k2_flops": total["k2"], "k3_flops": total["k3"],
            "segment_flops": (total["k2"] + total["k3"]) / segs}


def preview_flops(ctx, res, frames: int) -> dict:
    from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
    from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer

    total = {"flops": 0.0, "segments": 0}
    plain = tk.trace_camera_plain

    def counted(ks, cam, **kw):
        work: dict = {}
        out = plain(ks, cam, work=work, **kw)
        segs = int(out[1])
        total["flops"] += isect_flops(work, segs)
        total["segments"] += segs
        return out

    tk.trace_camera_plain = counted
    try:
        r = ProgressiveRenderer(ctx.program_scene(), res, spp_per_frame=2, seed=1,
                                max_depth=ctx.config["max_depth"], device="cpu")
        for _ in range(frames):
            r.step_u8()
    finally:
        tk.trace_camera_plain = plain
    return {"route": r.prep.route, "segments": total["segments"],
            "samples": res.num_pixels * 2 * frames,
            "segment_flops": total["flops"] / total["segments"]}


def main() -> int:
    import json

    import run
    from path_tracer_tpu_torch.utils.config import Resolution

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--res", default="90x60")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()
    w, h = (int(x) for x in args.res.split("x"))
    res = Resolution(height=h, width=w)
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as fh:
        cell = next(c for c in json.load(fh)["workloads"] if c["config"] == args.config)
    ctx = run.make_ctx(argparse.Namespace(workload=cell["name"], seed=0, seconds=0, trace=0),
                       "cpu")
    r = render_flops(ctx, res, args.spp)
    print(f"render {args.config} {w}x{h} {args.spp} spp, route {r['route']}: "
          f"{r['segments']} segments, K2 {r['k2_flops']:.6g} flop, K3 "
          f"{r['k3_flops']:.6g} flop, {r['camera_rays']} camera rays: "
          f"{r['segment_flops']:.1f} flop a segment")
    p = preview_flops(ctx, res, args.frames)
    print(f"preview {args.config} {w}x{h} 2 spp x {args.frames} frames, route "
          f"{p['route']}: {p['segments']} segments: {p['segment_flops']:.1f} flop a segment")
    return 0


if __name__ == "__main__":
    sys.exit(main())
