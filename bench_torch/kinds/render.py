"""Traffic kind ``render``: one user renders the configuration's scene back
to back, a closed loop, through the program's ``render()``.

The traffic file gives ``width``, ``height`` and ``spp``; render ``i`` of a
run takes the seed ``unit_seed(seed, i)``, so every seed renders the same
sizes. Set-up renders once at the cell's size (a seed no window render
takes) to build the kernels and warm every shape.

End-to-end: ``msamples_per_s``, the camera samples (pixels x spp) of every
render completed in the window over the time from the window's start to
the last completion, counted from what was asked for.

Traced runs (``--trace 1``) time the program's ``prepare_render`` in each
render (span ``prepare_render``), keep each render's portal ``cycles`` and
``polls`` (``RenderStats.extra``), and profile the first ``trace_units``
renders: ``traced`` holds their segments (``RenderStats.num_rays``),
samples and lanes a launch.

Check: ``check.renders`` renders kept from the window at random, and
``check.pixels`` pixels of each drawn from the seed, against the reference
at the full spp: ``mean_gap``, the mean over those pixels and channels of
|program - reference|.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

import common
import devtrace
import reference

WARM_UNIT = -1  # the set-up render's unit index: no window render takes it


def _config(ctx, seed: int):
    from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution

    t = ctx.traffic
    return RenderConfig(samples_per_pixel=t["spp"],
                        resolution=Resolution(height=t["height"], width=t["width"]),
                        seed=seed, max_depth=ctx.config["max_depth"],
                        rr_start_depth=ctx.config["rr_start_depth"])


def _sync(ctx):
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> common.Outcome:
    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.render import pipeline

    t = ctx.traffic
    npix, spp = t["width"] * t["height"], t["spp"]
    scene = ctx.program_scene()

    def render(seed):
        return pt.render(scene, _config(ctx, seed), device=ctx.device,
                         out_dir=None, verbose=False)

    render(ctx.unit_seed(WARM_UNIT))
    _sync(ctx)
    setup_s = time.perf_counter() - ctx.t0

    spans = {"prepare_render": []}
    counters = {"cycles": [], "polls": []}
    prepare = pipeline.prepare_render
    if ctx.trace:
        def timed_prepare(*a, **kw):
            s = time.perf_counter()
            with torch.profiler.record_function("bench.prepare_render"):
                p = prepare(*a, **kw)
            spans["prepare_render"].append(time.perf_counter() - s)
            return p
        pipeline.prepare_render = timed_prepare

    keep = common.Reservoir(t["check"]["renders"], ctx.rng(1))
    traced = {"units": 0, "segments": 0, "samples": 0, "lanes": npix}
    prof, trace = None, None
    units = rays = 0
    walls = paused = 0.0  # paused: starting and stopping the profiler
    try:
        t0 = last = time.perf_counter()
        while True:
            seed = ctx.unit_seed(units)
            if ctx.trace and units == 0:
                prof = devtrace.Profiled().__enter__()
                paused = prof.overhead_s
            span = (torch.profiler.record_function("bench.render") if prof
                    else contextlib.nullcontext())
            with span:
                done = render(seed)
            last = time.perf_counter()
            units += 1
            rays += done.stats.num_rays
            walls += done.stats.wall_seconds
            for k in counters:
                if k in done.stats.extra:
                    counters[k].append(done.stats.extra[k])
            if prof is not None:
                traced["units"] += 1
                traced["segments"] += done.stats.num_rays
                traced["samples"] += npix * spp
            if prof is not None and (traced["units"] == t["trace_units"]
                                     or last - t0 - paused >= ctx.seconds):
                prof.__exit__(None, None, None)
                trace, prof = prof, None
                paused = trace.overhead_s
            keep.offer(lambda: (seed, done.image.pixels.copy()))
            if last - t0 - paused >= ctx.seconds:
                break
    finally:
        pipeline.prepare_render = prepare
    window = last - t0 - paused
    print(f"{units} renders of {t['width']}x{t['height']} at {spp} spp in "
          f"{window:.4f} s; route {done.stats.extra.get('route')}; "
          f"{rays / walls / 1e6:.1f} Mray/s (RenderStats.num_rays over the "
          f"renders' wall time)", flush=True)
    if trace is not None:
        trace = devtrace.summarize(trace, devtrace.port_kernel_names(common.ROOT))
    return common.Outcome(
        metrics={"setup_s": setup_s, "msamples_per_s": units * npix * spp / window / 1e6},
        attempted=units, failed=0, answers=keep.items, spans=spans,
        counters=counters, trace=trace, traced=traced)


def check(ctx, answers) -> dict:
    """``mean_gap`` of the kept renders against the reference."""
    t = ctx.traffic
    npix, spp = t["width"] * t["height"], t["spp"]
    tables = reference.load_scene(ctx.scene_path())
    sc = reference.to_device(tables, ctx.device, torch.float32)
    ctl = reference.to_device(tables, ctx.device, ctx.control) if ctx.control else None
    rng = ctx.rng(2)
    kw = dict(width=t["width"], height=t["height"], max_depth=ctx.config["max_depth"],
              rr_start_depth=ctx.config["rr_start_depth"])
    gaps = []
    for seed, image in answers:
        pix = np.sort(rng.choice(npix, size=min(t["check"]["pixels"], npix), replace=False))
        pix_t = torch.from_numpy(pix).to(ctx.device)
        ref = torch.clamp(reference.pixel_sums(sc, pix_t, 0, spp, seed=seed, **kw) / spp,
                          0.0, 1.0).cpu().numpy()
        if ctl is not None:  # the control's answer in the program's place
            got = torch.clamp(reference.pixel_sums(ctl, pix_t, 0, spp, seed=seed, **kw)
                              .float() / spp, 0.0, 1.0).cpu().numpy()
        else:
            got = image[pix]
        gaps.append(np.abs(got.astype(np.float64) - ref))
    value = float(np.mean(np.concatenate(gaps))) if gaps else float("inf")
    return {"mean_gap": {"value": value, "limit": ctx.limits["mean_gap"]["limit"]}}
