"""Traffic kind ``preview``: one viewer user drags the camera of the
interactive preview, a closed loop, through the program's
``ProgressiveRenderer`` (the preview layer's entry, below the HTTP app).

The traffic is a series of gestures. A gesture is ``moves`` camera moves,
each followed by one ``step_u8`` frame, then ``still_frames`` frames that
accumulate. A move orbits the scene's home camera about the point
``pivot_distance`` ahead of it: the gesture's yaw grows by a step drawn from
``yaw_step_deg`` in a direction drawn per gesture, its pitch wanders by
steps drawn from ``pitch_step_deg``, as a mouse drag does. The ``gestures``
gestures are drawn once from ``pose_seed``; a run plays them in an order
drawn from its seed, a new order each round, so every seed draws the same
set of poses. The renderer's own seed is ``unit_seed(seed, 0)``.

Set-up builds the renderer (``spp_per_frame`` samples a frame at ``width``
x ``height``) and plays one gesture, which builds the kernels and warms
every shape a frame uses.

End-to-end: ``preview_fps``, the frames ``step_u8`` returned in the window
over the window; ``restart_p95_ms``, the 95th percentile over every move
in the window of the time from ``move_camera`` to the first new frame on
the host.

Traced runs profile the first ``trace_units`` gestures; ``traced`` holds
their frames and the segments ``integrator.render_pass`` returned for them.

Check: per stratum (``restart``: the frame after a move; ``settled``: a
gesture's last still frame; ``any``), ``check.frames`` frames kept from the
window at random, and ``check.pixels`` pixels of each drawn from the seed,
against the reference's frame at the same pose and sample count:
``mean_gap_u8``, the mean over those pixels and channels of
|program - reference| in 8-bit levels.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

import common
import devtrace
import reference

UP = np.array([0.0, 1.0, 0.0])


def _rotate(v, axis, angle):
    axis = axis / np.linalg.norm(axis)
    return (v * np.cos(angle) + np.cross(axis, v) * np.sin(angle)
            + axis * np.dot(axis, v) * (1.0 - np.cos(angle)))


def gestures(traffic: dict, home: dict) -> list[list[tuple]]:
    """The traffic's gestures: each a list of ``moves`` poses (position,
    direction toward the pivot), float32, orbiting ``home``."""
    rng = np.random.default_rng(traffic["pose_seed"])
    pos = np.asarray(home["position"], np.float64)
    d = np.asarray(home["direction"], np.float64)
    pivot = pos + d / np.linalg.norm(d) * traffic["pivot_distance"]
    out = []
    for _ in range(traffic["gestures"]):
        sign = rng.choice([-1.0, 1.0])
        yaw = pitch = 0.0
        poses = []
        for _ in range(traffic["moves"]):
            yaw += sign * rng.uniform(*traffic["yaw_step_deg"])
            pitch += rng.uniform(-1.0, 1.0) * traffic["pitch_step_deg"]
            v = _rotate(pos - pivot, UP, np.radians(yaw))
            v = _rotate(v, np.cross(v, UP), np.radians(pitch))
            p = (pivot + v).astype(np.float32)
            poses.append((p, (pivot - p).astype(np.float32)))
        out.append(poses)
    return out


def run(ctx) -> common.Outcome:
    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.render import integrator
    from path_tracer_tpu_torch.utils.config import Resolution
    from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer

    t = ctx.traffic
    scene = ctx.program_scene()
    home = {"position": scene.camera.position.copy(),
            "direction": scene.camera.direction.copy()}
    plan = gestures(t, home)
    spp = t["spp_per_frame"]
    r = ProgressiveRenderer(scene, Resolution(height=t["height"], width=t["width"]),
                            spp_per_frame=spp, seed=ctx.unit_seed(0),
                            max_depth=ctx.config["max_depth"], device=ctx.device)

    def play(g, window=None):
        """Gesture ``g``: its moves, each with a frame, then its still
        frames; stops where the window closes."""
        for pos, direction in plan[g]:
            s = time.perf_counter()
            r.move_camera(pt.Camera.looking(pos, direction))
            frame = r.step_u8()
            if window is not None:
                window.frame(pos, direction, 1, frame, time.perf_counter() - s)
                if window.closed():
                    return
        for n in range(2, t["still_frames"] + 2):
            frame = r.step_u8()
            if window is not None:
                window.frame(pos, direction, n, frame, None)
                if window.closed():
                    return

    play(0)
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0

    window = _Window(ctx)
    segments: list = []
    render_pass = integrator.render_pass
    if ctx.trace:
        def counted_pass(*a, **kw):
            acc, rays = render_pass(*a, **kw)
            if window.profiling:
                segments.append(rays)
            return acc, rays
        integrator.render_pass = counted_pass

    order_rng = ctx.rng(1)
    prof, trace = None, None
    played = 0
    try:
        window.open()
        while not window.closed():
            for g in order_rng.permutation(len(plan)):
                if ctx.trace and played == 0:
                    prof = devtrace.Profiled().__enter__()
                    window.profiling, window.paused = True, prof.overhead_s
                with (torch.profiler.record_function("bench.gesture") if prof
                      else contextlib.nullcontext()):
                    play(int(g), window)
                played += 1
                if prof is not None and (played == t["trace_units"] or window.closed()):
                    prof.__exit__(None, None, None)
                    trace, prof = prof, None
                    window.profiling, window.paused = False, trace.overhead_s
                    window.traced["units"] = played
                if window.closed():
                    break
    finally:
        integrator.render_pass = render_pass
    seconds = window.last - window.t0 - window.paused
    window.traced["segments"] = int(sum(int(h) for h in segments))
    if trace is not None:
        trace = devtrace.summarize(trace, devtrace.port_kernel_names(common.ROOT))
    restart_ms = np.asarray(window.restarts) * 1e3
    print(f"{window.frames} frames, {len(restart_ms)} moves of {t['width']}x{t['height']} "
          f"at {spp} spp a frame in {seconds:.4f} s; route {r.prep.route}; restart "
          f"median {np.median(restart_ms):.4f} ms", flush=True)

    def free():
        nonlocal r
        r = None

    answers = [(k, a) for k, res in window.keep.items() for a in res.items]
    return common.Outcome(
        metrics={"setup_s": setup_s, "preview_fps": window.frames / seconds,
                 "restart_p95_ms": float(np.percentile(restart_ms, 95))},
        attempted=window.frames, failed=0, answers=answers, trace=trace,
        traced=window.traced, free=free)


class _Window:
    """The measured window: its frames, the restart time of each move, the
    answers kept for the check, and the work of the traced gestures.
    ``paused`` is the profiler's start and stop, left out of the window."""

    def __init__(self, ctx):
        t = ctx.traffic
        self.seconds, self.settled = ctx.seconds, t["still_frames"] + 1
        self.frame_samples = t["width"] * t["height"] * t["spp_per_frame"]
        self.frames, self.restarts = 0, []
        self.t0 = self.last = None
        self.paused, self.profiling = 0.0, False
        self.keep = {k: common.Reservoir(t["check"]["frames"], ctx.rng(10 + i))
                     for i, k in enumerate(("restart", "settled", "any"))}
        self.traced = {"units": 0, "frames": 0, "segments": 0, "samples": 0,
                       "lanes": self.frame_samples}

    def open(self):
        self.t0 = self.last = time.perf_counter()

    def closed(self) -> bool:
        return self.last - self.t0 - self.paused >= self.seconds

    def frame(self, pos, direction, n, frame, restart_s):
        """A frame returned: the ``n``-th since its move."""
        self.last = time.perf_counter()
        self.frames += 1
        if restart_s is not None:
            self.restarts.append(restart_s)
        item = lambda: (pos, direction, n, frame)  # noqa: E731
        self.keep["any"].offer(item)
        if n == 1:
            self.keep["restart"].offer(item)
        elif n == self.settled:
            self.keep["settled"].offer(item)
        if self.profiling:
            self.traced["frames"] += 1
            self.traced["samples"] += self.frame_samples


def check(ctx, answers) -> dict:
    """``mean_gap_u8`` of the kept frames against the reference."""
    t = ctx.traffic
    npix, spp = t["width"] * t["height"], t["spp_per_frame"]
    tables = reference.load_scene(ctx.scene_path())
    file_cam = dict(tables.pop("camera_file"))
    rng = ctx.rng(2)
    kw = dict(seed=ctx.unit_seed(0), width=t["width"], height=t["height"],
              max_depth=ctx.config["max_depth"], rr_start_depth=ctx.config["rr_start_depth"])
    gaps = []
    for _, (pos, direction, n, frame) in answers:
        cam = dict(file_cam, position=pos, direction=reference.normalize(direction))
        tables["camera"] = reference.camera_basis(cam)
        pix = np.sort(rng.choice(npix, size=min(t["check"]["pixels"], npix), replace=False))
        pix_t = torch.from_numpy(pix).to(ctx.device)
        sc = reference.to_device(tables, ctx.device, torch.float32)
        ref = reference.quantize(torch.clamp(
            reference.pixel_sums(sc, pix_t, 0, n * spp, **kw) / (n * spp), 0.0, 1.0))
        if ctx.control:  # the control's frame in the program's place
            ctl = reference.to_device(tables, ctx.device, ctx.control)
            got = reference.quantize(torch.clamp(
                reference.pixel_sums(ctl, pix_t, 0, n * spp, **kw).float() / (n * spp),
                0.0, 1.0)).cpu().numpy()
        else:
            got = frame[pix].astype(np.int64)
        gaps.append(np.abs(got.astype(np.int64) - ref.cpu().numpy().astype(np.int64)))
    value = float(np.mean(np.concatenate(gaps))) if gaps else float("inf")
    return {"mean_gap_u8": {"value": value, "limit": ctx.limits["mean_gap_u8"]["limit"]}}
