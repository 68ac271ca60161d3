"""Host-side render orchestration.

Counterpart of ``path_tracer_tpu.render.pipeline`` for the routes the JAX
package's ``prepare_scene_and_mode`` gives a render whose resolution is
known:

- ``regen`` (the JAX ``pallas3:`` mode): scenes of at most 128 primitives.
  The scene is baked into a constants tensor and each pass launches K1
  (``trace_v2.trace_regen``) once over all pixels, in Morton order.
- ``portal``: scenes with one mesh of at least 65 triangles and a cheap
  remainder of at most 128 primitives (``mesh``), unless PT_TPU_NO_PORTAL
  is set. Each pass runs the v2 portal scheduler (``render.portal``) over
  K2 and K3 (with ``render.portal.POOL_RESOLVE`` off, from
  PT_TPU_POOL_RESOLVE=0, K2 and K7); progress, cancel and mid-pass
  checkpoints ride its poll hook. With PT_TPU_PORTAL_V1 set, the v1
  scheduler instead (K8 and K7), which cancels and checkpoints only
  between passes, at most 64 spp a pass when checkpointing.
- ``prim`` (the JAX ``pallasr:`` mode): every other scene; each pass
  launches K4 (``trace_kernel.trace_regen_prim``) over all pixels.

The interactive preview prepares with ``regen=False``, as the JAX package's
does, and gets one of two camera-free routes, so that a camera move
rebuilds nothing on the card:

- ``stepped`` (the JAX ``pallas2:`` mode): scenes of at most 128
  primitives; rays made by ``raygen.generate_rays`` go through K5
  (``trace_v2.trace_stepped``);
- ``stepped_prim`` (the JAX ``pallas`` mode with its kernel tables): every
  other scene, through K6 (``trace_kernel.trace_stepped``).

Passes: ``min(spp, 256)`` samples for ``regen`` (``samples_per_pass``
overrides), at most 64 for ``prim`` (K4's quota cap) and at most
PT_TPU_PORTAL_PASS_CAP (default 1024) for ``portal``. The global sample
base of pass i is ``i * k`` with k the full pass size.

Cancellation keeps completed work: a cancelled render still produces a
``RenderDone`` with the partial image and still writes the PPM. A portal
pass cancelled mid-pass keeps every started sample (freeze-and-drain) and
normalizes each pixel by its exact retired count.

The device is an explicit argument: ``"cuda"`` launches the CUDA kernels,
``"cpu"`` runs their plain torch versions. Nothing falls back from one to
the other. Off this slice, and raising ``NotImplementedError``:
``estimator="literal"`` and ``mock_random`` (ROADMAP.md Slice 1b).
"""

from __future__ import annotations

import functools
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from path_tracer_tpu_torch.models.scene import SceneDescriptor, pack_scene
from path_tracer_tpu_torch.ops.kernels import portal as portal_ops
from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render.image import Image, write_ppm
from path_tracer_tpu_torch.render.portal import (
    make_portal_pass_runner, make_portal_pass_runner_v2,
)
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
from path_tracer_tpu_torch.utils.profiling import RenderStats

# Samples per pixel in one K1 pass: the JAX package's pass granularity. The
# kernel takes the quota at run time, so this sets only how often progress,
# cancel and checkpoints are looked at.
PASS_SAMPLES = 256
# Seconds between mid-pass checkpoints of a portal pass (PT_TPU_CKPT_SECS)
CKPT_SECS = 15.0


@dataclass
class RenderUpdate:
    progress: float
    image: Image | None = None
    samples_done: int = 0
    stats: RenderStats | None = None


@dataclass
class RenderDone:
    image: Image
    duration: float
    stats: RenderStats = field(default_factory=RenderStats)
    ppm_path: str | None = None
    cancelled: bool = False


@dataclass(frozen=True)
class Prepared:
    """A scene ready to render on one device: its route and what it needs.
    ``scene`` is set for ``regen`` and ``stepped``, ``portal`` and
    ``kscene`` for ``portal``, ``kscene`` alone for ``prim`` and
    ``stepped_prim``. ``cam`` (the in-kernel camera) is None for the
    stepped routes, which take their rays from outside."""

    route: str
    cam: trace_v2.CameraConsts | None
    scene: trace_v2.SceneConsts | None = None
    portal: portal_ops.PortalConsts | None = None
    kscene: trace_kernel.KernelScene | None = None


def resolve_device(device) -> torch.device:
    """The device a render runs on; raises when CUDA is asked for and
    missing (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to render with the plain torch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def prepare_render(scene: SceneDescriptor, resolution: Resolution, device,
                   *, regen: bool = True) -> Prepared:
    """Pick the route as the JAX package's prepare_scene_and_mode does and
    build its tables on ``device``. ``regen=False`` (the interactive
    preview) gives the camera-free ``stepped`` or ``stepped_prim`` route."""
    packed = pack_scene(scene)
    consts = trace_v2.build_scene_consts(packed)
    if not regen:
        if consts is not None:
            return Prepared("stepped", None, scene=consts.to(device))
        return Prepared("stepped_prim", None,
                        kscene=trace_kernel.build_kernel_scene(packed).to(device))
    cam = trace_v2.build_camera_consts(
        scene.camera, resolution.width, resolution.height)
    if consts is not None:
        return Prepared("regen", cam, scene=consts.to(device))
    kscene = trace_kernel.build_kernel_scene(packed).to(device)
    portal = None if os.environ.get("PT_TPU_NO_PORTAL") else (
        portal_ops.build_portal_consts(packed))
    if portal is not None:
        return Prepared("portal", cam, portal=portal[0].to(device),
                        kscene=kscene)
    return Prepared("prim", cam, kscene=kscene)


def prepare_scene(scene: SceneDescriptor, resolution: Resolution, device
                  ) -> tuple[trace_v2.SceneConsts, trace_v2.CameraConsts]:
    """The baked scene (on ``device``) and camera of a scene of at most 128
    primitives, for K1."""
    prep = prepare_render(scene, resolution, device)
    if prep.route != "regen":
        raise ValueError(
            f"scene {scene.id!r} has more than {trace_v2.V2_MAX_PRIMS} "
            f"primitives; it takes the {prep.route!r} route (prepare_render)")
    return prep.scene, prep.cam


@functools.lru_cache(maxsize=8)
def morton_pixel_order(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """(perm, inv): Z-order traversal of the pixel grid, so that the lanes
    of a warp cover a compact screen tile. perm[i] = pixel index visited
    i-th; inv is its inverse. Cached (callers must not mutate the arrays)."""
    p = np.arange(width * height, dtype=np.int64)
    row = p // width
    col = p % width

    def spread(v):  # 16-bit -> even bit positions
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    code = (spread(row) << 1) | spread(col)
    perm = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return perm, inv


def pass_size(route: str, spp: int, samples_per_pass: int | None) -> int:
    """Samples per pixel in one full pass of a route."""
    if route == "regen":
        return min(samples_per_pass or PASS_SAMPLES, spp)
    cap = (trace_kernel.QUOTA_CAP_PRIM if route == "prim" else
           int(os.environ.get("PT_TPU_PORTAL_PASS_CAP", "1024")))
    return min(samples_per_pass or cap, cap, spp)


def _partial_image(accum, rad, cnt, samples_done: int, npix: int):
    """Completed passes plus a pass's retired radiance, each pixel divided
    by its retired count, clamped after averaging (mod.rs:849-856)."""
    total = torch.clamp(samples_done + cnt[:npix], min=1.0)
    return torch.clamp((accum[:npix] + rad[:npix]) / total[:, None], 0.0, 1.0)


def render(
    scene: SceneDescriptor,
    config: RenderConfig,
    *,
    device,
    progress: Callable[[RenderUpdate], None] | None = None,
    progress_interval: float = 0.5,
    progress_snapshots: bool = True,
    cancel: Callable[[], bool] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    out_dir: str | None = "out",
    verbose: bool = True,
) -> RenderDone:
    """Render a scene to completion (or cancellation) on ``device``."""
    config = config.validated()
    dev = resolve_device(device)
    if config.mock_random:
        raise NotImplementedError(
            "mock_random runs on the wavefront integrator, ported in "
            "ROADMAP.md Slice 1b")
    if config.estimator == "literal":
        raise NotImplementedError(
            "estimator='literal' runs on the wavefront integrator, ported in "
            "ROADMAP.md Slice 1b")
    if checkpoint_path and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"  # np.savez appends it regardless
    res = config.resolution
    npix = res.num_pixels
    spp = config.samples_per_pixel

    if verbose:
        print(
            f"Rendering scene {scene.id} ({len(scene.objects)} objects), "
            f"{spp} samples per pixel, {res.width}x{res.height} resolution"
        )

    t_start = time.perf_counter()
    prep = prepare_render(scene, res, dev)
    k = pass_size(prep.route, spp, config.samples_per_pass)
    portal_v1 = prep.route == "portal" and bool(
        os.environ.get("PT_TPU_PORTAL_V1"))
    if portal_v1 and checkpoint_path and checkpoint_every:
        # v1 has no poll hook, so it checkpoints only between passes: keep
        # them at 64 spp, as the JAX package does (pipeline.py:361-367)
        k = min(k, 64)
    full_passes, remainder = divmod(spp, k)
    stats = RenderStats()
    stats.extra["route"] = prep.route

    runner = None
    perm_dev = inv_perm = None
    if prep.route == "portal":
        # accum in pixel order: stages add into it by their pix rows
        make_runner = (make_portal_pass_runner if portal_v1
                       else make_portal_pass_runner_v2)
        runner = make_runner(
            prep.portal, prep.cam, prep.kscene, npix=npix, k_full=k,
            seed=config.seed, max_depth=config.max_depth,
            rr_start_depth=config.rr_start_depth, device=dev)
        stats.extra["portal_runner"] = "v1" if portal_v1 else "v2"
    else:
        # Z-order lanes; accum lives in permuted order until finalize
        perm, inv_perm = morton_pixel_order(res.width, res.height)
        perm_dev = torch.from_numpy(perm).to(dev)
    accum = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    samples_done = 0
    pass_start = 0

    def unpermute(arr: np.ndarray) -> np.ndarray:
        return arr if inv_perm is None else arr[inv_perm]

    # ---- resume ----
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        mismatches = [
            f"{name} {int(ck[name])} != {want}"
            for name, want in (
                ("seed", config.seed), ("spp", spp), ("npix", npix), ("k", k),
            )
            if int(ck[name]) != want
        ]
        if ck["accum"].shape != (npix, 3):
            mismatches.append(f"accum shape {ck['accum'].shape} != {(npix, 3)}")
        mid_pass = "mid_pass" in ck.files and int(ck["mid_pass"])
        if mid_pass and runner is None:
            mismatches.append("mid-pass checkpoint needs the portal route "
                              "(scene or PT_TPU_NO_PORTAL changed?)")
        elif mid_pass:
            got = str(ck["slot_layout"]) if "slot_layout" in ck.files \
                else "single"
            if got != runner.slot_layout:
                mismatches.append(f"slot layout {got} != {runner.slot_layout}")
        if not mismatches:
            accum = torch.from_numpy(np.asarray(ck["accum"], np.float32)).to(dev)
            samples_done = int(ck["samples_done"])
            pass_start = int(ck["next_pass"])
            stats.num_rays = int(ck["num_rays"])
            stats.resumed_samples = samples_done
            if mid_pass:
                # resume INTO pass `pass_start`: every remaining sample id
                # renders exactly once
                runner.resume_slots = (
                    ck["slot_pix"], ck["slot_done"], ck["slot_quota"])
                runner.resume_cycle0 = int(ck["cycle0"])
            if verbose:
                print(f"Resumed from {checkpoint_path} at {samples_done}/{spp} spp"
                      + (" (mid-pass)" if mid_pass else ""))
        else:
            # a silently dropped checkpoint would discard hours of
            # accumulation without a trace — ALWAYS say why it was ignored
            print(
                f"WARNING: ignoring checkpoint {checkpoint_path} "
                f"(config mismatch: {'; '.join(mismatches)}); "
                "rendering restarts from zero",
                file=sys.stderr,
            )

    # segment counts stay on the device until a checkpoint or the end
    ray_handles: list[torch.Tensor] = []

    def drain_rays():
        nonlocal ray_handles
        if ray_handles:
            stats.num_rays += int(torch.stack(ray_handles).sum().item())
        ray_handles = []

    last_update = 0.0
    last_image_t = 0.0
    last_image_cost = 0.0
    cancelled = False
    current_k_pass = 0

    def maybe_progress(force: bool = False, extra_samples: float = 0.0,
                       snapshot=None):
        # extra_samples: the portal hook's mid-pass completion estimate;
        # snapshot: its partial image of the pass (radiance, counts)
        nonlocal last_update, last_image_t, last_image_cost
        if progress is None:
            return
        now = time.perf_counter()
        if not force and now - last_update < progress_interval:
            return
        last_update = now
        img = None
        if progress_snapshots and snapshot is not None:
            # previews cost a device round trip: at most ~10% of the render
            if force or now - last_image_t >= max(
                    progress_interval, 10.0 * last_image_cost):
                rad, cnt = snapshot()
                partial = _partial_image(accum, rad, cnt, samples_done, npix)
                img = Image.new(partial.cpu().numpy(), res)
                last_image_t = time.perf_counter()
                last_image_cost = last_image_t - now
        elif progress_snapshots and samples_done > 0:
            partial = integrator.finalize(accum, samples_done).cpu().numpy()
            img = Image.new(unpermute(partial), res)
        progress(RenderUpdate(
            progress=min((samples_done + extra_samples) / spp, 1.0), image=img,
            samples_done=samples_done, stats=stats,
        ))

    if hasattr(runner, "set_hooks") and (
            progress is not None or cancel is not None
            or (checkpoint_path and checkpoint_every)):
        # progress, cancel and time-based checkpoints ride the drive's poll
        # hook: a portal pass is up to 1024 spp, far too coarse for them
        mid_ckpt = bool(checkpoint_path and checkpoint_every)
        ck_state = {"t": time.monotonic()}
        ck_secs = float(os.environ.get("PT_TPU_CKPT_SECS", str(CKPT_SECS)))

        def portal_hook(cycle, w, unfin, *, snapshot=None):
            if progress is not None:
                frac = 1.0 - min(unfin / runner.total_slots, 1.0)
                maybe_progress(extra_samples=frac * current_k_pass,
                               snapshot=snapshot)
            if cancel is not None and cancel():
                return "cancel"
            if mid_ckpt and time.monotonic() - ck_state["t"] >= ck_secs:
                return "pause"
            return False

        def save_mid_pass(accum_dev, slot_rows, pass_idx, k_pass):
            # accum holds every retired sample; slot_rows = (pix, done,
            # quota) give the remaining per-slot ranges [done, quota). The
            # current pass's rays so far stay with the runner: num_rays in
            # the file is a floor.
            drain_rays()
            np.savez(
                checkpoint_path,
                accum=accum_dev.cpu().numpy(),
                samples_done=samples_done,
                next_pass=pass_idx,
                seed=config.seed, spp=spp, npix=npix, k=k,
                num_rays=stats.num_rays,
                mid_pass=1,
                cycle0=int(runner.last_pause_cycles),
                slot_layout=runner.slot_layout,
                slot_pix=slot_rows[0], slot_done=slot_rows[1],
                slot_quota=slot_rows[2],
            )
            ck_state["t"] = time.monotonic()

        runner.set_hooks(on_check=portal_hook,
                         on_pause=save_mid_pass if mid_ckpt else None)

    def run_pass(pass_idx: int, k_pass: int):
        nonlocal accum
        if runner is not None:
            accum, rays = runner(accum, pass_idx, k_pass)
            return rays
        accum, rays = integrator.render_pass(
            prep, accum, perm_dev, seed=config.seed, sample_base=pass_idx * k,
            quota=k_pass, max_depth=config.max_depth,
            rr_start_depth=config.rr_start_depth)
        return rays

    # ---- pass schedule: full passes of k samples, then one remainder pass ----
    schedule = [(i, k) for i in range(pass_start, full_passes)]
    if remainder and full_passes >= pass_start:
        schedule.append((full_passes, remainder))

    for pass_idx, k_pass in schedule:
        if cancel is not None and cancel():
            if verbose:
                print("Canceling render prematurely")
            cancelled = True
            break
        current_k_pass = k_pass
        ray_handles.append(run_pass(pass_idx, k_pass))
        stats.num_dispatches += 1
        if runner is not None and runner.last_cancelled:
            # cancelled mid-pass by freeze-and-drain: every started sample
            # is in accum, runner.last_partial_counts holds the counts
            if verbose:
                print("Canceling render prematurely")
            cancelled = True
            break
        samples_done += k_pass
        stats.num_samples += k_pass * npix
        maybe_progress()

        if checkpoint_path and checkpoint_every and (
            (pass_idx + 1) % checkpoint_every == 0
        ):
            drain_rays()  # the snapshot stores the count up to this pass
            np.savez(
                checkpoint_path,
                accum=accum.cpu().numpy(),
                samples_done=samples_done,
                next_pass=pass_idx + 1,
                seed=config.seed,
                spp=spp,
                npix=npix,
                k=k,
                num_rays=stats.num_rays,
            )

    # ---- finalize ----
    if cancelled and runner is not None and runner.last_partial_counts is not None:
        # normalize each pixel by its exact retired count: completed passes
        # plus the cancelled pass's ragged counts
        cnt = runner.last_partial_counts
        stats.num_samples += int(cnt.sum().item())
        final = _partial_image(accum, torch.zeros_like(accum), cnt,
                               samples_done, npix)
    else:
        final = integrator.finalize(accum, max(samples_done, 1))
    final_np = final.cpu().numpy()
    drain_rays()
    duration = time.perf_counter() - t_start
    stats.wall_seconds = duration
    if runner is not None:
        stats.extra.update(cycles=runner.total_cycles, polls=runner.total_polls)

    image = Image.new(unpermute(final_np), res)
    if verbose:
        print("Rendering complete" if not cancelled else "Rendering cancelled")

    ppm_path = None
    if out_dir is not None:
        ppm_path = write_ppm(image, scene.id, spp, duration, out_dir=out_dir)

    if checkpoint_path and not cancelled and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)

    maybe_progress(force=True)
    return RenderDone(
        image=image,
        duration=duration,
        stats=stats,
        ppm_path=ppm_path,
        cancelled=cancelled,
    )
