"""Host-side render orchestration.

Counterpart of ``path_tracer_tpu.render.pipeline`` for the path the JAX
package takes for every scene of at most 128 primitives (its ``pallas3:``
mode): the scene is baked into a constants tensor, and each pass launches
the regenerative trace once over all pixels, in Morton order. The
accumulator stays on the device between passes; progress, cancellation and
checkpoints happen at pass boundaries.

Cancellation parity (§3.3 of the survey): a cancelled render still produces
a ``RenderDone`` with the partial image and still writes the PPM.

The device is an explicit argument: ``"cuda"`` launches the CUDA kernel,
``"cpu"`` runs its plain torch version. Nothing falls back from one to the
other. Off this slice, and raising ``NotImplementedError``: scenes of more
than 128 primitives (``mesh``; ROADMAP.md Slice 2), ``estimator="literal"``
and ``mock_random`` (Slice 1b).
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
from path_tracer_tpu_torch.ops.kernels import trace_v2
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render.image import Image, write_ppm
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
from path_tracer_tpu_torch.utils.profiling import RenderStats

# Samples per pixel in one pass: the JAX package's pass granularity (its
# static quota cap). The kernel takes the quota at run time, so this sets
# only how often progress, cancel and checkpoints are looked at.
PASS_SAMPLES = 256


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


def prepare_scene(scene: SceneDescriptor, resolution: Resolution, device
                  ) -> tuple[trace_v2.SceneConsts, trace_v2.CameraConsts]:
    """Bake the scene (on ``device``) and the camera raygen constants.
    Counterpart of the JAX package's prepare_scene_and_mode for scenes that
    take its ``pallas3:`` mode."""
    packed = pack_scene(scene)
    consts = trace_v2.build_scene_consts(packed)
    if consts is None:
        n = packed.num_spheres + packed.num_triangles
        raise NotImplementedError(
            f"scene {scene.id!r} has {n} primitives; scenes of more than "
            f"{trace_v2.V2_MAX_PRIMS} (the portal path of the mesh scene) are "
            "ported in ROADMAP.md Slice 2")
    cam = trace_v2.build_camera_consts(
        scene.camera, resolution.width, resolution.height)
    return consts.to(device), cam


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
    scene_c, cam_c = prepare_scene(scene, res, dev)
    k = min(config.samples_per_pass or PASS_SAMPLES, spp)
    full_passes, remainder = divmod(spp, k)

    # Z-order lanes; accum lives in permuted order until finalize
    perm, inv_perm = morton_pixel_order(res.width, res.height)
    perm_dev = torch.from_numpy(perm).to(dev)
    accum = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    samples_done = 0
    pass_start = 0
    stats = RenderStats()

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
        if "mid_pass" in ck.files and int(ck["mid_pass"]):
            mismatches.append("mid-pass checkpoints need the portal runner "
                              "(ROADMAP.md Slice 2)")
        if not mismatches:
            accum = torch.from_numpy(np.asarray(ck["accum"], np.float32)).to(dev)
            samples_done = int(ck["samples_done"])
            pass_start = int(ck["next_pass"])
            stats.num_rays = int(ck["num_rays"])
            stats.resumed_samples = samples_done
            if verbose:
                print(f"Resumed from {checkpoint_path} at {samples_done}/{spp} spp")
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
    cancelled = False

    def maybe_progress(force: bool = False):
        nonlocal last_update
        if progress is None:
            return
        now = time.perf_counter()
        if not force and now - last_update < progress_interval:
            return
        last_update = now
        img = None
        if progress_snapshots and samples_done > 0:
            partial = integrator.finalize(accum, samples_done).cpu().numpy()
            img = Image.new(partial[inv_perm], res)
        progress(RenderUpdate(
            progress=min(samples_done / spp, 1.0), image=img,
            samples_done=samples_done, stats=stats,
        ))

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
        # global sample base: k = FULL pass size, so a remainder pass
        # continues the subpixel schedule where the full passes stopped
        accum, rays = integrator.render_pass(
            scene_c, cam_c, accum, perm_dev, seed=config.seed,
            sample_base=pass_idx * k, quota=k_pass,
            max_depth=config.max_depth, rr_start_depth=config.rr_start_depth,
        )
        ray_handles.append(rays)
        samples_done += k_pass
        stats.num_samples += k_pass * npix
        stats.num_dispatches += 1
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
    final_np = integrator.finalize(accum, max(samples_done, 1)).cpu().numpy()
    drain_rays()
    duration = time.perf_counter() - t_start
    stats.wall_seconds = duration

    image = Image.new(final_np[inv_perm], res)
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
