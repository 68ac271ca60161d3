"""Progressive preview renderer.

Counterpart of ``path_tracer_tpu.viewer.progressive``: the interactive
viewport's path-traced preview. Each frame traces ``spp_per_frame`` more
samples of every pixel and adds them to one accumulator on the device;
a camera move restarts the accumulation.

The scene is prepared with ``regen=False``, as the JAX package's preview
does, so the routes are camera-free (``pipeline.prepare_render``): scenes
of at most 128 primitives trace through K5 (``trace_v2.trace_stepped``),
every other scene through K6 (``trace_kernel.trace_stepped``), over rays
made by ``raygen.generate_rays``. A camera move re-uploads nothing.

Frame f traces the global samples ``f * spp_per_frame ..``, each drawing
the counter generator's numbers for its (seed, pixel, sample), the numbers
``render()`` uses for the same sample: F frames of k samples and a render
of F * k samples of one seed differ only where ulps part a path.

Threads: one renderer serialises its frames, resets and camera moves on a
lock (the HTTP viewer serves requests from several threads). Its kernels
launch on the calling thread's current CUDA stream, which is CUDA's default
stream unless the caller sets another: a full ``render()`` in another
thread queues behind or ahead of a frame on that stream. The renderer keeps
no random state and allocates its scratch per frame, so the two share
neither.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from path_tracer_tpu_torch.models.scene import SceneDescriptor
from path_tracer_tpu_torch.ops import tonemap
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render.image import Image
from path_tracer_tpu_torch.render.pipeline import prepare_render, resolve_device
from path_tracer_tpu_torch.render.raygen import camera_arrays
from path_tracer_tpu_torch.utils.config import Resolution


class ProgressiveRenderer:
    """Accumulates samples frame by frame on ``device``; ``reset()`` or
    ``move_camera()`` restart it. ``device`` defaults to ``"cuda"`` and
    raises when CUDA is missing; ``"cpu"`` runs the kernels' plain
    versions."""

    def __init__(
        self,
        scene: SceneDescriptor,
        resolution: Resolution,
        spp_per_frame: int = 2,
        seed: int = 0,
        max_depth: int = 12,
        device="cuda",
    ):
        self.scene = scene
        self.resolution = resolution
        self.spp_per_frame = spp_per_frame
        self.seed = seed
        self.max_depth = max_depth
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.prep = prepare_render(scene, resolution, self.device, regen=False)
        self._pixels = torch.arange(
            resolution.num_pixels, dtype=torch.int32, device=self.device)
        self.reset()

    def reset(self) -> None:
        """Restart accumulation (after camera or scene edits)."""
        with self._lock:
            self._reset_locked()

    def _reset_locked(self) -> None:
        self._accum = torch.zeros((self.resolution.num_pixels, 3),
                                  dtype=torch.float32, device=self.device)
        self._frame = 0
        self._cam = camera_arrays(self.scene.camera)

    @property
    def samples_done(self) -> int:
        return self._frame * self.spp_per_frame

    def step(self) -> Image:
        """Render one frame's worth of samples; returns the running image."""
        with self._lock:
            self._advance_locked()
            img = integrator.finalize(self._accum, self.samples_done)
            return Image.new(img.cpu().numpy(), self.resolution)

    def step_u8(self) -> np.ndarray:
        """One frame, fetched gamma-quantized as uint8 ``[npix, 3]``: gamma
        and quantization run on the device (``tonemap.
        to_int_with_gamma_correction``, float64 pow), byte-equal to
        ``quantize_np`` of the running image, and the frame crosses to the
        host at one byte a channel."""
        with self._lock:
            self._advance_locked()
            img8 = tonemap.to_int_with_gamma_correction(
                integrator.finalize(self._accum, self.samples_done)
            ).to(torch.uint8)
            return img8.cpu().numpy()

    def _advance_locked(self) -> None:
        res = self.resolution
        integrator.render_pass(
            self.prep, self._accum, self._pixels, seed=self.seed,
            # equal-sized frames: frame index * per-frame spp
            sample_base=self._frame * self.spp_per_frame,
            quota=self.spp_per_frame, max_depth=self.max_depth,
            cam=self._cam, width=res.width, height=res.height)
        self._frame += 1

    def move_camera(self, camera) -> None:
        with self._lock:
            self.scene.camera = camera
            self._reset_locked()
