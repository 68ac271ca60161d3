"""Progressive preview renderer.

Counterpart of ``path_tracer_tpu.viewer.progressive``: the interactive
viewport's path-traced preview. Each frame traces ``spp_per_frame`` more
samples of every pixel and adds them to one accumulator on the device;
a camera move restarts the accumulation.

The scene is prepared with ``regen=False``, as the JAX package's preview
does, so the routes are camera-free (``pipeline.prepare_render``): scenes
of at most 128 primitives trace through K5, every other scene through K6,
whose camera entries (``trace_v2.trace_camera``, ``trace_kernel.
trace_camera``) make the frame's camera rays in the kernel. ``backend``
``exact`` or ``fast`` (``pipeline.resolve_backend``) runs the frames on the
wavefront integrator instead. A camera move re-uploads nothing. The frame's pixel and sample indices are made once
(``integrator.pass_rays``); a frame adds its sample base.

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

import itertools
import threading

import numpy as np
import torch

from path_tracer_tpu_torch.models.scene import SceneDescriptor
from path_tracer_tpu_torch.ops import tonemap
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render.image import Image
from path_tracer_tpu_torch.render.pipeline import prepare_render, resolve_device
from path_tracer_tpu_torch.render.raygen import camera_arrays
from path_tracer_tpu_torch.utils import profiling
from path_tracer_tpu_torch.utils.config import Resolution


class ProgressiveRenderer:
    """Accumulates samples frame by frame on ``device``; ``reset()`` or
    ``move_camera()`` restart it. ``device`` defaults to ``"cuda"`` and
    raises when CUDA is missing; ``"cpu"`` runs the kernels' plain
    versions. ``backend`` as ``RenderConfig.backend``.

    While a profiler runs, each frame is a unit of ``utils.profiling``'s
    spans, ``("frame", renderer, n)``, n counting this renderer's frames;
    a camera move belongs to the frame after it."""

    _ids = itertools.count()

    def __init__(
        self,
        scene: SceneDescriptor,
        resolution: Resolution,
        spp_per_frame: int = 2,
        seed: int = 0,
        max_depth: int = 12,
        backend: str = "auto",
        device="cuda",
    ):
        self.scene = scene
        self.resolution = resolution
        self.spp_per_frame = spp_per_frame
        self.seed = seed
        self.max_depth = max_depth
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._id = next(self._ids)
        self._unit = ("frame", self._id, 0)  # the next frame's span unit
        self.prep = prepare_render(scene, resolution, self.device, regen=False,
                                   backend=backend)
        self._pixels = torch.arange(
            resolution.num_pixels, dtype=torch.int32, device=self.device)
        self._rays = integrator.pass_rays(self._pixels, spp_per_frame)
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
        with self._lock, profiling.span("preview.frame", None, self._unit):
            with profiling.span("preview.issue"):
                self._advance_locked()
                img = integrator.finalize(self._accum, self.samples_done)
            with profiling.span("preview.fetch"):
                pixels = img.cpu().numpy()
            return Image.new(pixels, self.resolution)

    def step_u8(self) -> np.ndarray:
        """One frame, fetched gamma-quantized as uint8 ``[npix, 3]``: gamma
        and quantization run on the device (``tonemap.
        to_int_with_gamma_correction``, float64 pow), byte-equal to
        ``quantize_np`` of the running image, and the frame crosses to the
        host at one byte a channel."""
        with self._lock, profiling.span("preview.frame", None, self._unit):
            with profiling.span("preview.issue"):
                self._advance_locked()
                img8 = tonemap.to_int_with_gamma_correction(
                    integrator.finalize(self._accum, self.samples_done)
                ).to(torch.uint8)
            with profiling.span("preview.fetch"):
                return img8.cpu().numpy()

    def _advance_locked(self) -> None:
        res = self.resolution
        integrator.render_pass(
            self.prep, self._accum, self._pixels, seed=self.seed,
            # equal-sized frames: frame index * per-frame spp
            sample_base=self._frame * self.spp_per_frame,
            quota=self.spp_per_frame, max_depth=self.max_depth,
            cam=self._cam, width=res.width, height=res.height, rays=self._rays)
        self._frame += 1
        self._unit = ("frame", self._id, self._unit[2] + 1)

    def move_camera(self, camera) -> None:
        with self._lock, profiling.span("preview.move", None, self._unit):
            self.scene.camera = camera
            self._reset_locked()
