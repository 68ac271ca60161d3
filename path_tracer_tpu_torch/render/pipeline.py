"""Host-side render orchestration.

Counterpart of ``path_tracer_tpu.render.pipeline`` for the routes the JAX
package's ``prepare_scene_and_mode`` gives a render whose resolution is
known:

- ``regen`` (the JAX ``pallas3:`` mode): scenes of at most 128 primitives.
  The scene is baked into a constants tensor and each pass launches K1
  (``trace_v2.trace_regen``) once over all pixels, in Morton order.
- ``portal``: scenes with one mesh of at least 65 triangles and a cheap
  remainder of at most 128 primitives (``mesh``), unless PT_TPU_NO_PORTAL
  is set. Each pass runs the portal scheduler (``render.portal``) over K2
  and K3; progress, cancel and mid-pass checkpoints ride its poll hook.
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
``PORTAL_PASS_CAP`` for ``portal``, ``wavefront_pass``'s for
``wavefront``. The global sample base of pass i is ``i * k`` with k the
full pass size. A pass runner runs a route's passes (``make_pass_runner``):
``LanePasses`` those of ``regen``, ``prim`` and ``wavefront``,
``render.portal.PortalPasses`` the portal's; ``render`` drives progress,
cancel, checkpoints and the finalize through it alone.

Cancellation keeps completed work: a cancelled render still produces a
``RenderDone`` with the partial image and still writes the PPM. A portal
pass cancelled mid-pass keeps every started sample (freeze-and-drain) and
normalizes each pixel by its exact retired count.

The wavefront route (the JAX ``exact`` and ``fast`` modes): backend
``exact`` or ``fast`` (``jnp`` means ``fast``), and every render with
``mock_random`` or ``estimator="literal"``, which switch a kernel route to
``fast``. It runs ``integrator.trace`` in plain torch, no kernel, with the
JAX package's pass size and pixel chunking: a lane budget of
``DEFAULT_LANE_BUDGET``, bounded to ~2 GB of ``[lanes, T]`` intermediates
(``wavefront_pass``), chunks of the Morton order padded with pixel 0.
The backends ``auto``, ``mxu`` and ``pallas`` mean the kernel routes above
on both devices: on a CPU the port runs its kernels' plain versions, where
the JAX package resolves ``auto`` to ``fast``.

The device is an explicit argument: ``"cuda"`` launches the CUDA kernels
(and runs the wavefront on the card), ``"cpu"`` runs their plain torch
versions. Nothing falls back from one to the other.

While a profiler runs, a render is a unit of ``utils.profiling``'s spans:
``render`` around the call, and inside it ``render.prepare`` (with a span
a stage: ``prepare_render``), ``render.upload``, one ``render.pass`` a
pass, ``render.wait`` (a sync that only a traced render makes, so the
device's tail shows apart from the host's), ``render.fetch`` (the image
put in pixel order on the device, and its copy to the host),
``render.finish`` (the ``Image``, its digest handed to the worker),
``render.ppm`` and ``render.checkpoint``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from path_tracer_tpu_torch.models.scene import SceneDescriptor, pack_scene
from path_tracer_tpu_torch.ops.intersect import check_fp32_matmul, scene_tensors
from path_tracer_tpu_torch.ops.kernels import portal as portal_ops
from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render.image import Image, write_ppm
from path_tracer_tpu_torch.render.raygen import camera_arrays
from path_tracer_tpu_torch.render.portal import (
    PortalPasses, is_mid_pass, make_portal_pass_runner_v2,
)
from path_tracer_tpu_torch.utils import profiling
from path_tracer_tpu_torch.utils.config import BACKENDS, RenderConfig, Resolution
from path_tracer_tpu_torch.utils.profiling import RenderStats

# Samples per pixel in one K1 pass: the JAX package's pass granularity. The
# kernel takes the quota at run time, so this sets only how often progress,
# cancel and checkpoints are looked at.
PASS_SAMPLES = 256
# Samples per pixel in one portal pass at most: progress, cancel and
# checkpoints ride its polls, so a pass may be long
PORTAL_PASS_CAP = 1024
# Seconds between mid-pass checkpoints of a portal pass (PT_TPU_CKPT_SECS)
CKPT_SECS = 15.0
# Wavefront lanes (pixels x samples) in one dispatch, the JAX package's
DEFAULT_LANE_BUDGET = 2 * 1024 * 1024


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
    ``stepped_prim``, ``bufs`` (``intersect.scene_tensors``) and ``mode``
    (``exact`` or ``fast``) for ``wavefront``. ``cam`` (the in-kernel
    camera) is None for the stepped and wavefront routes, which make their
    rays outside a kernel."""

    route: str
    cam: trace_v2.CameraConsts | None
    scene: trace_v2.SceneConsts | None = None
    portal: portal_ops.PortalConsts | None = None
    kscene: trace_kernel.KernelScene | None = None
    bufs: dict | None = None
    mode: str = ""


def resolve_backend(backend: str) -> str:
    """``exact`` or ``fast`` (the wavefront), or ``kernel`` (the routes of
    ``prepare_render``): ``jnp`` means ``fast``; ``auto``, ``mxu`` and
    ``pallas`` mean the kernel routes on every device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend in ("exact", "fast"):
        return backend
    return "fast" if backend == "jnp" else "kernel"


def wavefront_pass(npix: int, spp: int, samples_per_pass: int, mode: str,
                   n_tris: int, pixel_chunk: int = 0) -> tuple[int, int]:
    """(samples per pixel in a pass, pixels in a chunk, 0 for none) of a
    wavefront render, by the JAX package's rule: a budget of
    DEFAULT_LANE_BUDGET lanes, at most ~2 GB of [lanes, T] intermediates
    (36 bytes a lane-triangle exact, 16 fast); chunks when even one sample
    a pixel exceeds it. A mock_random image depends on both."""
    per = 36 if mode == "exact" else 16
    budget = min(DEFAULT_LANE_BUDGET, max(2_000_000_000 // (n_tris * per), 4096))
    k = samples_per_pass or min(max(1, budget // max(npix, 1)), spp)
    chunk = pixel_chunk
    if not chunk and npix > budget:
        chunk = max(budget // k, 4096)
    if chunk >= npix:
        chunk = 0
    return k, chunk


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


@profiling.spanned("render.prepare")
def prepare_render(scene: SceneDescriptor, resolution: Resolution, device,
                   *, regen: bool = True, backend: str = "auto") -> Prepared:
    """Pick the route as the JAX package's prepare_scene_and_mode does and
    build its tables on ``device``. ``backend`` (``resolve_backend``)
    ``exact`` or ``fast`` gives the ``wavefront`` route. ``regen=False``
    (the interactive preview) gives the camera-free ``stepped`` or
    ``stepped_prim`` route.

    A kernel route builds its tables on the host in stages, each a span
    inside ``render.prepare``: ``.pack`` (``pack_scene``), ``.consts`` (K1's
    scene, None past 128 primitives, and the camera), ``.kscene``
    (``trace_kernel.build_kernel_scene``), ``.portal`` (the portal's split),
    then copies them to ``device`` in one ``.copy`` span whose size is the
    bytes copied."""
    with profiling.span("render.prepare.pack"):
        packed = pack_scene(scene)
    mode = resolve_backend(backend)
    if mode != "kernel":
        return Prepared("wavefront", None, bufs=scene_tensors(packed, device),
                        mode=mode)
    with profiling.span("render.prepare.consts"):
        consts = trace_v2.build_scene_consts(packed)
        cam = trace_v2.build_camera_consts(
            scene.camera, resolution.width, resolution.height) if regen else None
    kscene = portal = None
    if consts is None:
        kscene = trace_kernel.build_kernel_scene(packed)
        if regen and not os.environ.get("PT_TPU_NO_PORTAL"):
            with profiling.span("render.prepare.portal"):
                split = portal_ops.build_portal_consts(packed)
            portal = None if split is None else split[0]
    tables = (consts, kscene, portal)
    size = (sum(t.nbytes for t in tables if t is not None)
            if profiling.tracing() else None)
    with profiling.span("render.prepare.copy", size):
        consts, kscene, portal = (None if t is None else t.to(device)
                                  for t in tables)
    if consts is not None:
        return Prepared("regen" if regen else "stepped", cam, scene=consts)
    if portal is not None:
        return Prepared("portal", cam, portal=portal, kscene=kscene)
    return Prepared("prim" if regen else "stepped_prim", cam, kscene=kscene)


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
    """Samples per pixel in one full pass of a kernel route (the wavefront's
    is ``wavefront_pass``)."""
    if route == "regen":
        return min(samples_per_pass or PASS_SAMPLES, spp)
    cap = trace_kernel.QUOTA_CAP_PRIM if route == "prim" else PORTAL_PASS_CAP
    return min(samples_per_pass or cap, cap, spp)


class LanePasses:
    """The pass runner of the ``regen`` (K1), ``prim`` (K4) and
    ``wavefront`` routes: a lane a pixel in Morton order
    (``morton_pixel_order``), so that the lanes of a warp cover a compact
    screen tile, with accum [rows, 3] in that order (checkpoints keep it)
    and its images put in pixel order on the device by ``unpermute``.
    ``runner(accum, pass_idx, k_pass)`` runs one ``integrator.render_pass``
    a pass, or one a pixel chunk of ``chunk`` pixels on the wavefront,
    whose last chunk's pad lanes redo pixel 0 (their rows are cropped at
    the end), and returns (accum, segments traced) as ``PortalPasses``
    does. A pass runs whole: no hook stops it and no checkpoint resumes
    into it.

    On the ``prim`` route the runner keeps K4's counters across passes
    (``work``: an int64 [4] tensor on the device that every pass adds its
    warp queries, their tested tiles, their opened runs of tiles and the
    sphere rows its scans tested to, ``trace_kernel.WORK_KEYS``);
    ``segments`` reads them with the passes' counts in one transfer and
    ``report`` puts them into a render's stats and notes. A resumed
    render's earlier passes were not counted, so it reports none."""

    last_partial_counts = None  # no pass stops midway

    def __init__(self, prep: Prepared, res: Resolution, device, *, k: int,
                 chunk: int = 0, **pass_kw):
        npix = res.num_pixels
        self.prep, self.k, self.chunk, self.pass_kw = prep, k, chunk, pass_kw
        # K4's segments, warp queries, tested tiles, opened runs and tested
        # sphere rows over the passes, and where it read its rows
        # (``trace_kernel.k4_table``)
        self.work = self.prim = None
        if prep.route == "prim":
            n = len(trace_kernel.WORK_KEYS)
            self.work = torch.zeros(n, dtype=torch.int64, device=device)
            self.pass_kw = dict(pass_kw, work=self.work)
            self.prim = [0] * (n + 1)
            self.prim_table = trace_kernel.k4_table(prep.kscene, device)
        self.rows = -(-npix // chunk) * chunk if chunk else npix
        # built in numpy, on this thread alone: a torch CPU op splits over
        # the intra-op threads and waits for the slowest, which the previous
        # render's digest, still running on a core, can hold up
        order = np.zeros(self.rows, np.int32)
        order[:npix] = morton_pixel_order(res.width, res.height)[0]
        self.perm = torch.from_numpy(order).to(device)
        self.dispatches = 0

    def hooks(self, on_check=None, on_pause=None):
        """No poll runs inside a lane pass: the hooks go unused."""
        return contextlib.nullcontext()

    def __call__(self, accum, pass_idx, k_pass):
        kw = dict(self.pass_kw, sample_base=pass_idx * self.k, quota=k_pass)
        if not self.chunk:
            self.dispatches += 1
            return integrator.render_pass(self.prep, accum, self.perm, **kw)
        rays = 0
        for start in range(0, self.rows, self.chunk):
            accum, r = integrator.render_pass(
                self.prep, accum, self.perm, pixel_chunk=self.chunk,
                chunk_start=start, **kw)
            rays = rays + r
            self.dispatches += 1
        return accum, rays

    def segments(self, rays: list) -> int:
        """The segments of the passes' ``rays`` (scalar tensors), read in
        one transfer with K4's counters on the ``prim`` route, which
        restart."""
        total = torch.stack(rays).sum()
        if self.work is None:
            return int(total.item())
        counts = torch.cat([total.view(1), self.work]).tolist()
        self.work.zero_()
        if self.prim is not None:
            self.prim = [a + b for a, b in zip(self.prim, counts)]
        return counts[0]

    def checkpoint_fields(self) -> dict:
        """The portal route's counters, which every checkpoint keeps: none
        of them counts on these routes."""
        return dict.fromkeys(PortalPasses.COUNTERS, 0)

    def resume_mismatches(self, ck) -> list[str]:
        return (["mid-pass checkpoint needs the portal route (scene or "
                 "PT_TPU_NO_PORTAL changed?)"] if is_mid_pass(ck) else [])

    def resume(self, ck) -> None:
        self.prim = None  # the file's passes were not counted

    def unpermute(self, img: torch.Tensor) -> torch.Tensor:
        """``img`` (one row a pixel, accum's first npix rows' order) in
        pixel order, on its device: a scatter by the permutation the
        passes hold."""
        out = torch.empty_like(img)
        out[self.perm[:img.shape[0]]] = img
        return out

    def report(self, stats: RenderStats) -> None:
        """The launches into ``stats``; on the ``prim`` route, while every
        pass of the render is counted, K4's segments, warp queries, tested
        tiles, opened runs of tiles, tested sphere rows and table too, also
        as the ``render.prim``, ``render.prim.query``, ``render.prim.tiles``,
        ``render.prim.groups`` and ``render.prim.spheres`` notes."""
        stats.num_dispatches = self.dispatches
        if self.prim is None:
            return
        segments, queries, tiles, groups, spheres = self.prim
        stats.extra.update(prim_segments=segments, prim_queries=queries,
                           prim_tiles=tiles, prim_groups=groups,
                           prim_spheres=spheres, prim_table=self.prim_table)
        profiling.note("render.prim", segments, self.prim_table)
        profiling.note("render.prim.query", queries)
        profiling.note("render.prim.tiles", tiles)
        profiling.note("render.prim.groups", groups)
        profiling.note("render.prim.spheres", spheres)


def make_pass_runner(prep: Prepared, scene: SceneDescriptor,
                     config: RenderConfig, device):
    """The pass runner of ``prep``'s route, built on ``device``: the one
    place after ``prepare_render`` that looks at the route. Either runner
    has ``k`` (the full pass size), ``rows`` (accum's), ``runner(accum,
    pass_idx, k_pass) -> (accum, rays)``, ``hooks``, ``segments``,
    ``last_partial_counts``, ``checkpoint_fields``, ``resume_mismatches``,
    ``resume``, ``unpermute`` and ``report``."""
    res, spp = config.resolution, config.samples_per_pixel
    kw = dict(seed=config.seed, max_depth=config.max_depth,
              rr_start_depth=config.rr_start_depth)
    if prep.route == "wavefront":
        if prep.mode == "fast":
            check_fp32_matmul(device)
        k, chunk = wavefront_pass(res.num_pixels, spp, config.samples_per_pass,
                                  prep.mode, prep.bufs["tri_v"].shape[0],
                                  config.pixel_chunk)
        return LanePasses(prep, res, device, k=k, chunk=chunk,
                          cam=camera_arrays(scene.camera), width=res.width,
                          height=res.height, mock_random=config.mock_random,
                          literal=config.estimator == "literal", **kw)
    k = pass_size(prep.route, spp, config.samples_per_pass)
    if prep.route == "portal":
        return make_portal_pass_runner_v2(
            prep.portal, prep.cam, prep.kscene, npix=res.num_pixels,
            k_full=k, device=device, **kw)
    return LanePasses(prep, res, device, k=k, **kw)


def _partial_image(accum, rad, cnt, samples_done: int, npix: int):
    """Completed passes plus a pass's retired radiance, each pixel divided
    by its retired count, clamped after averaging (mod.rs:849-856)."""
    total = torch.clamp(samples_done + cnt[:npix], min=1.0)
    return torch.clamp((accum[:npix] + rad[:npix]) / total[:, None], 0.0, 1.0)


@profiling.spanned("render", unit="render")
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
    debug_nans: bool = False,
) -> RenderDone:
    """Render a scene to completion (or cancellation) on ``device``.
    ``debug_nans``: raise FloatingPointError as soon as the accumulator
    holds a non-finite value after a pass."""
    config = config.validated()
    dev = resolve_device(device)
    backend = config.backend
    if ((config.mock_random or config.estimator == "literal")
            and resolve_backend(backend) == "kernel"):
        # both are wavefront semantics: the kernels bake the shipped
        # estimator and draw from the counter generator
        backend = "fast"
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
    prep = prepare_render(scene, res, dev, backend=backend)
    stats = RenderStats()
    stats.extra["route"] = prep.route

    with profiling.span("render.upload"):
        runner = make_pass_runner(prep, scene, config, dev)
        accum = torch.zeros((runner.rows, 3), dtype=torch.float32, device=dev)
    k = runner.k
    full_passes, remainder = divmod(spp, k)
    samples_done = 0
    pass_start = 0

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
        if ck["accum"].shape != (runner.rows, 3):
            mismatches.append(
                f"accum shape {ck['accum'].shape} != {(runner.rows, 3)} "
                "(chunking)")
        mismatches += runner.resume_mismatches(ck)
        if not mismatches:
            accum = torch.from_numpy(np.asarray(ck["accum"], np.float32)).to(dev)
            samples_done = int(ck["samples_done"])
            pass_start = int(ck["next_pass"])
            stats.num_rays = int(ck["num_rays"])
            stats.resumed_samples = samples_done
            # a mid-pass file resumes INTO pass `pass_start`
            runner.resume(ck)
            if verbose:
                print(f"Resumed from {checkpoint_path} at {samples_done}/{spp} spp"
                      + (" (mid-pass)" if is_mid_pass(ck) else ""))
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
            stats.num_rays += runner.segments(ray_handles)
        ray_handles = []

    def write_checkpoint(accum_dev, next_pass, **fields):
        # every retired sample is in accum; a mid-pass file's ``fields``
        # give each slot's remaining range, and the rays of the pass so far
        # stay with the runner: num_rays in the file is a floor
        with profiling.span("render.checkpoint"):
            drain_rays()
            np.savez(
                checkpoint_path,
                accum=accum_dev.cpu().numpy(),
                samples_done=samples_done,
                next_pass=next_pass,
                seed=config.seed, spp=spp, npix=npix, k=k,
                num_rays=stats.num_rays,
                **runner.checkpoint_fields(),
                **fields,
            )

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
            partial = integrator.finalize(accum[:npix], samples_done)
            img = Image.new(runner.unpermute(partial).cpu().numpy(), res)
        progress(RenderUpdate(
            progress=min((samples_done + extra_samples) / spp, 1.0), image=img,
            samples_done=samples_done, stats=stats,
        ))

    # progress, cancel and time-based checkpoints also ride a portal pass's
    # poll hook: a pass is up to PORTAL_PASS_CAP spp, far too coarse for them
    mid_ckpt = bool(checkpoint_path and checkpoint_every)
    last_ckpt = time.monotonic()
    ck_secs = float(os.environ.get("PT_TPU_CKPT_SECS", str(CKPT_SECS)))

    def poll_hook(cycle, w, unfin, *, snapshot=None):
        if progress is not None:
            frac = 1.0 - min(unfin / npix, 1.0)
            maybe_progress(extra_samples=frac * current_k_pass,
                           snapshot=snapshot)
        if cancel is not None and cancel():
            return "cancel"
        if mid_ckpt and time.monotonic() - last_ckpt >= ck_secs:
            return "pause"
        return False

    def save_mid_pass(accum_dev, pass_idx, fields):
        nonlocal last_ckpt
        write_checkpoint(accum_dev, pass_idx, **fields)
        last_ckpt = time.monotonic()

    hooked = progress is not None or cancel is not None or mid_ckpt

    # ---- pass schedule: full passes of k samples, then one remainder pass ----
    schedule = [(i, k) for i in range(pass_start, full_passes)]
    if remainder and full_passes >= pass_start:
        schedule.append((full_passes, remainder))

    with runner.hooks(on_check=poll_hook if hooked else None,
                      on_pause=save_mid_pass if mid_ckpt else None):
        for pass_idx, k_pass in schedule:
            if cancel is not None and cancel():
                if verbose:
                    print("Canceling render prematurely")
                cancelled = True
                break
            current_k_pass = k_pass
            with profiling.span("render.pass", k_pass):
                accum, rays = runner(accum, pass_idx, k_pass)
                ray_handles.append(rays)
            if debug_nans and not bool(torch.isfinite(accum).all()):
                raise FloatingPointError(
                    f"non-finite radiance in the accumulator after pass "
                    f"{pass_idx} ({int((~torch.isfinite(accum)).any(dim=1).sum())} "
                    "pixels)")
            if runner.last_partial_counts is not None:
                # cancelled mid-pass by freeze-and-drain: every started
                # sample is in accum, the runner holds the counts
                if verbose:
                    print("Canceling render prematurely")
                cancelled = True
                break
            samples_done += k_pass
            stats.num_samples += k_pass * npix
            maybe_progress()
            if mid_ckpt and (pass_idx + 1) % checkpoint_every == 0:
                # the file stores the count up to this pass
                write_checkpoint(accum, pass_idx + 1)

    # ---- finalize ----
    profiling.sync_span("render.wait", dev)
    cnt = runner.last_partial_counts
    if cnt is not None:
        # normalize each pixel by its exact retired count: completed passes
        # plus the cancelled pass's ragged counts
        stats.num_samples += int(cnt.sum().item())
        final = _partial_image(accum, torch.zeros_like(accum), cnt,
                               samples_done, npix)
    else:
        final = integrator.finalize(accum[:npix], max(samples_done, 1))
    with profiling.span("render.fetch"):
        final_np = runner.unpermute(final).cpu().numpy()
    drain_rays()
    duration = time.perf_counter() - t_start
    stats.wall_seconds = duration
    runner.report(stats)

    with profiling.span("render.finish"):
        # the digest runs on the worker while the caller goes on
        image = Image.new(final_np, res)
    if verbose:
        print("Rendering complete" if not cancelled else "Rendering cancelled")

    ppm_path = None
    if out_dir is not None:
        with profiling.span("render.ppm"):
            ppm_path = write_ppm(image, scene.id, spp, duration,
                                 out_dir=out_dir)

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
