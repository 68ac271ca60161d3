"""Sample passes, stepped traces and finalization.

Counterpart of ``path_tracer_tpu.render.integrator`` for:

- the regenerative passes (``render_pass``'s ``pallas3:`` and ``pallasr:``
  branches: routes ``regen``, K1, and ``prim``, K4);
- the non-regenerative pass of the interactive preview (``render_pass``'s
  last branch) with ``render_samples``' ``pallas2:`` and ``pallas``
  dispatch: routes ``stepped`` (``trace_with_kernel_v2``, K5) and
  ``stepped_prim`` (``trace_with_kernel``, K6);
- ``finalize``.

The portal route's passes are ``render.portal``'s runner. The wavefront
integrator (``trace`` and ``render_samples``' ``fast`` and ``exact``
modes, ``estimator="literal"``, ``mock_random``) is not ported yet
(ROADMAP.md, Slice 1b). The JAX package pads the stepped kernels' rays to
its block size with guaranteed-miss rays, a TPU block constraint; a CUDA
thread per ray needs no padding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_tpu_torch.ops import rng
from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
from path_tracer_tpu_torch.render.raygen import generate_rays


class TraceResult(NamedTuple):
    radiance: torch.Tensor  # [N, 3] float32
    rays_traced: torch.Tensor  # int64 scalar tensor on radiance's device


def camera_rays(cam: dict, pixel_idx: torch.Tensor, sample_idx: torch.Tensor,
                *, seed: int, width: int, height: int):
    """Camera rays (o, d) [N,3] for (pixel, sample) pairs ([N] int32).

    The two raygen uniforms of a pair are the counter generator's draws at
    depth 0, slots 4 and 5, keyed by (seed, pixel, sample): those K1's
    regen loop takes for the same sample's camera ray. cam:
    ``camera_arrays``."""
    key = rng.path_key(seed, pixel_idx.to(torch.int64), sample_idx.to(torch.int64))
    u = torch.stack([rng.uniform(key, 0, 4), rng.uniform(key, 0, 5)], dim=1)
    return generate_rays(pixel_idx, sample_idx, u, cam, width, height)


def render_samples(prep, cam: dict, pixel_idx: torch.Tensor,
                   sample_idx: torch.Tensor, *, seed: int, width: int,
                   height: int, max_depth: int = 12, rr_start_depth: int = 5,
                   mock_random: bool = False, literal: bool = False
                   ) -> TraceResult:
    """Generate camera rays for (pixel, sample) pairs ([N] int32,
    ``camera_rays``) and trace them through a ``stepped`` (K5) or
    ``stepped_prim`` (K6) route, whose kernels draw the shading uniforms
    under the same (seed, pixel, sample) key."""
    if mock_random or literal:
        raise NotImplementedError(
            "mock_random and estimator='literal' run on the wavefront "
            "integrator, ported in ROADMAP.md Slice 1b")
    o, d = camera_rays(cam, pixel_idx, sample_idx, seed=seed, width=width,
                       height=height)
    kw = dict(seed=seed, pixel_idx=pixel_idx, sample_idx=sample_idx,
              max_depth=max_depth, rr_start_depth=rr_start_depth)
    if prep.route == "stepped":
        return trace_with_kernel_v2(o, d, prep.scene, **kw)
    if prep.route == "stepped_prim":
        return trace_with_kernel(o, d, prep.kscene, **kw)
    raise ValueError(f"render_samples has no {prep.route!r} route")


def trace_with_kernel_v2(o, d, scene, **kw) -> TraceResult:
    """Trace via the stepped static-scene kernel K5 (see
    ``trace_v2.trace_stepped`` for the keywords)."""
    return TraceResult(*trace_v2.trace_stepped(scene, o, d, **kw))


def trace_with_kernel(o, d, kscene, **kw) -> TraceResult:
    """Trace via the stepped full-scene kernel K6 (see
    ``trace_kernel.trace_stepped`` for the keywords)."""
    return TraceResult(*trace_kernel.trace_stepped(kscene, o, d, **kw))


def render_pass(prep, accum: torch.Tensor, pixel_perm: torch.Tensor, *,
                seed: int, sample_base: int, quota: int, max_depth: int = 12,
                rr_start_depth: int = 5, cam: dict | None = None,
                width: int = 0, height: int = 0):
    """One pass of a route (``pipeline.Prepared``): every pixel traces
    ``quota`` samples, global indices ``sample_base ..``, in ``pixel_perm``
    order (int32 [npix]; accum [npix, 3] is in the same order).

    ``regen`` (K1) and ``prim`` (K4): one lane per pixel. ``stepped`` (K5)
    and ``stepped_prim`` (K6): one ray per (pixel, sample), made from
    ``cam`` (``camera_arrays``) at ``width`` x ``height``.

    accum is updated in place. Returns (accum, segments traced as an int64
    scalar tensor on accum's device). A regen route raises if any pixel
    finished other than exactly ``quota`` samples."""
    if prep.route in ("stepped", "stepped_prim"):
        npix = pixel_perm.shape[0]
        pixel_idx = pixel_perm.repeat_interleave(quota)
        sample_idx = torch.arange(
            sample_base, sample_base + quota, dtype=torch.int32,
            device=pixel_perm.device).repeat(npix)
        result = render_samples(
            prep, cam, pixel_idx, sample_idx, seed=seed, width=width,
            height=height, max_depth=max_depth, rr_start_depth=rr_start_depth)
        accum += result.radiance.reshape(npix, quota, 3).sum(dim=1)
        return accum, result.rays_traced
    kw = dict(seed=seed, sample_base=sample_base, quota=quota,
              max_depth=max_depth, rr_start_depth=rr_start_depth)
    if prep.route == "regen":
        rad, segs, done = trace_v2.trace_regen(prep.scene, prep.cam, pixel_perm, **kw)
    elif prep.route == "prim":
        rad, segs, done = trace_kernel.trace_regen_prim(
            prep.kscene, prep.cam, pixel_perm, **kw)
    else:
        raise ValueError(f"render_pass has no {prep.route!r} route")
    if not bool((done == quota).all()):
        raise RuntimeError(
            f"per-pixel sample counts differ from the pass quota {quota}: "
            f"min {int(done.min())}, max {int(done.max())}")
    accum += rad
    return accum, segs.sum(dtype=torch.int64)


def finalize(accum: torch.Tensor, spp: int) -> torch.Tensor:
    """Average over spp and clamp per channel to [0,1] AFTER averaging
    (mod.rs:849-856)."""
    return torch.clamp(accum / float(spp), 0.0, 1.0)
