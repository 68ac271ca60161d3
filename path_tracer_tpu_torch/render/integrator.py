"""Wavefront integrator, sample passes, stepped traces and finalization.

Counterpart of ``path_tracer_tpu.render.integrator``:

- ``trace``: the wavefront integrator, the reference's recursive
  ``radiance`` (``mod.rs:661-792``) as a loop over bounce depth of plain
  tensor operations (``ops.intersect``, ``ops.bsdf``), in modes ``exact``
  and ``fast``, with ``mock_random`` and ``literal`` (route ``wavefront``,
  the JAX package's XLA modes);
- the regenerative passes (``render_pass``'s ``pallas3:`` and ``pallasr:``
  branches: routes ``regen``, K1, and ``prim``, K4);
- the non-regenerative pass (``render_pass``'s other branches) with
  ``render_samples``' dispatch: the wavefront, with JAX's pixel chunking,
  and the interactive preview's ``pallas2:`` and ``pallas`` modes: routes
  ``stepped`` (K5's camera entry, ``trace_v2.trace_camera``) and
  ``stepped_prim`` (K6's, ``trace_kernel.trace_camera``);
- ``finalize``.

The portal route's passes are ``render.portal``'s runner. The JAX package
pads the stepped kernels' rays to its block size with guaranteed-miss rays,
a TPU block constraint; a CUDA thread per ray needs no padding.

The wavefront transform (expectation-preserving, as in the JAX package):

recursive form                         wavefront form
--------------                         --------------
return emission (+ color * L(next))    accum += throughput * emission
color scaling / RR rescale 1/p         throughput *= color_eff * brdf_weight
recursion                              next step with new (o, d)
miss → black                           lane dies, accum unchanged
hard cut MAX_DEPTH=12                  max_depth steps (new_depth<12 in the
                                       RR survive condition kills step 12)

A lane whose throughput becomes exactly zero dies at once. Each step
intersects only the lanes alive at its start (the JAX loop runs every lane
and keeps dead ones inert: the same values).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from path_tracer_tpu_torch.ops import rng
from path_tracer_tpu_torch.ops.bsdf import sample_bsdf
from path_tracer_tpu_torch.ops.intersect import EPS_TRI_T, intersect_scene
from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
from path_tracer_tpu_torch.render.raygen import camera_rays, generate_rays
from path_tracer_tpu_torch.utils import profiling

WAVEFRONT_MODES = ("exact", "fast")


class TraceResult(NamedTuple):
    radiance: torch.Tensor  # [N, 3] float32
    rays_traced: torch.Tensor  # int64 scalar tensor on radiance's device


def _draws(n, dev, *, seed, pixel_idx, sample_idx, uniforms, mock_random):
    """draw(bounce, lanes) → the four shading uniforms [len(lanes), 4]
    (u_rr, u1, u2, u_br) of the given lanes at segment ``bounce``: the rows
    ``bounce * 4 ..`` of the injected ``uniforms`` [max_depth * 4, N], the
    MOCK_RANDOM fixture by the lane's position in the call, or the counter
    generator keyed by (seed, pixel, sample, bounce, slot 0-3), the numbers
    the stepped kernels' plain versions and K1 draw for that sample."""
    if uniforms is not None:
        return lambda s, lanes: uniforms[s * 4:s * 4 + 4, lanes].T
    if mock_random:
        return lambda s, lanes: rng.mock_uniforms_traced(s, n, 4, dev)[lanes]
    if pixel_idx is None or sample_idx is None:
        raise ValueError("trace draws by (seed, pixel, sample): give "
                         "pixel_idx and sample_idx, or uniforms")
    key = rng.path_key(seed, pixel_idx.to(torch.int64), sample_idx.to(torch.int64))
    return lambda s, lanes: torch.stack(
        [rng.uniform(key[lanes], s, k) for k in range(4)], dim=1)


def trace(o, d, scene: dict, *, seed: int = 0, pixel_idx=None,
          sample_idx=None, uniforms=None, max_depth: int = 12,
          rr_start_depth: int = 5, mode: str = "fast",
          mock_random: bool = False, literal: bool = False) -> TraceResult:
    """Trace the rays o, d [N,3] float32 to completion through a packed
    scene (``ops.intersect.scene_tensors``) on their device.

    Uniforms: ``uniforms`` [max_depth * 4, N] if given (the stepped plain
    versions' layout), else with ``mock_random`` the reference's fixed
    9-value cycle by (lane, bounce, slot), else the counter generator keyed
    by (seed, ``pixel_idx``, ``sample_idx``) ([N] int each). literal: the
    reference's ``t > 0`` triangle acceptance (mod.rs:592) with no
    departed-triangle exclusion, instead of the shipped ``t > EPS_TRI_T`` and
    exclusion. rays_traced counts the lanes alive at each step's start, as
    the JAX loop counts them."""
    if mode not in WAVEFRONT_MODES:
        raise ValueError(f"mode must be one of {WAVEFRONT_MODES}, got {mode!r}")
    n = o.shape[0]
    dev = o.device
    draw = _draws(n, dev, seed=seed, pixel_idx=pixel_idx, sample_idx=sample_idx,
                  uniforms=uniforms, mock_random=mock_random)
    o = o.clone()
    d = d.clone()
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    prev_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)  # the lanes alive at a step's start
    rays = 0
    for s in range(max_depth):
        if lanes.numel() == 0:
            break
        rays += lanes.numel()
        lo, ld, lthr = o[lanes], d[lanes], thr[lanes]
        hit = intersect_scene(
            lo, ld, scene, mode=mode,
            prev_tri=None if literal else prev_tri[lanes],
            eps_tri_t=0.0 if literal else EPS_TRI_T,
        )
        found = hit.found
        nd = torch.sum(hit.normal * ld, dim=-1)
        nl = torch.where((nd < 0.0)[:, None], hit.normal, -hit.normal)
        u = draw(s, lanes)
        new_depth = s + 1

        # Russian roulette (mod.rs:676-683): when new_depth > rr_start_depth,
        # survive with p = max(color) only if new_depth < max_depth;
        # survivor color /= p.
        max_refl = torch.amax(hit.color, dim=-1)
        rr_applies = new_depth > rr_start_depth
        survive = (u[:, 0] < max_refl) & (new_depth < max_depth)
        die_rr = rr_applies & ~survive
        scale = torch.where(rr_applies & survive,
                            1.0 / torch.clamp(max_refl, min=1e-30), 1.0)
        color_eff = hit.color * scale[:, None]

        # Both the terminate and continue paths add emission.
        acc[lanes] += torch.where(found[:, None], lthr * hit.emission, 0.0)

        bs = sample_bsdf(ld, hit.normal, nl, hit.rtype, u[:, 1:4])
        thr_new = lthr * color_eff * bs.weight
        alive_new = found & ~die_rr & (torch.amax(thr_new, dim=-1) > 0.0)

        keep = lanes[alive_new]
        o[keep] = hit.point[alive_new]
        d[keep] = bs.direction[alive_new]
        thr[keep] = thr_new[alive_new]
        prev_tri[keep] = hit.tri[alive_new].to(torch.int64)
        lanes = keep
    return TraceResult(radiance=acc,
                       rays_traced=torch.tensor(rays, dtype=torch.int64, device=dev))


def render_samples(prep, cam: dict, pixel_idx: torch.Tensor,
                   sample_idx: torch.Tensor, *, seed: int, width: int,
                   height: int, max_depth: int = 12, rr_start_depth: int = 5,
                   mode: str | None = None, mock_random: bool = False,
                   literal: bool = False) -> TraceResult:
    """Trace the camera rays of (pixel, sample) pairs ([N] int32) through
    the prepared route (``pipeline.Prepared``).

    ``wavefront``: ``trace`` in ``mode`` (default the route's own, ``exact``
    or ``fast``). With ``mock_random`` the camera rays take the fixture's
    raygen draws (bounce 15, 2 slots) and the shading draws its cycle;
    otherwise both are the counter generator's under (seed, pixel, sample),
    as on the stepped routes, so the same samples give the same paths up to
    intersection rounding.

    ``stepped`` (K5) and ``stepped_prim`` (K6): on the card the kernels'
    camera entries make the rays (``trace_v2.trace_camera``,
    ``trace_kernel.trace_camera``); on the CPU their plain versions,
    ``camera_rays`` and the plain trace. ``mock_random`` gives them the
    fixture's camera rays, traced as given rays with counter draws, as the
    JAX package's kernels draw from their own generator; ``literal`` is
    refused, since the kernels bake the shipped estimator."""
    if mode is not None and mode not in WAVEFRONT_MODES:
        raise ValueError(f"mode must be one of {WAVEFRONT_MODES}, got {mode!r}")
    wave = prep.route == "wavefront"
    if mode is not None and not wave:
        raise ValueError(f"mode {mode!r} needs the wavefront route, not "
                         f"{prep.route!r}")
    if literal and not wave:
        raise ValueError(
            "literal estimator mode needs the wavefront integrator (backend "
            "exact/fast); the CUDA kernels bake the shipped EPS_TRI_T semantics")
    o = d = None
    if mock_random:
        u = rng.mock_uniforms_traced(rng.MOCK_RAYGEN_BOUNCE, pixel_idx.shape[0],
                                     2, pixel_idx.device)
        o, d = generate_rays(pixel_idx, sample_idx, u, cam, width, height)
    kw = dict(seed=seed, pixel_idx=pixel_idx, sample_idx=sample_idx,
              max_depth=max_depth, rr_start_depth=rr_start_depth)
    if wave:
        if o is None:
            o, d = camera_rays(cam, pixel_idx, sample_idx, seed=seed,
                               width=width, height=height)
        return trace(o, d, prep.bufs, mode=mode or prep.mode,
                     mock_random=mock_random, literal=literal, **kw)
    if prep.route == "stepped":
        if o is not None:
            return TraceResult(*trace_v2.trace_stepped(prep.scene, o, d, **kw))
        return TraceResult(*trace_v2.trace_camera(
            prep.scene, cam, width=width, height=height, **kw))
    if prep.route == "stepped_prim":
        if o is not None:
            return TraceResult(*trace_kernel.trace_stepped(prep.kscene, o, d, **kw))
        return TraceResult(*trace_kernel.trace_camera(
            prep.kscene, cam, width=width, height=height, **kw))
    raise ValueError(f"render_samples has no {prep.route!r} route")


def render_pass(prep, accum: torch.Tensor, pixel_perm: torch.Tensor, *,
                seed: int, sample_base: int, quota: int, max_depth: int = 12,
                rr_start_depth: int = 5, cam: dict | None = None,
                width: int = 0, height: int = 0, rays=None,
                mock_random: bool = False, literal: bool = False,
                pixel_chunk: int = 0, chunk_start: int = 0, work=None):
    """One pass of a route (``pipeline.Prepared``): every pixel traces
    ``quota`` samples, global indices ``sample_base ..``, in ``pixel_perm``
    order (int32 [npix]; accum [npix, 3] is in the same order).

    ``regen`` (K1) and ``prim`` (K4): one lane per pixel. ``wavefront``,
    ``stepped`` (K5) and ``stepped_prim`` (K6): one ray per (pixel, sample),
    made from ``cam`` (``camera_arrays``) at ``width`` x ``height``;
    ``rays`` is ``pass_rays(pixel_perm, quota)``, made here when not given.
    ``pixel_chunk`` (wavefront): trace only the pixels ``chunk_start ..
    chunk_start + pixel_chunk`` of ``pixel_perm`` (and of accum), the JAX
    package's chunked dispatch; ``mock_random`` and ``literal`` as in
    ``render_samples``. With ``mock_random`` a lane's draws depend on its
    position in the call, so they depend on the pass size and the chunk.
    ``work`` (``prim``): K4's counters (``trace_kernel.trace_regen_prim``).

    accum is updated in place. Returns (accum, segments traced as an int64
    scalar tensor on accum's device). A regen route raises if any pixel
    finished other than exactly ``quota`` samples."""
    if prep.route in ("wavefront", "stepped", "stepped_prim"):
        if pixel_chunk:
            pixel_perm = pixel_perm[chunk_start:chunk_start + pixel_chunk]
            rays = None
        npix = pixel_perm.shape[0]
        if rays is None:
            rays = pass_rays(pixel_perm, quota)
        pixel_idx, sample_idx = rays[0], rays[1] + sample_base
        result = render_samples(
            prep, cam, pixel_idx, sample_idx, seed=seed, width=width,
            height=height, max_depth=max_depth, rr_start_depth=rr_start_depth,
            mock_random=mock_random, literal=literal)
        accum[chunk_start:chunk_start + npix] += (
            result.radiance.reshape(npix, quota, 3).sum(dim=1))
        return accum, result.rays_traced
    if mock_random or literal:
        raise ValueError(f"mock_random and literal need the wavefront route, "
                         f"not {prep.route!r}")
    kw = dict(seed=seed, sample_base=sample_base, quota=quota,
              max_depth=max_depth, rr_start_depth=rr_start_depth)
    if prep.route == "regen":
        rad, segs, done = trace_v2.trace_regen(prep.scene, prep.cam, pixel_perm, **kw)
    elif prep.route == "prim":
        rad, segs, done = trace_kernel.trace_regen_prim(
            prep.kscene, prep.cam, pixel_perm, work=work, **kw)
    else:
        raise ValueError(f"render_pass has no {prep.route!r} route")
    with profiling.span("render.check.wait"):
        exact = bool((done == quota).all())
    if not exact:
        raise RuntimeError(
            f"per-pixel sample counts differ from the pass quota {quota}: "
            f"min {int(done.min())}, max {int(done.max())}")
    accum += rad
    return accum, segs.sum(dtype=torch.int64)


def pass_rays(pixel_perm: torch.Tensor, quota: int):
    """The stepped routes' rays of a pass of ``quota`` samples a pixel:
    (pixel index, sample index less the pass's sample base), [npix * quota]
    int32 each, pixel-major."""
    npix = pixel_perm.shape[0]
    return (pixel_perm.repeat_interleave(quota),
            torch.arange(quota, dtype=torch.int32,
                         device=pixel_perm.device).repeat(npix))


def finalize(accum: torch.Tensor, spp: int) -> torch.Tensor:
    """Average over spp and clamp per channel to [0,1] AFTER averaging
    (mod.rs:849-856)."""
    return torch.clamp(accum / float(spp), 0.0, 1.0)
