"""Sample passes and finalization.

Counterpart of ``path_tracer_tpu.render.integrator`` for the regenerative
passes (``render_pass``'s ``pallas3:`` and ``pallasr:`` branches) and
``finalize``. The portal route's passes are ``render.portal``'s runner. The
wavefront integrator (``trace``, ``render_samples``: the JAX package's
``fast`` and ``exact`` modes, ``estimator="literal"``, ``mock_random``) is
not ported yet (ROADMAP.md, Slice 1b).
"""

from __future__ import annotations

import torch

from path_tracer_tpu_torch.ops.kernels.trace_kernel import trace_regen_prim
from path_tracer_tpu_torch.ops.kernels.trace_v2 import trace_regen


def render_pass(prep, accum: torch.Tensor, pixel_perm: torch.Tensor, *,
                seed: int, sample_base: int, quota: int, max_depth: int = 12,
                rr_start_depth: int = 5):
    """One pass of a ``regen`` (K1) or ``prim`` (K4) route
    (``pipeline.Prepared``): every pixel traces ``quota`` samples, global
    indices ``sample_base ..``, one lane per pixel in ``pixel_perm`` order.

    accum [npix, 3] (in pixel_perm order) is updated in place. Returns
    (accum, segments traced as an int64 scalar tensor on accum's device).
    Raises if any pixel finished other than exactly ``quota`` samples."""
    kw = dict(seed=seed, sample_base=sample_base, quota=quota,
              max_depth=max_depth, rr_start_depth=rr_start_depth)
    if prep.route == "regen":
        rad, segs, done = trace_regen(prep.scene, prep.cam, pixel_perm, **kw)
    elif prep.route == "prim":
        rad, segs, done = trace_regen_prim(prep.kscene, prep.cam, pixel_perm,
                                           **kw)
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
