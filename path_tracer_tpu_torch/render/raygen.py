"""Camera ray generation.

Counterpart of ``path_tracer_tpu.render.raygen`` (parity with
``render_pixel``, ``mod.rs:794-843``). The regenerative traces generate
their rays inside the kernel (``ops.kernels.trace_kernel.make_raygen``);
the stepped traces of the interactive preview take rays made here by
``generate_rays``. This module also holds the host-precomputed camera basis
and the tent filter both use.
"""

from __future__ import annotations

import numpy as np
import torch

from path_tracer_tpu_torch.models.camera import Camera


def camera_arrays(camera: Camera) -> dict[str, np.ndarray]:
    """Host-precomputed camera basis (lens_center/orthogonals once per render,
    parity with mod.rs:998-999)."""
    su, sv = camera.orthogonals()
    return {
        "sensor_origin": np.asarray(camera.position, np.float32),
        "su": su,
        "sv": sv,
        "lens_center": camera.lens_center(),
    }


def tent_filter(u: torch.Tensor) -> torch.Tensor:
    """u in [0,1) → tent-distributed offset in (-1, 1)."""
    r = 2.0 * u
    return torch.where(
        r < 1.0,
        torch.sqrt(r) - 1.0,
        1.0 - torch.sqrt(torch.clamp(2.0 - r, min=0.0)),
    )


def generate_rays(pixel_idx: torch.Tensor, sample_idx: torch.Tensor,
                  u: torch.Tensor, cam: dict, width: int, height: int):
    """pixel_idx [N] int, sample_idx [N] int, u [N,2] uniforms → (o, d)
    [N,3] float32 on u's device, in the JAX function's arithmetic: pixel →
    (x, y) with the y flip, the 2x2 subpixel ``(s % 2, (s // 2) % 2)``, the
    tent filter, ``/ width`` and ``/ height``, and d scaled by the rsqrt of
    its summed squares. cam: ``camera_arrays``' float32 vectors."""
    y = (height - 1 - torch.div(pixel_idx, width, rounding_mode="floor")).to(torch.float32)
    x = torch.remainder(pixel_idx, width).to(torch.float32)
    ysub = torch.remainder(torch.div(sample_idx, 2, rounding_mode="floor"), 2).to(torch.float32)
    xsub = torch.remainder(sample_idx, 2).to(torch.float32)
    xf = tent_filter(u[:, 0])
    yf = tent_filter(u[:, 1])
    sx = (x + 0.5 * (0.5 + xsub + xf)) / float(width) - 0.5
    sy = (y + 0.5 * (0.5 + ysub + yf)) / float(height) - 0.5
    so, su, sv, lc = (np.asarray(cam[k], np.float32).tolist() for k in (
        "sensor_origin", "su", "sv", "lens_center"))
    dd = [lc[k] - (so[k] + su[k] * sx + sv[k] * sy) for k in range(3)]
    dl = torch.rsqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
    d = torch.stack([dd[k] * dl for k in range(3)], dim=1)
    o = torch.tensor(lc, dtype=torch.float32, device=u.device).expand(d.shape[0], 3)
    return o.contiguous(), d
