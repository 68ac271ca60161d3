"""Camera ray generation helpers.

Counterpart of ``path_tracer_tpu.render.raygen`` (parity with
``render_pixel``, ``mod.rs:794-843``). The regenerative trace generates its
rays inside the kernel (``ops.kernels.trace_kernel.make_raygen``); this
module holds the host-precomputed camera basis and the tent filter it uses.
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
