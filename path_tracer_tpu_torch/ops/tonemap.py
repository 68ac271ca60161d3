"""Tone mapping: gamma 2.2 with clamp, quantization to 0..255.

Parity: ``gamma_correction`` / ``to_int_with_gamma_correction``
(``src/render/mod.rs:57-63``): clamp to [0,1], x^(1/2.2), then
``(255*g + 0.5)`` truncated toward zero.

Counterpart of ``path_tracer_tpu.ops.tonemap``. The host encoder
``quantize_np`` is the one the PPM writer uses; ``to_int_with_gamma_correction``
is the same quantizer on tensors, for the preview's on-device transport.
Both take the pow in float64, so their bytes are equal: the JAX package's
float32 pow differs from the host encoder in the last ulp on ~0.4% of
values, which can flip the +0.5 floor.
"""

from __future__ import annotations

import numpy as np
import torch

INV_GAMMA = 1.0 / 2.2


def quantize_np(x: np.ndarray) -> np.ndarray:
    """float (any shape) → int32 0..255 with +0.5 floor rounding.

    pow in float64 — f32 pow differs in the last ulp on ~0.4% of values,
    occasionally flipping the +0.5 floor."""
    g = np.power(np.clip(x.astype(np.float64), 0.0, 1.0), INV_GAMMA)
    return (255.0 * g + 0.5).astype(np.int32)


def gamma_correction(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0,1], then x^(1/2.2), in float64 on x's device."""
    return torch.pow(torch.clamp(x.to(torch.float64), 0.0, 1.0), INV_GAMMA)


def to_int_with_gamma_correction(x: torch.Tensor) -> torch.Tensor:
    """float tensor (any shape) → int32 0..255 with +0.5 floor rounding,
    byte-equal to ``quantize_np`` of the same values."""
    return (255.0 * gamma_correction(x) + 0.5).to(torch.int32)
