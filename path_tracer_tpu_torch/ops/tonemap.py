"""Tone mapping: gamma 2.2 with clamp, quantization to 0..255.

Parity: ``gamma_correction`` / ``to_int_with_gamma_correction``
(``src/render/mod.rs:57-63``): clamp to [0,1], x^(1/2.2), then
``(255*g + 0.5)`` truncated toward zero.

Counterpart of ``path_tracer_tpu.ops.tonemap``; the host encoder is the one
the PPM writer uses.
"""

from __future__ import annotations

import numpy as np

INV_GAMMA = 1.0 / 2.2


def quantize_np(x: np.ndarray) -> np.ndarray:
    """float (any shape) → int32 0..255 with +0.5 floor rounding.

    pow in float64 — f32 pow differs in the last ulp on ~0.4% of values,
    occasionally flipping the +0.5 floor."""
    g = np.power(np.clip(x.astype(np.float64), 0.0, 1.0), INV_GAMMA)
    return (255.0 * g + 0.5).astype(np.int32)
