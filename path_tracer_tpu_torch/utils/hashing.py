"""Image content hashing.

Counterpart of ``path_tracer_tpu.utils.hashing`` without the native
library: a cheap, deterministic digest over the f32 bit patterns of all
pixels, used as a cache-invalidation key. Only self-consistency matters.
"""

from __future__ import annotations

import hashlib

import numpy as np


def hash_image(pixels: np.ndarray) -> int:
    """blake2b digest over the f32 bit patterns of all components."""
    data = np.ascontiguousarray(pixels, np.float32).tobytes()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
