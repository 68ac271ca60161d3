"""Counter-based uniforms for the regenerative trace.

The JAX package's regen kernel draws from the TPU's hardware PRNG, seeded
per block, so its stream depends on the block layout. The port keys every
draw by what it is for instead:

    bits = mix(mix(mix(mix(0, seed), pixel), sample), depth * 8 + slot)

with ``mix(h, x) = fmix32(h ^ (x * 0x9E3779B1 + 0x7F4A7C15))`` (murmur3's
32-bit finalizer; all arithmetic mod 2^32). ``sample`` is the global sample
index, ``depth`` the path segment, and ``slot`` 0-5 follows ``draw(6)``'s
order in ``trace_kernel.regen_loop``: ``u_rr, u1, u2, u_br``, then the two
raygen draws. The bits become a float as ``trace_kernel._uniform`` does:
``(bits >> 9) | 0x3F800000`` reinterpreted, minus 1.

Keying by sample makes an image independent of how its samples are split
into passes and of the kernel's block layout. ``csrc/trace_regen.cu``
implements the same function; this module is its bit-exact torch twin. The
stream is not the TPU's: the two agree in distribution only.

Torch has no wrapping uint32 multiply, so values live in int64 and
``_mul32`` splits one factor into 16-bit halves: no partial product
exceeds 2^49.

``MOCK_RANDOMS``, ``mock_uniforms`` and ``mock_uniforms_traced`` are the
reference's MOCK_RANDOM fixture (a fixed 9-float cycle, ``mod.rs:31-45``)
as the JAX package's ``ops.rng`` reproduces it, value for value: draws
that are a pure function of a counter, for the wavefront integrator's
``mock_random`` mode.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1
MIX_ADD = 0x7F4A7C15
N_SLOTS = 6  # u_rr, u1, u2, u_br, raygen u1, raygen u2
SLOT_STRIDE = 8  # counter = depth * SLOT_STRIDE + slot


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 tensors a in [0, 2^32) and constant c."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mix(h: torch.Tensor, x: torch.Tensor | int) -> torch.Tensor:
    """One keying step: fold the value x (in [0, 2^32)) into the hash h."""
    if not isinstance(x, torch.Tensor):
        x = torch.full_like(h, int(x) & MASK32)
    return fmix32(h ^ ((_mul32(x & MASK32, GOLDEN) + MIX_ADD) & MASK32))


def path_key(seed: int, pixel: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Hash of (seed, pixel, global sample index) as int64 in [0, 2^32)."""
    h = mix(torch.zeros_like(pixel, dtype=torch.int64), int(seed) & MASK32)
    h = mix(h, pixel.to(torch.int64))
    return mix(h, sample.to(torch.int64))


def uniform_bits(key: torch.Tensor, depth: torch.Tensor | int, slot: int
                 ) -> torch.Tensor:
    """32 random bits for (path key, segment depth, slot)."""
    return mix(key, depth * SLOT_STRIDE + slot)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """``_uniform``'s conversion: the top 23 bits as a float in [0, 1)."""
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


def uniform(key: torch.Tensor, depth: torch.Tensor | int, slot: int
            ) -> torch.Tensor:
    return bits_to_uniform(uniform_bits(key, depth, slot))


# The reference's fixed mock sequence (mod.rs:33-43), rounded to f32.
MOCK_RANDOMS = np.array(
    [
        0.75902418061906407,
        0.023879213030728041,
        0.21016190197770457,
        0.78814922184253244,
        0.56819568237964491,
        0.7689823904006352,
        0.16910304067812287,
        0.54519597695203492,
        0.63614169009490062,
    ],
    dtype=np.float32,
)
MOCK_RAYGEN_BOUNCE = 15  # the raygen draws' bounce in mock_uniforms_traced


def mock_uniforms_traced(bounce: int, n: int, slots: int, device) -> torch.Tensor:
    """MOCK_RANDOM fixture for the wavefront: the draw (lane, bounce, slot)
    of a call of ``n`` lanes is ``MOCK_RANDOMS[(lane * slots * 16 + bounce *
    slots + slot) % 9]``, the index computed in int32 as the JAX package
    does. Returns [n, slots] float32 on ``device``."""
    lane = torch.arange(n, dtype=torch.int32, device=device)[:, None]
    slot = torch.arange(slots, dtype=torch.int32, device=device)[None, :]
    idx = (lane * (slots * 16) + int(bounce) * slots + slot) % len(MOCK_RANDOMS)
    return torch.from_numpy(MOCK_RANDOMS).to(device)[idx.long()]


def mock_uniforms(counter_start: int, shape, n: int, device="cpu") -> torch.Tensor:
    """Deterministic fixture: draw i returns MOCK_RANDOMS[i % 9], counting
    row-major over [*shape, n] starting at counter_start."""
    total = int(np.prod(shape)) * n
    idx = (np.arange(total, dtype=np.int64) + counter_start) % len(MOCK_RANDOMS)
    return torch.from_numpy(MOCK_RANDOMS[idx].reshape(tuple(shape) + (n,))).to(device)
