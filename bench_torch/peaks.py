"""Published peaks of one NVIDIA H100 SXM, and the least time a piece of
work can take on it.

Both rates are NVIDIA's data sheet figures for the SXM part at its full
700 W power limit (the numbers ``chip_smoke.py`` names ``PEAK_FP32`` and
``MEM_BW``). The path tracer's kernels do scalar float32 arithmetic, so the
rate that bounds them is the float32 rate outside the tensor cores. A card
set below 700 W runs slower under load: the harness prints its power limit
beside every run.
"""

from __future__ import annotations

PEAK_FP32 = 67e12  # flop/s, float32 outside the tensor cores
MEM_BW = 3.35e12  # bytes/s of HBM3


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for ``flops`` operations that move ``nbytes``: the
    larger of the two over their peaks, and which one it is."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / MEM_BW
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
