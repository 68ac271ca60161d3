"""Throughput counters.

Counterpart of ``path_tracer_tpu.utils.profiling``: the render statistics
(Mray/s is the headline metric: traced ray segments per wall second).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RenderStats:
    """Accumulated over a render: wall time, samples, traced ray segments."""

    wall_seconds: float = 0.0
    device_seconds: float = 0.0
    num_samples: int = 0  # camera samples (pixels x spp)
    num_rays: int = 0  # traced ray segments (sum of live lanes per step)
    num_dispatches: int = 0
    # per-pixel samples restored from a checkpoint (0 = fresh render)
    resumed_samples: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def mrays_per_sec(self) -> float:
        return self.num_rays / self.wall_seconds / 1e6 if self.wall_seconds else 0.0

    @property
    def msamples_per_sec(self) -> float:
        return (
            self.num_samples / self.wall_seconds / 1e6 if self.wall_seconds else 0.0
        )


def format_eta(seconds: float) -> str:
    """h:mm:ss formatting, parity with the reference CLI's progress line
    (``cmd_render.rs:54-80``)."""
    seconds = max(int(seconds), 0)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h}:{m:02d}:{s:02d}"
