"""Timing and throughput instrumentation.

Counterpart of ``path_tracer_tpu.utils.profiling``: wall-clock scopes
(``Timer``, ``timed``), the render statistics (Mray/s is the headline
metric: traced ray segments per wall second), and ``profiler_trace``, a
``torch.profiler`` trace written as a Chrome trace (the JAX package's
``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    name: str = ""
    elapsed: float = 0.0
    _start: float | None = None

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._start is not None:
            self.elapsed += time.perf_counter() - self._start
            self._start = None
        return self.elapsed


@contextlib.contextmanager
def timed(name: str = "", verbose: bool = False):
    t = Timer(name).start()
    try:
        yield t
    finally:
        t.stop()
        if verbose:
            print(f"Elapsed time ({name}): {t.elapsed:.4f}s")


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a torch.profiler trace (host, and the card's kernels when
    CUDA is present) into ``log_dir``/trace.json, a Chrome trace, when
    log_dir is given."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
