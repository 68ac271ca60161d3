"""What a torch.profiler window says about the device.

``Profiled`` wraps ``torch.profiler.profile`` (host and CUDA activity) with
a host range named ``bench.window`` around the work it traces. ``summarize``
then reduces the events to:

- ``window_s``: the length of ``bench.window``;
- ``busy_s``: the union of the device operations' intervals inside it
  (kernels, copies, fills; overlapping operations count once);
- ``ops``: how many device operations ran in it;
- ``port_s`` and ``port_launches``: the device time and the launches of
  the program's own CUDA kernels, those whose names its ``csrc`` declares
  ``__global__``;
- ``device_ops``: device time by operation name, largest first;
- ``idle_gaps``: the device's idle time inside the window, by what the
  host thread was doing at each gap's middle: the innermost host range
  open there (an aten operation, a CUDA runtime call, or one of the
  benchmark's ``bench.*`` ranges around calls into the program).
"""

from __future__ import annotations

import bisect
import glob
import os
import re
import time
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernel_names(root: str) -> frozenset[str]:
    """The names of the kernels the program's CUDA sources declare."""
    names = set()
    for path in glob.glob(os.path.join(root, "path_tracer_tpu_torch", "csrc", "*.cu*")):
        with open(path) as fh:
            names.update(_GLOBAL.findall(fh.read()))
    return frozenset(names)


def _base_name(name: str) -> str:
    """A demangled kernel name without its return type, namespaces,
    template arguments and parameters."""
    head = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return head.split("(")[0].split("<")[0].split("::")[-1].strip()


class Profiled:
    """Profile the host and the device while the block runs; the block's
    work is the ``bench.window`` range. ``overhead_s`` is the time spent
    starting and stopping the profiler (CUPTI's start-up is seconds), which
    a traced run leaves out of its window."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.range = torch.profiler.record_function(WINDOW)
        self.range.__enter__()
        self.overhead_s = time.perf_counter() - t
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.range.__exit__(*exc)
        t = time.perf_counter()
        self.prof.__exit__(*exc)
        self.overhead_s += time.perf_counter() - t
        return False


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: int
    port_s: float
    port_launches: int
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(profiled: Profiled, port_names: frozenset[str], top: int = 10) -> DeviceTrace:
    from torch.autograd import DeviceType

    events = profiled.prof.events()
    window = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError("the profiler recorded no bench.window range")
    w = window[0]
    ws, we = w.time_range.start, w.time_range.end
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("bench.") and s < we and t > ws:
                dev.append((max(s, ws), min(t, we), e.name))
        elif e.thread == w.thread and e.name != WINDOW and t > s:
            host.append((s, t, e.name))
    merged = _union((s, t) for s, t, _ in dev)
    busy = sum(t - s for s, t in merged)

    by_name: dict[str, float] = {}
    port_us, port_n = 0.0, 0
    for s, t, name in dev:
        short = _base_name(name) or name
        by_name[short] = by_name.get(short, 0.0) + (t - s)
        if _base_name(name) in port_names:
            port_us += t - s
            port_n += 1

    host.sort()
    starts = [h[0] for h in host]
    gaps: dict[str, float] = {}
    prev = ws
    for s, t in merged + [[we, we]]:
        if s > prev:
            mid = 0.5 * (prev + s)
            label = "host: no range open"
            # the innermost range open at mid is the latest-starting one
            # that has not ended; ranges nest, so look back a bounded way
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(j - 5000, -1), -1):
                if host[k][1] >= mid:
                    label = host[k][2]
                    break
            gaps[label] = gaps.get(label, 0.0) + (s - prev)
        prev = max(prev, t)

    def ranked(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return DeviceTrace(window_s=(we - ws) * 1e-6, busy_s=busy * 1e-6, ops=len(dev),
                       port_s=port_us * 1e-6, port_launches=port_n,
                       device_ops=ranked(by_name), idle_gaps=ranked(gaps))
