"""Instrumentation: the render statistics, spans on the device trace's
clock, the kernel libraries' load records, and the CLI's profiler trace.

Counterpart of ``path_tracer_tpu.utils.profiling``: the render statistics
(Mray/s is the headline metric: traced ray segments per wall second) and
``profiler_trace``, a ``torch.profiler`` trace written as a Chrome trace
(the JAX package's ``jax.profiler`` trace).

Spans are on exactly while a torch profiler runs (the CLI's ``--profile
DIR``, or any ``torch.profiler.profile`` around the calls) and cost one
flag read otherwise. ``span(name)`` then opens a host range ``pt.<name>``
on the profiler's timeline, so a gap in the device's work is labelled by
the span the host was in, and appends a record to an in-memory log
(``spans()``). Each record belongs to a unit, the call it was part of:
``("render", n)`` for a ``render()``, ``("frame", renderer, n)`` for a
preview frame. A span whose name ends in ``.wait`` blocks on the device.
``note(name, size, tag)`` logs a record of no length in the same way, for a
count known only once the work is done (``render.resolve``: a portal
render's resolve segments, tagged with where K3 read its rows).

A record's times are ``time.perf_counter_ns``; the profiler stamps its
events with the Unix clock (kineto's ``start_ns()``, ``time.time_ns``).
``trace_ns`` maps the one onto the other through an anchor pair of both
clocks, taken when the log is cleared and when a span opens with none open
on its thread (so at a profiler session's first span).

Load records are kept whether or not a profiler runs, since a process
loads its kernel libraries during set-up, before any profiler starts:
``ops.kernels.build.build`` and ``native.load_native`` each append one
record a library they load to ``loads()``, with the seconds spent hashing
its sources, building it (0 when it was already built) and loading it.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast


def tracing() -> bool:
    """Whether a torch profiler records: the flag its start sets and its
    stop clears."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span while no profiler runs: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, val, tb):
        return None


_OFF = _Off()


@dataclass
class SpanRecord:
    """A span: ``start_ns`` and ``end_ns`` from ``time.perf_counter_ns``
    (``end_ns`` 0 while it is open), ``parent`` the index in ``spans()`` of
    the span it opened in on its thread (-1: none), ``size`` its amount of
    work where it has one (a pass's samples, a batch's cycles), ``tag`` a
    note's label."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: tuple | None
    size: int | None
    tag: str | None = None


@dataclass(frozen=True)
class LoadRecord:
    """A kernel library's load: its source's stem, and the seconds spent
    reading and hashing its sources and headers (``hash_s``), compiling it
    (``build_s``, 0 when it was already built) and ``ctypes.CDLL``
    (``load_s``)."""

    stem: str
    hash_s: float
    build_s: float
    load_s: float

    @property
    def seconds(self) -> float:
        return self.hash_s + self.build_s + self.load_s


_spans: list[SpanRecord] = []
_loads: list[LoadRecord] = []
_lock = threading.Lock()
_local = threading.local()
_unit_ids = itertools.count()


def _clock_pair() -> tuple[int, int]:
    """(``perf_counter_ns``, the profiler's clock) read at one instant: the
    Unix clock between two reads of the other, at their midpoint."""
    a = time.perf_counter_ns()
    unix = time.time_ns()
    return (a + time.perf_counter_ns()) // 2, unix


_anchors: list[tuple[int, int]] = [_clock_pair()]


def trace_ns(ns: int) -> int:
    """A span record's time (``perf_counter_ns``) on the profiler's clock,
    the Unix time in ns of kineto's events (a ``FunctionEvent``'s
    ``time_range`` is in us from ``kineto_results.trace_start_ns()``, a
    Chrome trace's ``ts`` in us from its ``baseTimeNanoseconds``), through
    the latest anchor taken at or before it."""
    i = bisect.bisect_right(_anchors, (ns, float("inf"))) - 1
    perf, unix = _anchors[max(i, 0)]
    return ns - perf + unix


def _stack() -> list[int]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "size", "unit", "index", "range")

    def __init__(self, name, size, unit):
        self.name, self.size, self.unit = name, size, unit

    def __enter__(self):
        st = _stack()
        unit = self.unit
        if unit is None:
            unit = _spans[st[-1]].unit if st else None
        elif isinstance(unit, str):
            unit = (unit, next(_unit_ids))
        rec = SpanRecord(self.name, 0, 0, st[-1] if st else -1, unit, self.size)
        with _lock:
            if not st:
                _anchors.append(_clock_pair())
            self.index = len(_spans)
            _spans.append(rec)
        st.append(self.index)
        self.range = _RecordFunctionFast("pt." + self.name)
        self.range.__enter__()
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _spans[self.index].end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _stack().pop()
        return False


def span(name: str, size: int | None = None, unit: tuple | str | None = None):
    """A context manager around the host's work ``name``. While a profiler
    runs: a host range ``pt.<name>`` and a record in ``spans()`` with
    ``size``, in ``unit`` when it is a tuple, in a new unit ``(unit, n)``
    when it is a str, else in the unit of the span it opens in. Otherwise
    one shared no-op, with nothing built."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, size, unit)


def spanned(name: str, unit: str | None = None):
    """A decorator: each call of the function inside ``span(name, None,
    unit)`` while a profiler runs, a plain call otherwise."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, None, unit):
                return fn(*args, **kwargs)

        return traced

    return wrap


def sync_span(name: str, device) -> None:
    """While a profiler runs, a span ``name`` (a ``.wait``) around a sync of
    ``device``'s current stream, so that the device's tail of a call shows
    apart from the host's work after it. Otherwise nothing at all."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with span(name):
        if torch.device(device).type == "cuda":
            torch.cuda.current_stream(device).synchronize()


def note(name: str, size: int, tag: str | None = None) -> None:
    """While a profiler runs, a record ``name`` of no length in the span
    log, in the unit of the span open on this thread, with ``size`` and
    ``tag``: a count that is known only after the work it counts.
    Otherwise nothing at all."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    st = _stack()
    now = time.perf_counter_ns()
    rec = SpanRecord(name, now, now, st[-1] if st else -1,
                     _spans[st[-1]].unit if st else None, size, tag)
    with _lock:
        _spans.append(rec)


def spans() -> list[SpanRecord]:
    """The span log, in the order the spans opened."""
    return _spans


def clear() -> None:
    """Empty the span log (with no span open) and anchor the clocks anew."""
    with _lock:
        _spans.clear()
        _anchors[:] = [_clock_pair()]


def record_load(stem: str, hash_s: float, build_s: float, load_s: float) -> None:
    """Append a kernel library's load to ``loads()``, profiler or not."""
    with _lock:
        _loads.append(LoadRecord(stem, hash_s, build_s, load_s))


def loads() -> list[LoadRecord]:
    """The process's kernel library loads, in order."""
    return _loads


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a torch.profiler trace (host, with the ``pt.*`` spans, and
    the card's kernels when CUDA is present) into ``log_dir``/trace.json,
    a Chrome trace, when log_dir is given."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclass
class RenderStats:
    """Accumulated over a render: wall time, samples, traced ray segments
    and dispatches: the program's kernel launches on the kernel routes (one
    a pass on ``regen`` and ``prim``, two a cycle on the portal route),
    the pixel chunks of every pass on the wavefront."""

    wall_seconds: float = 0.0
    num_samples: int = 0  # camera samples (pixels x spp)
    num_rays: int = 0  # traced ray segments (sum of live lanes per step)
    num_dispatches: int = 0
    # per-pixel samples restored from a checkpoint (0 = fresh render)
    resumed_samples: int = 0
    # route; on the portal route (its runner's report) cycles, polls,
    # resolve_segments (K3's share of num_rays, restored with it
    # from a checkpoint; left out after a resume from a file without it),
    # resolve_table (render.portal.resolve_table) and resolve_group_items
    # (the live items K3 traced with a group of lanes, kept likewise)
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
