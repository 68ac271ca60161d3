"""What the harness (``run.py``), the traffic kinds and the metric readers
share."""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MASK32 = 0xFFFFFFFF


def load_module(path: str):
    """Import the file at ``path`` (names may hold dots) as a module."""
    name = "bench_" + os.path.basename(path)[:-3].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unit_seed(seed: int, i: int) -> int:
    """The render seed of unit ``i`` of a run: splitmix64 of (seed, i),
    32 bits."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (i + 2) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return (z ^ (z >> 31)) & MASK32


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make):
        """Offer the item ``make()`` builds; it is built only when kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = make()



@dataclass
class Outcome:
    """What a traffic kind's run hands back to the harness."""

    metrics: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    answers: list  # kept answers, for the kind's check
    spans: dict = field(default_factory=dict)  # name -> [seconds]
    counters: dict = field(default_factory=dict)  # name -> [values]
    trace: object = None  # devtrace.DeviceTrace of the traced units
    traced: dict = field(default_factory=dict)  # work of the traced units
    free: object = None  # drops the program's state
