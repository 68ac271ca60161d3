"""The benchmark's own tests run on the CPU at sizes a test run holds:

    python3 -m pytest bench_torch/tests -q

``tiny(cell, ...)`` builds a run of a cell as ``run.make_ctx`` does, on the
CPU, with the traffic cut to a few pixels, samples and frames; the limits
are the cell's own (``bench_torch/checks``)."""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import pytest  # noqa: E402

import run  # noqa: E402

TINY = {
    "render": dict(width=18, height=12, spp=8, trace_units=1,
                   check={"renders": 2, "pixels": 64}),
    "preview": dict(width=18, height=12, moves=3, still_frames=4, gestures=3,
                    trace_units=1, check={"frames": 2, "pixels": 64}),
}
with open(os.path.join(run.ROOT, "BENCHMARK.json")) as _fh:
    CELLS = [w["name"] for w in json.load(_fh)["workloads"]]


def tiny(cell: str, seed: int = 20261017123, seconds: float = 1.0, trace: int = 0):
    ctx = run.make_ctx(argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                                          trace=trace), "cpu")
    ctx.traffic.update(TINY[ctx.traffic["kind"]])
    if ctx.traffic["kind"] == "render" and ctx.config["name"] == "mesh":
        # the portal scheduler's plain versions: seconds a render at this size
        ctx.traffic.update(width=9, height=6, spp=4)
    return ctx


@pytest.fixture
def tiny_ctx():
    return tiny
