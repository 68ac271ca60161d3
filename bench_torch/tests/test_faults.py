"""A run whose timed path is broken underneath reads ``correct`` false.

Each test drives the rest of a run on the CPU (the program's kernels run
their plain versions there), past the harness's look for a chip, at a tiny
size: first sound, then with one fault planted in the program where it
produces its answer:

- ``altered``: every pixel of the image or frame the program finishes is
  off by 1/64 (``integrator.finalize``);
- ``half``: each pass or frame traces half its samples and scales their
  sum to the whole (``integrator.render_pass``; on the portal route, its
  pass runner), the mean taken over the half it kept."""

import contextlib

import pytest
import torch

import run
from conftest import CELLS, tiny



class _Halved:
    """A portal pass runner that runs half of each pass's samples."""

    def __init__(self, runner):
        self.runner = runner

    def __getattr__(self, name):
        return getattr(self.runner, name)

    def __call__(self, accum, pass_idx, k_pass):
        part, rays = self.runner(torch.zeros_like(accum), pass_idx, max(k_pass // 2, 1))
        accum += part * (k_pass / max(k_pass // 2, 1))
        return accum, rays


@contextlib.contextmanager
def fault(name):
    from path_tracer_tpu_torch.render import integrator, pipeline

    finalize, render_pass = integrator.finalize, integrator.render_pass
    portal = pipeline.make_portal_pass_runner_v2

    def altered(accum, spp):
        return finalize(accum, spp) + 1.0 / 64.0

    def half(prep, accum, perm, *, quota, **kw):
        if quota < 2:
            return render_pass(prep, accum, perm, quota=quota, **kw)
        part = torch.zeros_like(accum)
        kw.pop("rays", None)
        part, rays = render_pass(prep, part, perm, quota=quota // 2, **kw)
        accum += part * (quota / (quota // 2))
        return accum, rays

    if name == "altered":
        integrator.finalize = altered
    else:
        integrator.render_pass = half
        pipeline.make_portal_pass_runner_v2 = lambda *a, **kw: _Halved(portal(*a, **kw))
    try:
        yield
    finally:
        integrator.finalize, integrator.render_pass = finalize, render_pass
        pipeline.make_portal_pass_runner_v2 = portal


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run.run(tiny(cell))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", ["altered", "half"])
def test_fault_reads_not_correct(cell, name):
    with fault(name):
        result = run.run(tiny(cell))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layers(cell):
    result = run.run(tiny(cell, trace=1))
    assert result["correct"], result["checks"]
    assert "window_s" in result["device"] and result["breakdown"]["idle_gaps"]
    assert list(result)[-1] == "checks"
