"""K2's redesign for the card: what its schedule rests on.

The persistent kernel (csrc/portal_cheap.cu) runs only on a card;
tests/test_torch_cuda.py holds it to its plain version there. Any thread
may run any slot because a slot's steps depend on the slot alone. Here, on
the CPU:

1. ``trace_cheap_regen_plain``'s ``work["slot_steps"]`` counts the steps
   each slot runs: at least its processed segments, at most the budget.
2. A slot that stopped before the budget is a fixed point: a second call
   runs it no step and leaves its column as it was.
3. Asking for ``work`` changes nothing that the plain version computes.
4. The coherence model (scripts/k2_coherence.py) counts consistently.
5. The portal scheduler's builders take the device as a required keyword.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch.ops.kernels import portal as pk
from path_tracer_tpu_torch.render import portal as rp
from path_tracer_tpu_torch.render.pipeline import prepare_render
from path_tracer_tpu_torch.utils.config import Resolution
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "k2_coherence", os.path.join(ROOT, "scripts", "k2_coherence.py"))
COHERENCE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(COHERENCE)

RES = Resolution(24, 32)
CHEAP = dict(seed=7, quota=16, sample_base=0, step_cap=64, max_depth=12)


def _pool(park_k, cycles=2):
    """(prep, a mesh pool at K2's input after ``cycles`` cycles)."""
    scene = tpt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                           os.path.join(ROOT, "meshes"))
    prep = prepare_render(scene, RES, "cpu")
    pool = rp.make_pool_v2(RES.num_pixels, rp._round_block(RES.num_pixels),
                           16, park_k=park_k, device="cpu")
    for _ in range(cycles):
        pool = pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool,
                                          park_k=park_k, **CHEAP)[0]
        pool = pk.trace_resolve_pool_plain(prep.kscene, pool, seed=7,
                                           parts=park_k + 1, park_k=park_k)[0]
    return prep, pool


@pytest.fixture(scope="module")
def k2_pool():
    return _pool(3)


def test_slot_steps_cover_processed_counts(k2_pool):
    prep, pool = k2_pool
    work: dict = {}
    _, counts = pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool,
                                           park_k=3, work=work, **CHEAP)
    steps = work["slot_steps"]
    budget = pk.cheap_steps(CHEAP["quota"], CHEAP["step_cap"],
                            CHEAP["max_depth"])
    assert steps.shape == counts.shape and steps.dtype == torch.int32
    assert bool((steps >= counts).all()) and bool((steps <= budget).all())
    # a runnable step scans once; the plain version also scans its stopped
    # frozen lanes while other lanes run
    assert 0 < int(steps.sum()) <= work["scan"]
    real = pool[pk.V2_ROW_QUOTA] > 0
    assert int((steps[real] == budget).sum()) > 0
    assert int(((steps[real] > 0) & (steps[real] < budget)).sum()) > 0
    assert int(steps[~real].sum()) == 0  # padding slots never run


def test_stopped_slot_stays_stopped(k2_pool):
    """Within a call a slot runs until it first cannot advance, and never
    again: under a budget of b steps each slot runs min(b, its steps). A
    slot that stopped before the budget is a fixed point of the next call:
    it processes nothing, its column does not change, and it takes at most
    the one step that finds its path frozen again."""
    prep, pool = k2_pool
    work: dict = {}
    out, _ = pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool, park_k=3,
                                        work=work, **CHEAP)
    steps = work["slot_steps"]
    for cap in (8, 16, 32):
        capped: dict = {}
        pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool, park_k=3,
                                   work=capped, **dict(CHEAP, step_cap=cap))
        assert torch.equal(capped["slot_steps"], torch.clamp(steps, max=cap))
    budget = pk.cheap_steps(CHEAP["quota"], CHEAP["step_cap"],
                            CHEAP["max_depth"])
    stopped = steps < budget
    assert int(stopped.sum()) > pool.shape[1] // 10
    again: dict = {}
    out2, counts2 = pk.trace_cheap_regen_plain(prep.portal, prep.cam, out,
                                               park_k=3, work=again, **CHEAP)
    assert int(again["slot_steps"][stopped].max()) <= 1
    assert int(counts2[stopped].sum()) == 0
    assert torch.equal(out2[:, stopped], out[:, stopped])


@pytest.mark.parametrize("park_k,source", [(0, "counter"), (3, "counter"),
                                           (3, "table")])
def test_work_key_changes_nothing(park_k, source):
    prep, pool = _pool(park_k, cycles=1)
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(1).random(
            (6, pool.shape[1]), dtype=np.float32))
    kw = dict(CHEAP, park_k=park_k, uniforms=uni)
    bare = pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool, **kw)
    work: dict = {}
    counted = pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool,
                                         work=work, **kw)
    assert torch.equal(bare[0], counted[0]) and torch.equal(bare[1], counted[1])
    assert int(work["slot_steps"].sum()) > 0


def test_thread_per_slot_model():
    """A warp of 32 consecutive slots runs as long as its slowest."""
    steps = torch.tensor([1] * 31 + [64] + [2] * 32 + [5] * 3)
    got = COHERENCE.thread_per_slot(steps)
    assert got["warp_steps"] == 64 + 2 + 5
    assert got["lane_share"] == pytest.approx(
        int(steps.sum()) / (32 * (64 + 2 + 5)))


@pytest.mark.parametrize("refill_min", [1, 4, 32])
def test_persistent_model_takes_every_slot_once(refill_min):
    """Every slot's steps are counted once, whatever the threshold; equal
    slots keep every lane busy; slots that take no step cost no step."""
    rng = np.random.default_rng(0)
    steps = torch.from_numpy(rng.choice([0, 1, 64], size=5000,
                                        p=[0.1, 0.3, 0.6]))
    got = COHERENCE.persistent(steps, 256, refill_min)
    assert got["lane_share"] * 32 * got["warp_steps"] == pytest.approx(
        int(steps.sum()))
    assert 0 < got["grid_share"] <= got["lane_share"] <= 1.0
    assert got["resident_lanes"] == 256
    even = COHERENCE.persistent(torch.full((1024,), 8), 256, refill_min)
    assert even["lane_share"] == 1.0 and even["grid_steps"] == 32
    none = COHERENCE.persistent(torch.zeros(1000, dtype=torch.int64), 256,
                                refill_min)
    assert none["warp_steps"] == 0 and none["grid_steps"] == 0


def test_coherence_of_a_drive(k2_pool):
    """On a drive's pool, refilling at once keeps more lanes busy than one
    thread a slot, and fewer refills come with a higher threshold."""
    prep, pool = k2_pool
    work: dict = {}
    _, counts = pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool,
                                           park_k=3, work=work, **CHEAP)
    budget = pk.cheap_steps(CHEAP["quota"], CHEAP["step_cap"],
                            CHEAP["max_depth"])
    res = COHERENCE.coherence(work["slot_steps"], counts, budget,
                              resident=pool.shape[1] // 8)
    one = res["thread_per_slot"]["lane_share"]
    at_once, at_8 = res["persistent_refill_1"], res["persistent_refill_8"]
    assert 0 < one < at_once["lane_share"] <= 1.0
    assert at_8["refills_per_warp_step"] < at_once["refills_per_warp_step"]
    assert 0 < res["share_of_steps_processing"] <= 1.0
    assert res["steps_p10_25_50_75_90"] == sorted(res["steps_p10_25_50_75_90"])


@pytest.mark.parametrize("builder", ["make_pool_v2", "_pool_from_rows",
                                     "_retired_counts",
                                     "make_portal_pass_runner_v2"])
def test_scheduler_builders_require_a_device(builder):
    """The builders that render() and the sharded runner call take no
    default device: a caller that forgets it fails at once instead of
    building a pool on the CPU."""
    calls = {
        "make_pool_v2": lambda: rp.make_pool_v2(8, 2048, 4, park_k=3),
        "_pool_from_rows": lambda: rp._pool_from_rows(
            [0], [0], [1], n_pad=2048, park_k=3),
        "_retired_counts": lambda: rp._retired_counts(
            (), torch.zeros((8, 4)), out_rows=8),
        "make_portal_pass_runner_v2": lambda: rp.make_portal_pass_runner_v2(
            None, None, None, npix=8, k_full=4, seed=0),
    }
    with pytest.raises(TypeError, match="device"):
        calls[builder]()
