"""Portal host prep, K2 and K3: the port's plain versions against JAX.

1. Host: ``build_portal_consts`` equal to the JAX package's (the cheap
   scene's tables, the padded AABB bit for bit) for every built-in scene
   and the synthetic portal scene of tests/test_portal.py:529.
2. K2 ``trace_cheap_regen_plain`` against the JAX ``trace_cheap_regen`` in
   interpret mode (PRNG stub: zeros; the port given a table of zeros), park
   depths 1 and 3, step cap 4, two successive calls from a fresh pool; K3
   ``trace_resolve_pool_plain`` against ``trace_pallas_resolve_pool`` on the
   pool after those calls, all parts, under injected uniforms. The JAX
   outputs are committed under tests/golden/gpu/ by
   scripts/make_torch_portal_goldens.py (the interpreter takes minutes at
   park depth 3); a slow test regenerates them.
   Tolerance: every row of the JAX layout, per pool column, within 1e-4
   (relative and absolute) on all but MAX_BAD columns of the 864 real
   slots; the padding slots (born retired) must come out untouched. The
   limits are the measured disagreement plus one column: K2 disagrees on
   0 or 1 slot a call, K3 on 4 (park depth 1) and 5 (park depth 3).
   Reason: the interpreter runs under XLA, which contracts a*b+c into FMAs
   and rounds sqrt, rsqrt, sin and cos differently from torch; on the
   synthetic scene's 100-radius floor sphere the expanded sphere test
   cancels catastrophically, so such ulps flip a few hit decisions.
   The port's own sample rows are checked by invariants: every path in
   flight carries a distinct sample index below its slot's started count.
3. Per-slot independence, which makes one CUDA thread per slot faithful:
   K2 and K3 give a slot the same result in any pool of slots.
The CUDA kernels against these plain versions are in test_torch_cuda.py.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops.pallas import portal as j_pm
from path_tracer_tpu_torch.ops.kernels import portal as t_pm
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from path_tracer_tpu_torch.render import portal as t_rp
from tests.test_torch_host import SCENE_IDS, load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_portal_goldens",
    os.path.join(ROOT, "scripts", "make_torch_portal_goldens.py"))
GOLDENS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GOLDENS)
synthetic_portal = GOLDENS.synthetic_portal_scene

COL_TOL = 1e-4
MAX_BAD = {"k2": 2, "k3": 6}  # disagreeing real slots allowed (see above)


def _synth_port():
    """The synthetic scene in the port: (PortalConsts, camera, KernelScene,
    npix, pool width)."""
    scene = synthetic_portal(tpt)
    packed = tpt.pack_scene(scene)
    pc, _ = t_pm.build_portal_consts(packed)
    cam = t_tv2.build_camera_consts(scene.camera, GOLDENS.WIDTH, GOLDENS.HEIGHT)
    npix = GOLDENS.WIDTH * GOLDENS.HEIGHT
    return pc, cam, t_tk.build_kernel_scene(packed), npix, t_rp._round_block(npix)


@pytest.mark.parametrize("sid", SCENE_IDS + ["synth-portal"])
def test_portal_consts_equal(repo_root, sid):
    if sid == "synth-portal":
        js, ts = synthetic_portal(jpt), synthetic_portal(tpt)
    else:
        js, ts = load_both(sid, repo_root)
    j = j_pm.build_portal_consts(jpt.pack_scene(js))
    t = t_pm.build_portal_consts(tpt.pack_scene(ts))
    assert (j is None) == (t is None)
    assert (t is not None) == (sid in ("mesh", "synth-portal"))
    if t is None:
        return
    (jconsts, jheavy), (tconsts, theavy) = j, t
    assert jheavy == theavy
    want = t_pm.portal_consts_from_jax(jconsts)
    assert torch.equal(want.scene.prims, tconsts.scene.prims)
    assert torch.equal(want.scene.gates, tconsts.scene.gates)
    assert np.float32(want.lo).tobytes() == np.float32(tconsts.lo).tobytes()
    assert np.float32(want.hi).tobytes() == np.float32(tconsts.hi).tobytes()


def _check_columns(kernel, port, jax_rows, before, npix):
    """The real slots agree but for MAX_BAD[kernel] columns; the padding
    slots are left as they were, by both sides."""
    close = np.isclose(port[:, :npix], jax_rows[:, :npix], rtol=COL_TOL,
                       atol=COL_TOL).all(axis=0)
    assert (~close).sum() <= MAX_BAD[kernel], (kernel, int((~close).sum()))
    np.testing.assert_array_equal(port[:, npix:], before[:, npix:])
    np.testing.assert_array_equal(jax_rows[:, npix:], before[:, npix:])


def _check_sample_rows(pool, park_k, sample_base):
    """Every path in flight (the live active path, each non-empty buffer)
    carries a sample index in [sample_base, sample_base + started), the
    indices of one slot are distinct, and in-flight paths number
    started - done."""
    pool = pool.numpy()
    started = pool[t_pm.V3_ROW_STARTED]
    flight = [(pool[t_pm.ROW_ALIVE] > 0, pool[t_pm.sample_row(park_k)])]
    for j in range(park_k):
        flight.append((pool[t_pm.buf_row(j, t_pm.BUF_STATE)] > 0.5,
                       pool[t_pm.sample_row(park_k, j)]))
    count = sum(m.astype(np.float32) for m, _ in flight)
    np.testing.assert_array_equal(count, started - pool[t_pm.V2_ROW_DONE])
    for m, s in flight:
        assert np.all((s[m] >= sample_base) & (s[m] < sample_base + started[m]))
    for a in range(len(flight)):
        for b in range(a + 1, len(flight)):
            both = flight[a][0] & flight[b][0]
            assert np.all(flight[a][1][both] != flight[b][1][both])
    return int(count.sum())


@pytest.mark.parametrize("park_k", [1, 3])
def test_k2_plain_matches_jax_zero_stub(park_k):
    pc, cam, _, npix, n = _synth_port()
    spp, depth = GOLDENS.SHAPES[park_k]
    pool = t_rp.make_pool_v2(npix, n, spp, park_k=park_k)
    jrows = t_pm.pool_rows(park_k)
    in_flight = 0
    for call, seed in enumerate(GOLDENS.CHEAP_SEEDS, start=1):
        before = pool[:jrows].numpy().copy()
        pool, counts = t_pm.trace_cheap_regen_plain(
            pc, cam, pool, seed=seed, quota=spp, sample_base=0,
            step_cap=GOLDENS.STEP_CAP, park_k=park_k, max_depth=depth,
            uniforms=torch.zeros((6, n)))
        want = GOLDENS.load(f"k2_park{park_k}_call{call}")
        _check_columns("k2", pool[:jrows].numpy(), want, before, npix)
        in_flight = _check_sample_rows(pool, park_k, 0)
        assert int(counts.sum()) >= 0
    assert in_flight > 0  # paths are parked and frozen: K3 has work
    # every buffer holds frozen paths, so the resolve test below means much
    for j in range(park_k):
        assert (pool[t_pm.buf_row(j, t_pm.BUF_STATE)] == 1.0).any()


@pytest.mark.parametrize("park_k", [1, 3])
def test_k3_plain_matches_jax_injected_uniforms(park_k):
    _, _, ks, npix, n = _synth_port()
    _, depth = GOLDENS.SHAPES[park_k]
    jax_pool = GOLDENS.load(f"k2_park{park_k}_call2")
    pool = torch.cat([torch.from_numpy(jax_pool), torch.zeros((1 + park_k, n))])
    out, counts = t_pm.trace_resolve_pool_plain(
        ks, pool, seed=GOLDENS.RESOLVE_SEED, parts=park_k + 1, park_k=park_k,
        max_depth=depth,
        uniforms=torch.from_numpy(GOLDENS.uniforms(park_k, n)))
    want = GOLDENS.load(f"k3_park{park_k}")
    jrows = t_pm.pool_rows(park_k)
    _check_columns("k3", out[:jrows].numpy(), want, jax_pool, npix)
    # the port's rows are carried through untouched
    assert torch.equal(out[jrows:], pool[jrows:])
    # bookkeeping: done rose by the paths that ended, and no buffer is left
    # frozen (every frozen path was resolved to ready or empty)
    assert int(counts.sum()) > 0
    for j in range(park_k):
        assert not (out[t_pm.buf_row(j, t_pm.BUF_STATE)] == 1.0).any()


@pytest.mark.slow
def test_goldens_regenerate_unchanged():
    """The committed JAX outputs are what the JAX kernels give today."""
    for park_k in GOLDENS.SHAPES:
        for name, arr in GOLDENS.jax_outputs(park_k).items():
            np.testing.assert_array_equal(arr, GOLDENS.load(name))


def test_slots_are_independent():
    """A slot's K2 and K3 results do not depend on which other slots share
    the pool (so a thread per slot, stopping on its own, is the JAX block
    loop lane by lane): the pool run whole equals it run in two halves."""
    pc, cam, ks, npix, n = _synth_port()
    park_k, spp, depth = 3, 6, 5
    pool = t_rp.make_pool_v2(npix, n, spp, park_k=park_k)
    kw = dict(seed=9, quota=spp, sample_base=12, step_cap=8, park_k=park_k,
              max_depth=depth)
    for _ in range(2):
        whole, c_whole = t_pm.trace_cheap_regen_plain(pc, cam, pool, **kw)
        halves = [t_pm.trace_cheap_regen_plain(pc, cam, part, **kw)
                  for part in (pool[:, :n // 2], pool[:, n // 2:])]
        assert torch.equal(whole, torch.cat([h[0] for h in halves], dim=1))
        assert torch.equal(c_whole, torch.cat([h[1] for h in halves]))
        rkw = dict(seed=9, parts=park_k + 1, park_k=park_k, max_depth=depth)
        res, _ = t_pm.trace_resolve_pool_plain(ks, whole, **rkw)
        res_h = [t_pm.trace_resolve_pool_plain(ks, whole[:, s], **rkw)[0]
                 for s in (slice(0, n // 2), slice(n // 2, n))]
        assert torch.equal(res, torch.cat(res_h, dim=1))
        pool = res
    assert float(pool[t_pm.V2_ROW_DONE].sum()) > 0


def test_k2_step_budget():
    """A call runs at most cheap_steps(quota, step_cap, max_depth) steps a
    slot (the JAX bound rounded up to its 8-step granule); without a cap
    every slot ends the call unable to advance."""
    assert t_pm.cheap_steps(5, 4, 4) == 8
    assert t_pm.cheap_steps(256, 64, 12) == 64
    assert t_pm.cheap_steps(2, 0, 3) == 16
    pc, cam, _, npix, n = _synth_port()
    pool = t_rp.make_pool_v2(npix, n, 4, park_k=1)
    out, counts = t_pm.trace_cheap_regen_plain(
        pc, cam, pool, seed=1, quota=4, sample_base=0, step_cap=8, park_k=1,
        max_depth=3)
    assert int(counts.max()) <= 8
    out, _ = t_pm.trace_cheap_regen_plain(
        pc, cam, pool, seed=1, quota=4, sample_base=0, step_cap=0, park_k=1,
        max_depth=3)
    alive = out[t_pm.ROW_ALIVE] > 0
    can_start = (out[t_pm.V3_ROW_STARTED] < out[t_pm.V2_ROW_QUOTA]) | (
        out[t_pm.buf_row(0, t_pm.BUF_STATE)] > 1.5)
    buf_full = out[t_pm.buf_row(0, t_pm.BUF_STATE)] > 0.5
    # dead slots have nothing to start; live ones are frozen, buffer full
    assert not (~alive & can_start).any()
    assert (alive <= buf_full).all()


def test_wrappers_on_cpu_are_the_plain_versions():
    pc, cam, ks, npix, n = _synth_port()
    pool = t_rp.make_pool_v2(npix, n, 3, park_k=2)
    kw = dict(seed=2, quota=3, sample_base=0, step_cap=8, park_k=2, max_depth=4)
    before = (t_pm.trace_cheap_regen.launches, t_pm.trace_resolve_pool.launches)
    a = t_pm.trace_cheap_regen(pc, cam, pool, **kw)
    b = t_pm.trace_cheap_regen_plain(pc, cam, pool, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rkw = dict(seed=2, parts=3, park_k=2, max_depth=4)
    a = t_pm.trace_resolve_pool(ks, b[0], **rkw)
    c = t_pm.trace_resolve_pool_plain(ks, b[0], **rkw)
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    assert (t_pm.trace_cheap_regen.launches,
            t_pm.trace_resolve_pool.launches) == before
    assert torch.equal(pool, t_rp.make_pool_v2(npix, n, 3, park_k=2))  # unchanged


@pytest.mark.parametrize("bad", ["rows", "park_k", "parts", "uniforms"])
def test_portal_kernels_reject_bad_arguments(bad):
    pc, cam, ks, npix, n = _synth_port()
    pool = t_rp.make_pool_v2(npix, n, 3, park_k=1)
    kw = dict(seed=2, quota=3, sample_base=0, park_k=1)
    rkw = dict(seed=2, parts=2, park_k=1)
    if bad == "rows":
        pool = pool[:-1]
    elif bad == "park_k":
        kw["park_k"] = rkw["park_k"] = 4
    elif bad == "parts":
        rkw["parts"] = 3
    else:
        kw["uniforms"] = torch.zeros((4, n))
        rkw["uniforms"] = torch.zeros((4, n))
    if bad != "parts":
        with pytest.raises(ValueError):
            t_pm.trace_cheap_regen(pc, cam, pool, **kw)
    with pytest.raises(ValueError):
        t_pm.trace_resolve_pool(ks, pool, **rkw)
