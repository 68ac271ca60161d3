"""The drive loop and the scheduler's kernel-free pieces against JAX.

The same inputs go through the JAX package's function and the port's, and
the outputs must be equal: every row the JAX layout has, bit for bit (the
port's pool carries extra sample rows after them, checked on their own).
Covered: freeze_issuance and thaw_pool, the drive loop's control flow
(tests/test_drive.py: completion, cancel by freeze-and-drain, pause and
thaw, compaction before redistribution, stall detection), make_pool_v2 and
_pool_from_rows, the Morton slot order, tail compaction
(tests/test_portal.py:322), sample redistribution (:1205), snapshots and
retired counts, _redist_min (:849), _with_cnt_base (:868), _stall_limits
(:1170), and the pass runner's wiring across a pause and a resume
(tests/test_drive.py:219, :267).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.ops.pallas import portal as j_pm
from path_tracer_tpu.render import drive as j_drive
from path_tracer_tpu.render import portal as j_rp
from path_tracer_tpu_torch.ops.kernels import portal as t_pm
from path_tracer_tpu_torch.render import drive as t_drive
from path_tracer_tpu_torch.render import pipeline as t_pipeline
from path_tracer_tpu_torch.render import portal as t_rp
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)


def _port(jax_pool, park_k, g=None):
    """A port pool: the JAX rows, then sample rows (random when g is given)."""
    extra = np.zeros((1 + park_k, jax_pool.shape[1]), np.float32)
    if g is not None:
        extra = g.integers(0, 64, extra.shape).astype(np.float32)
    return torch.from_numpy(np.concatenate([np.asarray(jax_pool), extra]))


def _jax_rows(t, park_k):
    return t[:t_pm.pool_rows(park_k)].numpy()


def _fake_pool(n=8, quota=4):
    pool = torch.zeros((t_pm.port_rows(0), n))
    pool[t_pm.V2_ROW_PIX] = torch.arange(n, dtype=torch.float32)
    pool[t_pm.V2_ROW_QUOTA] = float(quota)
    return pool


def _fake_run_cycles(per_cycle=1.0):
    """Each cycle advances every unfinished slot's done count by per_cycle,
    clamped to its quota (issuance never exceeds quota)."""

    def run_cycles(pool, cycle, steps):
        pool = pool.clone()
        for _ in range(steps):
            pool[t_pm.V2_ROW_DONE] = torch.minimum(
                pool[t_pm.V2_ROW_DONE] + per_cycle, pool[t_pm.V2_ROW_QUOTA])
        unfin = (pool[t_pm.V2_ROW_DONE] < pool[t_pm.V2_ROW_QUOTA]).sum()
        return pool, steps, unfin

    return run_cycles


def _drive(pool, run_cycles, **kw):
    args = dict(
        run_cycles=run_cycles, poll=lambda u: (int(u), int(u)),
        compact_fn=lambda p, u: None,
        k_pass=int(pool[t_pm.V2_ROW_QUOTA].max()), max_depth=12, step_cap=0,
        park_k=0, check_every=1, batch_polls=False, stall_limit=10,
        hard_limit=1000)
    args.update(kw)
    return t_drive.drive_loop(pool, **args)


def test_drive_completes():
    res = _drive(_fake_pool(), _fake_run_cycles())
    assert res.outcome == t_drive.DONE and res.frozen_quota is None
    assert torch.all(res.stages[-1][t_pm.V2_ROW_DONE] == 4)
    assert res.rays == res.cycles and res.polls == res.cycles


def test_drive_cancel_freezes_and_drains():
    calls = []

    def hook(cycle, w, u):
        calls.append(u)
        return True

    res = _drive(_fake_pool(quota=10), _fake_run_cycles(), on_check=hook)
    assert res.outcome == t_drive.CANCEL
    assert len(calls) == 1  # no hook calls while draining
    assert torch.all(res.frozen_quota == 10)
    pool = res.stages[-1]
    assert torch.equal(pool[t_pm.V2_ROW_DONE], pool[t_pm.V2_ROW_QUOTA])
    assert torch.all(pool[t_pm.V2_ROW_DONE] < 10)


def test_drive_pause_verdict_and_thaw():
    res = _drive(_fake_pool(quota=10), _fake_run_cycles(),
                 on_check=lambda c, w, u: "pause")
    assert res.outcome == t_drive.PAUSE
    pool2 = t_drive.thaw_pool(res.stages[-1], res.frozen_quota, park_k=0)
    assert torch.all(pool2[t_pm.V2_ROW_QUOTA] == 10)
    assert torch.all(pool2[t_pm.V2_ROW_QUOTA] > pool2[t_pm.V2_ROW_DONE])
    res2 = _drive(pool2, _fake_run_cycles(), cycle0=res.cycles)
    assert res2.outcome == t_drive.DONE
    assert torch.all(res2.stages[-1][t_pm.V2_ROW_DONE] == 10)


def test_drive_compaction_preferred_over_redistribution():
    events = []

    def compact_fn(pool, u):
        if pool.shape[1] > 4:
            events.append("compact")
            return pool, pool[:, :4]
        return None

    def redistribute_fn(pool, flush):
        events.append("redist")
        return pool, flush

    for compact, want in ((compact_fn, ["compact"]), (lambda p, u: None, None)):
        events.clear()
        pool = _fake_pool(n=4096, quota=2)
        pool[t_pm.V2_ROW_QUOTA, :2] = 5.0
        res = _drive(pool, _fake_run_cycles(), k_pass=5, compact_fn=compact,
                     redistribute_fn=redistribute_fn,
                     new_flush=lambda: torch.zeros((4096, 4)),
                     hard_limit=10000, stall_limit=200)
        assert res.outcome == t_drive.DONE
        if want:
            assert events == want
        else:
            assert "redist" in events and res.flush is not None


def test_drive_stall_detection():
    def stuck(pool, cycle, steps):
        return pool, 0, torch.tensor(1)

    with pytest.raises(RuntimeError, match="stalled"):
        _drive(_fake_pool(), stuck, stall_limit=3)


@pytest.mark.parametrize("park_k", [0, 1, 3])
def test_freeze_and_thaw_match_jax(park_k):
    g = np.random.default_rng(park_k)
    rows = j_pm.pool_rows(park_k)
    jp = g.normal(size=(rows, 64)).astype(np.float32)
    jp[j_pm.V2_ROW_DONE] = g.integers(0, 5, 64)
    jp[j_pm.V2_ROW_QUOTA] = 8.0
    jp[j_pm.ROW_ALIVE] = g.integers(0, 2, 64)
    if park_k:
        jp[j_pm.V3_ROW_STARTED] = jp[j_pm.V2_ROW_DONE] + g.integers(0, 3, 64)
    tp = _port(jp, park_k, g)
    frozen_j = np.asarray(j_drive.freeze_issuance(jnp.asarray(jp), park_k=park_k))
    frozen_t = t_drive.freeze_issuance(tp, park_k=park_k)
    np.testing.assert_array_equal(_jax_rows(frozen_t, park_k), frozen_j)
    assert torch.equal(frozen_t[rows:], tp[rows:])
    fq = jp[j_pm.V2_ROW_QUOTA] + 1.0
    thaw_j = np.asarray(j_drive.thaw_pool(jnp.asarray(jp), jnp.asarray(fq),
                                          park_k=park_k))
    thaw_t = t_drive.thaw_pool(tp, torch.from_numpy(fq), park_k=park_k)
    np.testing.assert_array_equal(_jax_rows(thaw_t, park_k), thaw_j)
    assert not thaw_t[rows:].any()  # no path in flight after a drain
    rows_t = t_drive.drained_slot_state(tp, torch.from_numpy(fq))
    rows_j = j_drive.drained_slot_state(jnp.asarray(jp), jnp.asarray(fq))
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("park_k", [0, 3])
def test_pools_match_jax(park_k):
    w, h = 36, 24
    npix = w * h
    n_pad = t_rp._round_block(npix)
    assert n_pad == j_rp._round_block(npix)
    # the scheduler's Z-order of slots is the pipeline's pixel permutation
    np.testing.assert_array_equal(t_pipeline.morton_pixel_order(w, h)[0],
                                  j_rp.morton_pixel_order(w, h))
    jp = np.asarray(j_rp.make_pool_v2(npix, n_pad, 7, park_k=park_k))
    tp = t_rp.make_pool_v2(npix, n_pad, 7, park_k=park_k, device="cpu")
    np.testing.assert_array_equal(_jax_rows(tp, park_k), jp)
    assert tp.shape[0] == t_pm.port_rows(park_k) and not tp[jp.shape[0]:].any()
    g = np.random.default_rng(2)
    pix = g.integers(0, npix, 100).astype(np.float32)
    done = g.integers(0, 4, 100).astype(np.float32)
    quota = done + g.integers(0, 4, 100)
    jp = np.asarray(j_rp._pool_from_rows(jnp.asarray(pix), jnp.asarray(done),
                                         jnp.asarray(quota), n_pad=2048,
                                         park_k=park_k))
    tp = t_rp._pool_from_rows(pix, done, quota, n_pad=2048, park_k=park_k,
                              device="cpu")
    np.testing.assert_array_equal(_jax_rows(tp, park_k), jp)
    if park_k:  # the active path's sample row starts at done
        assert torch.equal(tp[t_pm.V3_ROW_STARTED], tp[t_pm.V2_ROW_DONE])


def test_compact_tail_matches_jax():
    g = np.random.default_rng(7)
    n, npix, quota, target = 64, 50, 4.0, 48
    jp = g.normal(size=(j_pm.V2_ROWS, n)).astype(np.float32)
    jp[j_pm.V2_ROW_PIX] = np.minimum(np.arange(n), npix - 1)
    jp[j_pm.V2_ROW_QUOTA] = quota
    done = g.integers(0, 5, size=n).astype(np.float32)
    done[npix:] = quota
    jp[j_pm.V2_ROW_DONE] = done
    tp = _port(jp, 0, g)
    src_j, small_j = j_rp._compact_tail_auto(jnp.asarray(jp), target=target)
    src_t, small_t = t_rp._compact_tail_auto(tp, target=target)
    np.testing.assert_array_equal(_jax_rows(src_t, 0), np.asarray(src_j))
    np.testing.assert_array_equal(_jax_rows(small_t, 0), np.asarray(small_j))
    # the sample rows move with their slots; padding lanes are zeroed
    m = int((done < quota).sum())
    idx = np.flatnonzero(done < quota)
    assert torch.equal(small_t[-1, :m], tp[-1, idx])
    assert not small_t[:, m:].any()


def _redist_pool(g, park_k=1):
    rows = j_pm.pool_rows(park_k)
    C, quota = 64, 40.0
    pool = np.zeros((rows, C), np.float32)
    pool[j_pm.V2_ROW_PIX] = np.arange(C)
    pool[j_pm.V2_ROW_QUOTA] = quota
    done = np.full(C, 20.0, np.float32)
    alive = np.ones(C, np.float32)
    done[:16] = quota
    alive[:16] = 0.0
    started = np.full(C, quota - 2.0, np.float32)
    started[:16] = quota
    started[16:24] = 8.0
    done[16:24] = 6.0
    pool[j_pm.V2_ROW_DONE] = done
    pool[j_pm.V3_ROW_STARTED] = started
    pool[j_pm.ROW_ALIVE] = alive
    pool[j_pm.ROW_ACC:j_pm.ROW_ACC + 3] = g.uniform(size=(3, C))
    return pool


def test_redistribute_samples_matches_jax():
    g = np.random.default_rng(3)
    jp = _redist_pool(g)
    tp = _port(jp, 1, g)
    jflush = jnp.zeros((64, 4), jnp.float32)
    pj, fj, nj = j_rp.redistribute_samples(jnp.asarray(jp), jflush, 4, park_k=1)
    pt, ft, nt = t_rp.redistribute_samples(tp, torch.zeros((64, 4)), 4, park_k=1)
    assert int(nj) == int(nt) == 8
    np.testing.assert_array_equal(_jax_rows(pt, 1), np.asarray(pj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert torch.equal(pt[j_pm.pool_rows(1):], tp[j_pm.pool_rows(1):])
    # chained adoption: donors whose done already holds a phantom prefix
    jp2, tp2 = np.asarray(pj).copy(), pt.clone()
    for p in (jp2, tp2):
        p[j_pm.V2_ROW_DONE, :8] = 40.0
        p[j_pm.V3_ROW_STARTED, :8] = 40.0
        p[j_pm.ROW_ACC:j_pm.ROW_ACC + 3, :8] = 1.0
    pj3, fj3, _ = j_rp.redistribute_samples(jnp.asarray(jp2), fj, 4, park_k=1)
    pt3, ft3, _ = t_rp.redistribute_samples(tp2, ft, 4, park_k=1)
    np.testing.assert_array_equal(_jax_rows(pt3, 1), np.asarray(pj3))
    np.testing.assert_array_equal(ft3.numpy(), np.asarray(fj3))


def test_snapshots_and_counts_match_jax():
    g = np.random.default_rng(4)
    stages_j, stages_t = [], []
    for n in (64, 32):
        jp = g.normal(size=(j_pm.V2_ROWS, n)).astype(np.float32)
        jp[j_pm.V2_ROW_PIX] = g.integers(0, 50, n)
        jp[j_pm.V2_ROW_QUOTA] = 4.0
        jp[j_pm.V2_ROW_DONE] = g.integers(0, 5, n)
        stages_j.append(jnp.asarray(jp))
        stages_t.append(_port(jp, 0, g))
    flush = g.normal(size=(70, 4)).astype(np.float32)
    rad_j, cnt_j = j_rp._snapshot_stages(tuple(stages_j), jnp.asarray(flush),
                                         out_rows=80)
    rad_t, cnt_t = t_rp._snapshot_stages(stages_t, torch.from_numpy(flush),
                                         out_rows=80)
    np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    ret_j = j_rp._retired_counts(tuple(stages_j), jnp.asarray(flush), out_rows=80)
    ret_t = t_rp._retired_counts(stages_t, torch.from_numpy(flush), out_rows=80,
                                 device="cpu")
    np.testing.assert_array_equal(ret_t.numpy(), np.asarray(ret_j))
    fs_j = np.asarray(j_rp._flush_stage(jnp.asarray(flush)))
    np.testing.assert_array_equal(t_rp._flush_stage(torch.from_numpy(flush)).numpy(),
                                  fs_j)


def test_small_helpers_match_jax(monkeypatch):
    monkeypatch.delenv("PT_TPU_REDIST_MIN", raising=False)
    for q in (1, 16, 64, 100, 256, 512, 1024):
        assert t_rp._redist_min(q) == j_rp._redist_min(q)
    for k_pass, depth in ((64, 12), (512, 12), (1024, 5)):
        assert t_rp._stall_limits(k_pass, depth) == \
            j_rp._stall_limits(k_pass, depth, 4, 4, narrow=False)
    assert t_rp.TAIL_LADDER == j_rp.TAIL_LADDER
    for kw in (dict(w=786432, k_pass=1024), dict(w=65536, k_pass=64),
               dict(w=4096, k_pass=64), dict(w=2048, k_pass=8)):
        for first in (False, True):
            args = dict(kw, check_every=4, first=first, step_cap=64, park_k=3,
                        max_depth=12, batch_polls=True)
            assert t_drive.poll_steps(**args) == j_drive.poll_steps(**args)
    rad = torch.zeros((2048, 3))
    cnt = torch.ones(2048)
    base = torch.full((864,), 2.0)
    _, cnt2 = t_rp._with_cnt_base((rad, cnt), base)
    assert torch.all(cnt2[:864] == 3.0) and torch.all(cnt2[864:] == 1.0)
    _, cnt3 = t_rp._with_cnt_base((rad[:864], cnt[:864]), base)
    assert torch.all(cnt3 == 3.0)


def _stage(pix, done, quota, acc=0.0):
    st = torch.zeros((t_pm.port_rows(0), len(pix)))
    st[t_pm.V2_ROW_PIX] = torch.tensor(pix, dtype=torch.float32)
    st[t_pm.V2_ROW_DONE] = torch.tensor(done, dtype=torch.float32)
    st[t_pm.V2_ROW_QUOTA] = torch.tensor(quota, dtype=torch.float32)
    st[t_pm.ROW_ACC] = float(acc)
    return st


def _scripted_runner(monkeypatch, results):
    """A pass runner whose drive_pool_v2 returns scripted DriveResults,
    recording each call's cycle0 (the wiring, no kernels)."""
    monkeypatch.setattr(t_pm, "PARK_K", 0)
    seen = {"cycle0": []}
    it = iter(results)

    def fake_drive(pool, *a, **kw):
        seen["cycle0"].append(kw.get("cycle0", 0))
        return next(it)

    monkeypatch.setattr(t_rp, "drive_pool_v2", fake_drive)
    runner = t_rp.make_portal_pass_runner_v2(None, None, None, npix=8,
                                             k_full=4, seed=0, max_depth=1,
                                             device="cpu")
    return runner, seen


def test_cancel_after_pause_carries_discarded_stage_counts(monkeypatch):
    pause = t_drive.DriveResult(
        stages=[_stage([0, 1, 2, 3], [2] * 4, [2] * 4, acc=1.0),
                _stage([4, 5, 6, 7], [1] * 4, [1] * 4)],
        rays=torch.tensor([9, 3]), flush=None, outcome=t_drive.PAUSE, cycles=7,
        frozen_quota=torch.full((4,), 4.0), polls=2)
    cancel = t_drive.DriveResult(
        stages=[_stage([4, 5, 6, 7], [2] * 4, [2] * 4, acc=0.5)],
        rays=torch.tensor([3, 1]), flush=None, outcome=t_drive.CANCEL, cycles=11,
        frozen_quota=torch.full((4,), 4.0), polls=1)
    runner, seen = _scripted_runner(monkeypatch, [pause, cancel])
    paused = {}
    with runner.hooks(on_check=lambda c, w, u: False,
                      on_pause=lambda acc, pi, fields: paused.update(fields)):
        accum, rays = runner(torch.zeros((8, 3)), 0, 4)
    assert runner.on_check is None and runner.on_pause is None
    np.testing.assert_array_equal(runner.last_partial_counts.numpy(), [2.0] * 8)
    np.testing.assert_allclose(accum[:4, 0].numpy(), 1.0)
    np.testing.assert_allclose(accum[4:, 0].numpy(), 0.5)
    assert rays.tolist() == [12, 4]  # K2's and K3's, over both drives
    assert paused["cycle0"] == 7 and paused["mid_pass"] == 1
    assert paused["slot_layout"] == runner.slot_layout == "single"
    assert all(len(paused[f"slot_{r}"]) == 4 for r in ("pix", "done", "quota"))
    assert seen["cycle0"] == [0, 7]
    assert runner.total_cycles == 11 and runner.total_polls == 3


def test_resume_continues_cycle_counter(monkeypatch):
    done = t_drive.DriveResult(
        stages=[_stage([0, 1], [4, 4], [4, 4])], rays=torch.tensor([6, 2]),
        flush=None, outcome=t_drive.DONE, cycles=900)
    runner, seen = _scripted_runner(monkeypatch, [done])
    runner.resume_slots = (np.array([0.0, 1.0]), np.array([2.0, 2.0]),
                           np.array([4.0, 4.0]))
    runner.resume_cycle0 = 777
    runner(torch.zeros((8, 3)), 0, 4)
    assert seen["cycle0"] == [777]
    assert runner.resume_cycle0 is None and runner.resume_slots is None


# ---------------------------------------------------------------- the slice
# mesh through render(device="cpu"): the portal route (K2 + K3 plain
# versions under the scheduler) and the pallasr: route (K4)

def _mesh(repo_root):
    from tests.test_torch_host import load_both

    return load_both("mesh", repo_root)


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _render(scene, cfg, **kw):
    import path_tracer_tpu_torch as tpt

    return tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False, **kw)


def test_mesh_portal_render_within_mc_noise_of_jax(repo_root):
    """The port's portal render against the JAX package's render() of the
    same configuration (on the CPU the JAX side takes its XLA mode): the
    gate of test_torch_render.py, RMSE(port, JAX seed 0) <= 1.5 x RMSE(JAX
    seed 0, JAX seed 1) and every channel mean within 4 standard errors;
    per-pixel counts exactly spp."""
    import path_tracer_tpu as jpt
    import path_tracer_tpu_torch as tpt

    js, ts = _mesh(repo_root)
    spp, res = 8, (24, 36)
    jcfg = jpt.RenderConfig(samples_per_pixel=spp, resolution=jpt.Resolution(*res))
    j0 = jpt.render(js, jcfg, out_dir=None, verbose=False).image.pixels
    j1 = jpt.render(js, jcfg.with_(seed=1), out_dir=None, verbose=False).image.pixels
    done = _render(ts, tpt.RenderConfig(samples_per_pixel=spp,
                                        resolution=tpt.Resolution(*res)))
    t0 = done.image.pixels
    assert done.stats.extra["route"] == "portal"
    assert done.stats.num_samples == spp * t0.shape[0] and done.stats.num_rays > 0
    noise = _rmse(j0, j1)
    assert _rmse(t0, j0) <= 1.5 * noise, (_rmse(t0, j0), noise)
    se = (j0 - j1).std(axis=0) / np.sqrt(j0.shape[0])
    assert (np.abs(t0.mean(0) - j0.mean(0)) <= 4 * se).all()


def test_mesh_portal_equals_pallasr_render(repo_root, monkeypatch):
    """Every path draws by its own sample index, so the portal scheduler and
    the brute-force K4 pass trace the same paths: the two images of one
    seed differ only where ulps part a path, far inside the noise between
    two seeds (mean |Δ| <= 0.25 x), and trace the same segments. The
    portal's park depth changes nothing either."""
    import path_tracer_tpu_torch as tpt

    _, ts = _mesh(repo_root)
    cfg = tpt.RenderConfig(samples_per_pixel=4, resolution=tpt.Resolution(18, 24))
    portal = _render(ts, cfg)
    monkeypatch.setattr(t_pm, "PARK_K", 1)
    portal1 = _render(ts, cfg)
    monkeypatch.setenv("PT_TPU_NO_PORTAL", "1")
    prim = _render(ts, cfg)
    prim1 = _render(ts, cfg.with_(seed=1))
    assert (portal.stats.extra["route"], prim.stats.extra["route"]) == (
        "portal", "prim")
    same = np.abs(portal.image.pixels - prim.image.pixels).mean()
    noise = np.abs(prim1.image.pixels - prim.image.pixels).mean()
    assert same <= 0.25 * noise, (same, noise)
    assert portal.stats.num_rays == prim.stats.num_rays
    np.testing.assert_allclose(portal1.image.pixels, portal.image.pixels,
                               atol=1e-5)


def test_mesh_portal_cancel_keeps_every_started_sample(repo_root, monkeypatch):
    """A cancel at the first poll freezes issuance and drains: every started
    sample retires and is kept. At max_depth 1 each sample is one segment,
    so the retired count equals the segments traced; each pixel is divided
    by its own retired count (clamped after averaging)."""
    import path_tracer_tpu_torch as tpt

    monkeypatch.setattr(t_rp, "STEP_CAP", 1)
    monkeypatch.setattr(t_rp, "CHECK_EVERY", 1)
    _, ts = _mesh(repo_root)
    spp = 8
    cfg = tpt.RenderConfig(samples_per_pixel=spp, resolution=tpt.Resolution(12, 16),
                           max_depth=1)
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 1  # False at the pre-pass check, then cancel

    done = _render(ts, cfg, cancel=cancel)
    npix = 12 * 16
    assert done.cancelled
    assert 0 < done.stats.num_samples < spp * npix
    assert done.stats.num_rays == done.stats.num_samples
    px = done.image.pixels
    assert np.isfinite(px).all() and 0.0 <= px.min() and px.max() <= 1.0
    assert px.max() > 0.0


def test_mesh_mid_pass_checkpoint_resume(repo_root, tmp_path, monkeypatch):
    """PT_TPU_CKPT_SECS=0 checkpoints at the first poll (freeze-and-drain;
    the npz holds the per-slot remaining ranges); a cancel once the file
    exists leaves it; the resumed render finishes exactly the remaining
    samples and gives the image of an uninterrupted render, itself run with
    another step budget: paths draw by their sample index, so the schedule
    does not matter. Tolerance 1e-6: the same sums added in another order."""
    import path_tracer_tpu_torch as tpt

    _, ts = _mesh(repo_root)
    cfg = tpt.RenderConfig(samples_per_pixel=8, resolution=tpt.Resolution(12, 16))
    full = _render(ts, cfg)
    monkeypatch.setattr(t_rp, "STEP_CAP", 2)
    monkeypatch.setattr(t_rp, "CHECK_EVERY", 1)
    monkeypatch.setenv("PT_TPU_CKPT_SECS", "0")
    ck = str(tmp_path / "mid.npz")
    part = _render(ts, cfg, cancel=lambda: (tmp_path / "mid.npz").exists(),
                   checkpoint_path=ck, checkpoint_every=1)
    assert part.cancelled and (tmp_path / "mid.npz").exists()
    with np.load(ck) as z:
        assert int(z["mid_pass"]) == 1 and str(z["slot_layout"]) == "single"
        rem = int((z["slot_quota"] - z["slot_done"]).sum())
        assert 0 < rem < 8 * 12 * 16
        assert {"cycle0", "slot_pix", "slot_done", "slot_quota"} <= set(z.files)
    monkeypatch.undo()
    resumed = _render(ts, cfg, checkpoint_path=ck, checkpoint_every=1)
    assert not resumed.cancelled and not (tmp_path / "mid.npz").exists()
    np.testing.assert_allclose(resumed.image.pixels, full.image.pixels, atol=1e-6)


def test_cli_renders_mesh(repo_root, tmp_path):
    from path_tracer_tpu_torch import cli
    from path_tracer_tpu_torch.render.image import read_ppm
    import glob
    import os

    rc = cli.main(["2", "12", "mesh", "--device", "cpu", "--quiet",
                   "--scene-dir", os.path.join(repo_root, "scenes"),
                   "--mesh-dir", os.path.join(repo_root, "meshes"),
                   "--out-dir", str(tmp_path)])
    assert rc == 0
    ppms = glob.glob(str(tmp_path / "*.ppm"))
    assert len(ppms) == 1
    vals, w, h = read_ppm(ppms[0])
    assert (w, h) == (18, 12) and vals.shape == (18 * 12, 3) and vals.max() > 0
