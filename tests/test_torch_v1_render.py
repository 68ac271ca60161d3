"""The v1 portal scheduler and the v2 glue route through render(), on the CPU
(the kernels' plain versions).

Every path draws under (seed, pixel, sample, depth), whichever kernel takes
its bounce, so the v1 route (K8 and K7), the glue route (K2 and K7), the v2
route (K2 and K3) and the PT_TPU_NO_PORTAL route (K4) of one seed trace the
same paths: their mesh images agree within 1e-5 (ulps of the two
intersectors), and the glue route's equals v2's bit for bit. Then the v1
route's pass bookkeeping: per-pixel counts, cancel and checkpoint at pass
boundaries, the 64-spp pass cap when checkpointing, the stall backstop, and
the image against the JAX package within Monte Carlo noise.
"""

import numpy as np
import pytest
import torch

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.render import pipeline as t_pipeline
from path_tracer_tpu_torch.render import portal as t_rp
from tests.test_torch_host import load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

RES = tpt.Resolution(24, 36)


@pytest.fixture(scope="module")
def mesh(repo_root):
    return load_both("mesh", repo_root)[1]


def _render(scene, cfg, **kw):
    return tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False, **kw)


def test_v1_and_glue_routes_equal_v2_and_prim(mesh, monkeypatch):
    cfg = tpt.RenderConfig(samples_per_pixel=4, resolution=RES)
    v2 = _render(mesh, cfg)
    monkeypatch.setattr(t_rp, "POOL_RESOLVE", False)
    glue = _render(mesh, cfg)
    monkeypatch.undo()
    monkeypatch.setenv("PT_TPU_PORTAL_V1", "1")
    v1 = _render(mesh, cfg)
    monkeypatch.undo()
    monkeypatch.setenv("PT_TPU_NO_PORTAL", "1")
    prim = _render(mesh, cfg)
    assert [d.stats.extra.get("portal_runner") for d in (v2, glue, v1)] == [
        "v2", "v2", "v1"]
    assert prim.stats.extra["route"] == "prim"
    npix = RES.num_pixels
    for d in (glue, v1, prim):
        assert d.stats.num_samples == 4 * npix
        assert d.stats.num_rays == v2.stats.num_rays
        np.testing.assert_allclose(d.image.pixels, v2.image.pixels, atol=1e-5)
    assert np.array_equal(glue.image.pixels, v2.image.pixels)
    assert v2.image.pixels.max() > 0


def test_v1_runner_counts_every_pixel_exactly(mesh):
    """Two passes of k samples: the pool (C = 4 * npix rounded to 2048
    slots, F_cap = C / 2) retires each pass's samples exactly once per
    pixel; the second pass draws global samples k ..; a pass that cannot
    drain hits the hard limit and raises."""
    prep = t_pipeline.prepare_render(mesh, RES, "cpu")
    npix, k = RES.num_pixels, 3
    runner = t_rp.make_portal_pass_runner(
        prep.portal, prep.cam, prep.kscene, npix=npix, k_full=k, seed=2)
    assert runner.pool_width == t_rp._round_block(npix * 3)
    assert runner.resolve_width == t_rp._round_resolve(runner.pool_width // 2)
    accum = torch.zeros((npix, 3))
    accum, rays0 = runner(accum, 0, k)
    assert torch.equal(runner.last_counts, torch.full((npix,), float(k)))
    accum, rays1 = runner(accum, 1, k)
    assert torch.equal(runner.last_counts, torch.full((npix,), float(k)))
    assert int(rays0) > npix * k and int(rays1) > npix * k
    assert runner.total_cycles > 0 and runner.total_polls > 0
    # the same 2k samples in one pass give the same image, up to the order
    # of the adds
    one = t_rp.make_portal_pass_runner(
        prep.portal, prep.cam, prep.kscene, npix=npix, k_full=2 * k, seed=2)
    acc1, rays = one(torch.zeros((npix, 3)), 0, 2 * k)
    np.testing.assert_allclose(acc1.numpy(), accum.numpy(), atol=1e-5)
    assert int(rays) == int(rays0) + int(rays1)


def test_v1_runner_stall_raises(mesh, monkeypatch):
    """Paths that never end (K7 stubbed to keep every lane alive) exhaust
    the hard limit of 64 + total * (max_depth + 2) * 4 / C cycles."""
    prep = t_pipeline.prepare_render(mesh, tpt.Resolution(4, 6), "cpu")

    def immortal(ks, o, d, thr, acc, alive, prev, depth, **kw):
        return o, d, thr, acc, torch.ones_like(alive), prev, depth, alive

    monkeypatch.setattr(t_rp, "trace_resolve", immortal)
    runner = t_rp.make_portal_pass_runner(
        prep.portal, prep.cam, prep.kscene, npix=24, k_full=1, seed=0,
        max_depth=2)
    with pytest.raises(RuntimeError, match="stalled"):
        runner(torch.zeros((24, 3)), 0, 1)


def test_v1_cancel_at_a_pass_boundary_keeps_its_passes(mesh, monkeypatch):
    """v1 has no poll hook: a cancel lands between passes, and the passes
    done are kept: the first of two 2-spp passes is the 2-spp image."""
    monkeypatch.setenv("PT_TPU_PORTAL_V1", "1")
    cfg = tpt.RenderConfig(samples_per_pixel=4, resolution=RES,
                           samples_per_pass=2)
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 1  # False before the first pass, then cancel

    part = _render(mesh, cfg, cancel=cancel)
    two = _render(mesh, cfg.with_(samples_per_pixel=2))
    assert part.cancelled and not two.cancelled
    assert part.stats.num_samples == 2 * RES.num_pixels
    assert np.array_equal(part.image.pixels, two.image.pixels)


def test_v1_checkpoint_resume_is_bit_exact(mesh, monkeypatch, tmp_path):
    monkeypatch.setenv("PT_TPU_PORTAL_V1", "1")
    cfg = tpt.RenderConfig(samples_per_pixel=4, resolution=RES,
                           samples_per_pass=2)
    full = _render(mesh, cfg)
    ck = str(tmp_path / "v1.npz")
    part = _render(mesh, cfg, cancel=lambda: (tmp_path / "v1.npz").exists(),
                   checkpoint_path=ck, checkpoint_every=1)
    assert part.cancelled and (tmp_path / "v1.npz").exists()
    with np.load(ck) as z:
        assert int(z["samples_done"]) == 2 and "mid_pass" not in z.files
    resumed = _render(mesh, cfg, checkpoint_path=ck, checkpoint_every=1)
    assert not resumed.cancelled and resumed.stats.resumed_samples == 2
    assert np.array_equal(resumed.image.pixels, full.image.pixels)


def test_v1_checkpointing_caps_passes_at_64_spp(mesh, monkeypatch, tmp_path):
    """Checkpoints land only between v1 passes, so a checkpointed render
    runs passes of at most 64 spp (the JAX package's pipeline.py:361-367);
    without checkpoints one pass takes every sample."""
    monkeypatch.setenv("PT_TPU_PORTAL_V1", "1")
    cfg = tpt.RenderConfig(samples_per_pixel=128,
                           resolution=tpt.Resolution(2, 3), max_depth=1)
    plain = _render(mesh, cfg)
    ck = _render(mesh, cfg, checkpoint_path=str(tmp_path / "c.npz"),
                 checkpoint_every=1)
    assert (plain.stats.num_dispatches, ck.stats.num_dispatches) == (1, 2)
    assert plain.stats.num_samples == ck.stats.num_samples == 128 * 6


def test_v1_render_within_mc_noise_of_jax(repo_root, monkeypatch):
    """The v1 image against the JAX package's render() of the same
    configuration, the gate of test_torch_drive.py: RMSE(port, JAX seed 0)
    <= 1.5 x RMSE(JAX seed 0, JAX seed 1), every channel mean within 4
    standard errors."""
    js, ts = load_both("mesh", repo_root)
    spp = 8
    jcfg = jpt.RenderConfig(samples_per_pixel=spp,
                            resolution=jpt.Resolution(RES.height, RES.width))
    j0 = jpt.render(js, jcfg, out_dir=None, verbose=False).image.pixels
    j1 = jpt.render(js, jcfg.with_(seed=1), out_dir=None,
                    verbose=False).image.pixels
    monkeypatch.setenv("PT_TPU_PORTAL_V1", "1")
    done = _render(ts, tpt.RenderConfig(samples_per_pixel=spp, resolution=RES))
    t0 = done.image.pixels
    assert done.stats.extra["portal_runner"] == "v1"

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    noise = rmse(j0, j1)
    assert rmse(t0, j0) <= 1.5 * noise, (rmse(t0, j0), noise)
    se = (j0 - j1).std(axis=0) / np.sqrt(j0.shape[0])
    assert (np.abs(t0.mean(0) - j0.mean(0)) <= 4 * se).all()


def test_glue_route_launches_no_pool_resolve(mesh, monkeypatch):
    """On the CPU nothing launches; the glue route's resolve goes through
    K7's wrapper (trace_resolve), never K3's (trace_resolve_pool)."""
    seen = []
    real = t_rp.trace_resolve

    def spy(*a, **kw):
        seen.append(1)
        return real(*a, **kw)

    def no_k3(*a, **kw):
        raise AssertionError("K3 ran on the glue route")

    monkeypatch.setattr(t_rp, "trace_resolve", spy)
    monkeypatch.setattr(t_rp, "trace_resolve_pool", no_k3)
    monkeypatch.setattr(t_rp, "POOL_RESOLVE", False)
    cfg = tpt.RenderConfig(samples_per_pixel=1, resolution=tpt.Resolution(4, 6))
    done = _render(mesh, cfg)
    assert seen and done.stats.num_samples == 24
    assert t_tk.trace_resolve.launches == 0
