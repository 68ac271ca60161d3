"""The port's slice as a whole: render(), the CLI, cancel and checkpoints.

The port's CPU render is held against the JAX package's render() of the
same configuration. On the CPU the JAX side resolves to its XLA ``fast``
mode (threefry), so the two random streams differ and the criterion is
Monte Carlo noise: RMSE(port, JAX seed 0) <= 1.5 x RMSE(JAX seed 0, JAX
seed 1), and every channel mean within 4 standard errors.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.render.image import read_ppm
from tests.test_torch_host import load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.mark.parametrize("sid", ["cornell", "two-spheres"])
def test_render_within_mc_noise_of_jax(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    spp, res = 64, (24, 36)
    jcfg = jpt.RenderConfig(samples_per_pixel=spp, resolution=jpt.Resolution(*res))
    j0 = jpt.render(js, jcfg, out_dir=None, verbose=False).image.pixels
    j1 = jpt.render(js, jcfg.with_(seed=1), out_dir=None, verbose=False).image.pixels
    tcfg = tpt.RenderConfig(samples_per_pixel=spp, resolution=tpt.Resolution(*res))
    done = tpt.render(ts, tcfg, device="cpu", out_dir=None, verbose=False)
    t0 = done.image.pixels
    assert t0.shape == j0.shape and np.isfinite(t0).all()
    assert done.stats.num_samples == spp * t0.shape[0] and done.stats.num_rays > 0
    noise = _rmse(j0, j1)
    assert noise > 0  # a radiance check, unlike cartesian's all-zero image
    assert _rmse(t0, j0) <= 1.5 * noise, (_rmse(t0, j0), noise)
    se = (j0 - j1).std(axis=0) / np.sqrt(j0.shape[0])
    assert (np.abs(t0.mean(0) - j0.mean(0)) <= 4 * se).all(), (
        t0.mean(0), j0.mean(0), se)


def test_cli_writes_a_ppm(repo_root, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "path_tracer_tpu_torch.cli", "8", "24",
         "cornell", "--device", "cpu", "--out-dir", str(tmp_path)],
        cwd=repo_root, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    ppms = glob.glob(str(tmp_path / "*.ppm"))
    assert len(ppms) == 1
    vals, w, h = read_ppm(ppms[0])
    assert (w, h) == (36, 24) and vals.shape == (36 * 24, 3)
    assert 0 <= vals.min() and vals.max() <= 255 and vals.max() > 0


def _cornell(repo_root):
    return load_both("cornell", repo_root)[1]


def test_cancelled_render_still_writes_its_ppm(repo_root, tmp_path):
    calls = []
    updates = []

    def cancel():
        calls.append(1)
        return len(calls) > 1  # after the first pass

    cfg = tpt.RenderConfig(samples_per_pixel=8, samples_per_pass=4,
                           resolution=tpt.Resolution(12, 18))
    done = tpt.render(_cornell(repo_root), cfg, device="cpu", cancel=cancel,
                      progress=updates.append, progress_interval=0.0,
                      out_dir=str(tmp_path), verbose=False)
    assert done.cancelled and done.stats.num_samples == 4 * 12 * 18
    assert done.ppm_path and os.path.exists(done.ppm_path)
    vals, w, h = read_ppm(done.ppm_path)
    assert (w, h) == (18, 12) and vals.max() > 0
    assert updates and updates[-1].samples_done == 4
    assert updates[0].image is not None


def test_checkpoint_resume_is_bit_exact(repo_root, tmp_path):
    scene = _cornell(repo_root)
    cfg = tpt.RenderConfig(samples_per_pixel=12, samples_per_pass=4,
                           resolution=tpt.Resolution(12, 18), seed=3)
    full = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)

    ck = str(tmp_path / "ck.npz")
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 2  # after two passes

    part = tpt.render(scene, cfg, device="cpu", cancel=cancel,
                      checkpoint_path=ck, checkpoint_every=1, out_dir=None,
                      verbose=False)
    assert part.cancelled and os.path.exists(ck)
    with np.load(ck) as z:
        assert set(z.files) == {"accum", "samples_done", "next_pass", "seed",
                                "spp", "npix", "k", "num_rays",
                                "resolve_segments", "resolve_group_items"}
        assert int(z["next_pass"]) == 2 and int(z["samples_done"]) == 8
    resumed = tpt.render(scene, cfg, device="cpu", checkpoint_path=ck,
                         checkpoint_every=1, out_dir=None, verbose=False)
    assert resumed.stats.resumed_samples == 8
    np.testing.assert_array_equal(resumed.image.pixels, full.image.pixels)
    assert resumed.stats.num_rays == full.stats.num_rays
    assert not os.path.exists(ck)  # removed once the render completes


def test_cuda_device_without_cuda_raises(repo_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tpt.RenderConfig(samples_per_pixel=1, resolution=tpt.Resolution(4, 6))
    with pytest.raises(RuntimeError, match="cuda"):
        tpt.render(_cornell(repo_root), cfg, device="cuda", out_dir=None)
    with pytest.raises(SystemExit, match="CUDA|cuda"):
        cli.main(["1", "4", "cornell", "--scene-dir",
                  os.path.join(repo_root, "scenes"), "--out-dir", "unused"])


def test_pass_sample_base_is_pass_index_times_pass_size(repo_root):
    """The port's sample base of pass i is i * k, with progress callbacks or
    without (ROADMAP Queue 3: the JAX package's fused hookless loop uses
    i * 256 instead): at samples_per_pass 6 both renders are one image."""
    cfg = tpt.RenderConfig(samples_per_pixel=12, samples_per_pass=6,
                           resolution=tpt.Resolution(12, 18), seed=4)
    plain = tpt.render(_cornell(repo_root), cfg, device="cpu", out_dir=None,
                       verbose=False)
    updates = []
    hooked = tpt.render(_cornell(repo_root), cfg, device="cpu", out_dir=None,
                        verbose=False, progress=updates.append,
                        progress_interval=0.0)
    assert len(updates) >= 2
    np.testing.assert_array_equal(hooked.image.pixels, plain.image.pixels)
    # and the two 6-spp passes are samples 0-5 and 6-11: one 12-spp pass
    one = tpt.render(_cornell(repo_root), cfg.with_(samples_per_pass=12),
                     device="cpu", out_dir=None, verbose=False)
    np.testing.assert_allclose(one.image.pixels, plain.image.pixels, atol=1e-6)


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--daemon"]])
def test_off_slice_cli_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="Slice 4"):
        cli.main(["1", "4", "cornell", "--device", "cpu", *flag])
