"""The port's slice as a whole: render(), the CLI, cancel and checkpoints
on every route, what each route reports, and that a render frees its
scene tables on return.

The port's CPU render is held against the JAX package's render() of the
same configuration. On the CPU the JAX side resolves to its XLA ``fast``
mode (threefry), so the two random streams differ and the criterion is
Monte Carlo noise: RMSE(port, JAX seed 0) <= 1.5 x RMSE(JAX seed 0, JAX
seed 1), and every channel mean within 4 standard errors.
"""

import dataclasses
import gc
import glob
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.render import pipeline as t_pipeline
from path_tracer_tpu_torch.render.image import read_ppm
from path_tracer_tpu_torch.utils import profiling
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


# route: (scene, render options, environment)
ROUTES = {
    "regen": ("cornell", {}, {}),
    "prim": ("mesh", {}, {"PT_TPU_NO_PORTAL": "1"}),
    "portal": ("mesh", {}, {}),
    "wavefront": ("cornell", {"backend": "fast", "pixel_chunk": 100}, {}),
}
CHECKPOINT_FIELDS = {"accum", "samples_done", "next_pass", "seed", "spp",
                     "npix", "k", "num_rays", "resolve_segments",
                     "resolve_group_items"}


def _route(repo_root, route, monkeypatch):
    """The scene and render options of ``route``, its environment set."""
    sid, kw, env = ROUTES[route]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    return load_both(sid, repo_root)[1], kw


@pytest.mark.parametrize("route", list(ROUTES))
def test_cancelled_render_still_writes_its_ppm(repo_root, tmp_path, monkeypatch,
                                               route):
    """A cancel between passes keeps the passes done: the first of two
    4-spp passes, its PPM written, with progress (and an image) on the
    way."""
    scene, kw = _route(repo_root, route, monkeypatch)
    updates = []
    cfg = tpt.RenderConfig(samples_per_pixel=8, samples_per_pass=4,
                           resolution=tpt.Resolution(12, 18), **kw)
    done = tpt.render(scene, cfg, device="cpu",
                      cancel=lambda: any(u.samples_done for u in updates),
                      progress=updates.append, progress_interval=0.0,
                      out_dir=str(tmp_path), verbose=False)
    assert done.stats.extra["route"] == route
    assert done.cancelled and done.stats.num_samples == 4 * 12 * 18
    assert done.ppm_path and os.path.exists(done.ppm_path)
    vals, w, h = read_ppm(done.ppm_path)
    assert (w, h) == (18, 12) and vals.max() > 0
    assert updates and updates[-1].samples_done == 4
    assert updates[0].image is not None


@pytest.mark.parametrize("route", list(ROUTES))
def test_checkpoint_resume_is_bit_exact(repo_root, tmp_path, monkeypatch,
                                        route):
    """A render cancelled after two of its three passes leaves a checkpoint
    of the same fields on every route; resumed from it, the render gives
    the uninterrupted render's image bit for bit, and its segment counts."""
    scene, kw = _route(repo_root, route, monkeypatch)
    monkeypatch.setenv("PT_TPU_CKPT_SECS", "3600")  # no portal pass pauses
    cfg = tpt.RenderConfig(samples_per_pixel=12, samples_per_pass=4,
                           resolution=tpt.Resolution(12, 18), seed=3, **kw)
    full = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)

    ck = str(tmp_path / "ck.npz")

    def cancel():  # once the second pass is in the file (a portal pass
        # also asks at its polls)
        if not os.path.exists(ck):
            return False
        with np.load(ck) as z:
            return int(z["samples_done"]) == 8

    part = tpt.render(scene, cfg, device="cpu", cancel=cancel,
                      checkpoint_path=ck, checkpoint_every=1, out_dir=None,
                      verbose=False)
    assert part.cancelled and os.path.exists(ck)
    with np.load(ck) as z:
        assert set(z.files) == CHECKPOINT_FIELDS
        assert int(z["next_pass"]) == 2 and int(z["samples_done"]) == 8
        # three chunks of 100 pixels on the wavefront
        assert z["accum"].shape == (300 if kw else 216, 3)
    resumed = tpt.render(scene, cfg, device="cpu", checkpoint_path=ck,
                         checkpoint_every=1, out_dir=None, verbose=False)
    assert resumed.stats.resumed_samples == 8
    np.testing.assert_array_equal(resumed.image.pixels, full.image.pixels)
    assert resumed.stats.num_rays == full.stats.num_rays
    assert resumed.stats.extra.get("resolve_segments") == \
        full.stats.extra.get("resolve_segments")
    assert not os.path.exists(ck)  # removed once the render completes


# Portal checkpoints of mesh at 6x4, 8 spp in passes of 4, seed 3, written
# on the CPU by the render loop from before the pass runners (which named
# K3's counters itself and wrote each kind of file with its own np.savez):
# one after the first pass, one paused at the second pass's first poll
# (render.portal STEP_CAP 2, CHECK_EVERY 1, PT_TPU_CKPT_SECS 0).
OLD_CHECKPOINTS = {"pass-boundary": "mesh_6x4_spp8_seed3_pass1.npz",
                   "mid-pass": "mesh_6x4_spp8_seed3_pass1_mid.npz"}


@pytest.mark.parametrize("kind", list(OLD_CHECKPOINTS))
def test_old_checkpoint_resumes_to_the_uninterrupted_image(
        repo_root, tmp_path, kind):
    """A checkpoint the earlier render loop wrote keeps its fields and
    resumes to the uninterrupted render's image: bit for bit with its
    segment counts from a pass boundary; from the middle of a pass within
    1e-6, the same sums added in another order."""
    import shutil

    scene = load_both("mesh", repo_root)[1]
    cfg = tpt.RenderConfig(samples_per_pixel=8, samples_per_pass=4,
                           resolution=tpt.Resolution(4, 6), seed=3)
    full = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    ck = str(tmp_path / "ck.npz")
    shutil.copy(os.path.join(repo_root, "tests", "golden",
                             OLD_CHECKPOINTS[kind]), ck)
    with np.load(ck) as z:
        mid = set(z.files) - CHECKPOINT_FIELDS
        assert mid == (set() if kind == "pass-boundary" else {
            "mid_pass", "cycle0", "slot_layout", "slot_pix", "slot_done",
            "slot_quota"})
        assert int(z["samples_done"]) == 4 and int(z["next_pass"]) == 1
    resumed = tpt.render(scene, cfg, device="cpu", checkpoint_path=ck,
                         checkpoint_every=1, out_dir=None, verbose=False)
    assert resumed.stats.resumed_samples == 4 and not resumed.cancelled
    assert resumed.stats.num_samples == 4 * 24
    assert not os.path.exists(ck)
    if kind == "pass-boundary":
        np.testing.assert_array_equal(resumed.image.pixels, full.image.pixels)
        for name in ("resolve_segments", "resolve_group_items"):
            assert resumed.stats.extra[name] == full.stats.extra[name]
        assert resumed.stats.num_rays == full.stats.num_rays
    else:
        np.testing.assert_allclose(resumed.image.pixels, full.image.pixels,
                                   atol=1e-6)


def test_paused_portal_pass_keeps_its_segment_counts(repo_root, tmp_path,
                                                     monkeypatch):
    """A portal pass that pauses at its polls for mid-pass checkpoints
    still counts every segment it traced: num_rays equals the same
    render's unpaused, and its image within 1e-6 (the same sums added in
    another order). K3's share of them is counted too; it is not the
    unpaused render's, since a pause's drain moves segments between K2
    and K3."""
    from path_tracer_tpu_torch.render import portal as t_rp

    scene = load_both("mesh", repo_root)[1]
    cfg = tpt.RenderConfig(samples_per_pixel=8, samples_per_pass=4,
                           resolution=tpt.Resolution(4, 6), seed=3)
    # a poll every cycle, and K2's short step budget: many cycles a pass
    monkeypatch.setattr(t_rp, "STEP_CAP", 2)
    monkeypatch.setattr(t_rp, "CHECK_EVERY", 1)
    full = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    monkeypatch.setenv("PT_TPU_CKPT_SECS", "0")
    ck = tmp_path / "ck.npz"
    seen = []

    def cancel():  # never cancels: notes whether each file it sees is mid-pass
        if ck.exists():
            with np.load(ck) as z:
                seen.append(int(z["samples_done"]) if "mid_pass" in z.files
                            else None)
        return False

    paused = tpt.render(scene, cfg, device="cpu", checkpoint_path=str(ck),
                        checkpoint_every=1, cancel=cancel, out_dir=None,
                        verbose=False)
    assert not paused.cancelled
    assert {0, 4} <= set(seen)  # paused in both passes
    assert paused.stats.num_rays == full.stats.num_rays > 0
    assert 0 < paused.stats.extra["resolve_segments"] < paused.stats.num_rays
    np.testing.assert_allclose(paused.image.pixels, full.image.pixels, atol=1e-6)


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


def _tensors(x):
    """The tensors held by ``x``, through dataclasses, dicts and sequences."""
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


@pytest.mark.parametrize("route", list(ROUTES) + ["portal-hooked"])
def test_render_frees_its_tables_on_return(repo_root, tmp_path, monkeypatch,
                                           route):
    """Nothing of a render holds its scene tables in a reference cycle:
    with the cyclic GC off, every tensor of its ``Prepared`` is freed by
    the time render() returns, on every route, and on the portal route
    also with progress, cancel and checkpoint hooks at its polls."""
    scene, kw = _route(repo_root, route.split("-")[0], monkeypatch)
    refs = []
    prepare = t_pipeline.prepare_render

    def kept(*a, **k):
        prep = prepare(*a, **k)
        refs.extend(weakref.ref(t) for t in _tensors(prep))
        return prep

    monkeypatch.setattr(t_pipeline, "prepare_render", kept)
    hooks = {}
    if route.endswith("hooked"):
        hooks = dict(progress=lambda u: None, cancel=lambda: False,
                     checkpoint_path=str(tmp_path / "ck.npz"),
                     checkpoint_every=1)
    cfg = tpt.RenderConfig(samples_per_pixel=4, samples_per_pass=2,
                           resolution=tpt.Resolution(4, 6), **kw)
    gc.collect()
    gc.disable()
    try:
        done = tpt.render(scene, cfg, device="cpu", out_dir=None,
                          verbose=False, **hooks)
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
    assert done.stats.extra["route"] == route.split("-")[0]
    assert refs
    assert alive == 0, f"{alive} of {len(refs)} tensors alive"


# the RenderStats.extra keys each route reports
EXTRA = {"regen": {"route"}, "wavefront": {"route"},
         "prim": {"route", "prim_segments", "prim_queries", "prim_tiles",
                  "prim_groups", "prim_spheres", "prim_table"},
         "portal": {"route", "cycles", "polls", "resolve_segments",
                    "resolve_table", "resolve_group_items"}}


@pytest.mark.parametrize("route", list(ROUTES))
def test_stats_and_notes_per_route(repo_root, monkeypatch, route):
    """Each route reports its own ``RenderStats.extra`` keys. The portal
    route, whose runner keeps K3's counters, logs them as the
    ``render.resolve`` and ``render.resolve.group`` notes of a traced
    render, and the prim route, whose runner keeps K4's, as the
    ``render.prim``, ``render.prim.query``, ``render.prim.tiles``,
    ``render.prim.groups`` and ``render.prim.spheres`` notes; the other
    routes log neither."""
    scene, kw = _route(repo_root, route, monkeypatch)
    cfg = tpt.RenderConfig(samples_per_pixel=2, resolution=tpt.Resolution(4, 6),
                           max_depth=3, **kw)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            done = tpt.render(scene, cfg, device="cpu", out_dir=None,
                              verbose=False)
        notes = {s.name: (s.size, s.tag) for s in profiling.spans()
                 if s.name.startswith(("render.resolve", "render.prim"))}
    finally:
        profiling.clear()
    extra = done.stats.extra
    assert set(extra) == EXTRA[route] and extra["route"] == route
    assert done.stats.num_samples == 2 * 24 and done.stats.num_rays > 0
    assert done.stats.num_dispatches > 0
    if route == "portal":
        assert notes == {
            "render.resolve": (extra["resolve_segments"], "plain"),
            "render.resolve.group": (extra["resolve_group_items"], "plain")}
        assert 0 < extra["resolve_segments"] < done.stats.num_rays
        assert done.stats.num_dispatches == 2 * extra["cycles"]
    elif route == "prim":
        assert notes == {
            "render.prim": (extra["prim_segments"], "plain"),
            "render.prim.query": (extra["prim_queries"], None),
            "render.prim.tiles": (extra["prim_tiles"], None),
            "render.prim.groups": (extra["prim_groups"], None),
            "render.prim.spheres": (extra["prim_spheres"], None)}
        assert extra["prim_segments"] == done.stats.num_rays
        assert 0 < extra["prim_queries"] <= extra["prim_tiles"]
    else:
        assert notes == {}
