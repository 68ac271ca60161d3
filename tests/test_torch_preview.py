"""The interactive preview's path: raygen, K5 and K6, routing, the on-device
quantizer and the progressive renderer, against the JAX package.

1. ``generate_rays`` against the JAX function under the same uniforms:
   origins equal, direction components within 2^-22 (two ulps of the unit
   length; XLA's and torch's rsqrt each round once).
2. K5 ``trace_v2.trace_stepped_plain`` against ``trace_pallas_v2`` and K6
   ``trace_kernel.trace_stepped_plain`` against ``trace_pallas``, the JAX
   kernels run in interpret mode on the same rays under the same injected
   uniforms (the ``tests/test_pallas.py:22-44`` recipe): at least 99.5% of
   lanes within |Δ|₁ < 1e-3 and equal ray counts (XLA's FMAs and ulp-level
   sqrt/rsqrt/sin/cos differences flip rare branches); a trace in calls of
   3 steps equals one in calls of 12 bit for bit.
3. ``prepare_render(regen=False)``: the route the JAX package's preview
   picks, for every built-in scene.
4. ``to_int_with_gamma_correction`` byte-equal to ``quantize_np``.
5. ``ProgressiveRenderer(device="cpu")``: within Monte Carlo noise of the
   JAX preview (on the CPU the JAX side is its XLA ``fast`` integrator with
   another random stream: RMSE(port, JAX seed 0) <= 1.5 x RMSE(JAX seed 0,
   JAX seed 1), channel means within 4 standard errors); 4 frames of 2 spp
   equal ``render()`` at 8 spp of the same seed far inside the noise (the
   same draws per sample; camera rays differ by ulps, ``/ width`` against
   ``* (1 / width)``); ``step_u8`` byte-equal to ``quantize_np``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops import tonemap as j_tonemap
from path_tracer_tpu.ops.pallas import trace_kernel as j_tk
from path_tracer_tpu.ops.pallas import trace_v2 as j_tv2
from path_tracer_tpu.render import pipeline as j_pipeline
from path_tracer_tpu.render import raygen as j_raygen
from path_tracer_tpu.viewer.progressive import ProgressiveRenderer as JRenderer
from path_tracer_tpu_torch.ops import tonemap as t_tonemap
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render import pipeline as t_pipeline
from path_tracer_tpu_torch.render import raygen as t_raygen
from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer
from tests.test_torch_host import SCENE_IDS, load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

LANE_TOL = 1e-3
LANE_FRAC = 0.995
MAX_DEPTH = 12


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _jax_rays(js, w, h, g):
    """Camera rays of the JAX generate_rays at w x h, one sample a pixel
    with random sample indices and uniforms, as numpy [N, 3]."""
    n = w * h
    cam = {k: jnp.asarray(v) for k, v in j_raygen.camera_arrays(js.camera).items()}
    u = g.random((n, 2), dtype=np.float32)
    s = g.integers(0, 64, n).astype(np.int32)
    o, d = j_raygen.generate_rays(jnp.arange(n, dtype=jnp.int32), jnp.asarray(s),
                                  jnp.asarray(u), cam, w, h)
    return np.array(o), np.array(d)  # writable copies for torch


def test_generate_rays_match_jax(repo_root):
    js, ts = load_both("cornell", repo_root)
    w, h = 36, 24
    g = np.random.default_rng(5)
    n = 4096
    pix = g.integers(0, w * h, n).astype(np.int32)
    smp = g.integers(0, 1000, n).astype(np.int32)
    u = g.random((n, 2), dtype=np.float32)
    jcam = {k: jnp.asarray(v) for k, v in j_raygen.camera_arrays(js.camera).items()}
    jo, jd = j_raygen.generate_rays(jnp.asarray(pix), jnp.asarray(smp),
                                    jnp.asarray(u), jcam, w, h)
    to, td = t_raygen.generate_rays(torch.from_numpy(pix), torch.from_numpy(smp),
                                    torch.from_numpy(u),
                                    t_raygen.camera_arrays(ts.camera), w, h)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # Everything before the normalisation is equal; XLA's rsqrt and torch's
    # each round once (XLA's jitted and eager forms differ from each other
    # too), so a unit direction's components may part by two ulps of its
    # length 1 (measured: one, 2^-23, on 47% of lanes).
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2.0 ** -22)


def _k5_case(sid, repo_root, n_side=32):
    js, ts = load_both(sid, repo_root)
    g = np.random.default_rng(0)
    o, d = _jax_rays(js, n_side, n_side, g)
    n = o.shape[0]
    U = g.random((MAX_DEPTH * 4, n), dtype=np.float32)
    return js, ts, o, d, U


def _port_kw(n, U):
    return dict(seed=3, pixel_idx=torch.arange(n, dtype=torch.int32),
                sample_idx=torch.zeros(n, dtype=torch.int32),
                uniforms=torch.from_numpy(U), max_depth=MAX_DEPTH)


def _assert_lanes_agree(j_rad, j_rays, t_rad, t_rays):
    assert np.isfinite(t_rad).all() and t_rad.sum() > 0
    assert int(t_rays) == int(float(j_rays))
    agree = (np.abs(j_rad - t_rad).sum(axis=1) < LANE_TOL).mean()
    assert agree >= LANE_FRAC, agree
    np.testing.assert_allclose(j_rad.mean(0), t_rad.mean(0), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("sid", ["cornell", "three-spheres"])
def test_k5_plain_matches_pallas_v2(repo_root, sid):
    js, ts, o, d, U = _k5_case(sid, repo_root)
    j_tv2.register_scene("k5-test", j_tv2.build_scene_consts(jpt.pack_scene(js)))
    with pltpu.force_tpu_interpret_mode():
        j_rad, j_rays = j_tv2.trace_pallas_v2.__wrapped__(
            jnp.asarray(o), jnp.asarray(d), "k5-test", 3, block=1024,
            max_depth=MAX_DEPTH, steps_per_call=MAX_DEPTH, uniforms=jnp.asarray(U))
    scene_c = t_tv2.build_scene_consts(tpt.pack_scene(ts))
    kw = _port_kw(o.shape[0], U)
    t_rad, t_rays = t_tv2.trace_stepped_plain(
        scene_c, torch.from_numpy(o), torch.from_numpy(d), **kw)
    _assert_lanes_agree(np.asarray(j_rad), j_rays, t_rad.numpy(), t_rays)
    # chained calls carry the whole state: 4 calls of 3 steps == 1 of 12
    t3 = t_tv2.trace_stepped_plain(scene_c, torch.from_numpy(o),
                                   torch.from_numpy(d), steps_per_call=3, **kw)
    assert torch.equal(t3[0], t_rad) and torch.equal(t3[1], t_rays)


@pytest.mark.parametrize("sid", ["mesh", "cornell"])
def test_k6_plain_matches_pallas(repo_root, sid):
    js, ts, o, d, U = _k5_case(sid, repo_root)
    kb = j_tk.kernel_scene_buffers(jpt.pack_scene(js))
    with pltpu.force_tpu_interpret_mode():
        j_rad, j_rays = j_tk.trace_pallas.__wrapped__(
            jnp.asarray(o), jnp.asarray(d), kb, 3, block=1024,
            max_depth=MAX_DEPTH, steps_per_call=MAX_DEPTH, uniforms=jnp.asarray(U))
    ks = t_tk.build_kernel_scene(tpt.pack_scene(ts))
    kw = _port_kw(o.shape[0], U)
    t_rad, t_rays = t_tk.trace_stepped_plain(
        ks, torch.from_numpy(o), torch.from_numpy(d), **kw)
    _assert_lanes_agree(np.asarray(j_rad), j_rays, t_rad.numpy(), t_rays)
    t3 = t_tk.trace_stepped_plain(ks, torch.from_numpy(o), torch.from_numpy(d),
                                  steps_per_call=3, **kw)
    assert torch.equal(t3[0], t_rad) and torch.equal(t3[1], t_rays)


def test_k5_and_k6_trace_the_same_paths_on_cornell(repo_root):
    """Under the counter generator, K5's baked scan and K6's full-scene
    intersector trace cornell's paths alike: they differ only in the sphere
    formula's rounding."""
    _, ts = load_both("cornell", repo_root)
    packed = tpt.pack_scene(ts)
    g = np.random.default_rng(2)
    o, d = (torch.from_numpy(x) for x in _jax_rays(load_both("cornell", repo_root)[0],
                                                   24, 16, g))
    n = o.shape[0]
    kw = dict(seed=9, pixel_idx=torch.arange(n, dtype=torch.int32),
              sample_idx=torch.full((n,), 5, dtype=torch.int32))
    k5 = t_tv2.trace_stepped(t_tv2.build_scene_consts(packed), o, d, **kw)
    k6 = t_tk.trace_stepped(t_tk.build_kernel_scene(packed), o, d, **kw)
    agree = float(((k5[0] - k6[0]).abs().sum(dim=1) < LANE_TOL).float().mean())
    assert agree >= LANE_FRAC, agree
    assert abs(int(k5[1]) - int(k6[1])) <= 0.005 * int(k5[1])


def test_stepped_wrappers_on_cpu_are_the_plain_versions(repo_root):
    _, ts = load_both("cornell", repo_root)
    packed = tpt.pack_scene(ts)
    g = np.random.default_rng(4)
    o, d = (torch.from_numpy(x) for x in _jax_rays(load_both("cornell", repo_root)[0],
                                                   12, 8, g))
    n = o.shape[0]
    kw = dict(seed=1, pixel_idx=torch.arange(n, dtype=torch.int32),
              sample_idx=torch.zeros(n, dtype=torch.int32), steps_per_call=5)
    for fn, plain, scene in (
            (t_tv2.trace_stepped, t_tv2.trace_stepped_plain,
             t_tv2.build_scene_consts(packed)),
            (t_tk.trace_stepped, t_tk.trace_stepped_plain,
             t_tk.build_kernel_scene(packed))):
        before = fn.launches
        a, b = fn(scene, o, d, **kw), plain(scene, o, d, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert fn.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["steps", "uniforms", "dtype", "shape"])
def test_stepped_wrappers_reject_bad_arguments(repo_root, bad):
    _, ts = load_both("cornell", repo_root)
    scene_c = t_tv2.build_scene_consts(tpt.pack_scene(ts))
    n = 8
    o = torch.zeros((n, 3))
    d = torch.zeros((n, 3))
    d[:, 2] = -1.0
    kw = dict(seed=0, pixel_idx=torch.arange(n, dtype=torch.int32),
              sample_idx=torch.zeros(n, dtype=torch.int32))
    if bad == "steps":  # injected uniforms need calls that tile max_depth
        kw.update(steps_per_call=5, uniforms=torch.zeros((48, n)))
    elif bad == "uniforms":
        kw.update(uniforms=torch.zeros((6, n)))
    elif bad == "dtype":
        kw.update(pixel_idx=torch.arange(n))
    else:
        o = torch.zeros((n, 4))
    with pytest.raises(ValueError):
        t_tv2.trace_stepped(scene_c, o, d, **kw)


@pytest.mark.parametrize("sid", SCENE_IDS)
def test_preview_routing_follows_jax(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    res = tpt.Resolution(12, 18)
    _, mode = j_pipeline.prepare_scene_and_mode(js, "pallas", res, regen=False)
    prep = t_pipeline.prepare_render(ts, res, "cpu", regen=False)
    want = "stepped" if mode.startswith("pallas2:") else "stepped_prim"
    assert mode.startswith("pallas2:") or mode == "pallas"
    assert prep.route == want and prep.cam is None
    packed = tpt.pack_scene(ts)
    if want == "stepped":
        assert torch.equal(prep.scene.prims, t_tv2.build_scene_consts(packed).prims)
    else:
        assert torch.equal(prep.kscene.tri, t_tk.build_kernel_scene(packed).tri)


def test_tensor_quantizer_is_byte_equal_to_quantize_np():
    g = np.random.default_rng(8)
    x = np.concatenate([
        np.linspace(0.0, 1.0, (1 << 20) + 1, dtype=np.float32),
        g.random(1 << 18, dtype=np.float32),
        g.normal(0.5, 1.0, 1 << 16).astype(np.float32),  # clamped both ways
    ])
    got = t_tonemap.to_int_with_gamma_correction(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, t_tonemap.quantize_np(x))
    np.testing.assert_array_equal(got, j_tonemap.quantize_np(x))


def _jax_preview(js, seed, frames, height):
    r = JRenderer(js, jpt.Resolution.from_height(height), seed=seed)
    for _ in range(frames):
        img = r.step()
    return img.pixels


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
def test_preview_within_mc_noise_of_jax(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    j0 = _jax_preview(js, 0, 8, 24)
    j1 = _jax_preview(load_both(sid, repo_root)[0], 1, 8, 24)
    r = ProgressiveRenderer(ts, tpt.Resolution.from_height(24), device="cpu")
    for _ in range(8):
        img = r.step()
    t0 = img.pixels
    assert r.samples_done == 16 and t0.shape == j0.shape and np.isfinite(t0).all()
    noise = _rmse(j0, j1)
    assert noise > 0
    assert _rmse(t0, j0) <= 1.5 * noise, (_rmse(t0, j0), noise)
    se = (j0 - j1).std(axis=0) / np.sqrt(j0.shape[0])
    assert (np.abs(t0.mean(0) - j0.mean(0)) <= 4 * se).all(), (
        t0.mean(0), j0.mean(0), se)


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
def test_preview_frames_equal_a_render_of_the_same_samples(repo_root, sid):
    _, ts = load_both(sid, repo_root)
    res = tpt.Resolution(8, 12)
    r = ProgressiveRenderer(ts, res, spp_per_frame=2, seed=0, device="cpu")
    for _ in range(4):
        img = r.step()
    cfg = tpt.RenderConfig(samples_per_pixel=8, resolution=res)
    scene = load_both(sid, repo_root)[1]
    ref = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    other = tpt.render(scene, cfg.with_(seed=1), device="cpu", out_dir=None,
                       verbose=False)
    same = np.abs(img.pixels - ref.image.pixels).mean()
    noise = np.abs(other.image.pixels - ref.image.pixels).mean()
    assert same <= 0.25 * noise, (same, noise)


def test_step_u8_is_quantize_np_of_the_accumulator(repo_root):
    _, ts = load_both("two-spheres", repo_root)
    r = ProgressiveRenderer(ts, tpt.Resolution.from_height(24), device="cpu")
    frame = r.step_u8()
    npix = r.resolution.num_pixels
    assert frame.dtype == np.uint8 and frame.shape == (npix, 3)
    fin = integrator.finalize(r._accum, r.samples_done).numpy()
    np.testing.assert_array_equal(frame, t_tonemap.quantize_np(fin))
    # interleaving transports keeps one accumulation stream
    img = r.step()
    assert r.samples_done == 2 * r.spp_per_frame
    assert img.pixels.shape == (npix, 3)


def test_move_camera_restarts_and_rebuilds_nothing(repo_root):
    _, ts = load_both("cornell", repo_root)
    r = ProgressiveRenderer(ts, tpt.Resolution(12, 18), device="cpu")
    first = r.step().pixels
    prims = r.prep.scene.prims
    cam = tpt.Camera.looking(ts.camera.position + np.float32(0.5),
                             ts.camera.direction)
    r.move_camera(cam)
    assert r.samples_done == 0 and r.scene.camera is cam
    assert r.prep.scene.prims is prims  # the scene tables stay where they are
    moved = r.step().pixels
    assert r.samples_done == r.spp_per_frame
    assert not np.array_equal(first, moved)


def test_preview_needs_cuda_when_asked(repo_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, ts = load_both("cornell", repo_root)
    with pytest.raises(RuntimeError, match="cuda"):
        ProgressiveRenderer(ts, tpt.Resolution(4, 6))
