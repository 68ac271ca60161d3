"""The port's wavefront integrator against the JAX package's.

- ``ops.intersect`` and ``ops.bsdf`` lane for lane on the fixtures of
  tests/test_intersect.py and tests/test_bsdf.py: hits (found, object,
  triangle) equal, distances within 1e-5 relative, directions and weights
  within 1e-5. Exact mode agrees bit for bit on these rays; in fast mode
  XLA's and torch's [R,3]@[3,T] products round differently.
- The MOCK_RANDOM fixture: equal value for value.
- ``integrator.trace`` against JAX ``trace`` under the same threefry
  uniforms, injected into the port (tests/test_pallas.py's ``_run_both``
  harness): ray counts equal and at least 99.5% of lanes within 1e-3
  (|Δ|₁); the rest would be ulp-driven decision flips (measured: none).
- ``trace`` against the port's own K5 and K6 plain versions under one
  injected table and under the counter generator.
- Renders: mock_random renders against JAX's at tests/test_golden.py's
  config, at least 99% of pixels within 1e-4 and ray counts within 0.1%
  (measured: two-spheres and mesh all pixels, cornell 0.9954: JAX's jitted
  camera rays take XLA's rsqrt and fused multiply-adds, and the fixture's
  nine values make paths that an ulp parts); fast renders within Monte
  Carlo noise of the JAX goldens, sample counts exact; the literal
  estimator; chunking, the preview, the CLI options (checkpoints and
  cancel on every route: tests/test_torch_render.py).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu import version as j_version
from path_tracer_tpu.ops import bsdf as j_bsdf
from path_tracer_tpu.ops import intersect as j_isect
from path_tracer_tpu.ops import rng as j_rng
from path_tracer_tpu.render import integrator as j_integrator
from path_tracer_tpu.render import pipeline as j_pipeline
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.ops import bsdf as t_bsdf
from path_tracer_tpu_torch.ops import intersect as t_isect
from path_tracer_tpu_torch.ops import rng as t_rng
from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render import pipeline as t_pipeline
from path_tracer_tpu_torch.render import raygen as t_raygen
from path_tracer_tpu_torch.render.image import read_ppm
from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer
from tests.test_torch_host import load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
T = torch.from_numpy


def _random_rays(scene, n, seed=0):
    """tests/test_intersect.py's rays: from near the camera toward random
    scene points."""
    g = np.random.default_rng(seed)
    cam = scene.camera
    o = cam.position[None, :] + g.normal(0, 0.3, (n, 3)).astype(np.float32)
    target = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = target - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _both_bufs(js, ts):
    jb = {k: jnp.asarray(v) for k, v in jpt.pack_scene(js).buffers().items()}
    return jb, t_isect.scene_tensors(tpt.pack_scene(ts), "cpu")


def _hits_agree(jh, th, exact):
    found = np.asarray(jh.found)
    assert np.array_equal(found, th.found.numpy())
    for k in ("obj", "tri", "rtype"):
        assert np.array_equal(np.asarray(getattr(jh, k)), getattr(th, k).numpy()), k
    for k in ("color", "emission"):
        assert np.array_equal(np.asarray(getattr(jh, k))[found],
                              getattr(th, k).numpy()[found]), k
    if exact:  # the literal grouping rounds alike on both sides
        for k in ("t", "point"):
            np.testing.assert_array_equal(np.asarray(getattr(jh, k)),
                                          getattr(th, k).numpy(), err_msg=k)
        np.testing.assert_allclose(np.asarray(jh.normal), th.normal.numpy(),
                                   atol=1e-6)  # XLA's rsqrt
        return
    np.testing.assert_allclose(np.asarray(jh.t)[found], th.t.numpy()[found],
                               rtol=1e-5, atol=0)
    for k in ("point", "normal"):
        np.testing.assert_allclose(np.asarray(getattr(jh, k)),
                                   getattr(th, k).numpy(), atol=1e-4, err_msg=k)


@pytest.mark.parametrize("estimator", ["shipped", "literal"])
@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("sid", ["cornell", "two-spheres", "cartesian", "mesh"])
def test_intersect_scene_matches_jax(repo_root, sid, mode, estimator):
    js, ts = load_both(sid, repo_root)
    jb, tb = _both_bufs(js, ts)
    o, d = _random_rays(js, 100 if sid == "mesh" else 200, seed=42)
    kw = {}
    if estimator == "shipped":
        # each ray departs from a random packed triangle (or none)
        n_tri = jpt.pack_scene(js).tri_v.shape[0]
        prev = np.random.default_rng(1).integers(-1, n_tri, o.shape[0]).astype(np.int32)
        jkw = dict(prev_tri=jnp.asarray(prev))
        tkw = dict(prev_tri=T(prev).long())
    else:
        jkw = tkw = dict(eps_tri_t=0.0)
    jh = j_isect.intersect_scene(jnp.asarray(o), jnp.asarray(d), jb, mode=mode,
                                 **jkw, **kw)
    th = t_isect.intersect_scene(T(o), T(d), tb, mode=mode, **tkw)
    assert np.asarray(jh.found).any()
    _hits_agree(jh, th, exact=mode == "exact")


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_reverse_order_tie_break_matches_jax(mode):
    """Two coincident spheres: the higher object index wins on both sides
    (the reference scans objects in reverse keeping strictly-closer hits)."""
    scenes = []
    for pkg in (jpt, tpt):
        mat = pkg.Material(np.ones(3), np.zeros(3), pkg.ReflectType.DIFFUSE)
        scenes.append(pkg.SceneDescriptor(id="tie", objects=[
            pkg.SceneObject.sphere(np.array([0, 0, -3], np.float32), 1.0, mat),
            pkg.SceneObject.sphere(np.array([0, 0, -3], np.float32), 1.0, mat)]))
    jb, tb = _both_bufs(*scenes)
    o = np.array([[0.0, 0.0, 0.0], [0.3, 0.1, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    jh = j_isect.intersect_scene(jnp.asarray(o), jnp.asarray(d), jb, mode=mode)
    th = t_isect.intersect_scene(T(o), T(d), tb, mode=mode)
    assert th.obj.tolist() == [1, 1] == np.asarray(jh.obj).tolist()
    _hits_agree(jh, th, exact=mode == "exact")


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_mesh_bounding_sphere_gate_matches_jax(repo_root, mode):
    """tests/test_intersect.py's gate rays at mesh, and the synthetic scene
    whose buggy bounding sphere leaves a triangle corner out."""
    from tests.test_torch_host import gated_scene

    js, ts = load_both("mesh", repo_root)
    obj0 = js.objects[0]
    g = np.random.default_rng(3)
    n = 100
    o = (obj0.position + np.array([0, 0, 6], np.float32))[None, :] + g.normal(
        0, 1.5, (n, 3)).astype(np.float32)
    target = obj0.position[None, :] + g.normal(0, 1.0, (n, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    for pair in ((js, ts), (gated_scene(jpt), gated_scene(tpt))):
        jb, tb = _both_bufs(*pair)
        jh = j_isect.intersect_scene(jnp.asarray(o), jnp.asarray(d), jb, mode=mode)
        th = t_isect.intersect_scene(T(o), T(d), tb, mode=mode)
        _hits_agree(jh, th, exact=mode == "exact")
    # the gate itself: a ray at the left-out corner of the gated scene misses
    jb, tb = _both_bufs(gated_scene(jpt), gated_scene(tpt))
    oc = np.array([[9.5, 1.5, 5.0]], np.float32)
    dc = np.array([[0.0, 0.0, -1.0]], np.float32)
    th = t_isect.intersect_scene(T(oc), T(dc), tb, mode=mode)
    jh = j_isect.intersect_scene(jnp.asarray(oc), jnp.asarray(dc), jb, mode=mode)
    assert bool(th.found[0]) == bool(jh.found[0])


def test_intersect_bounds_matches_jax(repo_root):
    from path_tracer_tpu.ops.host_intersect import pack_scene_bounds

    js, ts = load_both("mesh", repo_root)
    jb, tb = _both_bufs(js, ts)
    bbox_tris, bbox_obj = pack_scene_bounds(js)
    order = np.arange(len(bbox_obj), dtype=np.int32)
    o, d = _random_rays(js, 300, seed=5)
    jt, jo = j_isect.intersect_bounds(
        jnp.asarray(o), jnp.asarray(d), jb,
        {"tri_v": jnp.asarray(bbox_tris), "tri_order": jnp.asarray(order),
         "tri_obj": jnp.asarray(bbox_obj)})
    tt, to = t_isect.intersect_bounds(
        T(o), T(d), tb, {"tri_v": T(bbox_tris), "tri_order": T(order),
                         "tri_obj": T(bbox_obj)})
    assert (np.asarray(jo) >= 0).any() and (np.asarray(jo) == 0).any()
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


def _unit(g, n):
    v = g.normal(0, 1, (n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_bsdf_matches_jax():
    """Each BSDF function of tests/test_bsdf.py on seeded lanes, port
    against JAX within 1e-5: random incoming directions, normals on both
    sides, all three ray types, uniforms including the branch choice."""
    g = np.random.default_rng(0)
    n = 4096
    d, nrm = _unit(g, n), _unit(g, n)
    nl = np.where((np.sum(nrm * d, 1) < 0)[:, None], nrm, -nrm).astype(np.float32)
    u = g.random((n, 3), dtype=np.float32)
    rtype = g.integers(0, 3, n).astype(np.int32)
    J, Tt = jnp.asarray, T

    np.testing.assert_allclose(np.asarray(j_bsdf.reflect(J(d), J(nrm))),
                               t_bsdf.reflect(Tt(d), Tt(nrm)).numpy(), atol=1e-6)
    jd = np.asarray(j_bsdf.sample_diffuse(J(nl), J(u[:, :1]), J(u[:, 1:2])))
    td = t_bsdf.sample_diffuse(Tt(nl), Tt(u[:, :1]), Tt(u[:, 1:2])).numpy()
    np.testing.assert_allclose(jd, td, atol=1e-5)
    assert (np.sum(td * nl, 1) >= -1e-6).all()  # the nl hemisphere
    jr, jw = j_bsdf.sample_refract(J(d), J(nrm), J(nl), J(u[:, 2:3]))
    tr, tw = t_bsdf.sample_refract(Tt(d), Tt(nrm), Tt(nl), Tt(u[:, 2:3]))
    np.testing.assert_allclose(np.asarray(jr), tr.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-5)
    js = j_bsdf.sample_bsdf(J(d), J(nrm), J(nl), J(rtype), J(u))
    ts = t_bsdf.sample_bsdf(Tt(d), Tt(nrm), Tt(nl), Tt(rtype), Tt(u))
    np.testing.assert_allclose(np.asarray(js.direction), ts.direction.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(js.weight), ts.weight.numpy(), rtol=1e-5)
    assert t_bsdf.NC == j_bsdf.NC and t_bsdf.NT == j_bsdf.NT


def test_refract_total_internal_reflection_matches_jax():
    """tests/test_bsdf.py's TIR case: always reflect, weight 1."""
    crit = np.arcsin(1.0 / 1.5)
    ang = crit + 0.2
    d = np.array([[np.sin(ang), np.cos(ang), 0.0]], np.float32)
    n = np.array([[0.0, -1.0, 0.0]], np.float32)
    u = np.array([[0.9]], np.float32)
    jr, jw = j_bsdf.sample_refract(jnp.asarray(d), jnp.asarray(n), jnp.asarray(-n),
                                   jnp.asarray(u))
    tr, tw = t_bsdf.sample_refract(T(d), T(n), T(-n), T(u))
    np.testing.assert_allclose(tr.numpy()[0], [np.sin(ang), -np.cos(ang), 0.0],
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    assert float(tw[0, 0]) == 1.0 == float(jw[0, 0])


def test_mock_fixture_equals_jax():
    np.testing.assert_array_equal(t_rng.MOCK_RANDOMS, j_rng.MOCK_RANDOMS)
    for start, shape, n in ((0, (3,), 4), (2, (1,), 3), (7, (5, 2), 2)):
        np.testing.assert_array_equal(
            t_rng.mock_uniforms(start, shape, n).numpy(),
            np.asarray(j_rng.mock_uniforms(start, shape, n)))
    for bounce, n, slots in ((0, 17, 4), (5, 1000, 4), (11, 33, 4), (15, 257, 2)):
        np.testing.assert_array_equal(
            t_rng.mock_uniforms_traced(bounce, n, slots, "cpu").numpy(),
            np.asarray(j_rng.mock_uniforms_traced(jnp.int32(bounce), (n,), slots)))


def _trace_inputs(js, ts, n, seed, max_depth):
    g = np.random.default_rng(0)
    o = np.tile(np.array([0.0, -0.2, 7.0], np.float32), (n, 1))
    d = _unit(g, n)
    key = jax.random.PRNGKey(seed)
    u = jnp.stack([j_rng.bounce_uniforms(key, s, (n,), 4) for s in range(max_depth)])
    table = T(np.array(u.transpose(0, 2, 1).reshape(max_depth * 4, n)))
    jb = j_pipeline.prepare_scene(js)
    return o, d, key, table, jb, t_isect.scene_tensors(tpt.pack_scene(ts), "cpu")


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("max_depth", [12, 4])
@pytest.mark.parametrize("sid", ["cornell", "mesh", "two-spheres"])
def test_trace_matches_jax_under_injected_uniforms(repo_root, sid, max_depth, mode):
    js, ts = load_both(sid, repo_root)
    n = 1024
    o, d, key, table, jb, tb = _trace_inputs(js, ts, n, 7, max_depth)
    ref = j_integrator.trace(jnp.asarray(o), jnp.asarray(d), jb, key,
                             max_depth=max_depth, mode=mode)
    got = integrator.trace(T(o), T(d), tb, uniforms=table, max_depth=max_depth,
                           mode=mode)
    assert int(got.rays_traced) == int(ref.rays_traced)
    diff = np.abs(np.asarray(ref.radiance) - got.radiance.numpy()).sum(axis=1)
    assert (diff < 1e-3).mean() >= 0.995, (diff < 1e-3).mean()
    np.testing.assert_allclose(got.radiance.numpy().mean(0),
                               np.asarray(ref.radiance).mean(0), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("sid,kernel", [("cornell", "K5"), ("cornell", "K6"),
                                        ("mesh", "K6")])
def test_trace_matches_the_stepped_plain_versions(repo_root, sid, kernel):
    """One injected table, then the counter generator, feed the wavefront
    and K5's or K6's plain version: the same paths up to intersection
    rounding (ray counts equal, 99.5% of lanes within 1e-3)."""
    _, ts = load_both(sid, repo_root)
    packed = tpt.pack_scene(ts)
    n = 2048
    g = np.random.default_rng(4)
    o = T(np.tile(np.array([0.0, -0.2, 7.0], np.float32), (n, 1)))
    d = T(_unit(g, n))
    table = T(g.random((48, n), dtype=np.float32))
    pix = torch.arange(n, dtype=torch.int32)
    smp = torch.full((n,), 5, dtype=torch.int32)
    tb = t_isect.scene_tensors(packed, "cpu")
    if kernel == "K5":
        sc = trace_v2.build_scene_consts(packed)
        plain = lambda **kw: trace_v2.trace_stepped_plain(  # noqa: E731
            sc, o, d, pixel_idx=pix, sample_idx=smp, **kw)
    else:
        ks = trace_kernel.build_kernel_scene(packed)
        plain = lambda **kw: trace_kernel.trace_stepped_plain(  # noqa: E731
            ks, o, d, pixel_idx=pix, sample_idx=smp, **kw)
    for kw in (dict(seed=0, uniforms=table), dict(seed=11)):
        rad, rays = plain(**kw)
        got = integrator.trace(o, d, tb, pixel_idx=pix, sample_idx=smp, **kw)
        assert int(got.rays_traced) == int(rays)
        diff = (got.radiance - rad).abs().sum(dim=1)
        assert float((diff < 1e-3).float().mean()) >= 0.995


def _golden_cfg(pkg, **kw):
    return pkg.RenderConfig(samples_per_pixel=8, resolution=pkg.Resolution(24, 36),
                            seed=1234, **kw)


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("sid", ["two-spheres", "cornell", "mesh"])
def test_mock_render_matches_jax(repo_root, sid, mode):
    js, ts = load_both(sid, repo_root)
    jd = jpt.render(js, _golden_cfg(jpt, mock_random=True, backend=mode),
                    out_dir=None, verbose=False)
    td = tpt.render(ts, _golden_cfg(tpt, mock_random=True, backend=mode),
                    device="cpu", out_dir=None, verbose=False)
    assert td.stats.extra["route"] == "wavefront"
    assert td.stats.num_samples == jd.stats.num_samples == 8 * 24 * 36
    assert abs(td.stats.num_rays - jd.stats.num_rays) <= 1e-3 * jd.stats.num_rays
    diff = np.abs(td.image.pixels - jd.image.pixels).max(axis=1)
    assert (diff <= 1e-4).mean() >= 0.99, (diff <= 1e-4).mean()


def test_mock_render_is_seed_independent(repo_root):
    """tests/test_golden.py's check, on cornell: two-spheres at this size
    is black but for a pixel or two of luck."""
    _, ts = load_both("cornell", repo_root)
    cfg = tpt.RenderConfig(samples_per_pixel=4, resolution=tpt.Resolution(12, 18),
                           mock_random=True)
    a = tpt.render(ts, cfg, device="cpu", out_dir=None, verbose=False)
    b = tpt.render(ts, cfg.with_(seed=99), device="cpu", out_dir=None, verbose=False)
    np.testing.assert_array_equal(a.image.pixels, b.image.pixels)
    c = tpt.render(ts, cfg.with_(mock_random=False, backend="fast"), device="cpu",
                   out_dir=None, verbose=False)
    assert not np.array_equal(a.image.pixels, c.image.pixels)


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.mark.parametrize("sid", ["two-spheres", "cornell", "mesh"])
def test_fast_render_within_mc_noise_of_jax_golden(repo_root, sid):
    """The JAX goldens are its fast mode at seed 1234: the port's fast
    render lies within 1.5 x the JAX two-seed RMSE of them."""
    js, ts = load_both(sid, repo_root)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{sid}_24x36_spp8_seed1234.npy"))
    other = jpt.render(js, _golden_cfg(jpt).with_(seed=1), out_dir=None,
                       verbose=False).image.pixels
    done = tpt.render(ts, _golden_cfg(tpt, backend="fast"), device="cpu",
                      out_dir=None, verbose=False)
    img = done.image.pixels
    assert done.stats.num_samples == 8 * 24 * 36 and np.isfinite(img).all()
    noise = _rmse(golden, other)
    assert noise > 0
    assert _rmse(img, golden) <= 1.5 * noise, (_rmse(img, golden), noise)


def test_literal_estimator_differs(repo_root):
    """tests/test_integrator.py's back-wall ray: the literal t > 0
    acceptance re-hits the departed wall on CPU arithmetic and comes out
    brighter than the shipped estimator."""
    _, ts = load_both("cornell", repo_root)
    tb = t_isect.scene_tensors(tpt.pack_scene(ts), "cpu")
    n = 20_000
    o = torch.tensor([[0.0, -0.2, 7.8]]).expand(n, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3)
    kw = dict(seed=3, pixel_idx=torch.arange(n, dtype=torch.int32),
              sample_idx=torch.zeros(n, dtype=torch.int32))
    ship = integrator.trace(o, d, tb, **kw).radiance
    lit = integrator.trace(o, d, tb, literal=True, **kw).radiance
    sem = float(lit.std()) / np.sqrt(n)
    assert float(lit.mean()) > float(ship.mean()) + 3 * sem


@pytest.mark.parametrize("what", ["literal", "mock_random"])
def test_render_options_run_on_the_wavefront(repo_root, what):
    """estimator='literal' and mock_random switch the kernel route to the
    wavefront's fast mode, which renders them (the JAX package's rule)."""
    _, ts = load_both("cornell", repo_root)
    cfg = tpt.RenderConfig(samples_per_pixel=4, resolution=tpt.Resolution(16, 24),
                           seed=7, **({"estimator": "literal"} if what == "literal"
                                      else {"mock_random": True}))
    done = tpt.render(ts, cfg, device="cpu", out_dir=None, verbose=False)
    assert done.stats.extra["route"] == "wavefront"
    assert done.stats.num_samples == 4 * 16 * 24
    grid = done.image.to_grid()
    assert np.isfinite(grid).all() and grid.max() > 0.1


@pytest.mark.parametrize("what", ["literal", "mock_random"])
def test_render_samples_takes_the_wavefront_options(repo_root, what):
    """render_samples on the wavefront route, in both modes, and on the
    kernel routes: literal is refused there (the kernels bake the shipped
    estimator), mock_random gives the kernel the fixture's camera rays."""
    _, ts = load_both("cornell", repo_root)
    cam = t_raygen.camera_arrays(ts.camera)
    pix = torch.arange(24, dtype=torch.int32)
    smp = torch.arange(24, dtype=torch.int32) % 4
    kw = dict(seed=0, width=6, height=4, **{what: True})
    for mode in ("exact", "fast"):
        prep = t_pipeline.prepare_render(ts, tpt.Resolution(4, 6), "cpu",
                                         backend=mode)
        res = integrator.render_samples(prep, cam, pix, smp, **kw)
        other = integrator.render_samples(prep, cam, pix, smp, mode="exact", **kw)
        assert res.radiance.shape == (24, 3) and int(res.rays_traced) >= 24
        assert torch.isfinite(res.radiance).all()
        if what == "mock_random":  # literal's count is a function of rounding
            assert int(res.rays_traced) == int(other.rays_traced)
    stepped = t_pipeline.prepare_render(ts, tpt.Resolution(4, 6), "cpu", regen=False)
    if what == "literal":
        with pytest.raises(ValueError, match="literal"):
            integrator.render_samples(stepped, cam, pix, smp, **kw)
    else:
        res = integrator.render_samples(stepped, cam, pix, smp, **kw)
        u = t_rng.mock_uniforms_traced(15, 24, 2, "cpu")
        o, d = t_raygen.generate_rays(pix, smp, u, cam, 6, 4)
        rad, rays = trace_v2.trace_stepped_plain(stepped.scene, o, d, seed=0,
                                                 pixel_idx=pix, sample_idx=smp)
        torch.testing.assert_close(res.radiance, rad, rtol=0, atol=0)


def test_backend_mapping_and_precision(repo_root):
    assert t_pipeline.resolve_backend("jnp") == "fast"
    assert t_pipeline.resolve_backend("exact") == "exact"
    for b in ("auto", "mxu", "pallas"):
        assert t_pipeline.resolve_backend(b) == "kernel"
    with pytest.raises(ValueError, match="backend"):
        tpt.RenderConfig(backend="tpu").validated()
    with pytest.raises(ValueError, match="TPU"):
        tpt.RenderConfig(f32_precision="high").validated()
    _, ts = load_both("cornell", repo_root)
    res = tpt.Resolution(4, 6)
    assert t_pipeline.prepare_render(ts, res, "cpu").route == "regen"
    prep = t_pipeline.prepare_render(ts, res, "cpu", backend="jnp")
    assert (prep.route, prep.mode) == ("wavefront", "fast")


def test_fast_form_refuses_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        t_isect.check_fp32_matmul("cuda")
    t_isect.check_fp32_matmul("cpu")  # the CPU has no TF32


def test_wavefront_pass_and_chunk_follow_jax():
    """The lane budget, pass size and chunk rule: mesh (832 packed
    triangles) at 1024x768 in fast mode gives JAX's chunks of 150,240
    pixels, six a pass of one sample."""
    k, chunk = t_pipeline.wavefront_pass(1024 * 768, 4, 0, "fast", 832)
    assert (k, chunk) == (1, 150240)
    k, chunk = t_pipeline.wavefront_pass(1024 * 768, 4, 0, "exact", 832)
    assert chunk == max(2_000_000_000 // (832 * 36), 4096)
    assert t_pipeline.wavefront_pass(24 * 36, 8, 0, "fast", 32) == (8, 0)
    assert t_pipeline.wavefront_pass(24 * 36, 8, 3, "fast", 32, 100) == (3, 100)


def test_wavefront_chunks_do_not_change_the_image(repo_root):
    """Draws keyed by pixel need no chunk key: a chunked render equals the
    unchunked one (the pad lanes of the last chunk are cropped)."""
    _, ts = load_both("cornell", repo_root)
    cfg = tpt.RenderConfig(samples_per_pixel=4, resolution=tpt.Resolution(12, 18),
                           backend="fast", seed=5)
    whole = tpt.render(ts, cfg, device="cpu", out_dir=None, verbose=False)
    chunked = tpt.render(ts, cfg.with_(pixel_chunk=50), device="cpu",
                         out_dir=None, verbose=False)
    np.testing.assert_array_equal(whole.image.pixels, chunked.image.pixels)
    assert chunked.stats.num_dispatches == 5  # ceil(216 / 50) chunks, one pass
    assert whole.stats.num_rays < chunked.stats.num_rays  # pad lanes trace too


def test_preview_on_the_wavefront_equals_a_render(repo_root):
    """ProgressiveRenderer(backend='fast'): two frames of 2 spp draw the
    samples of a 4-spp fast render of the same seed, summed in another
    order."""
    _, ts = load_both("cornell", repo_root)
    res = tpt.Resolution(12, 18)
    r = ProgressiveRenderer(ts, res, spp_per_frame=2, seed=4, backend="fast",
                            device="cpu")
    assert r.prep.route == "wavefront"
    r.step()
    img = r.step().pixels
    done = tpt.render(ts, tpt.RenderConfig(samples_per_pixel=4, resolution=res,
                                           seed=4, backend="fast"),
                      device="cpu", out_dir=None, verbose=False)
    np.testing.assert_allclose(img, done.image.pixels, atol=1e-6)


def test_debug_nans_stops_a_non_finite_render():
    mat = tpt.Material(np.ones(3), np.array([np.nan, 0, 0], np.float32),
                       tpt.ReflectType.DIFFUSE)
    scene = tpt.SceneDescriptor(id="nan", objects=[
        tpt.SceneObject.sphere(np.array([0, 0, 0], np.float32), 100.0, mat)])
    cfg = tpt.RenderConfig(samples_per_pixel=2, resolution=tpt.Resolution(4, 6),
                           backend="fast")
    done = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    assert np.isnan(done.image.pixels).any()  # without the flag it renders on
    with pytest.raises(FloatingPointError, match="non-finite"):
        tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False,
                   debug_nans=True)


def test_cli_backend_profile_and_debug_nans(repo_root, tmp_path):
    prof = tmp_path / "prof"
    proc = subprocess.run(
        [sys.executable, "-m", "path_tracer_tpu_torch.cli", "4", "12",
         "cornell", "--device", "cpu", "--backend", "fast", "--debug-nans",
         "--profile", str(prof), "--out-dir", str(tmp_path)],
        cwd=repo_root, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    ppms = [p for p in os.listdir(tmp_path) if p.endswith(".ppm")]
    assert len(ppms) == 1
    vals, w, h = read_ppm(str(tmp_path / ppms[0]))
    assert (w, h) == (18, 12) and vals.max() > 0
    with open(prof / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with pytest.raises(SystemExit):
        cli.main(["1", "4", "cornell", "--backend", "tpu"])


def test_version_matches_jax():
    assert tpt.__version__ == j_version.__version__
    assert "__version__" in tpt.__all__
