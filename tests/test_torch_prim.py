"""The table-driven scene, the full-scene intersector and K4 against JAX.

1. Host: ``kernel_scene_buffers`` byte-equal to the JAX package's, and the
   device form ``KernelScene`` equal whether built from the JAX tables or
   the port's.
2. The intersector and one bounce: ``isect_full_plain`` + ``shade_phase``
   against the JAX resolver ``trace_pallas_resolve`` (K7, which runs the
   same ``make_isect``) in interpret mode on random rays under injected
   uniforms, as tests/test_portal.py:133 drives it. Lane-exact at depth 1:
   alive, prev, throughput, radiance and depth equal; origin and direction
   within 1e-6 (XLA contracts a*b+c into FMAs inside jit).
3. K4: ``trace_regen_prim_plain`` against ``trace_pallas_regen_prim`` in
   interpret mode, whose PRNG stub returns zeros, given a table of zeros
   (the tests/test_pallas.py:193 recipe, on mesh); against K1's plain
   version on cornell under the counter generator; the per-lane tile skip
   against the unculled scan; the wrapper's device rule and arguments.
The CUDA kernel against this plain version is in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops.pallas import trace_kernel as j_tk
from path_tracer_tpu.ops.pallas import trace_v2 as j_tv2
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from tests.test_torch_host import SYNTH, load_both
from tests.test_torch_portal import synthetic_portal
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

LANE_TOL = 1e-3
LANE_FRAC = 0.995


def _scenes(sid, repo_root):
    if sid in SYNTH:
        return SYNTH[sid](jpt), SYNTH[sid](tpt)
    if sid == "synth-portal":
        return synthetic_portal(jpt), synthetic_portal(tpt)
    return load_both(sid, repo_root)


def _lists(a):
    return [torch.from_numpy(np.ascontiguousarray(a[k])) for k in range(a.shape[0])]


@pytest.mark.parametrize("sid", ["mesh", "cornell", "synth-portal", "gated"])
def test_kernel_scene_buffers_byte_equal(repo_root, sid):
    js, ts = _scenes(sid, repo_root)
    jb = j_tk.kernel_scene_buffers(jpt.pack_scene(js))
    tb = t_tk.kernel_scene_buffers(tpt.pack_scene(ts))
    assert set(jb) == set(tb)
    for k in jb:
        a = np.asarray(jb[k])
        assert a.dtype == tb[k].dtype and a.shape == tb[k].shape, k
        assert a.tobytes() == tb[k].tobytes(), k
    if sid == "mesh":  # Morton tiles with an always-tested base set
        assert "tile_lo" in tb and "gate" not in tb
        assert tb["tri_na"].shape[1] == 8 + 13 * t_tk.TRI_TILE
    if sid == "gated":  # the bounding sphere leaves a corner out: gate matrix
        assert "gate" in tb and "tile_lo" not in tb
    ks_j = t_tk.kernel_scene_from_jax({k: np.asarray(v) for k, v in jb.items()})
    ks_t = t_tk.build_kernel_scene(tpt.pack_scene(ts))
    for a, b in zip((ks_j.sph, ks_j.bnd, ks_j.tri, ks_j.tiles),
                    (ks_t.sph, ks_t.bnd, ks_t.tri, ks_t.tiles)):
        assert torch.equal(a, b)
    assert ks_j.tile_base == ks_t.tile_base


def _random_rays(g, n, packed):
    """Rays from inside the triangles' box, any direction (mesh: the box is
    the Cornell room), or, for a flat box, from above it towards it."""
    verts = np.asarray(packed.tri_v[:packed.num_triangles]).reshape(-1, 3)
    lo, hi = verts.min(0), verts.max(0)
    if (hi - lo).min() > 1e-3:
        o = lo + (hi - lo) * g.random((n, 3))
        d = g.normal(size=(n, 3))
    else:
        target = lo + (hi - lo) * g.random((n, 3))
        o = target + g.normal(0.0, 4.0, (n, 3)) + np.array([0.0, 0.0, 8.0])
        d = target - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32).T.copy(), d.astype(np.float32).T.copy()


@pytest.mark.parametrize("sid", ["mesh", "gated"])
def test_isect_and_bounce_match_jax_resolver(repo_root, sid):
    js, ts = _scenes(sid, repo_root)
    jp = jpt.pack_scene(js)
    kb = j_tk.kernel_scene_buffers(jp)
    ks = t_tk.build_kernel_scene(tpt.pack_scene(ts))
    n = 512
    g = np.random.default_rng(11)
    o, d = _random_rays(g, n, jp)
    u = g.random((4, n), dtype=np.float32)
    depth = g.integers(0, 12, (1, n)).astype(np.float32)
    thr = np.full((3, n), 0.7, np.float32)
    acc = np.zeros((3, n), np.float32)
    alive = np.ones((1, n), np.float32)
    prev = np.full((1, n), -1.0, np.float32)
    with pltpu.force_tpu_interpret_mode():
        out = j_tk.trace_pallas_resolve(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(thr), jnp.asarray(acc),
            jnp.asarray(alive), jnp.asarray(prev), jnp.asarray(depth), kb, 7,
            max_depth=12, rr_start_depth=5, block=256, uniforms=jnp.asarray(u))
    jo, jd, jthr, jacc, jalive, jprev, jdepth, jcounts = (np.asarray(x) for x in out)

    found, point, nrm, color, emis, rtype, new_prev = t_tk.isect_full_plain(
        ks, _lists(o), _lists(d), torch.from_numpy(prev[0]),
        torch.ones(n, dtype=torch.bool))
    dep = torch.from_numpy(depth[0])
    tacc, thr_new, d_new, alive_new = t_tk.shade_phase(
        _lists(d), nrm, color, emis, rtype, found, _lists(thr), _lists(acc),
        _lists(u), dep + 1.0, 12, 5)
    am = alive_new.to(torch.float32)
    assert found.float().mean() > 0.5  # the rays hit the scene
    np.testing.assert_array_equal(jalive[0], am.numpy())
    np.testing.assert_array_equal(jprev[0], new_prev.numpy())
    np.testing.assert_array_equal(jthr, np.stack([(t * am).numpy() for t in thr_new]))
    np.testing.assert_array_equal(jacc, np.stack([a.numpy() for a in tacc]))
    np.testing.assert_array_equal(jdepth[0], depth[0] + 1.0)
    assert float(jcounts.sum()) == n
    live = am.numpy() > 0
    to = np.stack([p.numpy() for p in point])[:, live]
    td = np.stack([x.numpy() for x in d_new])[:, live]
    np.testing.assert_allclose(jo[:, live], to, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(jd[:, live], td, rtol=1e-6, atol=1e-6)


def test_per_lane_tile_skip_is_exact(repo_root):
    """The per-lane culling of Morton tiles changes no hit: the same rays
    against the same rows with every tile folded into the base set (no
    culling) give the same hits, bit for bit."""
    _, ts = load_both("mesh", repo_root)
    packed = tpt.pack_scene(ts)
    ks = t_tk.build_kernel_scene(packed)
    flat = t_tk.KernelScene(ks.sph, ks.bnd, ks.tri, ks.tiles[:0], 0)
    g = np.random.default_rng(5)
    o, d = _random_rays(g, 4096, packed)
    prev = torch.from_numpy(np.where(g.random(4096) < 0.3, g.integers(
        0, packed.num_triangles, 4096), -1).astype(np.float32))
    alive = torch.ones(4096, dtype=torch.bool)
    work = {}
    culled = t_tk.isect_full_plain(ks, _lists(o), _lists(d), prev, alive, work)
    full = t_tk.isect_full_plain(flat, _lists(o), _lists(d), prev, alive)
    assert culled[0].float().mean() > 0.5
    for a, b in zip(culled, full):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)
    # the skip is real: far fewer triangle rows than 4096 x 840
    assert work["tri"] < 0.5 * 4096 * ks.tri.shape[0]


def test_k4_plain_matches_pallas_kernel_zero_stub(repo_root):
    """trace_pallas_regen_prim in interpret mode (PRNG stub: zeros) against
    the plain version given a table of zeros, on mesh."""
    js, ts = load_both("mesh", repo_root)
    w, h = 64, 16
    n = w * h
    kb = j_tk.kernel_scene_buffers(jpt.pack_scene(js))
    cam = j_tv2.build_camera_consts(js.camera, w, h)
    with pltpu.force_tpu_interpret_mode():
        j_rad, j_rays = j_tk.trace_pallas_regen_prim.__wrapped__(
            jnp.arange(n, dtype=jnp.int32), kb, cam, 3, 0, quota=2,
            max_depth=4, block=1024, quota_cap=2)
    ks = t_tk.build_kernel_scene(tpt.pack_scene(ts))
    cam_c = t_tv2.build_camera_consts(ts.camera, w, h)
    t_rad, t_segs, t_done = t_tk.trace_regen_prim_plain(
        ks, cam_c, torch.arange(n, dtype=torch.int32), seed=3, sample_base=0,
        quota=2, max_depth=4, uniforms=torch.zeros((6, n), dtype=torch.float32))
    j_rad = np.asarray(j_rad)
    assert np.isfinite(j_rad).all() and j_rad.sum() > 0
    np.testing.assert_array_equal(t_done.numpy(), 2)
    assert int(t_segs.sum()) == int(float(j_rays))
    agree = (np.abs(j_rad - t_rad.numpy()).sum(axis=1) < LANE_TOL).mean()
    assert agree >= LANE_FRAC, agree
    np.testing.assert_allclose(j_rad.mean(0), t_rad.numpy().mean(0), rtol=1e-4)


def test_k4_plain_matches_k1_plain_on_cornell(repo_root):
    """On a scene both routes take, K4's full-scene loop and K1's baked scan
    trace the same paths under the counter generator: the intersectors
    differ only in the sphere formula's rounding."""
    _, ts = load_both("cornell", repo_root)
    packed = tpt.pack_scene(ts)
    w, h = 36, 24
    cam_c = t_tv2.build_camera_consts(ts.camera, w, h)
    pix = torch.arange(w * h, dtype=torch.int32)
    kw = dict(seed=5, sample_base=8, quota=4, max_depth=12)
    k4 = t_tk.trace_regen_prim_plain(t_tk.build_kernel_scene(packed), cam_c, pix, **kw)
    k1 = t_tv2.trace_regen_plain(t_tv2.build_scene_consts(packed), cam_c, pix, **kw)
    np.testing.assert_array_equal(k4[2].numpy(), 4)
    agree = float(((k4[0] - k1[0]).abs().sum(dim=1) < LANE_TOL).float().mean())
    assert agree >= LANE_FRAC, agree
    assert abs(int(k4[1].sum()) - int(k1[1].sum())) <= 0.005 * int(k1[1].sum())


def test_trace_regen_prim_on_cpu_is_the_plain_version(repo_root):
    _, ts = load_both("mesh", repo_root)
    ks = t_tk.build_kernel_scene(tpt.pack_scene(ts))
    cam_c = t_tv2.build_camera_consts(ts.camera, 8, 6)
    pix = torch.arange(48, dtype=torch.int32)
    kw = dict(seed=1, sample_base=0, quota=2, max_depth=6)
    before = t_tk.trace_regen_prim.launches
    a = t_tk.trace_regen_prim(ks, cam_c, pix, **kw)
    b = t_tk.trace_regen_prim_plain(ks, cam_c, pix, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert t_tk.trace_regen_prim.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["quota", "pix_dtype", "uniforms"])
def test_trace_regen_prim_rejects_bad_arguments(repo_root, bad):
    _, ts = load_both("mesh", repo_root)
    ks = t_tk.build_kernel_scene(tpt.pack_scene(ts))
    cam_c = t_tv2.build_camera_consts(ts.camera, 8, 6)
    pix = torch.arange(48, dtype=torch.int32)
    kw = dict(seed=1, sample_base=0, quota=2)
    if bad == "quota":
        kw["quota"] = t_tk.QUOTA_CAP_PRIM + 1
    elif bad == "pix_dtype":
        pix = pix.to(torch.int64)
    else:
        kw["uniforms"] = torch.zeros((4, 48))
    with pytest.raises(ValueError):
        t_tk.trace_regen_prim(ks, cam_c, pix, **kw)
