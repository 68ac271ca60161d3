"""K7, K8 and K9 and the portal scheduler's resolve phase: the port's plain
versions against the JAX package, and against each other.

1. K7 ``trace_resolve_plain`` against JAX ``trace_pallas_resolve`` in
   interpret mode under injected uniforms, on the mesh scene at mixed
   per-lane depths 0-11 with a tenth of the lanes dead: every row of every
   lane within 1e-6 (relative and absolute), depth and counts exact.
2. K8 ``trace_cheap_blocked_plain`` against JAX ``trace_cheap_blocked``
   (interpreter PRNG stub: zeros; the port given a table of zeros) on mesh
   primary rays, the JAX block and the port's group both 256: every row of
   the live lanes within 1e-4 (K2's slot tolerance), alive, depth and
   counts exact; and the freeze invariants of tests/test_portal.py:221.
3. ``portal_resolve_phase`` under injected uniforms is K3's plain version
   with them, bit for bit, on a pool in the middle of a drive.
4. K9 ``trace_sorted_plain`` equals K6's plain version bit for bit (draws
   are keyed by ray), and the JAX ``trace_pallas_sorted`` lane for lane
   (outputs committed by scripts/make_torch_v1_goldens.py: the interpreter
   takes half a minute); its sort keys equal the JAX keys.
5. K8's early freeze is harmless: groups of 32 (the port's, a warp), 64,
   256 and 2048 lanes freeze different lanes early, and with K7 after each
   call the pool drains to the same radiance and the same segment count.
The CUDA kernels against these plain versions are in test_torch_cuda.py.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops.pallas import portal as j_pm
from path_tracer_tpu.ops.pallas import trace_kernel as j_tk
from path_tracer_tpu.ops.pallas import trace_v2 as j_tv2
from path_tracer_tpu_torch.ops.kernels import portal as t_pm
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from path_tracer_tpu_torch.render import portal as t_rp
from tests.test_torch_host import load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_v1_goldens",
    os.path.join(ROOT, "scripts", "make_torch_v1_goldens.py"))
GOLDENS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GOLDENS)
_spec = importlib.util.spec_from_file_location(
    "make_torch_portal_goldens",
    os.path.join(ROOT, "scripts", "make_torch_portal_goldens.py"))
PORTAL_GOLDENS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PORTAL_GOLDENS)


@pytest.fixture(scope="module")
def mesh(repo_root):
    """(JAX scene, port scene, JAX packed, port packed) of mesh."""
    js, ts = load_both("mesh", repo_root)
    return js, ts, jpt.pack_scene(js), tpt.pack_scene(ts)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays_in_box(packed, n, g):
    verts = np.asarray(packed.tri_v[:packed.num_triangles]).reshape(-1, 3)
    o = g.uniform(verts.min(0), verts.max(0), (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_k7_plain_matches_jax_injected_uniforms(mesh):
    _, _, jp, tp = mesh
    n, max_depth, rr = 512, 12, 5
    g = np.random.default_rng(11)
    o, d = _rays_in_box(jp, n, g)
    state = [o.T, d.T, np.full((3, n), 0.7, np.float32),
             g.random((3, n), dtype=np.float32),
             (g.random((1, n)) < 0.9).astype(np.float32),
             np.full((1, n), -1.0, np.float32),
             g.integers(0, 12, (1, n)).astype(np.float32)]
    u = g.random((4, n), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = j_tk.trace_pallas_resolve(
            *(jnp.asarray(x) for x in state), j_tk.kernel_scene_buffers(jp), 7,
            max_depth=max_depth, rr_start_depth=rr, block=256,
            uniforms=jnp.asarray(u))
    got = t_tk.trace_resolve_plain(
        t_tk.build_kernel_scene(tp), *(_t(x) for x in state),
        pixel_idx=torch.zeros(n, dtype=torch.int32),
        sample_idx=torch.zeros(n, dtype=torch.int32), seed=7,
        max_depth=max_depth, rr_start_depth=rr, uniforms=_t(u))
    names = "o d thr acc alive prev depth counts".split()
    for name, w, t in zip(names, want, got):
        w, t = np.asarray(w), t.numpy()
        assert w.shape == t.shape, name
        if name in ("alive", "depth", "counts"):
            np.testing.assert_array_equal(t, w, err_msg=name)
        else:
            np.testing.assert_allclose(t, w, rtol=1e-6, atol=1e-6, err_msg=name)
    alive = np.asarray(want[4])[0] > 0
    assert 0 < alive.sum() < n  # some paths live on, some end
    np.testing.assert_array_equal(got[6][0].numpy(), state[6][0] + state[4][0])


def _primary_pool(js, n, w, h):
    """The v1 pool [17, n] of camera rays through pixels lane % (w*h), as
    tests/test_portal.py:221 makes them (JAX raygen, sample 0)."""
    import jax

    from path_tracer_tpu.ops import rng as rng_mod
    from path_tracer_tpu.render.raygen import camera_arrays, generate_rays

    cam = {k: jnp.asarray(v) for k, v in camera_arrays(js.camera).items()}
    pix = jnp.arange(n, dtype=jnp.int32) % (w * h)
    u = rng_mod.raygen_uniforms(jax.random.PRNGKey(2), (n,), 2)
    o, d = generate_rays(pix, jnp.zeros((n,), jnp.int32), u, cam, w, h)
    pool = np.zeros((t_pm.V1_PORT_ROWS, n), np.float32)
    pool[t_pm.ROW_O:t_pm.ROW_O + 3] = np.asarray(o).T
    pool[t_pm.ROW_D:t_pm.ROW_D + 3] = np.asarray(d).T
    pool[t_pm.ROW_THR:t_pm.ROW_THR + 3] = 1.0
    pool[t_pm.ROW_ALIVE] = 1.0
    pool[t_pm.ROW_PREV] = -1.0
    pool[t_pm.ROW_PIX] = np.asarray(pix, np.float32)
    return pool


def _blocked(pool, lo, hi):
    """The portal slab test of the lanes of a pool (numpy)."""
    oo = pool[t_pm.ROW_O:t_pm.ROW_O + 3].T
    dd = pool[t_pm.ROW_D:t_pm.ROW_D + 3].T
    inv = 1.0 / np.where(np.abs(dd) < 1e-30, 1e-30, dd)
    ta = (np.asarray(lo)[None] - oo) * inv
    tb = (np.asarray(hi)[None] - oo) * inv
    t_en = np.maximum.reduce(np.minimum(ta, tb), axis=1)
    t_ex = np.minimum.reduce(np.maximum(ta, tb), axis=1)
    return (t_ex >= t_en) & (t_ex > 0.0)


def test_k8_plain_matches_jax_zero_stub(mesh):
    js, _, jp, tp = mesh
    n, group = 2048, 256
    consts, _ = j_pm.build_portal_consts(jp)
    key = "portal:torch-v1-test"
    j_tv2.register_scene(key, consts)
    pool = _primary_pool(js, n, 64, 32)
    with pltpu.force_tpu_interpret_mode():
        want, c_want = j_pm.trace_cheap_blocked(
            jnp.asarray(pool[:t_pm.ROWS]), key, 3, max_depth=12,
            rr_start_depth=5, block=group)
    want = np.asarray(want)
    pc, _ = t_pm.build_portal_consts(tp)
    out, counts = t_pm.trace_cheap_blocked_plain(
        pc, _t(pool), seed=3, max_depth=12, group=group,
        uniforms=torch.zeros((4, n)))
    got = out.numpy()
    alive = want[t_pm.ROW_ALIVE] > 0
    assert alive.any() and (~alive).any()
    for r in (t_pm.ROW_ALIVE, t_pm.ROW_DEPTH, t_pm.ROW_PIX):
        np.testing.assert_array_equal(got[r], want[r], err_msg=f"row {r}")
    np.testing.assert_allclose(got[:t_pm.ROWS, alive], want[:, alive],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[t_pm.ROW_ACC:t_pm.ROW_ACC + 3],
                               want[t_pm.ROW_ACC:t_pm.ROW_ACC + 3],
                               rtol=1e-4, atol=1e-4)
    assert int(counts.sum()) == float(c_want)
    # the freeze invariants: counts are the depth advance; every frozen
    # lane is portal-blocked; the pix and sample rows pass through; a lane
    # frozen at entry kept its ray
    depth = got[t_pm.ROW_DEPTH]
    np.testing.assert_array_equal(counts.numpy(), depth)
    assert (depth <= 12).all()
    assert _blocked(got, pc.lo, pc.hi)[alive].all()
    np.testing.assert_array_equal(got[t_pm.ROW_PIX:], pool[t_pm.ROW_PIX:])
    frozen0 = alive & (depth == 0)
    assert frozen0.any()
    np.testing.assert_array_equal(got[:6, frozen0], pool[:6, frozen0])


def _mid_drive_pool(ts, park_k=3):
    """A mesh v2 pool at 36x24 after two step-capped K2 calls: live and
    frozen active paths, frozen, ready and empty park buffers, and the
    port's sample rows."""
    packed = tpt.pack_scene(ts)
    pc, _ = t_pm.build_portal_consts(packed)
    cam = t_tv2.build_camera_consts(ts.camera, 36, 24)
    ks = t_tk.build_kernel_scene(packed)
    npix = 36 * 24
    n = t_rp._round_block(npix)
    pool = t_rp.make_pool_v2(npix, n, 6, park_k=park_k, device="cpu")
    kw = dict(seed=4, quota=6, sample_base=12, step_cap=4, park_k=park_k,
              max_depth=12)
    pool, _ = t_pm.trace_cheap_regen_plain(pc, cam, pool, **kw)
    pool, _, _ = t_rp.portal_resolve_phase(
        pool, ks, seed=4, park_k=park_k, max_depth=12, rr_start_depth=5)
    pool, _ = t_pm.trace_cheap_regen_plain(pc, cam, pool, **kw)
    return ks, pool


def test_resolve_phase_under_injected_uniforms_is_k3_plain(mesh):
    _, ts, _, _ = mesh
    park_k = 3
    ks, pool = _mid_drive_pool(ts, park_k)
    n = pool.shape[1]
    states = [pool[t_pm.buf_row(j, t_pm.BUF_STATE)] for j in range(park_k)]
    assert (pool[t_pm.ROW_ALIVE] > 0).any()
    for st in states:  # every buffer holds frozen paths ...
        assert (st == 1.0).any()
    assert any((st == 0.0).any() for st in states)  # ... and empty slots
    uni = torch.from_numpy(np.random.default_rng(6).random(
        (4, (park_k + 1) * n), dtype=np.float32))
    kw = dict(seed=9, park_k=park_k, max_depth=12, rr_start_depth=5)
    want, counts = t_pm.trace_resolve_pool_plain(ks, pool, parts=park_k + 1,
                                                 uniforms=uni, **kw)
    got, rays, unfin = t_rp.portal_resolve_phase(pool, ks, uniforms=uni, **kw)
    assert torch.equal(got, want)
    assert int(rays) == int(counts.sum()) > 0
    assert int(unfin) == int(t_rp._unfinished(want))
    counter, _ = t_pm.trace_resolve_pool_plain(ks, pool, parts=park_k + 1, **kw)
    assert not torch.equal(got, counter)  # the uniforms were drawn from


def _sorted_inputs(packed, n, max_depth, seed):
    g = np.random.default_rng(seed)
    o, d = _rays_in_box(packed, n, g)
    return (_t(o), _t(d), torch.from_numpy(g.integers(0, 64, n).astype(np.int32)),
            torch.from_numpy(g.integers(0, 8, n).astype(np.int32)),
            _t(g.random((max_depth * 4, n), dtype=np.float32)))


@pytest.mark.parametrize("sort_every,dir_major", [(1, False), (1, True),
                                                  (4, False), (4, True)])
def test_k9_plain_equals_k6_plain(mesh, sort_every, dir_major):
    """Draws keyed by ray: sorting the wavefront changes no ray's result."""
    _, _, _, tp = mesh
    ks = t_tk.build_kernel_scene(tp)
    o, d, pix, smp, _ = _sorted_inputs(tp, 384, 12, 8)
    kw = dict(seed=5, pixel_idx=pix, sample_idx=smp, max_depth=12)
    rad, rays = t_tk.trace_sorted_plain(ks, o, d, sort_every=sort_every,
                                        dir_major=dir_major, **kw)
    want, want_rays = t_tk.trace_stepped_plain(ks, o, d,
                                               steps_per_call=sort_every, **kw)
    assert torch.equal(rad, want) and int(rays) == int(want_rays)
    assert int(rays) > 384 and (rad.sum(1) > 0).any()


@pytest.mark.parametrize("name", sorted(GOLDENS.CASES))
def test_k9_plain_matches_jax_sorted(mesh, name):
    _, _, _, tp = mesh
    sort_every, dir_major = GOLDENS.CASES[name]
    o, d, u = (_t(x) for x in GOLDENS.inputs())
    n = o.shape[0]
    rad, _ = t_tk.trace_sorted_plain(
        t_tk.build_kernel_scene(tp), o, d, seed=0,
        pixel_idx=torch.zeros(n, dtype=torch.int32),
        sample_idx=torch.zeros(n, dtype=torch.int32),
        max_depth=GOLDENS.MAX_DEPTH, rr_start_depth=GOLDENS.RR_START,
        sort_every=sort_every, dir_major=dir_major, uniforms=u)
    np.testing.assert_allclose(rad.numpy(), GOLDENS.load(name), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.slow
def test_k9_goldens_regenerate_unchanged():
    for name, arr in GOLDENS.jax_outputs().items():
        np.testing.assert_array_equal(arr, GOLDENS.load(name))


@pytest.mark.parametrize("dir_major", [False, True])
def test_ray_sort_keys_match_jax(mesh, dir_major):
    _, _, jp, tp = mesh
    kb = j_tk.kernel_scene_buffers(jp)
    ks = t_tk.build_kernel_scene(tp)
    assert np.float32(ks.aabb_lo).tobytes() == kb["aabb_lo"].tobytes()
    assert np.float32(ks.aabb_inv_span).tobytes() == kb["aabb_inv_span"].tobytes()
    g = np.random.default_rng(2)
    n = 4096
    o = g.uniform(-12, 12, (3, n)).astype(np.float32)  # cells clip at the box
    d = g.normal(size=(3, n)).astype(np.float32)
    alive = (g.random((1, n)) < 0.8).astype(np.float32)
    want = np.asarray(j_tk.ray_sort_keys(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(alive), kb["aabb_lo"],
                                         kb["aabb_inv_span"], dir_major))
    got = t_tk.ray_sort_keys(_t(o), _t(d), _t(alive), ks.aabb_lo,
                             ks.aabb_inv_span, dir_major)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _frozen_early(pool, pc):
    """Lanes K8 left alive whose AABB entry lies beyond their cheap hit:
    frozen by their group's vote, not by their own segment."""
    o = [pool[t_pm.ROW_O + k] for k in range(3)]
    d = [pool[t_pm.ROW_D + k] for k in range(3)]
    alive = pool[t_pm.ROW_ALIVE] > 0
    hit_box, t_en = t_pm._portal_blocked(pc.lo, pc.hi, o, d, alive)
    tmin = t_tv2.prim_scan(pc.scene, o, d, pool[t_pm.ROW_PREV])[0]
    return alive & hit_box & (t_en > tmin)


def test_early_freeze_is_harmless():
    """K8's vote freezes a lane early when no lane of its group may run; K7
    then traces that segment against the full scene, whose closest hit is
    the cheap hit, under the same depth-keyed draws. On random rays in the
    synthetic portal scene (its light sphere hangs in front of the heavy
    plate, so a lane can hit it before the plate's AABB), groups of 32 (the
    port's BLOCKED_GROUP), 64, 256 and 2048 lanes freeze different lanes
    early, and each drains the pool
    (K8, then K7 on every lane, until no path lives) to the same radiance
    per lane (one pixel sample each) and the same segment count."""
    scene = PORTAL_GOLDENS.synthetic_portal_scene(tpt)
    packed = tpt.pack_scene(scene)
    pc, _ = t_pm.build_portal_consts(packed)
    ks = t_tk.build_kernel_scene(packed)
    n, npix = 2048, 36 * 24
    g = np.random.default_rng(3)
    pool0 = torch.zeros((t_pm.V1_PORT_ROWS, n))
    pool0[t_pm.ROW_O:t_pm.ROW_O + 3] = _t(
        g.uniform([-3, -3, -5], [3, 3, 0], (n, 3)).astype(np.float32).T)
    d = g.normal(size=(n, 3))
    pool0[t_pm.ROW_D:t_pm.ROW_D + 3] = _t(
        (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32).T)
    pool0[t_pm.ROW_THR:t_pm.ROW_THR + 3] = 1.0
    pool0[t_pm.ROW_ALIVE] = 1.0
    pool0[t_pm.ROW_PREV] = -1.0
    lane = torch.arange(n)
    pool0[t_pm.ROW_PIX] = (lane % npix).to(torch.float32)
    pool0[t_pm.V1_ROW_SAMPLE] = torch.div(lane, npix, rounding_mode="floor").to(
        torch.float32)
    results = {}
    assert t_pm.BLOCKED_GROUP == 32
    for group in (32, 64, 256, 2048):
        pool, segs, early = pool0.clone(), 0, 0
        for _ in range(13):
            if not bool((pool[t_pm.ROW_ALIVE] > 0).any()):
                break
            pool, c1 = t_pm.trace_cheap_blocked_plain(pc, pool, seed=1,
                                                      group=group)
            early += int(_frozen_early(pool, pc).sum())
            *state, c2 = t_tk.trace_resolve_plain(
                ks, pool[0:3], pool[3:6], pool[6:9], pool[9:12], pool[12:13],
                pool[13:14], pool[14:15],
                pixel_idx=pool[t_pm.ROW_PIX].to(torch.int32),
                sample_idx=pool[t_pm.V1_ROW_SAMPLE].to(torch.int32), seed=1)
            pool[:t_pm.ROW_PIX] = torch.cat(state)
            segs += int(c1.sum()) + int(c2.sum())
        assert not bool((pool[t_pm.ROW_ALIVE] > 0).any())
        results[group] = (pool[t_pm.ROW_ACC:t_pm.ROW_ACC + 3].clone(), segs, early)
    rad, segs, _ = results[2048]
    assert float(rad.sum()) > 0
    for group in (32, 64, 256):
        np.testing.assert_allclose(results[group][0].numpy(), rad.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert results[group][1] == segs
    # smaller groups freeze more lanes early (a group of 32 votes over half
    # of a group of 64's lanes, so it freezes at least the lanes that one
    # freezes; on these rays, no more)
    assert results[32][2] >= results[64][2] > results[256][2] > results[2048][2]


def test_wrappers_on_cpu_are_the_plain_versions(mesh):
    js, _, _, tp = mesh
    pc, _ = t_pm.build_portal_consts(tp)
    ks = t_tk.build_kernel_scene(tp)
    counters = (t_pm.trace_cheap_blocked, t_tk.trace_resolve, t_tk.trace_sorted)
    before = [c.launches for c in counters]
    pool = _t(_primary_pool(js, 256, 16, 16))
    a = t_pm.trace_cheap_blocked(pc, pool, seed=2, group=64)
    b = t_pm.trace_cheap_blocked_plain(pc, pool, seed=2, group=64)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    pool = b[0]
    rows = (pool[0:3], pool[3:6], pool[6:9], pool[9:12], pool[12:13],
            pool[13:14], pool[14:15])
    kw = dict(pixel_idx=pool[t_pm.ROW_PIX].to(torch.int32),
              sample_idx=torch.zeros(256, dtype=torch.int32), seed=2)
    a = t_tk.trace_resolve(ks, *rows, **kw)
    b = t_tk.trace_resolve_plain(ks, *rows, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    o, d, pix, smp, _ = _sorted_inputs(tp, 128, 4, 3)
    kw = dict(seed=2, pixel_idx=pix, sample_idx=smp, max_depth=4, sort_every=2)
    a = t_tk.trace_sorted(ks, o, d, **kw)
    b = t_tk.trace_sorted_plain(ks, o, d, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("bad", ["rows", "group", "uniforms", "depth_shape",
                                 "pixel_dtype", "sort_uniforms"])
def test_v1_kernels_reject_bad_arguments(mesh, bad):
    js, _, _, tp = mesh
    pc, _ = t_pm.build_portal_consts(tp)
    ks = t_tk.build_kernel_scene(tp)
    n = 64
    pool = _t(_primary_pool(js, n, 8, 8))
    rows = [pool[0:3], pool[3:6], pool[6:9], pool[9:12], pool[12:13],
            pool[13:14], pool[14:15]]
    kw = dict(pixel_idx=torch.zeros(n, dtype=torch.int32),
              sample_idx=torch.zeros(n, dtype=torch.int32), seed=1)
    with pytest.raises(ValueError):
        if bad == "rows":
            t_pm.trace_cheap_blocked(pc, pool[:-1], seed=1)
        elif bad == "group":
            t_pm.trace_cheap_blocked(pc, pool, seed=1, group=0)
        elif bad == "uniforms":
            t_pm.trace_cheap_blocked(pc, pool, seed=1, uniforms=torch.zeros(6, n))
        elif bad == "depth_shape":
            rows[6] = pool[14]
            t_tk.trace_resolve(ks, *rows, **kw)
        elif bad == "pixel_dtype":
            kw["pixel_idx"] = torch.zeros(n, dtype=torch.int64)
            t_tk.trace_resolve(ks, *rows, **kw)
        else:  # injected rows must cover whole calls of sort_every steps
            o, d, pix, smp, u = _sorted_inputs(tp, n, 12, 1)
            t_tk.trace_sorted(ks, o, d, seed=1, pixel_idx=pix, sample_idx=smp,
                              sort_every=5, uniforms=u)
