"""The regen kernel's pieces: plain torch versions against the JAX code.

1. Piece by piece: ``make_prim_scan``, ``shade_phase`` and ``make_raygen``
   are shape-agnostic jnp functions; called eagerly on the same numpy
   inputs as the port's counterparts they agree lane for lane.
2. The counter-based generator.
3. The ``trace_regen`` wrapper on the CPU: the plain version, and the
   arguments it refuses.
The whole loop against JAX and the Pallas kernel is in test_torch_regen.py;
the CUDA kernel against its plain version is in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops.pallas import trace_kernel as j_tk
from path_tracer_tpu.ops.pallas import trace_v2 as j_tv2
from path_tracer_tpu_torch.ops import rng
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from tests.test_torch_host import SYNTH, load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

def _scenes(sid, repo_root):
    if sid in SYNTH:
        return SYNTH[sid](jpt), SYNTH[sid](tpt)
    return load_both(sid, repo_root)


def _consts(sid, repo_root, w, h):
    """(JAX prims, bnd, cam tuple), (port SceneConsts, CameraConsts)."""
    js, ts = _scenes(sid, repo_root)
    prims, bnd = j_tv2.build_scene_consts(jpt.pack_scene(js))
    cam = j_tv2.build_camera_consts(js.camera, w, h)
    scene_c = t_tv2.build_scene_consts(tpt.pack_scene(ts))
    cam_c = t_tv2.build_camera_consts(ts.camera, w, h)
    return (prims, bnd, cam), (scene_c, cam_c)


def _lists(a):
    return [a[k] for k in range(a.shape[0])]


def _np(x):
    return np.asarray(x)


def _unit(g, n):
    d = g.normal(0, 1, (3, n))
    return (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("sid", ["cornell", "three-spheres", "gated",
                                 "lone-triangle"])
def test_prim_scan_lanewise(repo_root, sid):
    (prims, bnd, _), (scene_c, _) = _consts(sid, repo_root, 36, 24)
    n = 4096
    g = np.random.default_rng(11)
    if sid == "cornell":  # origins inside the box, any direction
        o = (g.random((3, n), dtype=np.float32) * 2 - 1) * np.array(
            [[2.5], [1.9], [8.5]], np.float32)
        d = _unit(g, n)
    else:  # origins around the scene, aimed near a random primitive
        o = (g.random((3, n), dtype=np.float32) * 2 - 1) * 12
        centers = np.array([
            p[1] if p[0] == "s" else np.add(p[1], np.add(p[2], p[3]) / 3)
            for p in prims], np.float32)
        target = centers[g.integers(0, len(prims), n)].T + g.normal(0, 0.7, (3, n))
        d = (target - o) / np.linalg.norm(target - o, axis=0, keepdims=True)
        d = d.astype(np.float32)
    tri_ids = [p[9] for p in prims if p[0] != "s"] or [0.0]
    prev = np.where(g.random(n) < 0.5, -1.0, g.choice(tri_ids, n)).astype(np.float32)

    jout = j_tv2.make_prim_scan(prims, bnd)(
        [jnp.asarray(x) for x in o], [jnp.asarray(x) for x in d],
        jnp.asarray(prev))
    tout = t_tv2.prim_scan(
        scene_c, _lists(torch.from_numpy(o)), _lists(torch.from_numpy(d)),
        torch.from_numpy(prev).to(torch.int64))
    j_t, j_col, j_em, j_aux, j_rt, j_sph, j_prev = jout
    t_t, t_col, t_em, t_aux, t_rt, t_sph, t_prev = tout
    np.testing.assert_array_equal(_np(j_prev), t_prev.numpy().astype(np.float32))
    np.testing.assert_array_equal(_np(j_sph), t_sph.numpy())
    np.testing.assert_array_equal(_np(j_rt), t_rt.numpy())
    for k in range(3):
        np.testing.assert_array_equal(_np(j_col[k]), t_col[k].numpy())
        np.testing.assert_array_equal(_np(j_em[k]), t_em[k].numpy())
        np.testing.assert_array_equal(_np(j_aux[k]), t_aux[k].numpy())
    np.testing.assert_allclose(_np(j_t), t_t.numpy(), rtol=1e-5, atol=1e-5)
    hit = _np(j_t) < j_tv2.BIG
    assert hit.mean() > 0.2


def test_shade_phase_lanewise():
    n = 8192
    g = np.random.default_rng(4)
    d = _unit(g, n)
    nrm = _unit(g, n)
    color = g.random((3, n), dtype=np.float32)
    emis = (g.random((3, n), dtype=np.float32) * 3).astype(np.float32)
    rtype = g.integers(0, 3, n).astype(np.float32)
    found = g.random(n) < 0.9
    thr = g.random((3, n), dtype=np.float32)
    acc = g.random((3, n), dtype=np.float32)
    u4 = g.random((4, n), dtype=np.float32)
    new_depth = g.integers(1, 13, n)
    args = (d, nrm, color, emis, rtype, found, thr, acc, u4)

    def jx(a):
        return _lists(jnp.asarray(a)) if a.ndim == 2 else jnp.asarray(a)

    def tx(a):
        return _lists(torch.from_numpy(a)) if a.ndim == 2 else torch.from_numpy(a)

    j_acc, j_thr, j_d, j_alive = j_tk.shade_phase(
        *map(jx, args), jnp.asarray(new_depth, jnp.float32), 12, 5)
    t_acc, t_thr, t_d, t_alive = t_tk.shade_phase(
        *map(tx, args), torch.from_numpy(new_depth), 12, 5)
    np.testing.assert_array_equal(_np(j_alive), t_alive.numpy())
    for k in range(3):
        np.testing.assert_allclose(_np(j_acc[k]), t_acc[k].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(j_thr[k]), t_thr[k].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(j_d[k]), t_d[k].numpy(), rtol=1e-5, atol=1e-5)


def test_raygen_lanewise(repo_root):
    (_, _, cam), (_, cam_c) = _consts("cornell", repo_root, 36, 24)
    n = 36 * 24 * 4
    g = np.random.default_rng(8)
    pix = g.integers(0, 36 * 24, n).astype(np.int32)
    s_idx = g.integers(0, 1000, n)
    u1, u2 = g.random((2, n), dtype=np.float32)
    jray, jlc = j_tk.make_raygen(cam, jnp.asarray(pix, jnp.float32))
    tray, tlc = t_tk.make_raygen(cam_c, torch.from_numpy(pix))
    jd = jray(jnp.asarray(s_idx, jnp.float32), jnp.asarray(u1), jnp.asarray(u2))
    td = tray(torch.from_numpy(s_idx), torch.from_numpy(u1), torch.from_numpy(u2))
    assert list(jlc) == list(tlc)
    for k in range(3):
        np.testing.assert_allclose(_np(jd[k]), td[k].numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ counter generator


def _fmix32_ref(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _mix_ref(h, x):
    return _fmix32_ref(h ^ ((x * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF))


def test_counter_generator_is_a_pure_function_of_its_key():
    g = np.random.default_rng(1)
    pix = torch.from_numpy(g.integers(0, 2**24, 512))
    sample = torch.from_numpy(g.integers(0, 2**31 - 1, 512))
    depth = torch.from_numpy(g.integers(0, 12, 512))
    key = rng.path_key(12345, pix, sample)
    bits = rng.uniform_bits(key, depth, 3)
    # the same key gives the same bits
    assert torch.equal(bits, rng.uniform_bits(rng.path_key(12345, pix, sample), depth, 3))
    # and they are murmur3's fmix32 chain in exact integer arithmetic
    for i in range(0, 512, 37):
        h = _mix_ref(_mix_ref(_mix_ref(0, 12345), int(pix[i])), int(sample[i]))
        assert int(key[i]) == h
        assert int(bits[i]) == _mix_ref(h, int(depth[i]) * 8 + 3)
    u = rng.bits_to_uniform(bits)
    want = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    assert torch.equal(u, want)


def test_counter_uniforms_moments():
    n = 10**6
    key = rng.path_key(7, torch.arange(n, dtype=torch.int64) % 4096,
                       torch.arange(n, dtype=torch.int64) // 4096)
    u = rng.uniform(key, 3, 1).to(torch.float64)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    mean_se = (1 / 12 / n) ** 0.5
    var_se = ((1 / 80 - 1 / 144) / n) ** 0.5
    assert abs(float(u.mean()) - 0.5) < 4 * mean_se
    assert abs(float(u.var()) - 1 / 12) < 4 * var_se


def test_counter_render_independent_of_pass_split(repo_root):
    _, (scene_c, cam_c) = _consts("cornell", repo_root, 18, 12)
    pix = torch.randperm(18 * 12, generator=torch.Generator().manual_seed(0)).to(torch.int32)
    kw = dict(seed=9, max_depth=12)
    r4, s4, d4 = t_tv2.trace_regen(scene_c, cam_c, pix, sample_base=0, quota=4, **kw)
    ra, sa, da = t_tv2.trace_regen(scene_c, cam_c, pix, sample_base=0, quota=1, **kw)
    rb, sb, db = t_tv2.trace_regen(scene_c, cam_c, pix, sample_base=1, quota=3, **kw)
    assert torch.equal(s4, sa + sb) and torch.equal(d4, da + db)
    np.testing.assert_allclose(r4.numpy(), (ra + rb).numpy(), rtol=1e-5, atol=1e-6)
    assert float(r4.sum()) > 0


# ------------------------------------------------------------ the wrapper


def test_trace_regen_on_cpu_is_the_plain_version(repo_root):
    """CPU tensors run the plain version and launch nothing; a device that
    is neither cpu nor cuda is refused, never run on the CPU."""
    _, (scene_c, cam_c) = _consts("cornell", repo_root, 12, 8)
    pix = torch.arange(96, dtype=torch.int32)
    kw = dict(seed=4, sample_base=2, quota=2)
    before = t_tv2.trace_regen.launches
    got = t_tv2.trace_regen(scene_c, cam_c, pix, **kw)
    want = t_tv2.trace_regen_plain(scene_c, cam_c, pix, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert t_tv2.trace_regen.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_tv2.trace_regen(scene_c, cam_c, pix.to("meta"), **kw)


@pytest.mark.parametrize("bad", ["pixel_dtype", "uniforms_shape", "too_many_prims",
                                 "max_depth"])
def test_trace_regen_rejects_bad_arguments(repo_root, bad):
    _, (scene_c, cam_c) = _consts("cornell", repo_root, 12, 8)
    pix = torch.arange(96, dtype=torch.int32)
    kw = dict(seed=0, sample_base=0, quota=1)
    if bad == "pixel_dtype":
        pix = pix.to(torch.int64)
    elif bad == "uniforms_shape":
        kw["uniforms"] = torch.zeros((4, 96), dtype=torch.float32)
    elif bad == "too_many_prims":
        rows = scene_c.prims.repeat(12, 1)  # 132 rows
        scene_c = t_tv2.SceneConsts(rows, scene_c.gates)
    else:
        kw["max_depth"] = 0
    with pytest.raises(ValueError):
        t_tv2.trace_regen(scene_c, cam_c, pix, **kw)
