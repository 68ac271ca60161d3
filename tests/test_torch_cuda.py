"""The CUDA kernels against their plain torch versions, on a card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so that it runs where only the
port is installed; tests/conftest.py imports jax, so on such a machine run
it as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernels: K1 trace_regen (cornell, three-spheres, a gated scene), K4
trace_regen_prim, K2 trace_cheap_regen and K3 trace_resolve_pool (mesh),
K5 and K6 trace_stepped (cornell and mesh preview rays) and the progressive
preview on the card; K7 trace_resolve, K8 trace_cheap_blocked and K9
trace_sorted (mesh) and the v1 and glue portal routes.

Tolerance of the default build: at least 99.5% of pixels (K2, K3: pool
columns) within |Δ|₁ < 1e-3, channel means within rtol 1e-3 and atol 1e-3,
per-pixel sample counts exactly equal to the quota, segment totals within
0.5%. Reason: nvcc contracts a*b+c into FMAs where torch rounds each
operation, which parts a few long closed-box trajectories. A build with
--fmad=false is held to bit equality.
"""

import os

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch.ops.kernels import portal, trace_kernel, trace_v2
from path_tracer_tpu_torch.ops import tonemap
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render import portal as rportal
from path_tracer_tpu_torch.render.pipeline import (
    morton_pixel_order, prepare_render, prepare_scene,
)
from path_tracer_tpu_torch.render.raygen import camera_arrays
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _scene(sid):
    return tpt.load_scene(sid, os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))


def _gated_scene():
    """A quad whose buggy bounding sphere leaves a corner out, so the kernel
    must gate its triangles (tests/test_pallas.py:150-159), plus a light."""
    tris = np.array([[[4, -10, 0], [10, -10, 0], [4, 2, 0]],
                     [[10, -10, 0], [10, 2, 0], [4, 2, 0]]], np.float32)
    return tpt.SceneDescriptor(id="gated", objects=[
        tpt.SceneObject.from_mesh(
            np.zeros(3, np.float32), tpt.Mesh.from_triangles(tris),
            tpt.Material(np.full(3, 0.8, np.float32), np.zeros(3),
                         tpt.ReflectType.DIFFUSE)),
        tpt.SceneObject.sphere(
            np.array([6.0, -4.0, 4.0], np.float32), 1.5,
            tpt.Material(np.zeros(3), np.full(3, 6.0, np.float32),
                         tpt.ReflectType.DIFFUSE)),
    ], camera=tpt.Camera.looking([7.0, -4.0, 12.0], [0.0, 0.0, -1.0]))


@pytest.mark.cuda
@pytest.mark.parametrize("sid,source", [
    ("cornell", "counter"), ("cornell", "table"), ("three-spheres", "counter"),
    ("gated", "counter"),
])
def test_cuda_kernel_matches_plain(cuda_device, sid, source):
    res = Resolution(96, 128)
    scene = _gated_scene() if sid == "gated" else _scene(sid)
    scene_c, cam_c = prepare_scene(scene, res, cuda_device)
    if sid == "gated":
        assert scene_c.gates.shape[0] == 1
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(cuda_device)
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(0).random(
            (6, res.num_pixels), dtype=np.float32)).to(cuda_device)
    kw = dict(seed=5, sample_base=4, quota=4, max_depth=12, uniforms=uni)
    before = trace_v2.trace_regen.launches
    k_rad, k_segs, k_done = trace_v2.trace_regen(scene_c, cam_c, pix, **kw)
    torch.cuda.synchronize()
    assert trace_v2.trace_regen.launches == before + 1
    p_rad, p_segs, p_done = trace_v2.trace_regen_plain(scene_c, cam_c, pix, **kw)
    assert trace_v2.trace_regen.launches == before + 1  # plain launches nothing
    k_rad, p_rad = k_rad.cpu().numpy(), p_rad.cpu().numpy()
    np.testing.assert_array_equal(k_done.cpu().numpy(), 4)
    np.testing.assert_array_equal(p_done.cpu().numpy(), 4)
    assert np.isfinite(k_rad).all() and k_rad.sum() > 0
    agree = (np.abs(k_rad - p_rad).sum(axis=1) < 1e-3).mean()
    assert agree >= 0.995, agree
    np.testing.assert_allclose(k_rad.mean(0), p_rad.mean(0), rtol=1e-3, atol=1e-3)
    ks, ps = int(k_segs.sum(dtype=torch.int64)), int(p_segs.sum(dtype=torch.int64))
    assert abs(ks - ps) <= 0.005 * ps


@pytest.mark.cuda
@pytest.mark.parametrize("sid,source", [
    ("cornell", "counter"), ("cornell", "table"), ("gated", "counter"),
])
def test_cuda_kernel_without_fma_is_bit_exact(cuda_device, sid, source):
    """Built with --fmad=false the kernel rounds every product as torch
    does, and equals its plain version on the card bit for bit."""
    res = Resolution(96, 128)
    scene = _gated_scene() if sid == "gated" else _scene(sid)
    scene_c, cam_c = prepare_scene(scene, res, cuda_device)
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(cuda_device)
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(0).random(
            (6, res.num_pixels), dtype=np.float32)).to(cuda_device)
    kw = dict(seed=5, sample_base=4, quota=4, max_depth=12, uniforms=uni)
    k_out = trace_v2.trace_regen(scene_c, cam_c, pix, fmad=False, **kw)
    p_out = trace_v2.trace_regen_plain(scene_c, cam_c, pix, **kw)
    for k, p in zip(k_out, p_out):
        assert torch.equal(k, p)
    assert float(k_out[0].sum()) > 0


@pytest.mark.cuda
def test_cuda_render_matches_cpu_render(cuda_device):
    """The same counter-based random numbers on both devices: the card's
    render differs from the CPU's only where ulps part a path, far inside
    the Monte Carlo noise between two seeds."""
    scene = _scene("cornell")
    cfg = RenderConfig(samples_per_pixel=16, resolution=Resolution(24, 36))
    before = trace_v2.trace_regen.launches
    gpu = tpt.render(scene, cfg, device=cuda_device, out_dir=None, verbose=False)
    assert trace_v2.trace_regen.launches > before
    cpu = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    cpu1 = tpt.render(scene, cfg.with_(seed=1), device="cpu", out_dir=None,
                      verbose=False)
    same = np.abs(gpu.image.pixels - cpu.image.pixels).mean()
    noise = np.abs(cpu1.image.pixels - cpu.image.pixels).mean()
    assert same <= 0.25 * noise, (same, noise)
    assert gpu.stats.num_rays == pytest.approx(cpu.stats.num_rays, rel=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["counter", "table"])
def test_cuda_k4_matches_plain(cuda_device, source):
    res = Resolution(96, 128)
    prep = prepare_render(_scene("mesh"), res, cuda_device)
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(cuda_device)
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(0).random(
            (6, res.num_pixels), dtype=np.float32)).to(cuda_device)
    kw = dict(seed=5, sample_base=4, quota=4, uniforms=uni)
    before = trace_kernel.trace_regen_prim.launches
    k_rad, k_segs, k_done = trace_kernel.trace_regen_prim(
        prep.kscene, prep.cam, pix, **kw)
    torch.cuda.synchronize()
    assert trace_kernel.trace_regen_prim.launches == before + 1
    p_out = trace_kernel.trace_regen_prim_plain(prep.kscene, prep.cam, pix, **kw)
    np.testing.assert_array_equal(k_done.cpu().numpy(), 4)
    agree = float(((k_rad - p_out[0]).abs().sum(dim=1) < 1e-3).float().mean())
    assert agree >= 0.995, agree
    exact = trace_kernel.trace_regen_prim(prep.kscene, prep.cam, pix, fmad=False, **kw)
    for k, p in zip(exact, p_out):
        assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_portal_kernels_match_plain(cuda_device):
    """K2 and K3 over three cycles of a mesh pool with park depth 3: the
    --fmad=false builds equal the plain versions bit for bit, the default
    builds agree on 99.5% of the pool's columns."""
    res = Resolution(96, 128)
    prep = prepare_render(_scene("mesh"), res, cuda_device)
    n = rportal._round_block(res.num_pixels)
    pool = rportal.make_pool_v2(res.num_pixels, n, 16, park_k=3, device=cuda_device)
    cheap = dict(seed=3, quota=16, sample_base=0, step_cap=64, park_k=3)
    resolve = dict(seed=3, parts=4, park_k=3)
    for _ in range(3):
        for fn, plain, args, kw in (
            (portal.trace_cheap_regen, portal.trace_cheap_regen_plain,
             (prep.portal, prep.cam), cheap),
            (portal.trace_resolve_pool, portal.trace_resolve_pool_plain,
             (prep.kscene,), resolve),
        ):
            p_pool, p_counts = plain(*args, pool, **kw)
            e_pool, e_counts = fn(*args, pool, fmad=False, **kw)
            k_pool, _ = fn(*args, pool, **kw)
            torch.cuda.synchronize()
            assert torch.equal(e_pool, p_pool) and torch.equal(e_counts, p_counts)
            agree = float(((k_pool - p_pool).abs().sum(dim=0) < 1e-3).float().mean())
            assert agree >= 0.995, agree
            pool = p_pool
    assert float(pool[portal.V2_ROW_DONE].sum()) > 0


@pytest.mark.cuda
def test_cuda_mesh_renders_match_cpu(cuda_device, monkeypatch):
    """Both mesh routes on the card launch their kernels and agree with the
    CPU render of the same seed far inside the noise between two seeds."""
    scene = _scene("mesh")
    cfg = RenderConfig(samples_per_pixel=8, resolution=Resolution(24, 36))
    cpu = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    cpu1 = tpt.render(scene, cfg.with_(seed=1), device="cpu", out_dir=None,
                      verbose=False)
    noise = np.abs(cpu1.image.pixels - cpu.image.pixels).mean()
    counts = (portal.trace_cheap_regen, portal.trace_resolve_pool,
              trace_kernel.trace_regen_prim)
    for env, launched in ((None, (0, 1)), ("1", (2,))):
        if env:
            monkeypatch.setenv("PT_TPU_NO_PORTAL", env)
        before = [c.launches for c in counts]
        gpu = tpt.render(scene, cfg, device=cuda_device, out_dir=None,
                         verbose=False)
        for i in launched:
            assert counts[i].launches > before[i]
        same = np.abs(gpu.image.pixels - cpu.image.pixels).mean()
        assert same <= 0.25 * noise, (env, same, noise)
        assert gpu.stats.num_samples == cpu.stats.num_samples


def _preview_rays(scene, res, spp, dev):
    """The preview's rays for one frame of ``spp`` samples (render_samples)."""
    npix = res.num_pixels
    pix = torch.arange(npix, dtype=torch.int32, device=dev).repeat_interleave(spp)
    smp = torch.arange(spp, dtype=torch.int32, device=dev).repeat(npix)
    o, d = integrator.camera_rays(camera_arrays(scene.camera), pix, smp, seed=0,
                                  width=res.width, height=res.height)
    return o, d, pix, smp


@pytest.mark.cuda
@pytest.mark.parametrize("sid,kernel", [("cornell", "K5"), ("three-spheres", "K5"),
                                        ("mesh", "K6"), ("cornell", "K6")])
@pytest.mark.parametrize("source", ["counter", "table"])
def test_cuda_stepped_kernels_match_plain(cuda_device, sid, kernel, source):
    """K5 and K6 on a frame of preview rays, in calls of 12 and of 5 steps:
    the --fmad=false build equals the plain version bit for bit, the default
    build agrees on 99.5% of rays."""
    res = Resolution(96, 128)
    prep = prepare_render(_scene(sid), res, cuda_device, regen=False)
    o, d, pix, smp = _preview_rays(_scene(sid), res, 2, cuda_device)
    if kernel == "K5":
        fn, scene = trace_v2.trace_stepped, prep.scene
        plain = trace_v2.trace_stepped_plain
    else:
        fn, plain = trace_kernel.trace_stepped, trace_kernel.trace_stepped_plain
        scene = trace_kernel.build_kernel_scene(tpt.pack_scene(_scene(sid))).to(
            cuda_device)
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(0).random(
            (48, o.shape[0]), dtype=np.float32)).to(cuda_device)
    for steps in (12, 6) if source == "table" else (12, 5):
        kw = dict(seed=5, pixel_idx=pix, sample_idx=smp, uniforms=uni,
                  steps_per_call=steps)
        before = fn.launches
        k_rad, k_rays = fn(scene, o, d, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + -(-12 // steps)
        p_rad, p_rays = plain(scene, o, d, **kw)
        assert fn.launches == before + -(-12 // steps)  # plain launches nothing
        agree = float(((k_rad - p_rad).abs().sum(dim=1) < 1e-3).float().mean())
        assert agree >= 0.995, agree
        assert abs(int(k_rays) - int(p_rays)) <= 0.005 * int(p_rays)
        e_rad, e_rays = fn(scene, o, d, fmad=False, **kw)
        assert torch.equal(e_rad, p_rad) and torch.equal(e_rays, p_rays)
        assert float(p_rad.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sid", ["cornell", "mesh"])
def test_cuda_preview_launches_its_kernel(cuda_device, sid):
    """The preview on the card runs K5 (cornell) or K6 (mesh) and no other
    trace kernel; step_u8 is quantize_np of the accumulator; 4 frames of 2
    spp match the CPU preview far inside the noise between two seeds."""
    res = Resolution(24, 36)
    counters = (trace_v2.trace_regen, trace_v2.trace_stepped,
                trace_kernel.trace_regen_prim, trace_kernel.trace_stepped,
                portal.trace_cheap_regen, portal.trace_resolve_pool)
    want = trace_v2.trace_stepped if sid == "cornell" else trace_kernel.trace_stepped
    before = [c.launches for c in counters]
    r = ProgressiveRenderer(_scene(sid), res, device=cuda_device)
    for _ in range(3):
        r.step()
    frame = r.step_u8()
    fin = integrator.finalize(r._accum, r.samples_done).cpu().numpy()
    np.testing.assert_array_equal(frame, tonemap.quantize_np(fin))
    for c, b in zip(counters, before):
        assert c.launches - b == (4 if c is want else 0), c.__name__
    cpu = ProgressiveRenderer(_scene(sid), res, device="cpu")
    cpu1 = ProgressiveRenderer(_scene(sid), res, seed=1, device="cpu")
    for _ in range(4):
        a, b = cpu.step().pixels, cpu1.step().pixels
    same = np.abs(fin - a).mean()
    assert same <= 0.25 * np.abs(a - b).mean(), same


def _v1_pool(prep, res, dev):
    """A fresh v1 pool of camera rays, one sample of each pixel, built by
    the v1 cycle's refill (a cycle over an empty pool with K8 and K7 idle)."""
    npix = res.num_pixels
    n = rportal._round_block(npix)
    pool = torch.zeros((portal.V1_PORT_ROWS, n), device=dev)
    pool[portal.ROW_PIX] = -1.0
    accum = torch.zeros((npix, 3), device=dev)
    counts = torch.zeros(npix, device=dev)
    issued = torch.zeros((), dtype=torch.int64, device=dev)
    pool, issued, _, _ = rportal.portal_cycle(
        pool, accum, counts, issued, limit=npix, sample_base=0, pc=prep.portal,
        cam=prep.cam, ks=prep.kscene, seed=3, npix=npix, max_depth=12,
        rr_start_depth=5, F_cap=rportal.RESOLVE_BLOCK)
    assert int(issued) == npix
    return pool


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["counter", "table"])
def test_cuda_v1_kernels_match_plain(cuda_device, source):
    """K8 then K7 over cycles of a mesh v1 pool: the --fmad=false builds
    equal the plain versions bit for bit, the default builds agree on 99.5%
    of the pool's columns; each wrapper launches once a call."""
    res = Resolution(96, 128)
    prep = prepare_render(_scene("mesh"), res, cuda_device)
    pool = _v1_pool(prep, res, cuda_device)
    n = pool.shape[1]
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(0).random(
            (4, n), dtype=np.float32)).to(cuda_device)
    for _ in range(3):
        kw = dict(seed=3, uniforms=uni)
        before = portal.trace_cheap_blocked.launches
        k_pool, k_counts = portal.trace_cheap_blocked(prep.portal, pool, **kw)
        e_pool, e_counts = portal.trace_cheap_blocked(prep.portal, pool,
                                                      fmad=False, **kw)
        p_pool, p_counts = portal.trace_cheap_blocked_plain(prep.portal, pool, **kw)
        torch.cuda.synchronize()
        assert portal.trace_cheap_blocked.launches == before + 2
        assert torch.equal(e_pool, p_pool) and torch.equal(e_counts, p_counts)
        agree = float(((k_pool - p_pool).abs().sum(dim=0) < 1e-3).float().mean())
        assert agree >= 0.995, agree
        rows = [p_pool[a:b] for a, b in ((0, 3), (3, 6), (6, 9), (9, 12),
                                         (12, 13), (13, 14), (14, 15))]
        rkw = dict(pixel_idx=p_pool[portal.ROW_PIX].to(torch.int32),
                   sample_idx=p_pool[portal.V1_ROW_SAMPLE].to(torch.int32),
                   seed=3, uniforms=uni)
        before = trace_kernel.trace_resolve.launches
        k_out = trace_kernel.trace_resolve(prep.kscene, *rows, **rkw)
        e_out = trace_kernel.trace_resolve(prep.kscene, *rows, fmad=False, **rkw)
        p_out = trace_kernel.trace_resolve_plain(prep.kscene, *rows, **rkw)
        torch.cuda.synchronize()
        assert trace_kernel.trace_resolve.launches == before + 2
        assert all(torch.equal(e, p) for e, p in zip(e_out, p_out))
        k_state, p_state = torch.cat(k_out[:7]), torch.cat(p_out[:7])
        agree = float(((k_state - p_state).abs().sum(dim=0) < 1e-3).float().mean())
        assert agree >= 0.995, agree
        pool = p_pool.clone()
        pool[:portal.ROW_PIX] = p_state
    assert float(pool[portal.ROW_ACC:portal.ROW_ACC + 3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sort_every,dir_major", [(1, False), (4, True)])
def test_cuda_k9_equals_k6(cuda_device, sort_every, dir_major):
    """K9 on the card: the K6 kernel in calls of sort_every steps with the
    rays sorted in between gives K6's radiance ray for ray (--fmad=false:
    bit for bit, and equal to the plain version)."""
    res = Resolution(96, 128)
    scene = _scene("mesh")
    ks = trace_kernel.build_kernel_scene(tpt.pack_scene(scene)).to(cuda_device)
    o, d, pix, smp = _preview_rays(scene, res, 2, cuda_device)
    kw = dict(seed=5, pixel_idx=pix, sample_idx=smp)
    before = (trace_kernel.trace_sorted.launches, trace_kernel.trace_stepped.launches)
    s_rad, s_rays = trace_kernel.trace_sorted(ks, o, d, sort_every=sort_every,
                                              dir_major=dir_major, fmad=False, **kw)
    k_rad, k_rays = trace_kernel.trace_stepped(ks, o, d, steps_per_call=sort_every,
                                               fmad=False, **kw)
    torch.cuda.synchronize()
    calls = -(-12 // sort_every)
    assert (trace_kernel.trace_sorted.launches - before[0],
            trace_kernel.trace_stepped.launches - before[1]) == (calls, calls)
    assert torch.equal(s_rad, k_rad) and int(s_rays) == int(k_rays)
    p_rad, _ = trace_kernel.trace_sorted_plain(ks, o, d, sort_every=sort_every,
                                               dir_major=dir_major, **kw)
    assert torch.equal(s_rad, p_rad)


@pytest.mark.cuda
def test_cuda_v1_and_glue_renders_match_cpu(cuda_device, monkeypatch):
    """The v1 route launches K8 and K7 (not K2, K3), the glue route K2 and
    K7 (not K3); both agree with the CPU render of the same seed far inside
    the noise between two seeds, with every sample counted."""
    scene = _scene("mesh")
    cfg = RenderConfig(samples_per_pixel=8, resolution=Resolution(24, 36))
    cpu = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    cpu1 = tpt.render(scene, cfg.with_(seed=1), device="cpu", out_dir=None,
                      verbose=False)
    noise = np.abs(cpu1.image.pixels - cpu.image.pixels).mean()
    counters = (portal.trace_cheap_regen, portal.trace_resolve_pool,
                portal.trace_cheap_blocked, trace_kernel.trace_resolve)
    for route, launched in (("v1", {2, 3}), ("glue", {0, 3})):
        with monkeypatch.context() as m:
            if route == "v1":
                m.setenv("PT_TPU_PORTAL_V1", "1")
            else:
                m.setattr(rportal, "POOL_RESOLVE", False)
            before = [c.launches for c in counters]
            gpu = tpt.render(scene, cfg, device=cuda_device, out_dir=None,
                             verbose=False)
        for i, c in enumerate(counters):
            assert (c.launches > before[i]) == (i in launched), (route, i)
        same = np.abs(gpu.image.pixels - cpu.image.pixels).mean()
        assert same <= 0.25 * noise, (route, same, noise)
        assert gpu.stats.num_samples == cpu.stats.num_samples
