"""The CUDA kernel against its plain torch version, on a card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so that it runs where only the
port is installed; tests/conftest.py imports jax, so on such a machine run
it as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance of the default build: at least 99.5% of pixels within
|Δ|₁ < 1e-3, channel means within rtol 1e-3 and atol 1e-3, per-pixel sample
counts exactly equal to the quota, segment totals within 0.5%. Reason: nvcc
contracts a*b+c into FMAs where torch rounds each operation, which parts a
few long closed-box trajectories. A build with --fmad=false is held to bit
equality.
"""

import os

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch.ops.kernels import trace_v2
from path_tracer_tpu_torch.render.pipeline import morton_pixel_order, prepare_scene
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution

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
