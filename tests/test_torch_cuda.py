"""The CUDA kernels against their plain torch versions, on a card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so that it runs where only the
port is installed; tests/conftest.py imports jax, so on such a machine run
it as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernels: K1 trace_regen (cornell, three-spheres, a gated scene; also on
single-sphere and a scene of 128 primitives, the most a static scene
holds, with K2's SASS held to the commit's before K7's and K8's
redesign), K4 trace_regen_prim (mesh; mesh and the two-mesh scene at
quota 64; past one wave of resident threads; a scene whose table exceeds
its shared-memory budget; its launch configuration; its group level, on
panda_arm against the flat scan's build and the plain version, and its
four counters on one run of tiles and past it, on both row modes; its
warp queries' tile rows read from hit_tiles on the read-only path; its
flat sphere scan on rtiow_final's 488 sphere rows in shared memory), K2 trace_cheap_regen and K3 trace_resolve_pool (mesh;
K2 also at park depths 0-3, on pools wider than one wave of resident
threads and narrower, of a width no multiple of the block, with every slot
stalled at entry, with slots that reach the step budget and on a scene of
128 cheap primitives, the most it takes; K3 also on
pools with every mix of live parts, with none, and on a scene whose table
is too large for shared memory; its group split, where the tiles outnumber
the sort key's 31, on mesh13k's 199 tiles with every mix of live parts,
with lane queries only and tile queries only, on a strip of 70 tiles, and
its group counter),
K5 and K6 trace_stepped (cornell and mesh preview rays), K6's design
variants (the -D choices of csrc/trace_stepped.cu) on a full preview frame,
the camera entries of K5 and K6 (trace_camera) against camera_rays and the
plain trace, K5 on 1, 33 and 4,097 rays, on a 4-spp preview frame and with
rays dead on entry, K6 on a scene whose table exceeds its shared-memory budget,
and the progressive preview on the card; K3 and K6 on a scene of 35 tiles
in a row with rays that enter them all (the sort pad); K7 trace_resolve
(also at both of its routes' shapes and on a scene whose table exceeds
its shared-memory budget), K8 trace_cheap_blocked (also at vote groups of
32 to 1024) and K9 trace_sorted (mesh); K7 and K8 on the lanes of the
deleted v1 and glue routes (scripts/ablate_k7.py builds them).

render() of the benchmark's two meshes (K3 on shared rows and on rows
from device memory) against the benchmark's plain reference, and a
1024x768 cornell render's image, put in pixel order on the card, against
the host gather of its rows.

Whether FMA contraction moves images: K1 at 512 spp, the v2 portal render
of a random portal scene and K5's preview, each against the CPU render of
the same seed, within a quarter of the CPU's noise between two seeds.

The program's spans under a profiler with CUDA activity: host ranges
only, none on the device timeline.

Tolerance of the default build: at least 99.5% of pixels (K2, K3: pool
columns) within |Δ|₁ < 1e-3, channel means within rtol 1e-3 and atol 1e-3,
per-pixel sample counts exactly equal to the quota, segment totals within
0.5%. Reason: nvcc contracts a*b+c into FMAs where torch rounds each
operation, which parts a few long closed-box trajectories. A build with
--fmad=false is held to bit equality.
"""

import dataclasses
import importlib.util
import json
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
from path_tracer_tpu_torch.render.raygen import camera_arrays, camera_rays
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


def ceiling_scene(pkg=tpt, far: bool = False):
    """A scene of exactly 128 primitives, the most the static route takes,
    in ``pkg`` (either package): two triangles of _gated_scene's mesh,
    moved apart so that they form no quad, whose buggy bounding sphere
    gates them, 100 spheres of all three reflect types on a grid, two of
    them lights, and 26 loose triangles that pair with nothing. (A quad
    counts two triangles against the static route's 128, so a scene of 128
    rows has none.) The spheres stay within about 8 units of the camera;
    ``far`` puts the camera 17 units from them, where the rounding of a
    first hit can reach the 1e-4 self-hit epsilon."""
    g = np.random.default_rng(12)
    mat = [pkg.ReflectType.DIFFUSE, pkg.ReflectType.SPECULAR,
           pkg.ReflectType.REFRACT]
    objs = [pkg.SceneObject.from_mesh(
        np.zeros(3, np.float32), pkg.Mesh.from_triangles(np.array(
            [[[4, -10, 0], [10, -10, 0], [4, 2, 0]],
             [[10, -10, 0], [10, 2, 0], [4.5, 2, 0]]], np.float32)),
        pkg.Material(np.full(3, 0.8, np.float32), np.zeros(3),
                     pkg.ReflectType.DIFFUSE))]
    for k in range(100):
        c = np.array([k % 10 - 4.5, k // 10 - 4.5, -0.5 * (k % 3)], np.float32)
        light = k in (33, 66)
        objs.append(pkg.SceneObject.sphere(
            c, 0.4, pkg.Material(
                g.uniform(0.3, 0.95, 3).astype(np.float32),
                np.full(3, 5.0 if light else 0.0, np.float32),
                pkg.ReflectType.DIFFUSE if light else mat[k % 3])))
    tris = g.uniform(-5, 5, (26, 3, 3)).astype(np.float32)
    tris[:, :, 2] = g.uniform(-4, -2, (26, 3))
    objs.append(pkg.SceneObject.from_mesh(
        np.zeros(3, np.float32), pkg.Mesh.from_triangles(tris),
        pkg.Material(np.full(3, 0.7, np.float32), np.zeros(3),
                     pkg.ReflectType.DIFFUSE)))
    return pkg.SceneDescriptor(id="ceiling", objects=objs,
                               camera=pkg.Camera.looking(
                                   [0.0, 0.0, 17.0 if far else 7.0],
                                   [0.0, 0.0, -1.0]))


def huge_scene(pkg=tpt):
    """A triangle 2e15 units across, whose normal's |n.x| + |n.y| + |n.z|
    (4e30) exceeds 2^100, so that K1's split scan keeps CUDA's
    range-checked reciprocal, with a light sphere in view."""
    tri = np.array([[[0.0, 0.0, -5.0], [2e15, 0.0, -5.0],
                     [0.0, 2e15, -5.0]]], np.float32)
    return pkg.SceneDescriptor(id="huge", objects=[
        pkg.SceneObject.from_mesh(
            np.zeros(3, np.float32), pkg.Mesh.from_triangles(tri),
            pkg.Material(np.full(3, 0.8, np.float32), np.zeros(3),
                         pkg.ReflectType.DIFFUSE)),
        pkg.SceneObject.sphere(
            np.array([0.0, 0.0, -2.0], np.float32), 1.0,
            pkg.Material(np.zeros(3), np.full(3, 4.0, np.float32),
                         pkg.ReflectType.DIFFUSE)),
    ], camera=pkg.Camera.looking([1.0, 1.0, 6.0], [0.0, 0.0, -1.0]))


K1_SCENES = {"cornell": lambda: _scene("cornell"),
             "three-spheres": lambda: _scene("three-spheres"),
             "single-sphere": lambda: _scene("single-sphere"),
             "gated": _gated_scene, "ceiling": ceiling_scene,
             "huge": huge_scene}


@pytest.mark.cuda
def test_cuda_k1_bit_exact_on_every_scene(cuda_device):
    """K1 built with --fmad=false equals the plain version bit for bit
    (radiance, segments, samples) on cornell with both uniform sources,
    three-spheres, single-sphere, the gated scene, the 128-primitive scene,
    a scene too large for the unchecked reciprocal and a pixel count that is
    no multiple of the block; the default build keeps 99.5% of pixels
    within 1e-3 and counts exactly the quota."""
    res = Resolution(48, 64)
    cases = [(sid, src) for sid in K1_SCENES for src in ("counter",)]
    cases += [("cornell", "table"), ("cornell", "odd")]
    for sid, source in cases:
        scene_c, cam_c = prepare_scene(K1_SCENES[sid](), res, cuda_device)
        if sid == "ceiling":
            assert scene_c.prims.shape[0] == 128 and scene_c.gates.shape[0] == 1
            assert int((scene_c.prims[:, trace_v2.COL_GATE] >= 0).sum()) == 2
        assert scene_c.rcp_safe == (sid != "huge")
        pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(
            cuda_device)
        if source == "odd":
            pix = pix[:1000]  # 7 blocks of 128 and 104 threads
        uni = None
        if source == "table":
            uni = torch.from_numpy(np.random.default_rng(1).random(
                (6, pix.shape[0]), dtype=np.float32)).to(cuda_device)
        kw = dict(seed=3, sample_base=4, quota=4, max_depth=12, uniforms=uni)
        p = trace_v2.trace_regen_plain(scene_c, cam_c, pix, **kw)
        e = trace_v2.trace_regen(scene_c, cam_c, pix, fmad=False, **kw)
        k = trace_v2.trace_regen(scene_c, cam_c, pix, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(e, p)), (sid, source)
        assert bool((k[2] == 4).all())
        agree = float(((k[0] - p[0]).abs().sum(dim=1) < 1e-3).float().mean())
        assert agree >= 0.995, (sid, source, agree)
        assert float(p[0].sum()) > 0, sid


@pytest.mark.cuda
def test_cuda_k1_config_reports_the_design(cuda_device):
    """regen_config: K1 stages the split table, the gates and the hit table
    into shared memory, runs 128 threads a block and holds 9 blocks an SM
    in 56 registers or fewer."""
    scene_c, _ = prepare_scene(_scene("cornell"), Resolution(24, 32), cuda_device)
    cfg = trace_v2.regen_config(scene_c)
    assert cfg["smem_bytes"] == 11 * (trace_v2.SPLIT_F + trace_v2.HIT_F) * 4
    assert cfg["threads"] == 128 and cfg["min_blocks"] == 9
    assert cfg["blocks_per_sm"] >= 9 and cfg["registers"] <= 56
    big, _ = prepare_scene(ceiling_scene(), Resolution(24, 32), cuda_device)
    assert trace_v2.regen_config(big)["smem_bytes"] == (
        128 * (trace_v2.SPLIT_F + trace_v2.HIT_F) + trace_v2.GATE_F) * 4


@pytest.mark.cuda
def test_cuda_k1_leaves_the_other_kernels_sass(cuda_device):
    """The redesigns of K1, K3, K4, K5, K6, K7 and K8 leave the SASS of
    the kernel that shares common.cuh with K1 and was not redesigned with
    it as it was: K2 (scripts/ablate_k1.py GUARDED), built with and
    without FMA contraction, hashes as in the fixture that
    scripts/ablate_k4.py --fingerprints wrote from the builds of the commit
    before K7's and K8's redesign on this toolkit. K4's group level leaves
    every other kernel that includes csrc/isect_full.cuh as it was too: K3
    (portal_resolve.cu), K5-K7 and K9 (trace_stepped.cu) hash as the
    commit before the level built them (scripts/ablate_k1.py FIXTURE),
    rewritten from this tree's builds when the sphere test took op = c - o
    first (K3, K6, K7 and K9 changed; K2 and K5 did not)."""
    spec = importlib.util.spec_from_file_location(
        "ablate_k1", os.path.join(ROOT, "scripts", "ablate_k1.py"))
    ablate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablate)
    with open(os.path.join(ROOT, "tests", "golden", "gpu",
                           "k1_shared_sass.json")) as fh:
        want = json.load(fh)
    got = ablate.fingerprints(ROOT)
    if got["nvcc"] != want["nvcc"]:
        pytest.skip(f"fixture made with {want['nvcc']}, this is {got['nvcc']}")
    assert got["kernels"] == want["kernels"]


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
def test_cuda_render_puts_its_image_in_pixel_order_on_the_card(cuda_device,
                                                               monkeypatch):
    """A 1024x768 regen render's image is put in pixel order on the card
    before its fetch: bit for bit the host gather of its finalized rows by
    the inverse Morton permutation, with that gather's hash_image."""
    from path_tracer_tpu_torch.utils.hashing import hash_image

    finals = []
    finalize = integrator.finalize

    def kept(*a, **k):
        out = finalize(*a, **k)
        finals.append(out.cpu().numpy())
        return out

    monkeypatch.setattr(integrator, "finalize", kept)
    res = Resolution(768, 1024)
    done = tpt.render(_scene("cornell"),
                      RenderConfig(samples_per_pixel=8, resolution=res),
                      device=cuda_device, out_dir=None, verbose=False)
    assert done.stats.extra["route"] == "regen" and len(finals) == 1
    want = finals[0][morton_pixel_order(res.width, res.height)[1]]
    np.testing.assert_array_equal(done.image.pixels, want)
    assert done.image.hash == hash_image(want)


@pytest.mark.cuda
def test_cuda_spans_stay_off_the_device_timeline(cuda_device):
    """Under a profiler with CUDA activity, a portal render's and a preview
    frame's ``pt.*`` spans are host ranges only: no user annotation and no
    CUDA-side event of the name, so a device trace counts none of them as
    device work. The render's ``num_dispatches`` equals its K2 and K3
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_tpu_torch.utils import profiling

    mesh = _scene("mesh")
    cfg = RenderConfig(samples_per_pixel=16, resolution=Resolution(36, 48))
    tpt.render(mesh, cfg, device=cuda_device, out_dir=None, verbose=False)
    r = ProgressiveRenderer(mesh, Resolution(36, 48), device=cuda_device)
    r.step_u8()
    k2, k3 = portal.trace_cheap_regen.launches, portal.trace_resolve_pool.launches
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        done = tpt.render(mesh, cfg, device=cuda_device, out_dir=None,
                          verbose=False)
        r.move_camera(r.scene.camera)
        r.step_u8()
    names = {s.name for s in profiling.spans()}
    profiling.clear()
    assert {"render", "render.wait", "portal.issue", "portal.wait",
            "preview.move", "preview.frame", "preview.fetch"} <= names
    events = prof.events()
    host = [e for e in events
            if e.name.startswith("pt.") and e.device_type == DeviceType.CPU]
    assert host and not any(e.is_user_annotation for e in host)
    assert not [e.name for e in events if e.name.startswith("pt.")
                and e.device_type == DeviceType.CUDA]
    launches = (portal.trace_cheap_regen.launches - k2
                + portal.trace_resolve_pool.launches - k3)
    assert done.stats.num_dispatches == launches == 2 * done.stats.extra["cycles"]


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


def _k4_case(sid, res, dev):
    spec = importlib.util.spec_from_file_location(
        "k4_coherence", os.path.join(ROOT, "scripts", "k4_coherence.py"))
    coh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(coh)
    scene = coh.two_mesh_scene(tpt, ROOT) if sid == "two-mesh" else _scene(sid)
    prep = prepare_render(scene, res, dev)
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(dev)
    return prep.kscene, prep.cam, pix


@pytest.mark.cuda
@pytest.mark.parametrize("sid", ["mesh", "two-mesh"])
def test_cuda_k4_quota_64_bit_exact(cuda_device, sid):
    """K4 at the quota its render launches (64), on mesh and on the
    two-mesh scene the default router sends it: the --fmad=false build
    equals the plain version bit for bit; the default build counts the
    quota exactly and keeps 99.5% of pixels within 1e-3."""
    ks, cam, pix = _k4_case(sid, Resolution(48, 64), cuda_device)
    assert trace_kernel.k4_shared_table(ks)
    kw = dict(seed=7, sample_base=4, quota=64)
    p_out = trace_kernel.trace_regen_prim_plain(ks, cam, pix, **kw)
    exact = trace_kernel.trace_regen_prim(ks, cam, pix, fmad=False, **kw)
    k_rad, _, k_done = trace_kernel.trace_regen_prim(ks, cam, pix, **kw)
    torch.cuda.synchronize()
    for k, p in zip(exact, p_out):
        assert torch.equal(k, p)
    assert bool((k_done == 64).all())
    assert float(((k_rad - p_out[0]).abs().sum(dim=1) < 1e-3).float().mean()) >= 0.995


@pytest.mark.cuda
def test_cuda_k4_refills_lanes_past_one_wave(cuda_device):
    """More pixels than the card's resident threads (512x384 = 196,608):
    threads that finish their pixel take the next from the counter; every
    pixel still equals the plain version bit for bit (--fmad=false), with
    the injected uniforms too."""
    ks, cam, pix = _k4_case("mesh", Resolution(384, 512), cuda_device)
    cfg = trace_kernel.regen_prim_config(ks)
    assert pix.shape[0] > cfg["blocks_per_sm"] * cfg["sms"] * cfg["threads"]
    uni = torch.from_numpy(np.random.default_rng(1).random(
        (6, pix.shape[0]), dtype=np.float32)).to(cuda_device)
    for u in (None, uni):
        kw = dict(seed=3, sample_base=0, quota=2, uniforms=u)
        p_out = trace_kernel.trace_regen_prim_plain(ks, cam, pix, **kw)
        exact = trace_kernel.trace_regen_prim(ks, cam, pix, fmad=False, **kw)
        torch.cuda.synchronize()
        for k, p in zip(exact, p_out):
            assert torch.equal(k, p)


@pytest.mark.cuda
def test_cuda_k4_config_reports_the_design(cuda_device):
    ks, _, _ = _k4_case("mesh", Resolution(24, 32), cuda_device)
    cfg = trace_kernel.regen_prim_config(ks)
    assert cfg["shared_table"] and cfg["threads"] == 1024
    assert cfg["blocks_per_sm"] >= 1 and cfg["registers"] <= 64
    assert cfg["smem_bytes"] == (trace_kernel.k6_table_bytes(ks)
                                 + cfg["threads"] * (32 + 2))


@pytest.mark.cuda
def test_cuda_k4_large_table_reads_rows_from_device_memory(cuda_device):
    """A scene whose tables exceed K4_SHARED_BUDGET (mesh's tiles four times
    over: 3,336 rows, 267 KB) takes the read-only path, chosen from its
    size, and still equals the plain version; so does quota 0."""
    ks, cam, pix = _k4_case("mesh", Resolution(48, 64), cuda_device)
    tiles = ks.tri[ks.tile_base:]
    big = trace_kernel.KernelScene(
        ks.sph, ks.bnd, torch.cat([ks.tri[:ks.tile_base]] + [tiles] * 4),
        torch.cat([ks.tiles] * 4), ks.tile_base)
    assert not trace_kernel.k4_shared_table(big)
    cfg = trace_kernel.regen_prim_config(big)
    assert not cfg["shared_table"]
    assert cfg["smem_bytes"] == cfg["threads"] * (32 + 2)
    for quota in (4, 0):
        kw = dict(seed=5, sample_base=0, quota=quota)
        p_out = trace_kernel.trace_regen_prim_plain(big, cam, pix, **kw)
        exact = trace_kernel.trace_regen_prim(big, cam, pix, fmad=False, **kw)
        torch.cuda.synchronize()
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


def _k3_pool(dev, res=Resolution(96, 128), cycles=2):
    """(KernelScene, a mesh park-3 pool at K3's input after ``cycles``
    cycles) from the plain versions."""
    prep = prepare_render(_scene("mesh"), res, dev)
    pool = rportal.make_pool_v2(res.num_pixels, rportal._round_block(
        res.num_pixels), 16, park_k=3, device=dev)
    cheap = dict(seed=3, quota=16, sample_base=0, step_cap=64, park_k=3)
    for cyc in range(cycles + 1):
        pool = portal.trace_cheap_regen_plain(prep.portal, prep.cam, pool,
                                              **cheap)[0]
        if cyc < cycles:
            pool = portal.trace_resolve_pool_plain(prep.kscene, pool, seed=3,
                                                   parts=4, park_k=3)[0]
    return prep.kscene, pool


def _live_mask(pool, parts):
    cols, part = portal.live_items(pool, parts=parts, park_k=3)
    mask = torch.zeros(pool.shape[1], dtype=torch.int64, device=pool.device)
    return mask.index_add_(0, cols, 1 << part)


def _k3_equal(ks, pool, kw):
    """K3 --fmad=false equals the plain version bit for bit; the default
    build agrees on 99.5% of columns."""
    plain = portal.trace_resolve_pool_plain(ks, pool, **kw)
    exact = portal.trace_resolve_pool(ks, pool, fmad=False, **kw)
    kern = portal.trace_resolve_pool(ks, pool, **kw)
    torch.cuda.synchronize()
    assert torch.equal(exact[0], plain[0]) and torch.equal(exact[1], plain[1])
    agree = float(((kern[0] - plain[0]).abs().sum(dim=0) < 1e-3).float().mean())
    assert agree >= 0.995, agree
    assert torch.equal(kern[1], plain[1])


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["counter", "table"])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_cuda_k3_every_mix_of_live_parts(cuda_device, source, parts):
    """The packed, sorted K3 on a pool whose columns hold every mix of live
    parts (column i keeps the parts of i mod 16 that are live), of a width
    that is no multiple of the kernel's chunk, under both uniform sources."""
    ks, pool = _k3_pool(cuda_device)
    _k3_every_mix(ks, _mixed(pool), source, parts)


def _mixed(pool):
    """``pool`` cut to a width no multiple of K3's chunk, column i keeping
    the parts of i mod 16 that are live."""
    pool = pool[:, :pool.shape[1] - 100].contiguous()
    want = torch.arange(pool.shape[1], device=pool.device) % 16
    pool[portal.ROW_ALIVE] = torch.where(want & 1 > 0, pool[portal.ROW_ALIVE], 0.0)
    for j in range(1, 4):
        r = portal.buf_row(j - 1, portal.BUF_STATE)
        pool[r] = torch.where((want >> j) & 1 > 0, pool[r], 0.0)
    return pool


def _k3_every_mix(ks, pool, source, parts):
    n = pool.shape[1]
    assert n % portal.resolve_pool_config(ks)["window"]
    assert set(_live_mask(pool, 4).tolist()) == set(range(16))
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(2).random(
            (4, parts * n), dtype=np.float32)).to(pool.device)
    _k3_equal(ks, pool, dict(seed=3, parts=parts, park_k=3, uniforms=uni))


def _k3_13k_pool(dev, res=Resolution(48, 64)):
    """(KernelScene, K3's input pool on cycle 2 of a mesh13k drive: 199
    tiles, past the key's 31) from the plain versions."""
    scene, _ = _bench_scene("mesh13k")
    return _script("k3_coherence").k3_input_pool(scene, res, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["counter", "table"])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_cuda_k3_group_split_every_mix_of_live_parts(cuda_device, source, parts):
    """On mesh13k's kernel scene (199 tiles, rows from device memory) K3
    traces each item whose line enters a tile with a group of lanes and
    the rest one a lane; on a pool whose columns hold every mix of live
    parts, under both uniform sources, it equals the plain version."""
    ks, pool = _k3_13k_pool(cuda_device)
    cfg = portal.resolve_pool_config(ks)
    assert ks.tiles.shape[0] == 199 and not cfg["shared_table"]
    assert cfg["group"] in (4, 8, 16, 32)
    _k3_every_mix(ks, _mixed(pool), source, parts)


def _aim(pool, ks, g, into: bool):
    """Every live item's ray (each part's o, d) set to start beside the
    tiles' box, below it in y, and head into a random tile (``into``) or
    straight down, away from every tile."""
    lo = ks.tiles[:, :3].min(dim=0).values
    hi = ks.tiles[:, 3:].max(dim=0).values
    n = pool.shape[1]
    dev = pool.device
    o = lo[None, :] + (hi - lo)[None, :] * torch.from_numpy(
        g.random((n, 3), dtype=np.float32)).to(dev)
    o[:, 1] = lo[1] - 0.05
    if into:
        c = torch.from_numpy(g.integers(0, ks.tiles.shape[0], n)).to(dev)
        box = ks.tiles[c]
        at = box[:, :3] + (box[:, 3:] - box[:, :3]) * torch.from_numpy(
            g.uniform(0.25, 0.75, (n, 3)).astype(np.float32)).to(dev)
        d = at - o
    else:
        d = torch.from_numpy(g.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)).to(dev)
        d[:, 1] = -1.0
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    for j in range(4):
        b = portal.ROW_O if j == 0 else portal.buf_row(j - 1, portal.BUF_O)
        pool[b:b + 3] = o.T
        pool[b + 3:b + 6] = d.T
    return pool


@pytest.mark.cuda
@pytest.mark.parametrize("into", [False, True])
def test_cuda_k3_group_split_lane_or_tile_queries_only(cuda_device, into):
    """On mesh13k's 199 tiles: a pool none of whose live items' lines
    enters a tile (lane queries only) and one every one of whose does (tile
    queries only) both equal the plain version, and the kernel's group
    counter reads 0 and every live item."""
    ks, pool = _k3_13k_pool(cuda_device)
    pool = _aim(pool, ks, np.random.default_rng(5 + into), into)
    kw = dict(seed=3, parts=4, park_k=3)
    live = portal.live_items(pool, parts=4, park_k=3)[0].numel()
    want = int(portal.group_items_plain(ks, pool, parts=4, park_k=3))
    assert want == (live if into else 0) and live > 1000
    _k3_equal(ks, pool, kw)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    portal.trace_resolve_pool(ks, pool, group_items=counter, **kw)
    assert int(counter) == want


@pytest.mark.cuda
def test_cuda_k3_group_split_on_a_long_strip(cuda_device):
    """The strip scene built past two 32-tile rounds of the group scan (70
    tiles in a row), every other column's active path along the strip, so
    its line enters every tile: K3 (--fmad=false) equals the plain version
    bit for bit, counts included, and its group counter counts every live
    item whose line enters a tile."""
    scenes = _script("portal_fuzz_scenes")
    ks, pool = _script("k3_coherence").k3_input_pool(
        scenes.strip_scene(4480), Resolution(48, 64), cuda_device)
    assert ks.tiles.shape[0] == 70
    g = np.random.default_rng(13)
    cols = torch.arange(0, pool.shape[1], 2, device=cuda_device)
    o, d = (torch.from_numpy(a.T.copy()).to(cuda_device)
            for a in scenes.strip_rays(cols.numel(), g))
    pool[portal.ROW_O:portal.ROW_O + 3, cols] = o
    pool[portal.ROW_D:portal.ROW_D + 3, cols] = d
    pool[portal.ROW_THR:portal.ROW_THR + 3, cols] = 1.0
    pool[portal.ROW_ALIVE, cols] = 1.0
    pool[portal.ROW_PREV, cols] = -1.0
    kw = dict(seed=3, parts=4, park_k=3)
    plain = portal.trace_resolve_pool_plain(ks, pool, **kw)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    exact = portal.trace_resolve_pool(ks, pool, fmad=False, group_items=counter,
                                      **kw)
    torch.cuda.synchronize()
    assert _lost(exact[0], plain[0], 0) == 0
    assert torch.equal(exact[1], plain[1])
    want = int(portal.group_items_plain(ks, pool, parts=4, park_k=3))
    assert int(counter) == want >= cols.numel()


@pytest.mark.cuda
def test_cuda_k3_group_counter_counts_tile_entering_items(cuda_device):
    """One launch's group counter equals the live input items whose line
    enters a tile, by the plain slab test (``_tile_slab``) over the input
    pool, on mesh13k at each number of parts; on mesh (13 tiles, the key
    holds them all) it reads 0."""
    ks, pool = _k3_13k_pool(cuda_device)
    for parts in (1, 4):
        cols, part = portal.live_items(pool, parts=parts, park_k=3)
        base = torch.where(part == 0, portal.ROW_O,
                           portal.buf_row(0) + (part - 1) * portal.BUF_ROWS)
        o = [pool[base + k, cols] for k in range(3)]
        inv = trace_kernel._inv_dir([pool[base + 3 + k, cols] for k in range(3)])
        enters = torch.zeros(cols.numel(), dtype=torch.bool, device=cuda_device)
        for c in range(ks.tiles.shape[0]):
            enters |= trace_kernel._tile_slab(ks.tiles[c], o, inv)[1]
        counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        portal.trace_resolve_pool(ks, pool, seed=3, parts=parts, park_k=3,
                                  group_items=counter)
        assert int(counter) == int(enters.sum()) > 0
        assert int(enters.sum()) < cols.numel()
    ks, pool = _k3_pool(cuda_device)
    assert portal.resolve_pool_config(ks)["group"] == 1
    counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    portal.trace_resolve_pool(ks, pool, seed=3, parts=4, park_k=3,
                              group_items=counter)
    assert int(counter) == 0


@pytest.mark.cuda
def test_cuda_k3_pool_with_no_live_item(cuda_device):
    ks, pool = _k3_pool(cuda_device)
    pool[portal.ROW_ALIVE] = 0.0
    for j in range(3):
        pool[portal.buf_row(j, portal.BUF_STATE)] = 2.0 * (torch.arange(
            pool.shape[1], device=cuda_device) % 2)
    _k3_equal(ks, pool, dict(seed=3, parts=4, park_k=3))


@pytest.mark.cuda
def test_cuda_k3_large_table_reads_rows_from_device_memory(cuda_device):
    """A scene whose compact table does not fit in a block's shared memory
    beside K3's chunk (mesh's 13 tiles three times over: 2,504 rows, 200
    KB) takes the read-only path and still equals the plain version; a
    launch the kernel refuses (a table off its 16-byte alignment) raises."""
    ks, pool = _k3_pool(cuda_device)
    tiles = ks.tri[ks.tile_base:]
    big = trace_kernel.KernelScene(
        ks.sph, ks.bnd, torch.cat([ks.tri[:ks.tile_base]] + [tiles] * 3),
        torch.cat([ks.tiles] * 3), ks.tile_base)
    assert big.hit.numel() * 4 > 200 * 1000
    assert not portal.resolve_pool_config(big)["shared_table"]
    assert portal.resolve_pool_config(ks)["shared_table"]
    _k3_equal(big, pool, dict(seed=3, parts=4, park_k=3))
    shifted = torch.empty(ks.hit.numel() + 1, device=cuda_device)[1:]
    bad = dataclasses.replace(ks, hit=shifted.view_as(ks.hit).copy_(ks.hit))
    before = portal.trace_resolve_pool.launches
    with pytest.raises(RuntimeError, match="trace_resolve_pool"):
        portal.trace_resolve_pool(bad, pool, seed=3, parts=4, park_k=3)
    assert portal.trace_resolve_pool.launches == before


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lost(exact, plain, dim):
    """The rays (pool columns, or rays) whose --fmad=false result is not
    the plain version's."""
    return int((exact != plain).any(dim=dim).sum())


@pytest.mark.cuda
def test_cuda_sort_pad_drops_no_ray_on_a_strip_scene(cuda_device):
    """K3 and K6 sort each chunk's live rays by tile-entry key, padded to a
    power of two; on a scene of 35 tiles in a row (scripts/
    portal_fuzz_scenes.py strip_scene), rays along the strip enter every
    tile, so their keys are the largest a key can be, beside the pad's. No
    such ray may lose its bounce to a pad: K3 on a park-3 pool built as
    tests/test_torch_k3.py builds it, with every other column's active
    path along the strip, and K6 given rays, half of them along the strip
    among the scene's camera rays, equal their plain versions bit for bit
    (--fmad=false), rays and counts included."""
    scenes = _script("portal_fuzz_scenes")
    scene = scenes.strip_scene()
    res = Resolution(48, 64)
    ks, pool = _script("k3_coherence").k3_input_pool(scene, res, cuda_device)
    assert ks.tiles.shape[0] >= 33
    g = np.random.default_rng(12)
    cols = torch.arange(0, pool.shape[1], 2, device=cuda_device)
    o, d = (torch.from_numpy(a.T.copy()).to(cuda_device)
            for a in scenes.strip_rays(cols.numel(), g))
    pool[portal.ROW_O:portal.ROW_O + 3, cols] = o
    pool[portal.ROW_D:portal.ROW_D + 3, cols] = d
    pool[portal.ROW_THR:portal.ROW_THR + 3, cols] = 1.0
    pool[portal.ROW_ALIVE, cols] = 1.0
    pool[portal.ROW_PREV, cols] = -1.0
    kw = dict(seed=3, parts=4, park_k=3)
    plain = portal.trace_resolve_pool_plain(ks, pool, **kw)
    exact = portal.trace_resolve_pool(ks, pool, fmad=False, **kw)
    torch.cuda.synchronize()
    k3_lost = _lost(exact[0], plain[0], 0)
    k3_counts = torch.equal(exact[1], plain[1])

    n = 6000
    cam_o, cam_d, pix, smp = _preview_rays(scene, Resolution(48, 64), 2,
                                           cuda_device)
    pick = torch.from_numpy(g.choice(cam_o.shape[0], n, replace=False)).to(cuda_device)
    o, d = cam_o[pick].clone(), cam_d[pick].clone()
    along = torch.from_numpy(g.random(n) < 0.5).to(cuda_device)
    so, sd = (torch.from_numpy(a).to(cuda_device) for a in scenes.strip_rays(n, g))
    o = torch.where(along[:, None], so, o).contiguous()
    d = torch.where(along[:, None], sd, d).contiguous()
    skw = dict(seed=4, pixel_idx=pix[pick].contiguous(),
               sample_idx=smp[pick].contiguous())
    p = trace_kernel.trace_stepped_plain(ks, o, d, **skw)
    e = trace_kernel.trace_stepped(ks, o, d, fmad=False, **skw)
    torch.cuda.synchronize()
    k6_lost, k6_bounces = _lost(e[0], p[0], 1), int(p[1]) - int(e[1])
    assert (k3_lost, k3_counts, k6_lost, k6_bounces) == (0, True, 0, 0), (
        f"K3: {k3_lost} columns differ, counts equal {k3_counts}; K6: "
        f"{k6_lost} rays' radiance differs, {k6_bounces} bounces lost")


def _k2_pool(dev, park_k, res=Resolution(96, 128), cycles=2, scene=None):
    """(prep, a pool of ``scene`` (mesh) at K2's input after ``cycles``
    cycles of the plain versions at park depth ``park_k``)."""
    prep = prepare_render(scene or _scene("mesh"), res, dev)
    pool = rportal.make_pool_v2(res.num_pixels, rportal._round_block(
        res.num_pixels), 16, park_k=park_k, device=dev)
    cheap = dict(seed=3, quota=16, sample_base=0, step_cap=64, park_k=park_k)
    for _ in range(cycles):
        pool = portal.trace_cheap_regen_plain(prep.portal, prep.cam, pool,
                                              **cheap)[0]
        pool = portal.trace_resolve_pool_plain(prep.kscene, pool, seed=3,
                                               parts=park_k + 1,
                                               park_k=park_k)[0]
    return prep, pool


def _widen(pool, width):
    """The pool's columns tiled or cut to ``width`` (slots are independent,
    so a repeated slot is one more slot)."""
    return pool.repeat(1, -(-width // pool.shape[1]))[:, :width].contiguous()


def _resident(prep, park_k):
    cfg = portal.cheap_regen_config(prep.portal, park_k)
    return cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"]


def _k2_equal(prep, pool, kw, seg_tol=0.005):
    """K2 --fmad=false equals the plain version bit for bit; the default
    build agrees on 99.5% of slots, with processed-segment totals within
    ``seg_tol``; every launch counts once. Returns the plain version's slot
    steps."""
    work: dict = {}
    plain = portal.trace_cheap_regen_plain(prep.portal, prep.cam, pool,
                                           work=work, **kw)
    before = portal.trace_cheap_regen.launches
    exact = portal.trace_cheap_regen(prep.portal, prep.cam, pool, fmad=False,
                                     **kw)
    kern = portal.trace_cheap_regen(prep.portal, prep.cam, pool, **kw)
    torch.cuda.synchronize()
    assert portal.trace_cheap_regen.launches == before + 2
    assert torch.equal(exact[0], plain[0]) and torch.equal(exact[1], plain[1])
    agree = float(((kern[0] - plain[0]).abs().sum(dim=0) < 1e-3).float().mean())
    assert agree >= 0.995, agree
    assert abs(int(kern[1].sum()) - int(plain[1].sum())) <= seg_tol * int(
        plain[1].sum()) + 1
    return work["slot_steps"]


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["counter", "table"])
@pytest.mark.parametrize("park_k", [0, 1, 2, 3])
def test_cuda_k2_park_depths(cuda_device, park_k, source):
    """The persistent K2 at every park depth under both uniform sources, on
    a pool wider than one wave of resident threads, so warps take slots
    from the counter."""
    prep, pool = _k2_pool(cuda_device, park_k)
    width = _resident(prep, park_k) * 3 // 2 + pool.shape[1]
    pool = _widen(pool, width)
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(2).random(
            (6, width), dtype=np.float32)).to(cuda_device)
    steps = _k2_equal(prep, pool, dict(seed=3, quota=16, sample_base=0,
                                       step_cap=64, park_k=park_k,
                                       uniforms=uni))
    assert int(steps.max()) > 1 and int((steps == 1).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "narrow"])
def test_cuda_k2_pool_widths(cuda_device, case):
    """A pool width that is no multiple of the block (and beyond one wave),
    and a pool narrower than one wave: one slot a thread."""
    prep, pool = _k2_pool(cuda_device, 3)
    resident = _resident(prep, 3)
    width = resident * 2 + 77 if case == "ragged" else 1000
    assert (width < resident) == (case == "narrow")
    pool = _widen(pool, width)
    _k2_equal(prep, pool, dict(seed=3, quota=16, sample_base=0, step_cap=64,
                               park_k=3))


@pytest.mark.cuda
def test_cuda_k2_every_slot_stalled_at_entry(cuda_device):
    """No slot can advance at entry (dead, every sample started, no ready
    buffer): each takes no step and only has its scratch cleaned."""
    prep, pool = _k2_pool(cuda_device, 3)
    pool = _widen(pool, _resident(prep, 3) + 4096)
    pool[portal.ROW_ALIVE] = 0.0
    pool[portal.V3_ROW_STARTED] = pool[portal.V2_ROW_QUOTA]
    for j in range(3):
        r = portal.buf_row(j, portal.BUF_STATE)
        pool[r] = torch.where(pool[r] > 1.5, 1.0, pool[r])
    steps = _k2_equal(prep, pool, dict(seed=3, quota=16, sample_base=0,
                                       step_cap=64, park_k=3))
    assert int(steps.sum()) == 0


@pytest.mark.cuda
def test_cuda_k2_slots_reach_the_step_budget(cuda_device):
    """A budget of 8 steps: many slots stop on the budget, not by stalling,
    and keep their live paths and scratch as they are."""
    prep, pool = _k2_pool(cuda_device, 3)
    pool = _widen(pool, _resident(prep, 3) + 4096)
    steps = _k2_equal(prep, pool, dict(seed=3, quota=16, sample_base=0,
                                       step_cap=8, park_k=3))
    assert int((steps == 8).sum()) > pool.shape[1] // 10


@pytest.mark.cuda
def test_cuda_k2_largest_cheap_scene(cuda_device):
    """A random portal scene's heavy mesh with 128 spheres around it: 128
    cheap primitives, the most K2 takes, so its shared memory is largest
    and the occupancy query's grid smallest; the launch goes through and K2
    equals its plain version."""
    spec = importlib.util.spec_from_file_location(
        "portal_fuzz_scenes", os.path.join(ROOT, "scripts",
                                           "portal_fuzz_scenes.py"))
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    base = scenes.fuzz_scene(0)
    g = np.random.default_rng(6)
    lamp = tpt.Material(np.full(3, 0.5, np.float32), np.full(3, 2.0, np.float32),
                        tpt.ReflectType.DIFFUSE)
    scene = dataclasses.replace(base, objects=[base.objects[0]] + [
        tpt.SceneObject.sphere(g.uniform(-6, 6, 3).astype(np.float32), 0.3,
                               lamp) for _ in range(128)])
    prep, pool = _k2_pool(cuda_device, 3, scene=scene)
    assert prep.portal.scene.prims.shape[0] == 128
    pool = _widen(pool, _resident(prep, 3) + 4096)
    # The slots that FMA contraction parts among 128 small lights keep
    # bouncing differently for up to 64 steps, so the default build's
    # segment totals are not held here: only the --fmad=false build's, bit
    # for bit, and the share of agreeing slots
    _k2_equal(prep, pool, dict(seed=3, quota=16, sample_base=0, step_cap=64,
                               park_k=3), seg_tol=1.0)


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


def _bench_scene(config):
    """The program's scene of a benchmark configuration, MeshFile paths
    taken from beside its scene file; and that file's path."""
    path = os.path.join(ROOT, "bench_torch", "configs", config, f"{config}.json")
    with open(path) as fh:
        desc = json.load(fh)
    return tpt.SceneDescriptor.from_json_dict(desc, base_dir=os.path.dirname(path)), path


@pytest.mark.cuda
@pytest.mark.parametrize("config,table", [("mesh", "shared"), ("mesh13k", "global")])
def test_cuda_portal_render_reads_k3_rows_from_its_table(cuda_device, config, table):
    """render() of a benchmark mesh at 450x300 takes the portal route with
    K3 reading its rows from shared memory (mesh, 810 triangles) or from
    device memory (mesh13k, 12,716: its compact table exceeds a block's
    shared memory), and 256 pixels drawn from a seed are within the
    render cell's ``mean_gap`` limit of the benchmark's plain reference
    at the same spp."""
    ref_mod = importlib.util.spec_from_file_location(
        "bench_reference", os.path.join(ROOT, "bench_torch", "reference.py"))
    ref = importlib.util.module_from_spec(ref_mod)
    ref_mod.loader.exec_module(ref)
    with open(os.path.join(ROOT, "bench_torch", "checks",
                           f"{config}.render-450x300-500spp.json")) as fh:
        limit = json.load(fh)["mean_gap"]["limit"]
    scene, path = _bench_scene(config)
    w, h, spp, seed = 450, 300, 8, 2026
    cfg = RenderConfig(samples_per_pixel=spp, resolution=Resolution(h, w), seed=seed)
    before = portal.trace_resolve_pool.launches
    done = tpt.render(scene, cfg, device=cuda_device, out_dir=None, verbose=False)
    extra = done.stats.extra
    assert extra["route"] == "portal" and extra["resolve_table"] == table
    assert portal.trace_resolve_pool.launches - before == extra["cycles"]
    assert 0 < extra["resolve_segments"] < done.stats.num_rays
    pix = np.sort(np.random.default_rng(seed).choice(w * h, 256, replace=False))
    sc = ref.to_device(ref.load_scene(path), cuda_device, torch.float32)
    want = torch.clamp(ref.pixel_sums(
        sc, torch.from_numpy(pix).to(cuda_device), 0, spp, seed=seed, width=w,
        height=h, max_depth=cfg.max_depth, rr_start_depth=cfg.rr_start_depth) / spp,
        0.0, 1.0).cpu().numpy()
    gap = float(np.abs(done.image.pixels[pix].astype(np.float64) - want).mean())
    assert gap <= limit, (gap, limit)


def _k4_counters(ks, cam, pix, **kw):
    """K4 built with --fmad=false and the plain version on the same pixels:
    their outputs and K4's four counters (``trace_kernel.WORK_KEYS``),
    each side's."""
    plain_work = {}
    p_out = trace_kernel.trace_regen_prim_plain(ks, cam, pix, work=plain_work, **kw)
    work = torch.zeros(4, dtype=torch.int64, device=pix.device)
    exact = trace_kernel.trace_regen_prim(ks, cam, pix, fmad=False, work=work, **kw)
    torch.cuda.synchronize()
    return exact, p_out, work.tolist(), [plain_work.get(k, 0) for k in trace_kernel.WORK_KEYS]


@pytest.mark.cuda
def test_cuda_k4_counts_and_matches_plain_on_panda_arm(cuda_device):
    """On the panda_arm configuration's kernel scene (133,768 rows in 2,090
    tiles, 66 runs of 32, read from device memory) at 32x24, quota 2: K4
    built with --fmad=false equals the plain version bit for bit, and its
    four counters (the warp queries, the tiles they tested, the runs of
    tiles they opened and the sphere rows its scans tested) equal the
    plain version's ``work`` counts, adding up over launches, with each
    query opening at least one run and fewer than all 66; the default
    build counts the quota exactly and keeps 99.5% of pixels within
    1e-3."""
    scene, _ = _bench_scene("panda_arm")
    res = Resolution(24, 32)
    prep = prepare_render(scene, res, cuda_device)
    ks = prep.kscene
    assert prep.route == "prim" and ks.tiles.shape[0] == 2090
    assert not trace_kernel.k4_shared_table(ks) and ks.tile_groups.shape == (66, 6)
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(cuda_device)
    kw = dict(seed=9, sample_base=0, quota=2)
    exact, p_out, got, counts = _k4_counters(ks, prep.cam, pix, **kw)
    for k, p in zip(exact, p_out):
        assert torch.equal(k, p)
    assert got == counts and 0 < counts[0] <= counts[1]
    assert counts[0] <= counts[2] < 66 * counts[0]
    work = torch.tensor(got, dtype=torch.int64, device=cuda_device)
    trace_kernel.trace_regen_prim(ks, prep.cam, pix, fmad=False, work=work, **kw)
    assert work.tolist() == [2 * c for c in counts]
    fast = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    k_rad, _, k_done = trace_kernel.trace_regen_prim(ks, prep.cam, pix, work=fast, **kw)
    assert bool((k_done == 2).all())
    assert float(((k_rad - p_out[0]).abs().sum(dim=1) < 1e-3).float().mean()) >= 0.995
    assert min(fast.tolist()) > 0


@pytest.mark.cuda
def test_cuda_k4_warp_queries_read_tile_rows_from_hit_tiles(cuda_device):
    """On the read-only path a warp query reads each tested tile's rows
    from ``KernelScene.hit_tiles``, not from ``tri``: on the panda_arm
    configuration's kernel scene at 32x24, quota 2, with the distance-test
    columns (0-15) of every tiled row of ``tri`` set to NaN once
    ``hit_tiles`` is made, K4 built with --fmad=false still equals the
    plain version on the intact scene bit for bit, its four counters too."""
    scene, _ = _bench_scene("panda_arm")
    res = Resolution(24, 32)
    prep = prepare_render(scene, res, cuda_device)
    ks = prep.kscene
    assert trace_kernel.k4_table(ks, cuda_device) == "global" and ks.tile_base > 0
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(cuda_device)
    kw = dict(seed=9, sample_base=0, quota=2)
    plain_work = {}
    p_out = trace_kernel.trace_regen_prim_plain(ks, prep.cam, pix, work=plain_work, **kw)
    ks.hit_tiles  # made from the intact rows
    ks.tri[ks.tile_base:, :trace_kernel.T_NA + 1] = float("nan")
    work = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    exact = trace_kernel.trace_regen_prim(ks, prep.cam, pix, fmad=False, work=work, **kw)
    torch.cuda.synchronize()
    for k, p in zip(exact, p_out):
        assert torch.equal(k, p)
    want = [plain_work.get(k, 0) for k in trace_kernel.WORK_KEYS]
    assert work.tolist() == want and want[1] > 0


@pytest.mark.cuda
def test_cuda_prim_render_of_panda_arm_reads_rows_from_device_memory(cuda_device):
    """render() of the panda_arm configuration at 450x300 takes the prim
    route with K4 reading its rows from device memory (``prim_table``
    ``global``), reports K4's counters for all of the render's segments,
    and 256 pixels drawn from a seed are within the render cell's
    ``mean_gap`` limit of the benchmark's plain reference at the same
    spp."""
    ref_mod = importlib.util.spec_from_file_location(
        "bench_reference", os.path.join(ROOT, "bench_torch", "reference.py"))
    ref = importlib.util.module_from_spec(ref_mod)
    ref_mod.loader.exec_module(ref)
    with open(os.path.join(ROOT, "bench_torch", "checks",
                           "panda_arm.render-450x300-100spp.json")) as fh:
        limit = json.load(fh)["mean_gap"]["limit"]
    scene, path = _bench_scene("panda_arm")
    w, h, spp, seed = 450, 300, 4, 2027
    cfg = RenderConfig(samples_per_pixel=spp, resolution=Resolution(h, w), seed=seed)
    before = trace_kernel.trace_regen_prim.launches
    done = tpt.render(scene, cfg, device=cuda_device, out_dir=None, verbose=False)
    extra = done.stats.extra
    assert extra["route"] == "prim" and extra["prim_table"] == "global"
    assert trace_kernel.trace_regen_prim.launches - before == done.stats.num_dispatches == 1
    assert extra["prim_segments"] == done.stats.num_rays
    assert 0 < extra["prim_queries"] < extra["prim_segments"]
    assert extra["prim_tiles"] >= extra["prim_queries"]
    pix = np.sort(np.random.default_rng(seed).choice(w * h, 256, replace=False))
    sc = ref.to_device(ref.load_scene(path), cuda_device, torch.float32)
    want = torch.clamp(ref.pixel_sums(
        sc, torch.from_numpy(pix).to(cuda_device), 0, spp, seed=seed, width=w,
        height=h, max_depth=cfg.max_depth, rr_start_depth=cfg.rr_start_depth) / spp,
        0.0, 1.0).cpu().numpy()
    gap = float(np.abs(done.image.pixels[pix].astype(np.float64) - want).mean())
    assert gap <= limit, (gap, limit)


@pytest.mark.cuda
def test_cuda_k4_counts_and_matches_plain_on_rtiow_final(cuda_device):
    """On the rtiow_final configuration's kernel scene (484 spheres in 488
    rows, the ground's quad, no tile, the table in shared memory) at 72x48,
    quota 4: K4 built with --fmad=false equals the plain version bit for
    bit, no segment is a warp query, and the sphere rows its scans tested
    (``work[3]``) equal the plain version's ``work["sph"]``: every row a
    segment, 488 a segment under the flat scan."""
    scene, _ = _bench_scene("rtiow_final")
    res = Resolution(48, 72)
    prep = prepare_render(scene, res, cuda_device)
    ks = prep.kscene
    assert prep.route == "prim" and trace_kernel.k4_table(ks, cuda_device) == "shared"
    assert ks.tiles.shape[0] == 0 and ks.sph.shape[0] == 488 and ks.bnd.shape[0] == 0
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(cuda_device)
    exact, p_out, got, want = _k4_counters(ks, prep.cam, pix, seed=11,
                                           sample_base=0, quota=4)
    for k, p in zip(exact, p_out):
        assert torch.equal(k, p)
    segments = int(p_out[1].sum())
    assert got == want == [0, 0, 0, 488 * segments] and segments > 0


def _k4_fixture():
    """scripts/k4_flat_fixture.py and the fixture it wrote from the builds
    of the commit before K4's group level (the flat tile scan)."""
    spec = importlib.util.spec_from_file_location(
        "k4_flat_fixture", os.path.join(ROOT, "scripts", "k4_flat_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(ROOT, "tests", "golden", "gpu",
                           "k4_flat_parent.json")) as fh:
        want = json.load(fh)
    if mod.nvcc_release() != want["nvcc"]:
        pytest.skip(f"fixture made with {want['nvcc']}, this is {mod.nvcc_release()}")
    return mod, want


@pytest.mark.cuda
def test_cuda_k4_grouped_image_equals_the_flat_build(cuda_device):
    """K4's default build (FMA contraction on) on panda_arm at 200x150, at
    the production quota of 64: radiance, segments and finished samples
    hash as the flat tile scan's build from the commit before the group
    level did on this toolkit (scripts/k4_flat_fixture.py): the same image,
    bit for bit."""
    mod, want = _k4_fixture()
    ks, cam, pix = mod.panda_case(cuda_device)
    shape = want["flat_panda_arm"]
    kw = {k: shape[k] for k in ("seed", "sample_base", "quota")}
    assert (shape["width"], shape["height"], kw["quota"]) == (200, 150, 64)
    assert mod.digests(trace_kernel.trace_regen_prim(ks, cam, pix, **kw)) == shape["sha256"]


def _mesh_tiles(ks, copies: int, extra: int = 0):
    """``ks`` with its tiles ``copies`` times over and then its first
    ``extra`` tiles once more."""
    tiles = ks.tri[ks.tile_base:]
    return trace_kernel.KernelScene(
        ks.sph, ks.bnd,
        torch.cat([ks.tri[:ks.tile_base]] + [tiles] * copies
                  + [tiles[:extra * trace_kernel.TRI_TILE]]),
        torch.cat([ks.tiles] * copies + [ks.tiles[:extra]]), ks.tile_base)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n_tiles,shared", [
    ("mesh", 13, True), ("two-mesh", 26, True), ("mesh 33", 33, True),
    ("mesh 52", 52, False)])
def test_cuda_k4_three_counters_on_each_scan(cuda_device, case, n_tiles, shared):
    """K4 with --fmad=false equals the plain version, image and four
    counters, on both its kernels: one run of tiles on shared rows (mesh,
    the two-mesh scene: at most one run opened a query), and past one run,
    on shared rows (mesh's tiles to 33: two runs, the last of one tile)
    and on rows from device memory (mesh's tiles four times over: 52)."""
    sid = case.split()[0]
    ks, cam, pix = _k4_case(sid, Resolution(48, 64), cuda_device)
    if case == "mesh 33":
        ks = _mesh_tiles(ks, 2, 7)
    elif case == "mesh 52":
        ks = _mesh_tiles(ks, 4)
    assert ks.tiles.shape[0] == n_tiles and trace_kernel.k4_shared_table(ks) == shared
    exact, p_out, got, want = _k4_counters(ks, cam, pix, seed=5,
                                           sample_base=0, quota=4)
    for k, p in zip(exact, p_out):
        assert torch.equal(k, p)
    assert got == want and want[0] > 0
    if n_tiles <= trace_kernel.TILE_GROUP:
        assert 0 < want[2] <= want[0]


def _preview_rays(scene, res, spp, dev):
    """The preview's rays for one frame of ``spp`` samples (render_samples)."""
    npix = res.num_pixels
    pix = torch.arange(npix, dtype=torch.int32, device=dev).repeat_interleave(spp)
    smp = torch.arange(spp, dtype=torch.int32, device=dev).repeat(npix)
    o, d = camera_rays(camera_arrays(scene.camera), pix, smp, seed=0,
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


# K6's build-time design choices (csrc/trace_stepped.cu), each a build
K6_VARIANTS = ["", "K6_SHARED_TABLE=0", "K6_SORT_BY_KEY=0", "K6_GROUP_ORDER=0",
               "K6_SORT=0", "K6_SORT=0,K6_REFILL_MIN=1", "K6_SORT=0,K6_PERSISTENT=0",
               "K6_SORT=0,K6_SHARED_TABLE=0"]


def _k6_frame(dev, res=Resolution(300, 450), spp=2):
    """mesh's KernelScene, camera arrays and one preview frame's pixel and
    sample indices at 450x300 x 2 spp: 270,000 rays, more than one wave of
    K6's persistent grid."""
    scene = _scene("mesh")
    ks = trace_kernel.build_kernel_scene(tpt.pack_scene(scene)).to(dev)
    pix, smp = integrator.pass_rays(
        torch.arange(res.num_pixels, dtype=torch.int32, device=dev), spp)
    return ks, camera_arrays(scene.camera), pix, smp, res


def _agree(k, p):
    return float(((k[0] - p[0]).abs().sum(dim=1) < 1e-3).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("defines", K6_VARIANTS)
def test_cuda_k6_variants_match_plain(cuda_device, defines):
    """Each K6 build on a full mesh preview frame, given rays in calls of 12
    and of 5 steps and from the camera entry: the --fmad=false build equals
    the plain version bit for bit, the default build agrees on 99.5% of
    rays."""
    ks, cam, pix, smp, res = _k6_frame(cuda_device)
    d = tuple(x for x in defines.split(",") if x)
    libs = {f: trace_kernel.stepped_library(f, d) for f in (True, False)}
    o, dirs = camera_rays(cam, pix, smp, seed=0, width=res.width,
                          height=res.height)
    kw = dict(seed=5, pixel_idx=pix, sample_idx=smp)
    for steps in (12, 5):
        p = trace_kernel.trace_stepped_plain(ks, o, dirs, steps_per_call=steps, **kw)
        e = trace_kernel.trace_stepped(ks, o, dirs, steps_per_call=steps,
                                       library=libs[False], **kw)
        k = trace_kernel.trace_stepped(ks, o, dirs, steps_per_call=steps,
                                       library=libs[True], **kw)
        torch.cuda.synchronize()
        assert torch.equal(e[0], p[0]) and torch.equal(e[1], p[1]), steps
        assert _agree(k, p) >= 0.995
    ckw = dict(kw, width=res.width, height=res.height)
    p = trace_kernel.trace_camera_plain(ks, cam, **ckw)
    e = trace_kernel.trace_camera(ks, cam, library=libs[False], **ckw)
    torch.cuda.synchronize()
    assert torch.equal(e[0], p[0]) and torch.equal(e[1], p[1])
    assert _agree(trace_kernel.trace_camera(ks, cam, library=libs[True], **ckw),
                  p) >= 0.995


@pytest.mark.cuda
@pytest.mark.parametrize("sid", ["cornell", "mesh"])
@pytest.mark.parametrize("source", ["counter", "table"])
def test_cuda_camera_entries_match_camera_rays(cuda_device, sid, source):
    """K5's (cornell) and K6's (mesh) camera entries on a preview frame, in
    calls of 12 steps and of 5 (6 with a table: it must divide 12): the
    --fmad=false build equals camera_rays followed by the plain trace bit
    for bit, the default build agrees on 99.5% of rays; one launch a call."""
    res = Resolution(96, 128)
    scene = _scene(sid)
    prep = prepare_render(scene, res, cuda_device, regen=False)
    if sid == "cornell":
        fn, plain, tables = trace_v2.trace_camera, trace_v2.trace_camera_plain, prep.scene
        counter = trace_v2.trace_stepped
    else:
        fn, plain, tables = (trace_kernel.trace_camera,
                             trace_kernel.trace_camera_plain, prep.kscene)
        counter = trace_kernel.trace_stepped
    pix, smp = integrator.pass_rays(
        torch.arange(res.num_pixels, dtype=torch.int32, device=cuda_device), 2)
    smp = smp + 4
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(1).random(
            (48, pix.shape[0]), dtype=np.float32)).to(cuda_device)
    cam = camera_arrays(scene.camera)
    for steps in (12, 6) if source == "table" else (12, 5):
        kw = dict(width=res.width, height=res.height, seed=9, pixel_idx=pix,
                  sample_idx=smp, uniforms=uni, steps_per_call=steps)
        before = counter.launches
        k = fn(tables, cam, **kw)
        torch.cuda.synchronize()
        assert counter.launches == before + -(-12 // steps)
        p = plain(tables, cam, **kw)  # camera_rays, then the plain trace
        assert _agree(k, p) >= 0.995
        e = fn(tables, cam, fmad=False, **kw)
        assert torch.equal(e[0], p[0]) and torch.equal(e[1], p[1])
        assert float(p[0].sum()) > 0


def _k5_frame(dev, res, spp):
    """cornell's SceneConsts, camera arrays and one preview frame's pixel
    and sample indices at ``res`` x ``spp``."""
    scene = _scene("cornell")
    sc = trace_v2.build_scene_consts(tpt.pack_scene(scene)).to(dev)
    pix, smp = integrator.pass_rays(
        torch.arange(res.num_pixels, dtype=torch.int32, device=dev), spp)
    return sc, camera_arrays(scene.camera), pix, smp


def _k5_cases(sc, cam, pix, smp, res, source, exact_only=False):
    """K5 from the camera entry and on given rays, in calls of 12 steps and
    of 5 (6 with a table): the --fmad=false build equals the plain version
    bit for bit, the default build agrees on 99.5% of rays (unless
    ``exact_only``: too few rays for a share); one launch a call."""
    n = pix.shape[0]
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(4).random(
            (48, n), dtype=np.float32)).to(pix.device)
    o, d = camera_rays(cam, pix, smp, seed=0, width=res.width,
                       height=res.height)
    for steps in (12, 6) if uni is not None else (12, 5):
        kw = dict(seed=3, pixel_idx=pix, sample_idx=smp, uniforms=uni,
                  steps_per_call=steps)
        ckw = dict(kw, width=res.width, height=res.height)
        for fn, plain, args in (
                (trace_v2.trace_camera, trace_v2.trace_camera_plain, (sc, cam)),
                (trace_v2.trace_stepped, trace_v2.trace_stepped_plain,
                 (sc, o, d))):
            fkw = ckw if fn is trace_v2.trace_camera else kw
            before = trace_v2.trace_stepped.launches
            k = fn(*args, **fkw)
            torch.cuda.synchronize()
            assert trace_v2.trace_stepped.launches == before + -(-12 // steps)
            p = plain(*args, **fkw)
            e = fn(*args, fmad=False, **fkw)
            assert torch.equal(e[0], p[0]) and torch.equal(e[1], p[1]), (
                fn.__name__, steps)
            assert bool(torch.isfinite(k[0]).all())
            if not exact_only:
                assert _agree(k, p) >= 0.995
                assert abs(int(k[1]) - int(p[1])) <= 0.005 * int(p[1])


@pytest.mark.cuda
def test_cuda_k5_config_reports_the_design(cuda_device):
    """K5's launch configuration: blocks of 256 threads, 4 resident an SM
    asked of ptxas and granted (64 registers at most), no spills; the
    split and hit tables and the gates in shared memory."""
    sc, _, _, _ = _k5_frame(cuda_device, Resolution(12, 18), 1)
    for camera in (True, False):
        cfg = trace_v2.stepped_static_config(sc, camera=camera)
        assert cfg["threads"] == 256 and cfg["min_blocks"] == 4
        assert cfg["blocks_per_sm"] >= 4 and cfg["registers"] <= 64
        assert cfg["local_bytes"] == 0
        assert cfg["smem_bytes"] == 4 * (
            sc.prims.shape[0] * (trace_v2.SPLIT_F + trace_v2.HIT_F)
            + sc.gates.shape[0] * trace_v2.GATE_F)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 4097])
@pytest.mark.parametrize("source", ["counter", "table"])
def test_cuda_k5_ray_counts(cuda_device, n, source):
    """K5 on 1, 33 and 4,097 rays: far fewer than the card's resident
    lanes, and no multiple of a block or a warp."""
    res = Resolution(300, 450)
    sc, cam, pix, smp = _k5_frame(cuda_device, res, 2)
    pick = torch.from_numpy(np.random.default_rng(n).choice(
        pix.shape[0], n, replace=False)).to(cuda_device)
    _k5_cases(sc, cam, pix[pick].contiguous(), smp[pick].contiguous(), res,
              source, exact_only=n < 4097)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["counter", "table"])
def test_cuda_k5_four_spp_frame(cuda_device, source):
    """K5 on a 450x300 x 4 spp preview frame (540,000 rays: more than one
    wave of the card's resident threads)."""
    res = Resolution(300, 450)
    _k5_cases(*_k5_frame(cuda_device, res, 4), res, source)


@pytest.mark.cuda
@pytest.mark.parametrize("fmad", [False, True])
def test_cuda_k5_leaves_dead_rays_unwritten(cuda_device, fmad):
    """A ray dead on entry is not traced and not written: every third ray
    of a given-ray call is dead, its state rows and count hold sentinels,
    and after one launch of 12 steps (and one of 5 from depth 5) they are
    bit for bit as they were; the live rays equal the plain call's (bit for
    bit without FMA contraction, on 99.5% of rays with it)."""
    res = Resolution(60, 90)
    sc, cam, pix, smp = _k5_frame(cuda_device, res, 2)
    n = pix.shape[0]
    o, d = camera_rays(cam, pix, smp, seed=0, width=res.width,
                       height=res.height)
    state = torch.empty((trace_kernel.STATE_ROWS, n), device=cuda_device)
    state[0:3], state[3:6] = o.T, d.T
    state[6:9], state[9:12] = 1.0, 0.0
    state[trace_kernel.ROW_ALIVE] = 1.0
    state[trace_kernel.ROW_PREV] = -1.0
    dead = torch.arange(n, device=cuda_device) % 3 == 1
    state[:, dead] = 123.0
    state[trace_kernel.ROW_ALIVE, dead] = 0.0
    counts = torch.where(dead, 77, 2).to(torch.int32)
    launch = trace_kernel.stepped_launcher(
        "trace_stepped (K5)", "pt_trace_stepped_static",
        trace_v2._stepped_scene_args(sc), seed=3, max_depth=12,
        rr_start_depth=5, fmad=fmad, counter=trace_v2.trace_stepped)
    draw = trace_kernel.stepped_draw(3, pix, smp, None)
    isect = trace_v2.stepped_isect(sc)
    for depth0, steps in ((0, 12), (5, 5)):
        k_state, k_counts = state.clone(), counts.clone()
        launch(k_state, k_counts, depth0, steps, pix, smp, None)
        p_state, p_counts = state.clone(), counts.clone()
        trace_kernel.stepped_call_plain(isect, draw, p_state, p_counts,
                                        depth0=depth0, n_steps=steps,
                                        max_depth=12, rr_start_depth=5)
        torch.cuda.synchronize()
        assert torch.equal(k_state[:, dead], state[:, dead])
        assert torch.equal(k_counts[dead], counts[dead])
        assert torch.equal(k_counts, p_counts) or fmad
        live = ~dead
        if fmad:
            acc = trace_kernel.ROW_ACC
            agree = ((k_state[acc:acc + 3, live] - p_state[acc:acc + 3, live])
                     .abs().sum(dim=0) < 1e-3).float().mean()
            assert float(agree) >= 0.995
        else:
            assert torch.equal(k_state[:, live], p_state[:, live])


@pytest.mark.cuda
def test_cuda_fma_k1_512_spp_image(cuda_device):
    """Does FMA contraction move K1's image at the production quota? cornell
    at 16x16 and 512 spp (two K1 passes at quota 256) on the card against
    the CPU render of the same seed: mean |card - CPU| at most a quarter of
    the CPU's noise between seeds 0 and 1, the sample counts exact."""
    scene = _scene("cornell")
    cfg = RenderConfig(samples_per_pixel=512, resolution=Resolution(16, 16))
    before = trace_v2.trace_regen.launches
    gpu = tpt.render(scene, cfg, device=cuda_device, out_dir=None, verbose=False)
    assert trace_v2.trace_regen.launches - before == 2
    cpu = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    cpu1 = tpt.render(scene, cfg.with_(seed=1), device="cpu", out_dir=None,
                      verbose=False)
    same = np.abs(gpu.image.pixels - cpu.image.pixels).mean()
    noise = np.abs(cpu1.image.pixels - cpu.image.pixels).mean()
    print(f"K1 512 spp: mean |card - CPU| {same:.3g}, CPU noise {noise:.3g}")
    assert same <= 0.25 * noise, (same, noise)
    assert gpu.stats.num_samples == cpu.stats.num_samples == 512 * 256


@pytest.mark.cuda
def test_cuda_fma_portal_v2_image(cuda_device):
    """Does FMA contraction move the v2 portal render's image? The random
    portal scene of chip_smoke.py phase 3 (scripts/portal_fuzz_scenes.py
    fuzz_scene(3), glass and mirror spheres) at 18x12 and 32 spp on the
    card against the CPU render of the same seed: mean |card - CPU| at most
    a quarter of the CPU's noise between seeds 0 and 1, the sample counts
    exact."""
    scene = _script("portal_fuzz_scenes").fuzz_scene(3)
    cfg = RenderConfig(samples_per_pixel=32, resolution=Resolution(12, 18))
    before = portal.trace_cheap_regen.launches
    gpu = tpt.render(scene, cfg, device=cuda_device, out_dir=None, verbose=False)
    assert portal.trace_cheap_regen.launches > before
    assert gpu.stats.extra["route"] == "portal"
    cpu = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    cpu1 = tpt.render(scene, cfg.with_(seed=1), device="cpu", out_dir=None,
                      verbose=False)
    same = np.abs(gpu.image.pixels - cpu.image.pixels).mean()
    noise = np.abs(cpu1.image.pixels - cpu.image.pixels).mean()
    print(f"v2 portal: mean |card - CPU| {same:.3g}, CPU noise {noise:.3g}")
    assert same <= 0.25 * noise, (same, noise)
    assert gpu.stats.num_samples == cpu.stats.num_samples == 32 * 216


@pytest.mark.cuda
def test_cuda_fma_k5_preview_image(cuda_device):
    """Does FMA contraction move K5's preview? Eight frames of 2 spp on
    cornell at 90x60 on the card against the CPU preview of the same seed:
    mean |card - CPU| at most a quarter of the CPU's noise between seeds 0
    and 1, the samples exact."""
    res = Resolution(60, 90)
    gpu = ProgressiveRenderer(_scene("cornell"), res, device=cuda_device)
    cpu = ProgressiveRenderer(_scene("cornell"), res, device="cpu")
    cpu1 = ProgressiveRenderer(_scene("cornell"), res, seed=1, device="cpu")
    before = trace_v2.trace_stepped.launches
    for _ in range(8):
        g, a, b = gpu.step().pixels, cpu.step().pixels, cpu1.step().pixels
    assert trace_v2.trace_stepped.launches - before == 8
    same, noise = np.abs(g - a).mean(), np.abs(a - b).mean()
    print(f"K5 preview: mean |card - CPU| {same:.3g}, CPU noise {noise:.3g}")
    assert same <= 0.25 * noise, (same, noise)
    assert gpu.samples_done == cpu.samples_done == 16


@pytest.mark.cuda
def test_cuda_k6_large_table_reads_rows_from_device_memory(cuda_device):
    """A scene whose tables exceed K6_SHARED_BUDGET (mesh's tiles four times
    over: 3,336 rows, 267 KB) takes the read-only path, chosen from its size,
    and still equals the plain version; the preview renders it through the
    same path."""
    ks, cam, pix, smp, res = _k6_frame(cuda_device, Resolution(96, 128))
    tiles = ks.tri[ks.tile_base:]
    big = trace_kernel.KernelScene(
        ks.sph, ks.bnd, torch.cat([ks.tri[:ks.tile_base]] + [tiles] * 4),
        torch.cat([ks.tiles] * 4), ks.tile_base)
    assert trace_kernel.k6_table_bytes(big) > trace_kernel.K6_SHARED_BUDGET
    cfg = trace_kernel.stepped_prim_config(big, camera=True)
    assert not cfg["shared_table"] and cfg["smem_bytes"] == 0
    assert trace_kernel.stepped_prim_config(ks)["shared_table"]
    kw = dict(width=res.width, height=res.height, seed=2, pixel_idx=pix,
              sample_idx=smp)
    p = trace_kernel.trace_camera_plain(big, cam, **kw)
    e = trace_kernel.trace_camera(big, cam, fmad=False, **kw)
    assert torch.equal(e[0], p[0]) and torch.equal(e[1], p[1])
    prep = prepare_render(_scene("mesh"), res, cuda_device, regen=False)
    prep_big = dataclasses.replace(prep, kscene=big)
    acc = torch.zeros((res.num_pixels, 3), device=cuda_device)
    before = trace_kernel.trace_stepped.launches
    integrator.render_pass(prep_big, acc, pix[::2].contiguous(), seed=2,
                           sample_base=0, quota=2, cam=cam, width=res.width,
                           height=res.height)
    torch.cuda.synchronize()
    assert trace_kernel.trace_stepped.launches == before + 1
    want = trace_kernel.trace_camera_plain(big, cam, **kw)[0]
    assert float(((acc - want.reshape(-1, 2, 3).sum(dim=1)).abs().sum(dim=1)
                  < 1e-3).float().mean()) >= 0.995


def _v1_pool(prep, res, dev):
    """A fresh v1 pool of camera rays, one sample of each pixel
    (scripts/ablate_k7.py v1_pool)."""
    npix = res.num_pixels
    return _script("ablate_k7").v1_pool(prep, npix, rportal._round_block(npix),
                                        limit=npix, seed=3)


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


def _k7_equal(ks, lanes, uni):
    """K7 on ``lanes`` (state, pixel_idx, sample_idx): --fmad=false equals
    the plain version bit for bit, the default build agrees on 99.5% of
    lanes with the counts equal; one launch a call."""
    state, pix, smp = lanes
    kw = dict(pixel_idx=pix, sample_idx=smp, seed=3, uniforms=uni)
    before = trace_kernel.trace_resolve.launches
    k = trace_kernel.trace_resolve(ks, *state, **kw)
    e = trace_kernel.trace_resolve(ks, *state, fmad=False, **kw)
    p = trace_kernel.trace_resolve_plain(ks, *state, **kw)
    torch.cuda.synchronize()
    assert trace_kernel.trace_resolve.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(e, p))
    ks_, ps_ = torch.cat(k[:7]), torch.cat(p[:7])
    assert float(((ks_ - ps_).abs().sum(dim=0) < 1e-3).float().mean()) >= 0.995
    assert torch.equal(k[7], p[7]) and int(p[7].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["v1 front", "glue"])
@pytest.mark.parametrize("source", ["counter", "table"])
def test_cuda_k7_both_shapes_match_plain(cuda_device, shape, source):
    """K7 at analogues of its two routes' shapes at 128x96
    (scripts/ablate_k7.py k7_shapes): the v1 front, its live lanes first,
    and the glue lanes of a park-3 pool, more than one wave of its blocks."""
    prep, _, lanes, _ = _script("ablate_k7").k7_shapes(
        _scene("mesh"), Resolution(96, 128), cuda_device)
    assert trace_kernel.resolve_config(prep.kscene)["shared_table"]
    n = lanes[shape][1].shape[0]
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(5).random(
            (4, n), dtype=np.float32)).to(cuda_device)
    _k7_equal(prep.kscene, lanes[shape], uni)


@pytest.mark.cuda
def test_cuda_k7_large_table_reads_rows_from_device_memory(cuda_device):
    """A scene whose tables exceed K7_SHARED_BUDGET (mesh's tiles three
    times over: 2,504 rows, 200 KB) takes the read-only path, chosen from
    its size, and still equals the plain version; a compact table off its
    16-byte alignment is refused and launches nothing."""
    prep, _, lanes, _ = _script("ablate_k7").k7_shapes(
        _scene("mesh"), Resolution(96, 128), cuda_device)
    ks = prep.kscene
    tiles = ks.tri[ks.tile_base:]
    big = trace_kernel.KernelScene(
        ks.sph, ks.bnd, torch.cat([ks.tri[:ks.tile_base]] + [tiles] * 3),
        torch.cat([ks.tiles] * 3), ks.tile_base)
    cfg = trace_kernel.resolve_config(big)
    assert not cfg["shared_table"] and cfg["smem_bytes"] < 48 * 1024
    _k7_equal(big, lanes["glue"], None)
    shifted = torch.empty(ks.hit.numel() + 1, device=cuda_device)[1:]
    bad = dataclasses.replace(ks, hit=shifted.view_as(ks.hit).copy_(ks.hit))
    state, pix, smp = lanes["glue"]
    before = trace_kernel.trace_resolve.launches
    with pytest.raises(RuntimeError, match="trace_resolve"):
        trace_kernel.trace_resolve(bad, *state, pixel_idx=pix, sample_idx=smp,
                                   seed=3)
    assert trace_kernel.trace_resolve.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("group", [32, 64, 128, 1024])
def test_cuda_k8_groups_match_plain(cuda_device, group):
    """K8 on a fresh mesh v1 pool at the port's group (32, a warp's vote)
    and at groups of 64, 128 and 1024 (a block's vote): the --fmad=false
    build equals the plain version at that group bit for bit, the default
    build agrees on 99.5% of columns with segment totals within 0.5%."""
    res = Resolution(96, 128)
    prep = prepare_render(_scene("mesh"), res, cuda_device)
    pool = _v1_pool(prep, res, cuda_device)
    kw = dict(seed=4, group=group)
    k = portal.trace_cheap_blocked(prep.portal, pool, **kw)
    e = portal.trace_cheap_blocked(prep.portal, pool, fmad=False, **kw)
    p = portal.trace_cheap_blocked_plain(prep.portal, pool, **kw)
    torch.cuda.synchronize()
    assert torch.equal(e[0], p[0]) and torch.equal(e[1], p[1])
    assert float(((k[0] - p[0]).abs().sum(dim=0) < 1e-3).float().mean()) >= 0.995
    segs, want = int(k[1].sum()), int(p[1].sum())
    assert abs(segs - want) <= 0.005 * want and want > 0


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
