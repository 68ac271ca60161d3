"""K6's redesign and the preview's camera entries: what they rest on.

The kernels (csrc/trace_stepped.cu) run only on a card; tests/test_torch_cuda.py
holds them to their plain versions there. Here, on the CPU:

1. The camera entries' plain versions (``trace_v2.trace_camera_plain`` for
   K5, ``trace_kernel.trace_camera_plain`` for K6) are ``camera_rays``
   followed by the plain trace, bit for bit, and the wrappers on CPU
   tensors are those plain versions; the preview's frames go through them.
2. A trace of permuted rays is the permuted trace (both uniform sources):
   a ray computes the same wherever it runs, which the persistent grid's
   refill and the chunk sort rest on.
3. Chained calls (5 steps, then 7) equal one 12-step call, from the camera
   entry on too.
4. The size rule: a scene whose tables exceed K6_SHARED_BUDGET reads its
   rows from device memory (no compact table handed to the kernel).
5. scripts/k6_coherence.py's model on a small frame counts every ray once,
   traces the camera entry's frame, and gives shares in (0, 1].
6. The camera entry's plain version against the JAX package's preview
   trace (``generate_rays`` and ``trace_pallas`` in interpret mode) on the
   same counter-drawn raygen uniforms and injected shading uniforms.
"""

from tests.test_torch_host import load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops.pallas import trace_kernel as j_tk
from path_tracer_tpu.render import raygen as j_raygen
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as tv2
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render.pipeline import prepare_render
from path_tracer_tpu_torch.render.raygen import (
    camera_arrays, camera_rays, generate_rays, tent_filter,
)
from path_tracer_tpu_torch.utils.config import Resolution
from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "k6_coherence", os.path.join(ROOT, "scripts", "k6_coherence.py"))
COHERENCE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(COHERENCE)

RES = Resolution(12, 18)
MAX_DEPTH = 12
LANE_TOL = 1e-3
LANE_FRAC = 0.995


def _scene(sid):
    return tpt.load_scene(sid, os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))


def _case(sid, res=RES, spp=2):
    """(kernel name, trace_camera, trace_camera_plain, trace_stepped_plain,
    the scene's tables, camera arrays, pixel_idx, sample_idx)."""
    scene = _scene(sid)
    pix, smp = integrator.pass_rays(
        torch.arange(res.num_pixels, dtype=torch.int32), spp)
    packed = tpt.pack_scene(scene)
    if sid == "cornell":
        return ("K5", tv2.trace_camera, tv2.trace_camera_plain,
                tv2.trace_stepped_plain, tv2.build_scene_consts(packed),
                camera_arrays(scene.camera), pix, smp + 6)
    return ("K6", tk.trace_camera, tk.trace_camera_plain,
            tk.trace_stepped_plain, tk.build_kernel_scene(packed),
            camera_arrays(scene.camera), pix, smp + 6)


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
@pytest.mark.parametrize("steps", [12, 5])
def test_camera_entry_plain_is_camera_rays_then_trace(sid, steps):
    _, fn, plain, stepped, scene, cam, pix, smp = _case(sid)
    kw = dict(seed=3, pixel_idx=pix, sample_idx=smp, steps_per_call=steps)
    o, d = camera_rays(cam, pix, smp, seed=3, width=RES.width, height=RES.height)
    want = stepped(scene, o, d, **kw)
    before = tk.trace_stepped.launches + tv2.trace_stepped.launches
    for got in (plain(scene, cam, width=RES.width, height=RES.height, **kw),
                fn(scene, cam, width=RES.width, height=RES.height, **kw)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tk.trace_stepped.launches + tv2.trace_stepped.launches == before
    assert float(want[0].sum()) > 0


def test_generate_rays_divides_by_the_image_size():
    """The divisors became a tensor (on the card torch multiplies by the
    reciprocal of a Python-number divisor); on the CPU the rays are those
    of the division by Python numbers, bit for bit."""
    g = np.random.default_rng(11)
    n, w, h = 4096, 450, 300
    pix = torch.from_numpy(g.integers(0, w * h, n).astype(np.int32))
    smp = torch.from_numpy(g.integers(0, 64, n).astype(np.int32))
    u = torch.from_numpy(g.random((n, 2), dtype=np.float32))
    cam = camera_arrays(_scene("mesh").camera)
    o, d = generate_rays(pix, smp, u, cam, w, h)
    y = (h - 1 - torch.div(pix, w, rounding_mode="floor")).to(torch.float32)
    x = torch.remainder(pix, w).to(torch.float32)
    ysub = torch.remainder(torch.div(smp, 2, rounding_mode="floor"), 2).to(torch.float32)
    xsub = torch.remainder(smp, 2).to(torch.float32)
    sx = (x + 0.5 * (0.5 + xsub + tent_filter(u[:, 0]))) / float(w) - 0.5
    sy = (y + 0.5 * (0.5 + ysub + tent_filter(u[:, 1]))) / float(h) - 0.5
    so, su, sv, lc = (np.asarray(cam[k], np.float32).tolist() for k in (
        "sensor_origin", "su", "sv", "lens_center"))
    dd = [lc[k] - (so[k] + su[k] * sx + sv[k] * sy) for k in range(3)]
    dl = torch.rsqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
    assert torch.equal(d, torch.stack([dd[k] * dl for k in range(3)], dim=1))
    assert torch.equal(o, torch.tensor(lc).expand(n, 3))


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
@pytest.mark.parametrize("source", ["counter", "table"])
def test_permuted_rays_trace_to_the_permuted_result(sid, source):
    _, _, _, stepped, scene, cam, pix, smp = _case(sid)
    o, d = camera_rays(cam, pix, smp, seed=4, width=RES.width, height=RES.height)
    n = o.shape[0]
    g = np.random.default_rng(2)
    uni = None
    if source == "table":
        uni = torch.from_numpy(g.random((MAX_DEPTH * 4, n), dtype=np.float32))
    perm = torch.from_numpy(g.permutation(n))
    kw = dict(seed=4, steps_per_call=4)
    rad, rays = stepped(scene, o, d, pixel_idx=pix, sample_idx=smp,
                        uniforms=uni, **kw)
    prad, prays = stepped(scene, o[perm], d[perm], pixel_idx=pix[perm],
                          sample_idx=smp[perm],
                          uniforms=None if uni is None else uni[:, perm], **kw)
    assert torch.equal(prad, rad[perm]) and int(prays) == int(rays)


def _fresh_state(o, d):
    state = torch.empty((tk.STATE_ROWS, o.shape[0]))
    state[tk.ROW_O:tk.ROW_O + 3] = o.T
    state[tk.ROW_D:tk.ROW_D + 3] = d.T
    state[tk.ROW_THR:tk.ROW_THR + 3] = 1.0
    state[tk.ROW_ACC:tk.ROW_ACC + 3] = 0.0
    state[tk.ROW_ALIVE] = 1.0
    state[tk.ROW_PREV] = -1.0
    return state, torch.zeros(o.shape[0], dtype=torch.int32)


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
def test_chained_calls_equal_one_call(sid):
    """5 steps, then 7 from depth 5, leave the state and counts of one
    12-step call, on the rays the camera entry starts; the camera entry's
    wrapper in calls of 5 steps gives its 12-step result."""
    _, fn, _, _, scene, cam, pix, smp = _case(sid)
    o, d = camera_rays(cam, pix, smp, seed=8, width=RES.width, height=RES.height)
    if sid == "cornell":
        scan = tv2.make_isect(scene)

        def isect(o_, d_, prev, alive):
            out = scan(o_, d_, prev.to(torch.int64), alive)
            return (*out[:6], out[6].to(torch.float32))
    else:
        def isect(o_, d_, prev, alive):
            return tk.isect_full_plain(scene, o_, d_, prev, alive)
    draw = tk.stepped_draw(8, pix, smp, None)

    def run(state, counts, depth0, steps):
        tk.stepped_call_plain(isect, draw, state, counts, depth0=depth0,
                              n_steps=steps, max_depth=MAX_DEPTH,
                              rr_start_depth=5)

    s12, c12 = _fresh_state(o, d)
    run(s12, c12, 0, 12)
    s57, c57 = _fresh_state(o, d)
    run(s57, c57, 0, 5)
    run(s57, c57, 5, 7)
    assert torch.equal(s12, s57) and torch.equal(c12, c57)
    assert int(c12.max()) > 5  # some paths run past the first call
    kw = dict(width=RES.width, height=RES.height, seed=8, pixel_idx=pix,
              sample_idx=smp)
    a, b = fn(scene, cam, steps_per_call=5, **kw), fn(scene, cam, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(b[0], s12[tk.ROW_ACC:tk.ROW_ACC + 3].T)


def _big(ks, copies=4):
    """mesh's tiles ``copies`` times over: a compact table above the budget."""
    tiles = ks.tri[ks.tile_base:]
    return tk.KernelScene(ks.sph, ks.bnd,
                          torch.cat([ks.tri[:ks.tile_base]] + [tiles] * copies),
                          torch.cat([ks.tiles] * copies), ks.tile_base)


def test_size_rule_reads_rows_from_device_memory_above_the_budget():
    ks = tk.build_kernel_scene(tpt.pack_scene(_scene("mesh")))
    # csrc/isect_full.cuh scene_layout: 840 rows of 80 bytes, 8 spheres of
    # 48, no bounding sphere, 13 tile boxes of 24 (312, padded to 320)
    assert tk.k6_table_bytes(ks) == 840 * 80 + 8 * 48 + 0 + 320
    assert tk.k6_shared_table(ks)
    assert tk._prim_scene_args(ks)[6] == ks.hit.data_ptr()
    big = _big(ks)
    assert tk.k6_table_bytes(big) > tk.K6_SHARED_BUDGET
    assert not tk.k6_shared_table(big)
    assert tk._prim_scene_args(big)[6] is None  # GlobalRows
    # the rule changes where rows are read, not what is traced
    pix, smp = integrator.pass_rays(torch.arange(24, dtype=torch.int32), 2)
    cam = camera_arrays(_scene("mesh").camera)
    kw = dict(width=6, height=4, seed=1, pixel_idx=pix, sample_idx=smp)
    a, b = tk.trace_camera(ks, cam, **kw), tk.trace_camera(big, cam, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
def test_preview_frames_go_through_the_camera_entries(sid):
    """A preview frame is render_samples over the cached rays: equal to the
    camera entry's plain version on the same samples, accumulated."""
    scene = _scene(sid)
    r = ProgressiveRenderer(scene, RES, spp_per_frame=2, seed=5, device="cpu")
    r.step()
    r.step()
    _, _, plain, _, tables, cam, pix, smp = _case(sid)
    want = torch.zeros((RES.num_pixels, 3))
    for base in (0, 2):
        rad, _ = plain(tables, cam, width=RES.width, height=RES.height, seed=5,
                       pixel_idx=pix, sample_idx=smp - 6 + base)
        want += rad.reshape(RES.num_pixels, 2, 3).sum(dim=1)
    assert torch.equal(r._accum, want)
    prep = prepare_render(scene, RES, "cpu", regen=False)
    acc = torch.zeros_like(want)
    integrator.render_pass(prep, acc, torch.arange(RES.num_pixels, dtype=torch.int32),
                           seed=5, sample_base=0, quota=2, cam=cam,
                           width=RES.width, height=RES.height)
    first, _ = plain(tables, cam, width=RES.width, height=RES.height, seed=5,
                     pixel_idx=pix, sample_idx=smp - 6)
    assert torch.equal(acc, first.reshape(RES.num_pixels, 2, 3).sum(dim=1))


def test_pass_rays_are_pixel_major_pairs():
    """pass_rays: every pixel of the order ``quota`` times in a row, with
    the samples 0 .. quota-1 (a pass adds its sample base), which the
    preview makes once and the stepped routes otherwise make a pass."""
    perm = torch.tensor([5, 0, 3], dtype=torch.int32)
    pix, smp = integrator.pass_rays(perm, 2)
    assert pix.tolist() == [5, 5, 0, 0, 3, 3]
    assert smp.tolist() == [0, 1, 0, 1, 0, 1]
    assert pix.dtype == smp.dtype == torch.int32


def test_camera_entry_arguments_are_checked():
    _, fn, _, _, scene, cam, pix, smp = _case("mesh")
    kw = dict(seed=0, pixel_idx=pix, sample_idx=smp)
    with pytest.raises(ValueError):
        fn(scene, cam, width=0, height=RES.height, **kw)
    with pytest.raises(ValueError):
        fn(scene, cam, width=RES.width, height=RES.height, seed=0,
           pixel_idx=pix.to(torch.int64), sample_idx=smp)
    with pytest.raises(ValueError):
        fn(scene, cam, width=RES.width, height=RES.height,
           uniforms=torch.zeros((4, pix.shape[0])), **kw)


def test_coherence_model_counts_every_ray_once():
    res = Resolution(16, 24)
    ks, cam, pix, smp = COHERENCE.frame(_scene("mesh"), res, torch.device("cpu"))
    steps, tiles, keys, live, rad = COHERENCE.trace_record(
        ks, cam, pix, smp, res.width, res.height)
    want = tk.trace_camera_plain(ks, cam, width=res.width, height=res.height,
                                 seed=COHERENCE.SEED, pixel_idx=pix, sample_idx=smp)
    assert torch.equal(rad, want[0]) and int(steps.sum()) == int(want[1])
    assert torch.equal(live.sum(dim=0), steps)  # a ray is live at each step it takes
    n = pix.shape[0]
    model = COHERENCE.coherence(ks, steps, tiles, keys, live,
                                resident=n // 3 // 32 * 32, windows=(256,))
    assert model["rays"] == n == sum(model["path_length_histogram_1_to_12"])
    assert model["steps"] == int(steps.sum())
    shares = [model["thread_per_ray"]["lane_share"],
              model["thread_per_ray"]["useful_row_share"],
              model["chunks_of_256_sorted"]["useful_row_share"],
              model["chunks_of_256_packed"]["useful_row_share"]]
    for r in COHERENCE.REFILL_MINS:
        p = model[f"persistent_refill_{r}"]
        shares += [p["lane_share"], p["grid_share"], p["useful_row_share"]]
    assert all(0.0 < x <= 1.0 for x in shares), shares
    assert (model["persistent_refill_1"]["lane_share"]
            >= model["thread_per_ray"]["lane_share"])


def test_k6_camera_entry_plain_matches_pallas(repo_root):
    """The slice against the JAX package: the preview's rays of a mesh frame
    (the JAX generate_rays on the port's counter-drawn raygen uniforms),
    traced by the JAX trace_pallas in interpret mode, against the camera
    entry's plain version, both with injected shading uniforms. The rays
    agree to 2^-22 (XLA's rsqrt, tests/test_torch_preview.py), so paths may
    part: the preview's lane tolerance."""
    from path_tracer_tpu_torch.ops import rng

    js, ts = load_both("mesh", repo_root)
    res = Resolution(16, 32)
    pix, smp = integrator.pass_rays(
        torch.arange(res.num_pixels, dtype=torch.int32), 2)
    key = rng.path_key(2, pix.to(torch.int64), smp.to(torch.int64))
    u = torch.stack([rng.uniform(key, 0, 4), rng.uniform(key, 0, 5)], dim=1)
    jcam = {k: jnp.asarray(v) for k, v in j_raygen.camera_arrays(js.camera).items()}
    jo, jd = j_raygen.generate_rays(jnp.asarray(pix.numpy()), jnp.asarray(smp.numpy()),
                                    jnp.asarray(u.numpy()), jcam, res.width,
                                    res.height)
    n = pix.shape[0]
    U = np.random.default_rng(7).random((MAX_DEPTH * 4, n), dtype=np.float32)
    kb = j_tk.kernel_scene_buffers(jpt.pack_scene(js))
    with pltpu.force_tpu_interpret_mode():
        j_rad, j_rays = j_tk.trace_pallas.__wrapped__(
            jo, jd, kb, 2, block=n, max_depth=MAX_DEPTH,
            steps_per_call=MAX_DEPTH, uniforms=jnp.asarray(U))
    ks = tk.build_kernel_scene(tpt.pack_scene(ts))
    t_rad, t_rays = tk.trace_camera_plain(
        ks, camera_arrays(ts.camera), width=res.width, height=res.height,
        seed=2, pixel_idx=pix, sample_idx=smp, uniforms=torch.from_numpy(U))
    j_rad = np.asarray(j_rad)
    agree = (np.abs(j_rad - t_rad.numpy()).sum(axis=1) < LANE_TOL).mean()
    assert agree >= LANE_FRAC, agree
    assert abs(int(t_rays) - int(float(j_rays))) <= 0.005 * int(t_rays)
    assert float(t_rad.sum()) > 0
