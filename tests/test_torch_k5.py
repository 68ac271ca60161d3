"""K5's redesign: what it rests on, on the CPU.

The kernel (csrc/trace_stepped.cu trace_stepped_static_kernel) runs only on
a card; tests/test_torch_cuda.py holds it to its plain version there. Its
persistent grid hands the frame's rays to lanes from a counter, so a lane
traces whichever rays it takes, in whatever order. Here:

1. The plain model of that schedule (scripts/k5_coherence.py
   ``refill_call``: lanes that take rays from a counter, a warp's reserve
   at a time or one at a time, in the list's order or any other, each ray
   traced one step at a time at its own depth) gives
   ``trace_camera_plain``'s per-ray radiance and counts bit for bit, from
   the camera entry and in chained calls of 5 steps, with both uniform
   sources.
2. The same model on given rays against the JAX package's
   ``trace_pallas_v2`` (interpret mode) under the same injected uniforms.
3. The tables K5 scans and shades from (K1's split table and hit table)
   are byte-equal to the rows they come from, and are what the wrapper
   hands the kernel.
4. The lane model on cornell at 150x100 x 2 spp, seed 0: one thread a ray
   keeps 0.772 of its lane-steps working, computed from the plain counts.
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
from path_tracer_tpu.ops.pallas import trace_v2 as j_tv2
from path_tracer_tpu.render import raygen as j_raygen
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as tv2
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render.raygen import camera_arrays
from path_tracer_tpu_torch.utils.config import Resolution

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "k5_coherence", os.path.join(ROOT, "scripts", "k5_coherence.py"))
COHERENCE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(COHERENCE)

MAX_DEPTH = 12
LANE_TOL = 1e-3
LANE_FRAC = 0.995


def _scene(sid):
    return tpt.load_scene(sid, os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))


def _frame(sid, res, spp=2):
    scene = _scene(sid)
    sc = tv2.build_scene_consts(tpt.pack_scene(scene))
    pix, smp = integrator.pass_rays(
        torch.arange(res.num_pixels, dtype=torch.int32), spp)
    return sc, camera_arrays(scene.camera), pix, smp + 3


def _refill_trace(sc, cam, pix, smp, res, steps, **kw):
    """The camera entry's whole trace, in calls of ``steps``, under the
    model of K5's schedule: (radiance [N, 3], counts [N])."""
    state, counts = COHERENCE.camera_state(cam, pix, smp, seed=4,
                                           width=res.width, height=res.height)
    for depth0 in range(0, MAX_DEPTH, steps):
        COHERENCE.refill_call(sc, state, counts, pix, smp, seed=4,
                              depth0=depth0, n_steps=steps, **kw)
    return state[tk.ROW_ACC:tk.ROW_ACC + 3].T, counts


@pytest.mark.parametrize("sid", ["cornell", "three-spheres"])
@pytest.mark.parametrize("schedule", [
    dict(lanes=256, batch=32), dict(lanes=96, batch=0),
    dict(lanes=160, batch=64, order="reversed"),
    dict(lanes=64, batch=32, order="shuffled"),
])
@pytest.mark.parametrize("source", ["counter", "table"])
def test_refill_model_equals_the_plain_version(sid, schedule, source):
    """Whichever lane takes a ray, and in whatever order the list is
    handed out, each ray's radiance and count are the plain version's:
    lanes fewer than the rays (several rays a lane), reserves of 32 and 64
    and none, the list forward, backward and shuffled; from the camera
    entry in one call and in calls of 5 steps (6 with a table), where the
    later calls meet rays dead on entry."""
    res = Resolution(10, 16)
    sc, cam, pix, smp = _frame(sid, res)
    n = pix.shape[0]
    kw = dict(schedule)
    order = kw.pop("order", None)
    if order == "reversed":
        kw["order"] = torch.arange(n - 1, -1, -1)
    elif order == "shuffled":
        kw["order"] = torch.from_numpy(np.random.default_rng(3).permutation(n))
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(2).random(
            (MAX_DEPTH * 4, n), dtype=np.float32))
    for steps in (12, 6 if uni is not None else 5):
        rad, counts = _refill_trace(sc, cam, pix, smp, res, steps,
                                    uniforms=uni, **kw)
        want_rad, want_rays = tv2.trace_camera_plain(
            sc, cam, width=res.width, height=res.height, seed=4,
            pixel_idx=pix, sample_idx=smp, uniforms=uni, steps_per_call=steps)
        assert torch.equal(rad, want_rad), steps
        assert int(counts.sum()) == int(want_rays)
        assert float(rad.sum()) > 0
    # per-ray counts equal too: one call of 12 steps, plainly
    state, per_ray = COHERENCE.camera_state(cam, pix, smp, seed=4,
                                            width=res.width, height=res.height)
    tk.stepped_call_plain(tv2.stepped_isect(sc),
                          tk.stepped_draw(4, pix, smp, uni), state, per_ray,
                          depth0=0, n_steps=MAX_DEPTH, max_depth=MAX_DEPTH,
                          rr_start_depth=5)
    _, counts = _refill_trace(sc, cam, pix, smp, res, MAX_DEPTH, uniforms=uni,
                              **kw)
    assert torch.equal(counts, per_ray)


def test_refill_model_hands_out_every_ray_once():
    """The schedule's counter: the rays taken past the first wave cover the
    list once, whether the reserve is a warp's 32 or the idle lanes' need,
    and every lane-step counted is a step of some ray."""
    res = Resolution(8, 12)
    sc, cam, pix, smp = _frame("cornell", res)
    n = pix.shape[0]
    for lanes, batch in ((64, 32), (64, 0), (n + 32, 32)):
        state, counts = COHERENCE.camera_state(cam, pix, smp, seed=4,
                                               width=res.width,
                                               height=res.height)
        out = COHERENCE.refill_call(sc, state, counts, pix, smp, seed=4,
                                    depth0=0, n_steps=MAX_DEPTH, lanes=lanes,
                                    batch=batch)
        assert out["lane_steps"] == int(counts.sum())
        assert bool((counts > 0).all())  # every ray was traced
        assert 0.0 < out["lane_share"] <= 1.0
        first = -(-lanes // 32) * 32
        assert out["rays_taken"] >= max(0, n - first)


def test_refill_model_on_given_rays_matches_pallas_v2(repo_root):
    """The slice against the JAX package: the JAX generate_rays' cornell
    rays, traced by the JAX trace_pallas_v2 in interpret mode and by the
    model of K5's schedule (given rays, 96 lanes with reserves of 32), both
    under the same injected uniforms: at least 99.5% of rays within 1e-3
    (XLA's FMAs flip rare branches) and the ray totals within 0.5%."""
    js, ts = load_both("cornell", repo_root)
    g = np.random.default_rng(0)
    w, h = 32, 32
    n = w * h
    cam = {k: jnp.asarray(v)
           for k, v in j_raygen.camera_arrays(js.camera).items()}
    u = g.random((n, 2), dtype=np.float32)
    s = g.integers(0, 64, n).astype(np.int32)
    jo, jd = j_raygen.generate_rays(jnp.arange(n, dtype=jnp.int32),
                                    jnp.asarray(s), jnp.asarray(u), cam, w, h)
    o, d = np.array(jo), np.array(jd)
    U = g.random((MAX_DEPTH * 4, n), dtype=np.float32)
    j_tv2.register_scene("k5-refill", j_tv2.build_scene_consts(jpt.pack_scene(js)))
    with pltpu.force_tpu_interpret_mode():
        j_rad, j_rays = j_tv2.trace_pallas_v2.__wrapped__(
            jnp.asarray(o), jnp.asarray(d), "k5-refill", 3, block=1024,
            max_depth=MAX_DEPTH, steps_per_call=MAX_DEPTH,
            uniforms=jnp.asarray(U))
    sc = tv2.build_scene_consts(tpt.pack_scene(ts))
    state = torch.empty((tk.STATE_ROWS, n), dtype=torch.float32)
    state[tk.ROW_O:tk.ROW_O + 3] = torch.from_numpy(o).T
    state[tk.ROW_D:tk.ROW_D + 3] = torch.from_numpy(d).T
    state[tk.ROW_THR:tk.ROW_THR + 3] = 1.0
    state[tk.ROW_ACC:tk.ROW_ACC + 3] = 0.0
    state[tk.ROW_ALIVE] = 1.0
    state[tk.ROW_PREV] = -1.0
    counts = torch.zeros(n, dtype=torch.int32)
    pix = torch.arange(n, dtype=torch.int32)
    COHERENCE.refill_call(sc, state, counts, pix, torch.from_numpy(s), seed=3,
                          depth0=0, n_steps=MAX_DEPTH, lanes=96, batch=32,
                          uniforms=torch.from_numpy(U))
    t_rad = state[tk.ROW_ACC:tk.ROW_ACC + 3].T.numpy()
    j_rad = np.asarray(j_rad)
    agree = (np.abs(j_rad - t_rad).sum(axis=1) < LANE_TOL).mean()
    assert agree >= LANE_FRAC, agree
    rays = int(counts.sum())
    assert abs(rays - int(float(j_rays))) <= 0.005 * rays
    assert t_rad.sum() > 0


@pytest.mark.parametrize("sid", ["cornell", "three-spheres", "single-sphere",
                                 "cartesian"])
def test_k5_tables_are_the_rows_bytes(sid):
    """K5 scans K1's split table and shades from K1's hit table: each
    column's bytes are the bytes of the row column it comes from (spheres
    first, then triangles and quads, each in packed order), and the
    wrapper hands the kernel these tensors, with the rows' sphere count and
    the reciprocal rule."""
    sc = tv2.build_scene_consts(tpt.pack_scene(_scene(sid)))
    rows = sc.prims.numpy().view(np.uint32)
    split = sc.split.numpy().view(np.uint32)
    hit = sc.hit.numpy().view(np.uint32)
    sphere = sc.prims[:, tv2.COL_KIND].numpy() == tv2.KIND_SPHERE
    order = np.concatenate([np.nonzero(sphere)[0], np.nonzero(~sphere)[0]])
    g = tv2.COL_GEOM
    one = np.float32(1.0).view(np.uint32)
    for i, p in enumerate(order):
        r = rows[p]
        if i < sc.n_sph:
            assert (split[i, tv2.SP_C:tv2.SP_C + 4] == r[g:g + 4]).all()
            assert sc.split[i, tv2.SP_ROW] == p
            assert (hit[p, tv2.H_AUX:tv2.H_AUX + 3] == r[g:g + 3]).all()
        else:
            for col, src in ((tv2.SQ_N, g + 9), (tv2.SQ_E1, g + 3),
                             (tv2.SQ_E2, g + 6), (tv2.SQ_E2XA, g + 15),
                             (tv2.SQ_AXE1, g + 18)):
                assert (split[i, col:col + 3] == r[src:src + 3]).all()
            assert split[i, tv2.SQ_NA] == r[g + 21]
            assert split[i, tv2.SQ_PREVID] == r[tv2.COL_PREVID]
            assert split[i, tv2.SQ_GATE] == r[tv2.COL_GATE]
            assert split[i, tv2.SQ_UW] == (
                one if sc.prims[p, tv2.COL_KIND] != tv2.KIND_QUAD else 0)
            assert sc.split[i, tv2.SQ_ROW] == p
            assert (hit[p, tv2.H_AUX:tv2.H_AUX + 3] == r[g + 12:g + 15]).all()
        for col, src in ((tv2.H_COLOR, tv2.COL_COLOR), (tv2.H_EMIS, tv2.COL_EMIS)):
            assert (hit[p, col:col + 3] == r[src:src + 3]).all()
        assert hit[p, tv2.H_RTYPE] == r[tv2.COL_RTYPE]
        assert hit[p, tv2.H_PREVID] == r[tv2.COL_PREVID]
        assert sc.hit[p, tv2.H_SPHERE] == float(sphere[p])
    assert sc.n_sph == int(sphere.sum())
    args = tv2._stepped_scene_args(sc)
    assert args[0] == sc.split.data_ptr() and args[-1] == sc.hit.data_ptr()
    assert args[1:4] == (sc.prims.shape[0], sc.n_sph, int(sc.rcp_safe))
    assert args[5] == sc.gates.shape[0]
    assert tv2._stepped_tables(sc) == (sc.split, sc.gates, sc.hit)


def test_lane_model_share_on_cornell():
    """One thread a ray on cornell at 150x100 x 2 spp (seed 0): warps of 32
    consecutive rays, each as long as its longest path, keep 0.772 of their
    lane-steps working; refill at 2 rays a lane keeps about as many."""
    res = Resolution(100, 150)
    sc, cam, pix, smp = _frame("cornell", res)
    smp = smp - 3
    state, steps = COHERENCE.camera_state(cam, pix, smp, seed=0,
                                          width=res.width, height=res.height)
    tk.stepped_call_plain(tv2.stepped_isect(sc),
                          tk.stepped_draw(0, pix, smp, None), state, steps,
                          depth0=0, n_steps=MAX_DEPTH, max_depth=MAX_DEPTH,
                          rr_start_depth=5)
    _, rays = tv2.trace_camera_plain(sc, cam, width=res.width,
                                     height=res.height, seed=0, pixel_idx=pix,
                                     sample_idx=smp)
    assert int(steps.sum()) == int(rays)
    s = steps.to(torch.int64)
    warp_max = torch.cat([s, s.new_zeros((-s.numel()) % 32)]).view(-1, 32).amax(dim=1)
    share = int(s.sum()) / (32 * int(warp_max.sum()))
    m = COHERENCE.model(s, resident=pix.shape[0] // 2)
    assert m["thread_per_ray"]["lane_share"] == pytest.approx(share, abs=0)
    assert round(share, 3) == 0.772
    assert int(s.max()) == MAX_DEPTH
    assert m["rays_per_lane"] == 2.0
    refill = m["persistent_refill_1"]["lane_share"]
    assert share <= refill < share + 0.02
