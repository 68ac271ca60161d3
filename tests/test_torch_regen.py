"""The whole regenerative loop: the kernel's plain torch version against the
JAX package's own loop and its Pallas kernel.

1. ``trace_kernel.regen_loop`` run under JAX on the CPU (no Pallas), with
   ``isect`` built as ``_make_kernel_v3`` builds it and the injected
   per-lane table, against ``trace_regen_plain`` with the same table.
2. The Pallas kernel itself, ``trace_pallas_regen`` in interpret mode,
   whose PRNG stub returns zeros, against the plain version given a table
   of zeros.
3. Semantics of the loop that hold on the port alone: the wall-quad
   collapse, the one-segment depth bound and the 2x2 subpixel schedule.
The pieces of the loop are in test_torch_trace.py; the CUDA kernel against
its plain version is in test_torch_cuda.py.

Tolerance for whole paths (as tests/test_pallas.py:50-52): at least 99.5%
of lanes within |Δ|₁ < 1e-3, channel means within rtol 1e-3 and atol 1e-3,
per-lane sample counts exactly equal to the quota, segment totals within
0.5%. Reason: XLA-CPU and torch-CPU ``sqrt``, ``rsqrt``, ``sin`` and ``cos``
differ by ulps (and XLA contracts a*b+c into FMAs inside jit), which flips
rare Russian-roulette and tie branches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops.pallas import trace_kernel as j_tk
from path_tracer_tpu.ops.pallas import trace_v2 as j_tv2
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from tests.test_torch_trace import _consts, _np

LANE_TOL = 1e-3
LANE_FRAC = 0.995


def _jax_regen(prims, bnd, cam, U, quota, max_depth):
    """regen_loop with isect built exactly as _make_kernel_v3 builds it."""
    scan = j_tv2.make_prim_scan(prims, bnd)

    def isect(o, d, prev, alive):
        tmin, h_color, h_emis, h_aux, h_rtype, h_sph, h_prev = scan(o, d, prev)
        found = (tmin < j_tv2.BIG) & alive
        point = [o[k] + d[k] * tmin for k in range(3)]
        sn = [point[k] - h_aux[k] for k in range(3)]
        sl = jax.lax.rsqrt(
            jnp.maximum(sn[0] ** 2 + sn[1] ** 2 + sn[2] ** 2, 1e-30))
        nrm = [jnp.where(h_sph > 0.5, sn[k] * sl, h_aux[k]) for k in range(3)]
        new_prev = jnp.where(found, h_prev, -1.0)
        return found, point, nrm, h_color, h_emis, h_rtype, new_prev

    Uj = [jnp.asarray(U[k]) for k in range(U.shape[0])]
    n = U.shape[1]
    acc, counts = j_tk.regen_loop(
        jnp.float32(0.0), jnp.arange(n, dtype=jnp.float32), isect,
        lambda m: Uj[:m], cam, quota, max_depth, 5, loop="fori",
        sync_every=1, quota_cap=quota,
    )
    return np.stack([_np(a) for a in acc], axis=1), _np(counts)


def _port_regen(scene_c, cam_c, U, quota, max_depth, sample_base=0):
    return t_tv2.trace_regen_plain(
        scene_c, cam_c, torch.arange(U.shape[1], dtype=torch.int32), seed=0,
        sample_base=sample_base, quota=quota, max_depth=max_depth,
        uniforms=torch.from_numpy(U))


def _assert_paths_agree(j_rad, t_rad, j_segs, t_segs, t_done, quota, frac=LANE_FRAC):
    np.testing.assert_array_equal(t_done, quota)
    agree = (np.abs(j_rad - t_rad).sum(axis=1) < LANE_TOL).mean()
    assert agree >= frac, agree
    np.testing.assert_allclose(j_rad.mean(0), t_rad.mean(0), rtol=1e-3, atol=1e-3)
    assert abs(float(j_segs) - float(t_segs)) <= 0.005 * float(j_segs)


# max_depth 8: a fixed per-lane table repeats the same bounce at every step,
# so in the closed cornell box a path that survives Russian roulette runs to
# max_depth along a deterministic trajectory, and ulp differences grow
# bounce after bounce until the trajectories part (first seen at depth 9:
# 5 of 864 lanes at depth 12, quota 1). Depth 8 keeps the lane-exact grade
# meaningful; the production depth is held to the same means and counts.
@pytest.mark.parametrize("sid", ["cornell", "two-spheres", "three-spheres",
                                 "single-sphere", "cartesian", "gated"])
def test_regen_loop_matches_jax_under_injected_table(repo_root, sid):
    w, h, quota, max_depth = 36, 24, 4, 8
    (prims, bnd, cam), (scene_c, cam_c) = _consts(sid, repo_root, w, h)
    U = np.random.default_rng(0).random((6, w * h), dtype=np.float32)
    j_rad, j_counts = _jax_regen(prims, bnd, cam, U, quota, max_depth)
    t_rad, t_segs, t_done = _port_regen(scene_c, cam_c, U, quota, max_depth)
    _assert_paths_agree(j_rad, t_rad.numpy(), j_counts.sum(),
                        t_segs.sum(), t_done.numpy(), quota)
    if sid in ("cornell", "three-spheres", "single-sphere", "gated"):
        assert t_rad.sum() > 0  # light reaches the camera


def test_regen_loop_production_depth_cornell(repo_root):
    """max_depth 12: counts exact, means and segment totals as above; the
    lane share is held at 99% (see the max_depth 8 note)."""
    w, h, quota, max_depth = 36, 24, 4, 12
    (prims, bnd, cam), (scene_c, cam_c) = _consts("cornell", repo_root, w, h)
    U = np.random.default_rng(0).random((6, w * h), dtype=np.float32)
    j_rad, j_counts = _jax_regen(prims, bnd, cam, U, quota, max_depth)
    t_rad, t_segs, t_done = _port_regen(scene_c, cam_c, U, quota, max_depth)
    _assert_paths_agree(j_rad, t_rad.numpy(), j_counts.sum(), t_segs.sum(),
                        t_done.numpy(), quota, frac=0.99)


def test_max_depth_one_is_one_segment_per_sample(repo_root):
    """max_depth 1: every sample is exactly one segment on both sides, and
    the radiance is what the camera rays see directly."""
    w, h, quota = 36, 24, 3
    (prims, bnd, cam), (scene_c, cam_c) = _consts("cornell", repo_root, w, h)
    U = np.random.default_rng(6).random((6, w * h), dtype=np.float32)
    j_rad, j_counts = _jax_regen(prims, bnd, cam, U, quota, 1)
    t_rad, t_segs, t_done = _port_regen(scene_c, cam_c, U, quota, 1)
    np.testing.assert_array_equal(j_counts, quota)
    np.testing.assert_array_equal(t_segs.numpy(), quota)
    np.testing.assert_array_equal(t_done.numpy(), quota)
    np.testing.assert_allclose(j_rad, t_rad.numpy(), rtol=1e-5, atol=1e-5)
    assert (t_rad.numpy() > 0).any()  # the light is in view


def test_pallas_regen_kernel_zero_stub(repo_root):
    """The Pallas kernel in interpret mode (its PRNG stub returns zeros)
    against the plain version given a table of zeros: the call of
    tests/test_pallas.py:215."""
    w, h, quota, max_depth = 64, 16, 2, 4
    (prims, bnd, cam), (scene_c, cam_c) = _consts("cornell", repo_root, w, h)
    j_tv2.register_scene("torch-port-regen", (prims, bnd))
    j_tv2.register_scene("cam-torch-port-regen", cam)
    n = w * h
    with pltpu.force_tpu_interpret_mode():
        j_rad, j_rays = j_tv2.trace_pallas_regen.__wrapped__(
            jnp.arange(n, dtype=jnp.int32), "torch-port-regen",
            "cam-torch-port-regen", 3, 0, quota=quota, max_depth=max_depth,
            block=1024, quota_cap=quota,
        )
    t_rad, t_segs, t_done = t_tv2.trace_regen_plain(
        scene_c, cam_c, torch.arange(n, dtype=torch.int32), seed=3,
        sample_base=0, quota=quota, max_depth=max_depth,
        uniforms=torch.zeros((6, n), dtype=torch.float32))
    j_rad = _np(j_rad)
    assert np.isfinite(j_rad).all() and j_rad.sum() > 0
    _assert_paths_agree(j_rad, t_rad.numpy(), float(j_rays), t_segs.sum(),
                        t_done.numpy(), quota)
    assert int(t_segs.sum()) == int(float(j_rays))


def test_wall_quad_collapse_is_exact(repo_root, monkeypatch):
    """detect_quad_pairs' exactness argument, on the whole loop: cornell with
    its wall triangles collapsed into quads traces the same paths as with
    the triangles themselves."""
    w, h, quota, max_depth = 36, 24, 4, 8
    _, (quads_c, cam_c) = _consts("cornell", repo_root, w, h)
    monkeypatch.setattr(t_tv2, "detect_quad_pairs", lambda packed: ({}, set()))
    _, (tris_c, _) = _consts("cornell", repo_root, w, h)
    kinds = tris_c.prims[:, t_tv2.COL_KIND]
    assert (kinds == t_tv2.KIND_TRI).sum() == 14 and tris_c.prims.shape[0] == 18
    U = np.random.default_rng(2).random((6, w * h), dtype=np.float32)
    q_rad, q_segs, _ = _port_regen(quads_c, cam_c, U, quota, max_depth)
    t_rad, t_segs, t_done = _port_regen(tris_c, cam_c, U, quota, max_depth)
    _assert_paths_agree(q_rad.numpy(), t_rad.numpy(), q_segs.sum(),
                        t_segs.sum(), t_done.numpy(), quota)


def test_subpixel_schedule_has_period_four(repo_root):
    """The camera ray of sample s sits on the 2x2 subpixel grid at s mod 4:
    under a fixed table, sample bases 4 apart trace the same paths and the
    four bases of one period do not."""
    w, h = 36, 24
    _, (scene_c, cam_c) = _consts("three-spheres", repo_root, w, h)
    U = np.random.default_rng(5).random((6, w * h), dtype=np.float32)
    runs = [_port_regen(scene_c, cam_c, U, 1, 4, sample_base=s)[:2]
            for s in range(6)]
    for s in (0, 1):
        assert all(torch.equal(a, b) for a, b in zip(runs[s], runs[s + 4]))
    rads = [r[0] for r in runs[:4]]
    assert all(not torch.equal(rads[i], rads[j])
               for i in range(4) for j in range(i + 1, 4))
