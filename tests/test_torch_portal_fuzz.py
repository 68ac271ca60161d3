"""The portal scheduler on random portal-eligible scenes, not only `mesh`.

The scenes are scripts/portal_fuzz_scenes.py's: one random heavy mesh (80
to 220 triangles, at least PORTAL_MIN_TRIS) plus at most 128 cheap
primitives, seen from a random camera. Per scene, with a random resolution,
quota (spp), pool width, park depth and step budget, the v2 drive through
K2's and K3's plain versions:

- retires exactly the quota on every pixel, and nothing on padding slots;
- gives the image of the PT_TPU_NO_PORTAL route (K4's plain version) of
  the same seed. Draws are keyed by each path's sample index, so the two
  routes trace the same paths, but the cheap scene's scan and the full
  intersector round a hit differently: where ulps part a path the pixel
  differs. Tolerance: 97% of pixels within 1e-5 (measured: 0 to 2 pixels of
  a few hundred beyond it), every pixel within 0.25, and the traced segment
  totals within 1%.

A 450x300 render (135,000 pixels, no multiple of CHEAP_BLOCK) pauses at its
first poll and takes progress snapshots after it: every snapshot equals the
JAX package's ``_snapshot_stages`` on the same stages, and the last shows
the full quota on every pixel, the pause carry included.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as tpt
from path_tracer_tpu.render import portal as j_rp
from path_tracer_tpu_torch.ops.kernels import portal as t_pm
from path_tracer_tpu_torch.render import drive as t_drive
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render import portal as t_rp
from path_tracer_tpu_torch.render.pipeline import prepare_render
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "portal_fuzz_scenes", os.path.join(ROOT, "scripts", "portal_fuzz_scenes.py"))
_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scenes)
fuzz_scene = _scenes.fuzz_scene

SEEDS = range(10)


def _drive(prep, npix, spp, n_pad, park_k, on_check=None):
    pool = t_rp.make_pool_v2(npix, n_pad, spp, park_k=park_k, device="cpu")
    return t_rp.drive_pool_v2(pool, spp, 0, pc=prep.portal, cam=prep.cam,
                              ks=prep.kscene, seed=0, max_depth=12,
                              rr_start_depth=5, park_k=park_k,
                              adaptive_polls=False, npix=npix,
                              on_check=on_check)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_scene_portal_matches_prim_route(seed, monkeypatch):
    scene = fuzz_scene(seed)
    g = np.random.default_rng(1000 + seed)
    res = tpt.Resolution(int(g.integers(6, 14)), int(g.integers(6, 18)))
    spp, park_k = int(g.integers(1, 5)), int(g.integers(0, 4))
    npix = res.num_pixels
    n_pad = t_rp._round_block(npix) * int(g.integers(1, 3))
    monkeypatch.setattr(t_rp, "STEP_CAP", int(g.choice([8, 16, 64])))
    prep = prepare_render(scene, res, "cpu")
    assert prep.route == "portal"
    assert prep.portal.scene.prims.shape[0] <= 128

    result = _drive(prep, npix, spp, n_pad, park_k)
    assert result.outcome == t_drive.DONE
    counts = t_rp._retired_counts(tuple(result.stages), result.flush,
                                  out_rows=n_pad, device="cpu")
    assert torch.equal(counts[:npix], torch.full((npix,), float(spp)))
    assert int(counts[npix:].abs().sum()) == 0
    accum = t_rp.merge_stages(torch.zeros((npix, 3)), result.stages,
                              result.flush)
    portal = integrator.finalize(accum, spp).numpy()

    monkeypatch.setenv("PT_TPU_NO_PORTAL", "1")
    prim = tpt.render(scene, tpt.RenderConfig(samples_per_pixel=spp,
                                              resolution=res),
                      device="cpu", out_dir=None, verbose=False)
    assert prim.stats.extra["route"] == "prim"
    diff = np.abs(portal - prim.image.pixels).max(axis=1)
    assert (diff <= 1e-5).mean() >= 0.97, np.sort(diff)[-5:]
    assert diff.max() <= 0.25
    rays = int(result.rays.sum())  # K2's and the resolve's
    assert abs(rays - prim.stats.num_rays) <= 0.01 * prim.stats.num_rays
    assert portal.mean() > 0.0


def test_pause_snapshot_450x300_matches_jax(monkeypatch):
    """A 450x300 pass at depth 1 pauses at its first poll and snapshots
    every poll after it: each snapshot is the JAX ``_snapshot_stages`` of
    the same stages (radiance to float rounding, counts exactly), over a
    pool wider than the 135,000 pixels; the last counts the full quota on
    every pixel, the carry from before the pause included."""
    scene = fuzz_scene(0)
    res = tpt.Resolution(300, 450)
    # 9 samples need two calls of K2's 8-step granule, so the first poll
    # finds the pass unfinished; park depth 0 keeps K3's plain version cheap
    npix, spp = res.num_pixels, 9
    assert npix % t_rp.CHEAP_BLOCK
    monkeypatch.setattr(t_rp, "STEP_CAP", 1)
    monkeypatch.setattr(t_rp, "CHECK_EVERY", 1)
    monkeypatch.setattr(t_pm, "PARK_K", 0)
    prep = prepare_render(scene, res, "cpu")
    seen = []
    snapshot = t_rp._snapshot_stages

    def recorded(stages, flush, *, out_rows):
        out = snapshot(stages, flush, out_rows=out_rows)
        seen.append(([s.clone() for s in stages],
                     None if flush is None else flush.clone(), out_rows, out))
        return out

    monkeypatch.setattr(t_rp, "_snapshot_stages", recorded)
    state = {"paused": False, "snaps": []}

    def on_pause(accum, pass_idx, fields):
        state["paused"] = True

    def hook(cycle, width, unfin, *, snapshot=None):
        if not state["paused"] and unfin > 0:
            return "pause"
        if state["paused"] and snapshot is not None:
            state["snaps"].append(snapshot())
        return False

    runner = t_rp.make_portal_pass_runner_v2(
        prep.portal, prep.cam, prep.kscene, npix=npix, k_full=spp, seed=0,
        max_depth=1, device="cpu")
    with runner.hooks(on_check=hook, on_pause=on_pause):
        accum, rays = runner(torch.zeros((npix, 3)), 0, spp)
    assert state["paused"] and state["snaps"]
    assert int(rays.sum()) == npix * spp  # depth 1: a segment a sample
    rad, cnt = state["snaps"][-1]
    assert cnt.shape[0] == t_rp._round_block(npix) > npix
    assert torch.equal(cnt[:npix], torch.full((npix,), float(spp)))
    assert seen
    for stages, flush, out_rows, (rad_t, cnt_t) in seen:
        rad_j, cnt_j = j_rp._snapshot_stages(
            tuple(jnp.asarray(s.numpy()) for s in stages),
            None if flush is None else jnp.asarray(flush.numpy()),
            out_rows=out_rows)
        np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
