"""The port's raster preview against the JAX package's.

Tessellation (the UV spheres, the ground grid, the near-plane clip) and the
helpers are byte-equal. ``render_preview``'s depth is within 1e-5 of JAX's
on every pixel and its color on at least 99.9% of them (cornell 96×64:
measured all but 3 of 6,144; the rest are pixels where two triangles'
depths tie to an ulp). The depth interpolation at near-plane-clipped
vertices is ill-conditioned, so the port fuses its multiply-adds as XLA
does on the CPU (``raster._fma``).
"""

import numpy as np
import pytest

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.models.geometry import sphere_to_triangles as j_sphere_tris
from path_tracer_tpu.models.scene import scene_bounds as j_scene_bounds
from path_tracer_tpu.viewer import raster as j_raster
from path_tracer_tpu_torch.models.geometry import sphere_to_triangles
from path_tracer_tpu_torch.models.scene import scene_bounds
from path_tracer_tpu_torch.viewer import raster
from tests.test_torch_host import SCENE_IDS, load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("radius,steps", [(1.0, 16), (0.35, 16), (2.5, 6)])
def test_sphere_to_triangles_byte_equal(radius, steps):
    assert _same(sphere_to_triangles(radius, steps), j_sphere_tris(radius, steps))


@pytest.mark.parametrize("sid", SCENE_IDS)
def test_tessellation_and_bounds_byte_equal(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    for a, b in zip(j_scene_bounds(js), scene_bounds(ts)):
        assert _same(a, b)
    jt, jc = j_raster.tessellate_scene(js)
    tt, tc = raster.tessellate_scene(ts)
    assert _same(jt, tt) and _same(jc, tc)
    for a, b in zip(j_raster.clip_near_plane(jt, jc, js.camera),
                    raster.clip_near_plane(tt, tc, ts.camera)):
        assert _same(a, b)


def test_grid_triangles_byte_equal():
    for pos in ([0, 0, 4], [0, 3, 40], [0, 0, 400]):
        a = j_raster.grid_triangles(jpt.Camera.looking(pos, [0, 0, -1]))
        b = raster.grid_triangles(tpt.Camera.looking(pos, [0, 0, -1]))
        assert _same(a[0], b[0]) and _same(a[1], b[1])
    near = raster.grid_triangles(tpt.Camera.looking([0, 0, 4], [0, 0, -1]))[0]
    far = raster.grid_triangles(tpt.Camera.looking([0, 0, 400], [0, 0, -1]))[0]
    assert far.max() > near.max() * 5  # spacing grows with zoom


@pytest.mark.parametrize("sid", ["cornell", "mesh", "two-spheres"])
def test_render_preview_matches_jax(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    ref = j_raster.render_preview(js, 96, 64)
    out = raster.render_preview(ts, 96, 64, device="cpu")
    assert out["color"].shape == (64, 96, 3) and out["depth"].shape == (64, 96)
    assert out["composite"].shape == (64, 96, 3)
    assert np.isfinite(out["color"]).all()
    np.testing.assert_allclose(out["depth"], ref["depth"], atol=1e-5, rtol=0)
    color = np.abs(out["color"] - ref["color"]).max(axis=2)
    assert (color <= 1e-5).mean() >= 0.999, (color <= 1e-5).mean()
    comp = np.abs(out["composite"] - ref["composite"]).max(axis=2)
    assert (comp <= 1e-5).mean() >= 0.999
    # the JAX test's checks: something rasterized; the top half is depth
    assert out["color"].std() > 0.01
    top = out["composite"][: 64 // 2]
    assert np.allclose(top[..., 0], top[..., 1])


def test_render_preview_chunking_is_exact(repo_root):
    """The z-buffer loop's chunk size does not change the image: a
    triangle's depth test is the same in any chunk, and ties go to the
    earlier triangle in both the chunk and the buffer."""
    _, ts = load_both("cornell", repo_root)
    tri_v, tri_c = raster.clip_near_plane(*raster.tessellate_scene(ts), ts.camera)
    import torch

    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in (
        tri_v, tri_c, ts.camera.view_projection(1.5),
        ts.camera.direction / np.linalg.norm(ts.camera.direction))]
    a = raster._raster_core(*args, 48, 32)
    b = raster._raster_core(*args, 48, 32, chunk=100)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
