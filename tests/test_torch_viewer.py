"""The port's viewer against the JAX package's: camera controls, picking,
the ray probe, the host intersector, the PNG encoder and the HTTP app.

Controls, picking, the probe and the host intersector are the same numpy
code on both sides, so the same inputs must give equal outputs (the cases
of ``tests/test_viewer.py:18-95``). The port's PNG encoder (zlib and
struct, no imaging library) is checked with PIL's decoder. The HTTP app
runs on the CPU. Each test loads its scenes afresh: the controls move the
camera of the scene they are given.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops import host_intersect as j_hi
from path_tracer_tpu.viewer import controls as j_controls
from path_tracer_tpu.viewer.debug import test_scene_ray as j_probe
from path_tracer_tpu_torch.ops import host_intersect as t_hi
from path_tracer_tpu_torch.ops import tonemap as t_tonemap
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.viewer import app as t_app
from path_tracer_tpu_torch.viewer import controls as t_controls
from path_tracer_tpu_torch.viewer.debug import test_scene_ray as t_probe
from tests.test_torch_host import load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

GRID = [(x, y) for x in (0.1, 0.3, 0.5, 0.7, 0.9) for y in (0.1, 0.5, 0.8)]


def _cams_equal(jc, tc):
    np.testing.assert_array_equal(tc.position, jc.position)
    np.testing.assert_array_equal(tc.direction, jc.direction)


def test_axis_angle_matrix_equal():
    g = np.random.default_rng(0)
    for _ in range(8):
        axis, angle = g.normal(size=3), float(g.uniform(-3, 3))
        np.testing.assert_array_equal(t_controls.axis_angle_matrix(axis, angle),
                                      j_controls.axis_angle_matrix(axis, angle))
    R = t_controls.axis_angle_matrix(np.array([0, 1, 0]), np.pi / 2)
    np.testing.assert_allclose(R @ np.array([1, 0, 0]), [0, 0, -1], atol=1e-6)


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
def test_camera_matrices_equal(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    for name in ("view_matrix",):
        np.testing.assert_array_equal(getattr(ts.camera, name)(),
                                      getattr(js.camera, name)())
    np.testing.assert_array_equal(ts.camera.projection_matrix(1.5),
                                  js.camera.projection_matrix(1.5))
    np.testing.assert_array_equal(ts.camera.view_projection(1.5),
                                  js.camera.view_projection(1.5))
    assert ts.camera.fov_y() == js.camera.fov_y()


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
def test_navigation_moves_equal(repo_root, sid):
    """Orbit, zoom, pan and look-around move both cameras alike; the orbit
    keeps its pivot distance (tests/test_viewer.py:24-68)."""
    js, ts = load_both(sid, repo_root)
    jn, tn = j_controls.SceneNavigator(js), t_controls.SceneNavigator(ts)
    np.testing.assert_array_equal(tn.get_orbit_point(), jn.get_orbit_point())
    tn.begin_orbit()
    pivot = tn._orbit_point.copy()
    r0 = np.linalg.norm(ts.camera.position - pivot)
    for nav in (jn, tn):
        for _ in range(5):
            nav.orbit(40.0, 25.0)
        nav.end_orbit()
    _cams_equal(js.camera, ts.camera)
    np.testing.assert_allclose(np.linalg.norm(ts.camera.position - pivot), r0,
                               rtol=1e-4)
    for move, args in (("zoom", (100.0,)), ("pan", (50.0, 30.0)),
                       ("look_around", (120.0, 60.0, 400.0))):
        getattr(jn, move)(*args)
        getattr(tn, move)(*args)
        _cams_equal(js.camera, ts.camera)


@pytest.mark.parametrize("sid", ["cornell", "mesh", "three-spheres"])
def test_pick_and_probe_equal(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    jn, tn = j_controls.SceneNavigator(js), t_controls.SceneNavigator(ts)
    hits = 0
    for relx, rely in GRID:
        assert tn.pick_object(relx, rely, 1.5) == jn.pick_object(relx, rely, 1.5)
        jr = j_probe(relx, rely, js, verbose=False)
        tr = t_probe(relx, rely, ts, packed=tn.packed, verbose=False)
        assert (jr is None) == (tr is None)
        if tr is not None:
            hits += 1
            assert tr.object_id == jr.object_id and tr.distance == jr.distance
            np.testing.assert_array_equal(tr.point, jr.point)
            tm, jm = tr.material, jr.material
            np.testing.assert_array_equal(tm.color, jm.color)
            np.testing.assert_array_equal(tm.emission, jm.emission)
            assert tm.reflect_type.to_json() == jm.reflect_type.to_json()
    assert hits > 0


@pytest.mark.parametrize("sid", ["cornell", "mesh", "two-spheres"])
def test_host_intersector_equal(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    jp, tp = jpt.pack_scene(js), tpt.pack_scene(ts)
    jb, tb = j_hi.pack_scene_bounds(js), t_hi.pack_scene_bounds(ts)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b, a)
    g = np.random.default_rng(1)
    o0 = ts.camera.lens_center()
    for _ in range(64):
        o = o0 + g.normal(0, 0.5, 3)
        d = g.normal(size=3)
        d /= np.linalg.norm(d)
        jh, th = j_hi.intersect_packed(jp, o, d), t_hi.intersect_packed(tp, o, d)
        assert (jh is None) == (th is None)
        if th is not None:
            assert th[:2] == jh[:2]
            np.testing.assert_array_equal(th[2], jh[2])
            np.testing.assert_array_equal(th[3], jh[3])
        assert (t_hi.intersect_bounds_packed(tp, *tb, o, d)
                == j_hi.intersect_bounds_packed(jp, *jb, o, d))


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (24, 36), (160, 240)])
def test_png_encoder_decodes_with_pil(shape):
    g = np.random.default_rng(shape[0])
    arr = g.integers(0, 256, (*shape, 3), dtype=np.uint8)
    png = t_app._png_u8(arr)
    assert png[:8] == t_app.PNG_SIGNATURE
    dec = PILImage.open(io.BytesIO(png))
    assert dec.mode == "RGB" and dec.size == (shape[1], shape[0])
    np.testing.assert_array_equal(np.asarray(dec), arr)
    with pytest.raises(ValueError):
        t_app._png_u8(arr.astype(np.float32))


def test_preview_png_orientation(repo_root, monkeypatch):
    """The served preview PNG is the u8 frame in display orientation, the
    same double flip as Image.to_grid (row 0 = PPM row 0): PNG is lossless,
    so the decode equals quantize_np of the renderer's accumulator."""
    monkeypatch.chdir(repo_root)
    state = t_app.ViewerState(preview_res=24, device="cpu")
    assert state.scene.id == "mesh"  # the app opens on mesh, as the reference
    state.select_scene("two-spheres")
    png, etag = state.preview_frame()
    arr = np.asarray(PILImage.open(io.BytesIO(png)))
    r = state.preview
    h, w = r.resolution.height, r.resolution.width
    exact = t_tonemap.quantize_np(
        integrator.finalize(r._accum, r.samples_done).numpy()).astype(np.uint8)
    np.testing.assert_array_equal(arr, exact.reshape(h, w, 3)[::-1, ::-1, :])
    assert etag.startswith('"') and etag.endswith('"')


def test_viewer_needs_cuda_when_asked(repo_root, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(repo_root)
    with pytest.raises(RuntimeError, match="cuda"):
        t_app.ViewerState(preview_res=8)


def test_http_app_endpoints(repo_root, monkeypatch):
    monkeypatch.chdir(repo_root)
    server = t_app.make_server(0, device="cpu", preview_res=16)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def url(p):
        return f"http://127.0.0.1:{port}{p}"

    def get(p, etag=None):
        req = urllib.request.Request(url(p))
        if etag:
            req.add_header("If-None-Match", etag)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read(), resp.headers.get("ETag")

    def post(p, body):
        req = urllib.request.Request(url(p), data=json.dumps(body).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        assert b"path_tracer_tpu_torch" in get("/")[0]
        s = json.loads(get("/state")[0])
        assert s["render_state"] == "not_rendering" and s["scene"] == "mesh"
        tags = []
        for _ in range(2):
            png, tag = get("/preview.png")
            assert png[:8] == t_app.PNG_SIGNATURE
            assert np.asarray(PILImage.open(io.BytesIO(png))).shape == (16, 24, 3)
            tags.append(tag)
        assert tags[0] != tags[1]  # a new frame each time
        assert json.loads(get("/state")[0])["preview_samples"] == 4
        post("/control", {"action": "orbit", "dx": 30, "dy": 10})
        assert json.loads(get("/state")[0])["preview_samples"] == 0
        assert "selected" in post("/pick", {"relx": 0.5, "rely": 0.5})
        probe = post("/probe", {"relx": 0.5, "rely": 0.5})
        assert probe["distance"] > 0 and len(probe["material"]["color"]) == 3
        post("/select_scene", {"id": "two-spheres"})
        assert json.loads(get("/state")[0])["scene"] == "two-spheres"
        with pytest.raises(urllib.error.HTTPError) as e404:
            get("/render.png")
        assert e404.value.code == 404
        post("/start_render", {"spp": 4, "res_y": 16})
        deadline = time.time() + 60
        while time.time() < deadline:
            s = json.loads(get("/state")[0])
            if s["render_state"] == "done" or s["render_error"]:
                break
            time.sleep(0.2)
        assert s["render_state"] == "done" and s["render_error"] is None, s
        png, tag = get("/render.png")
        assert np.asarray(PILImage.open(io.BytesIO(png))).shape == (16, 24, 3)
        with pytest.raises(urllib.error.HTTPError) as e304:
            get("/render.png", etag=tag)  # unchanged: 304, no body
        assert e304.value.code == 304
        for bad in ({"spp": 123456, "res_y": 16}, {"res_y": 16}):
            with pytest.raises(urllib.error.HTTPError) as e400:
                post("/start_render", bad)
            assert e400.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e400:
            post("/control", {"action": "roll"})
        assert e400.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
