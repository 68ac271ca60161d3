"""The port's host layer against the JAX package: byte-equal.

Scene packing, scene JSON, PPM bytes, the quantizer, the camera basis, the
Morton order, and the regen kernel's baked scene and camera constants must
be identical on both sides: every later comparison feeds both the same
scene through them.
"""

import faulthandler
import json
import os
import signal
import sys
import threading
from datetime import datetime

import numpy as np
import pytest
import torch
from jax._src.pallas.mosaic.interpret import interpret_pallas_call as _interp

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.models import off as j_off
from path_tracer_tpu.models import scene as j_scene
from path_tracer_tpu.ops import tonemap as j_tonemap
from path_tracer_tpu.ops.pallas import trace_kernel as j_tk
from path_tracer_tpu.ops.pallas import trace_v2 as j_tv2
from path_tracer_tpu.render import image as j_image
from path_tracer_tpu.render import pipeline as j_pipeline
from path_tracer_tpu.render import raygen as j_raygen
from path_tracer_tpu_torch.models import off as t_off
from path_tracer_tpu_torch.models import scene as t_scene
from path_tracer_tpu_torch.ops import tonemap as t_tonemap
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from path_tracer_tpu_torch.render import image as t_image
from path_tracer_tpu_torch.render import pipeline as t_pipeline
from path_tracer_tpu_torch.render import raygen as t_raygen

# Tier-1 runs six pytest workers on one machine's CPU cores; torch's default
# intra-op pool (a thread a core, in every worker) then oversubscribes them
# many times over, and a portal render test of ~15 s took over 200 s. The
# port's CPU tests work on a few thousand lanes, where one thread is as fast.
# Every worker imports every test module, so this holds for all of them.
torch.set_num_threads(1)

# The Pallas interpreter (jax 0.9) runs parts of a kernel as io_callbacks,
# which receive their arguments as JAX arrays. Every such callback turns its
# device id into an int first except _update_clocks_for_device_barrier,
# which multiplies the array: a JAX dispatch from the runtime's callback
# thread. When the main thread of an unjitted driver dispatches its next
# operation meanwhile (JAX on the CPU dispatches asynchronously), the two
# deadlock for good: tests/test_pallas.py's
# test_sorted_trace_is_a_permutation (trace_pallas_sorted.__wrapped__ in
# interpret mode) hung so and stalled whole Tier-1 runs until the line's
# time limit, with the main thread in dispatch.apply_primitive under
# ray_sort_keys and the callback thread in update_clocks_for_device_barrier.
# The callback is given the int here. Every worker imports every test module
# before it runs a test, so this holds for all of them.
_barrier_clocks = _interp._update_clocks_for_device_barrier


def _update_clocks_for_device_barrier(device_id):
    _barrier_clocks(int(device_id))


_interp._update_clocks_for_device_barrier = _update_clocks_for_device_barrier

# Each port test module that renders imports this fixture, so that a test
# that hangs fails on its own instead of stalling the whole Tier-1 run until
# the line's time limit cuts it: several times the slowest such test
# measured serially (23 s).
TEST_LIMIT_S = 120


@pytest.fixture(autouse=True)
def per_test_limit(request):
    """Fail the test if it runs past TEST_LIMIT_S (four times that for a
    test marked slow, such as a golden regeneration): SIGALRM fails it in the
    main thread, where pytest-xdist's workers run their tests, after
    dumping every thread's stack to stderr so the report names where it
    hung. A test stuck in native code never returns to the interpreter, so
    the signal's handler cannot run: 30 s later faulthandler's own watchdog
    thread dumps the stacks and ends the worker, which xdist reports as
    down while the run goes on to its end. Off the main thread (no
    signals there) the watchdog alone acts."""
    limit = TEST_LIMIT_S * (4 if request.node.get_closest_marker("slow") else 1)
    faulthandler.dump_traceback_later(limit + 30, exit=True,
                                      file=sys.__stderr__)
    main = threading.current_thread() is threading.main_thread()
    if main:
        def on_alarm(signum, frame):
            faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
            pytest.fail(f"{request.node.nodeid} ran past {limit} s; "
                        "every thread's stack is in the worker's stderr")

        previous = signal.signal(signal.SIGALRM, on_alarm)
        signal.alarm(limit)
    try:
        yield
    finally:
        if main:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


SCENE_IDS = ["single-sphere", "cartesian", "two-spheres", "three-spheres",
             "cornell", "mesh"]
SMALL_IDS = [s for s in SCENE_IDS if s != "mesh"]  # <= 128 primitives


def load_both(sid, repo_root):
    old = os.getcwd()
    os.chdir(repo_root)  # MeshFile paths are repo-relative
    try:
        return (jpt.load_scene(sid, "scenes", "meshes"),
                tpt.load_scene(sid, "scenes", "meshes"))
    finally:
        os.chdir(old)


def _mesh_scene(pkg, tris, pos=(0.0, 0.0, 0.0), extra_sphere=False):
    objs = [pkg.SceneObject.from_mesh(
        np.asarray(pos, np.float32), pkg.Mesh.from_triangles(tris),
        pkg.Material(np.full(3, 0.8, np.float32), np.zeros(3),
                     pkg.ReflectType.DIFFUSE),
    )]
    if extra_sphere:  # a light, so that renders of the scene are not black
        objs.append(pkg.SceneObject.sphere(
            np.array([6.0, -4.0, 4.0], np.float32), 1.5,
            pkg.Material(np.zeros(3), np.full(3, 6.0, np.float32),
                         pkg.ReflectType.DIFFUSE)))
    return pkg.SceneDescriptor(id="t", objects=objs,
                               camera=pkg.Camera.looking([7.0, -4.0, 12.0],
                                                         [0.0, 0.0, -1.0]))


# tests/test_pallas.py:150-159: the buggy bounding sphere leaves the corner
# (4, 2, 0) out, so the kernel must gate these triangles
GATED_TRIS = np.array(
    [[[4, -10, 0], [10, -10, 0], [4, 2, 0]],
     [[10, -10, 0], [10, 2, 0], [4, 2, 0]]], np.float32)
# one triangle that pairs with nothing: the scan's "t" branch
LONE_TRI = np.array([[[3, -9, 0], [11, -8, 0], [6, 1.5, 0]]], np.float32)


def gated_scene(pkg):
    return _mesh_scene(pkg, GATED_TRIS, extra_sphere=True)


def lone_triangle_scene(pkg):
    return _mesh_scene(pkg, LONE_TRI, extra_sphere=True)


SYNTH = {"gated": gated_scene, "lone-triangle": lone_triangle_scene}


@pytest.mark.parametrize("sid", SCENE_IDS)
def test_pack_scene_byte_equal(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    jp, tp = jpt.pack_scene(js), tpt.pack_scene(ts)
    jb, tb = jp.buffers(), tp.buffers()
    assert jb.keys() == tb.keys()
    for k in jb:
        assert jb[k].dtype == tb[k].dtype, k
        assert jb[k].tobytes() == tb[k].tobytes(), k
    for k in ("num_spheres", "num_triangles", "num_meshes", "num_objects"):
        assert getattr(jp, k) == getattr(tp, k)


def test_hdodec_rejected_on_both_sides(repo_root):
    path = os.path.join(repo_root, "meshes", "hdodec.off")
    with open(path) as fh:
        text = fh.read()
    with pytest.raises(j_off.OffParseError):
        j_off.parse_off(text, 1.0)
    with pytest.raises(t_off.OffParseError):
        t_off.load_off(path, 1.0)


@pytest.mark.parametrize("sid", SCENE_IDS)
def test_scene_json_round_trip(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    text = t_scene.dumps_scene_json(ts.to_json())
    assert text == j_scene.dumps_scene_json(js.to_json())
    back = t_scene.SceneDescriptor.from_json_dict(json.loads(text), repo_root)
    assert t_scene.dumps_scene_json(back.to_json()) == text


def test_write_ppm_bytes_equal(tmp_path):
    res = tpt.Resolution(7, 11)
    g = np.random.default_rng(5)
    pix = g.random((res.num_pixels, 3), dtype=np.float32) * 1.2 - 0.1
    ts = datetime(2026, 1, 2, 3, 4, 5)
    pj = j_image.write_ppm(j_image.Image.new(pix, res), "s", 16, 3.7,
                           out_dir=str(tmp_path / "j"), timestamp=ts,
                           make_symlink=False)
    pt_ = t_image.write_ppm(t_image.Image.new(pix, res), "s", 16, 3.7,
                            out_dir=str(tmp_path / "t"), timestamp=ts,
                            make_symlink=False)
    assert os.path.basename(pj) == os.path.basename(pt_)
    with open(pj, "rb") as a, open(pt_, "rb") as b:
        assert a.read() == b.read()
    vals, w, h = t_image.read_ppm(pt_)
    assert (w, h) == (11, 7) and vals.shape == (77, 3)


def test_quantize_np():
    x = np.array([0.0, 0.5, 0.75, 1.0], np.float32)
    want = [0, 186, 224, 255]
    assert t_tonemap.quantize_np(x).tolist() == want
    assert j_tonemap.quantize_np(x).tolist() == want
    y = np.random.default_rng(2).random(10000, dtype=np.float32) * 1.4 - 0.2
    np.testing.assert_array_equal(t_tonemap.quantize_np(y), j_tonemap.quantize_np(y))


@pytest.mark.parametrize("sid", SCENE_IDS)
def test_camera_arrays_equal(repo_root, sid):
    js, ts = load_both(sid, repo_root)
    ja, ta = j_raygen.camera_arrays(js.camera), t_raygen.camera_arrays(ts.camera)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].tobytes() == ta[k].tobytes(), k


@pytest.mark.parametrize("wh", [(36, 24), (64, 16), (1024, 768), (7, 5)])
def test_morton_pixel_order_equal(wh):
    jp, ji = j_pipeline.morton_pixel_order(*wh)
    tp, ti = t_pipeline.morton_pixel_order(*wh)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(ji, ti)


def _both_small(sid, repo_root):
    if sid in SYNTH:
        return SYNTH[sid](jpt), SYNTH[sid](tpt)
    return load_both(sid, repo_root)


@pytest.mark.parametrize("sid", SMALL_IDS + list(SYNTH))
def test_kernel_consts_bit_equal(repo_root, sid):
    """detect_quad_pairs, build_scene_consts and build_camera_consts: the
    port's tensors equal the JAX package's constants carried across."""
    js, ts = _both_small(sid, repo_root)
    jp, tp = jpt.pack_scene(js), tpt.pack_scene(ts)

    jq, jc = j_tk.detect_quad_pairs(jp)
    tq, tc = t_tk.detect_quad_pairs(tp)
    assert jc == tc and jq.keys() == tq.keys()
    for k in jq:
        assert jq[k].tobytes() == tq[k].tobytes()

    prims, bnd = j_tv2.build_scene_consts(jp)
    want = t_tv2.scene_from_jax_consts(prims, bnd)
    got = t_tv2.build_scene_consts(tp)
    assert got.prims.dtype == torch.float32
    assert torch.equal(got.prims, want.prims)
    assert torch.equal(got.gates, want.gates)
    assert got.prims.shape[0] == len(prims) and got.gates.shape[0] == len(bnd)
    kinds = {p[0] for p in prims}
    if sid == "gated":
        assert len(bnd) == 1 and (got.prims[:, t_tv2.COL_GATE] >= 0).any()
    if sid == "lone-triangle":
        assert "t" in kinds
    if sid == "cornell":
        assert kinds == {"s", "q"} and len(prims) == 11

    for w, h in ((36, 24), (1024, 768)):
        jcam = t_tv2.camera_from_jax_consts(
            j_tv2.build_camera_consts(js.camera, w, h))
        tcam = t_tv2.build_camera_consts(ts.camera, w, h)
        assert torch.equal(jcam.params, tcam.params)
        assert (jcam.width, jcam.height) == (tcam.width, tcam.height) == (w, h)


def test_mesh_scene_is_too_big_for_the_static_scan(repo_root):
    js, ts = load_both("mesh", repo_root)
    assert j_tv2.build_scene_consts(jpt.pack_scene(js)) is None
    assert t_tv2.build_scene_consts(tpt.pack_scene(ts)) is None
