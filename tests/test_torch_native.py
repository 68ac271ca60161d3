"""The port's host native runtime against the JAX package's: byte-equal.

The cases of tests/test_native.py, run on the port's library, which the
port builds on first use with g++ (present here) into
``path_tracer_tpu_torch/_build/``: the tests require it to load, so the
native path is what they hold. The JAX package's own library is not built
here, so its pure-Python parser, quantizer and FNV-1a are the references.
"""

import os

import numpy as np
import pytest

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.models.off import OffParseError as JOffParseError
from path_tracer_tpu.models.off import parse_off as j_parse_off
from path_tracer_tpu.ops.tonemap import quantize_np as j_quantize_np
from path_tracer_tpu.utils.hashing import fnv1a as j_fnv1a
from path_tracer_tpu_torch import native
from path_tracer_tpu_torch.models import off as t_off
from path_tracer_tpu_torch.ops.kernels import trace_kernel
from path_tracer_tpu_torch.utils import hashing
from tests.test_torch_host import load_both
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)


def test_library_builds_into_the_build_dir():
    assert native.native_available()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("pt_native-")


@pytest.mark.parametrize("scale", [0.16, 1.0, 0.5])
def test_off_matches_python(repo_root, scale):
    path = os.path.join(repo_root, "meshes", "mctri.off")
    tris = native.native_parse_off(path, scale)
    with open(path) as f:
        text = f.read()
    ref = j_parse_off(text, scale)
    assert tris.shape == ref.shape == (810, 3, 3) and tris.dtype == ref.dtype
    assert tris.tobytes() == ref.tobytes()
    assert t_off.parse_off(text, scale).tobytes() == ref.tobytes()


def test_off_rejects_pentagons(repo_root):
    path = os.path.join(repo_root, "meshes", "hdodec.off")
    with pytest.raises(t_off.OffParseError):
        native.native_parse_off(path, 1.0)
    with open(path) as f, pytest.raises(JOffParseError):
        j_parse_off(f.read(), 1.0)


def test_ppm_body_matches_python():
    g = np.random.default_rng(0)
    px = g.uniform(-0.1, 1.1, (257, 3)).astype(np.float32)
    q = j_quantize_np(px)
    for reverse in (True, False):
        rows = q[::-1] if reverse else q
        expected = b"".join(b"%d %d %d " % tuple(row) for row in rows)
        assert native.native_ppm_body(px, reverse=reverse) == expected


def test_hash_matches_reference_fnv():
    px = np.arange(30, dtype=np.float32) / 7.0
    assert native.native_hash_image(px) == j_fnv1a(px.tobytes())
    assert hashing.fnv1a(px.tobytes()) == j_fnv1a(px.tobytes())
    # the image hash takes the native path where the library loads
    assert hashing.hash_image(px) == j_fnv1a(px.tobytes())


def test_morton_codes():
    pts = np.array([[0, 0, 0], [0.9999999, 0.9999999, 0.9999999], [0.5, 0, 0]],
                   np.float32)
    codes = native.native_morton3d(pts)
    assert codes[0] == 0
    assert codes[1] == (1 << 30) - 1  # all 30 bits set (1023 per axis)
    assert codes[2] == 1 << 29  # x=0.5 -> bit 9 of x -> interleaved bit 29
    g = np.random.default_rng(2)
    rand = g.uniform(0, 0.999999, (1000, 3)).astype(np.float32)
    assert np.array_equal(native.native_morton3d(rand),
                          trace_kernel._morton3d(rand))


def test_fallbacks_agree_with_the_library(repo_root, monkeypatch):
    """Without the library every entry point falls back to Python, with the
    same meshes and Morton codes (the image hash becomes blake2b, a cache
    key only)."""
    g = np.random.default_rng(3)
    rand = g.uniform(0, 0.999999, (500, 3)).astype(np.float32)
    with_lib = trace_kernel._morton3d(rand)
    mesh_lib = t_off.load_off(os.path.join(repo_root, "meshes", "mctri.off"), 0.16)
    monkeypatch.setattr(native, "load_native", lambda: None)
    assert native.native_parse_off("unused", 1.0) is None
    assert native.native_hash_image(rand) is None
    assert np.array_equal(trace_kernel._morton3d(rand), with_lib)
    mesh_py = t_off.load_off(os.path.join(repo_root, "meshes", "mctri.off"), 0.16)
    assert mesh_py.triangles.tobytes() == mesh_lib.triangles.tobytes()
    assert isinstance(hashing.hash_image(rand), int)


def test_mesh_scene_through_the_library_packs_byte_equal(repo_root):
    """mesh loads its OFF file through the library, and its packed buffers
    and kernel tables (Morton-ordered tiles) equal the JAX package's."""
    from path_tracer_tpu.ops.pallas import trace_kernel as j_tk

    js, ts = load_both("mesh", repo_root)
    jp, tp = jpt.pack_scene(js), tpt.pack_scene(ts)
    for k, v in jp.buffers().items():
        assert v.tobytes() == tp.buffers()[k].tobytes(), k
    jk = j_tk.kernel_scene_buffers(jp)
    tk = trace_kernel.kernel_scene_buffers(tp)
    assert set(jk) == set(tk) and "tile_lo" in tk
    for k in jk:
        assert np.asarray(jk[k]).tobytes() == tk[k].tobytes(), k
