"""ctypes bindings to the C++ native runtime (``csrc/pt_native.cpp``).

Counterpart of ``path_tracer_tpu.native``. The library accelerates host
work the reference did in Rust: OFF mesh parsing, ASCII-P3 PPM encoding
with gamma quantization, FNV-1a image hashing, and Morton codes for the
kernels' triangle tiles. Every entry point has a pure-Python fallback, and
the package works without the library.

The library is built on first use with ``g++ -O2 -shared -fPIC`` into the
git-ignored ``path_tracer_tpu_torch/_build/pt_native-<hash>.so``, keyed by a
hash of the source and the flags, as ``ops.kernels.build`` keys the CUDA
builds. Without a C++ compiler, or when the build fails, ``load_native``
returns None and the fallbacks run. A load appends a record of its hash,
build and ``dlopen`` seconds to ``utils.profiling.loads()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from path_tracer_tpu_torch.utils import profiling

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "pt_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_TRIED = False
_GUARD = threading.Lock()


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"pt_native-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return False
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return True


def load_native():
    """Build (once per source hash), load and cache the library, or None if
    it cannot be built."""
    global _LIB, _TRIED
    with _GUARD:
        if _TRIED:
            return _LIB
        _TRIED = True
        t0 = time.perf_counter()
        path = library_path()
        hash_s, build_s = time.perf_counter() - t0, 0.0
        if not os.path.exists(path):
            t0 = time.perf_counter()
            if not _build(path):
                return None
            build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        profiling.record_load("pt_native", hash_s, build_s,
                              time.perf_counter() - t0)
        lib.pt_parse_off.restype = ctypes.c_longlong
        lib.pt_parse_off.argtypes = [
            ctypes.c_char_p,            # path
            ctypes.c_float,             # scale
            ctypes.POINTER(ctypes.c_float),  # out triangles [cap*9]
            ctypes.c_longlong,          # cap (triangles)
        ]
        lib.pt_ppm_encode.restype = ctypes.c_longlong
        lib.pt_ppm_encode.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # pixels [n*3]
            ctypes.c_longlong,               # n pixels
            ctypes.c_int,                    # reverse order flag
            ctypes.POINTER(ctypes.c_char),   # out buffer
            ctypes.c_longlong,               # out capacity
        ]
        lib.pt_hash_image.restype = ctypes.c_ulonglong
        lib.pt_hash_image.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
        ]
        lib.pt_morton3d.restype = None
        lib.pt_morton3d.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # points [n*3] in [0,1)
            ctypes.c_longlong,                # n
            ctypes.POINTER(ctypes.c_uint32),  # out codes [n]
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return load_native() is not None


def native_parse_off(path: str, scale: float) -> np.ndarray | None:
    """Parse OFF via native code; returns [T,3,3] float32 or None (fallback)."""
    lib = load_native()
    if lib is None:
        return None
    # First call with cap=0 returns required triangle count (or -1 on error).
    need = lib.pt_parse_off(
        path.encode(), ctypes.c_float(scale), None, ctypes.c_longlong(0)
    )
    if need < 0:
        from path_tracer_tpu_torch.models.off import OffParseError

        raise OffParseError(f"native OFF parse failed for {path} (code {need})")
    out = np.empty((max(int(need), 1), 3, 3), np.float32)
    got = lib.pt_parse_off(
        path.encode(),
        ctypes.c_float(scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(int(need)),
    )
    if got < 0:
        from path_tracer_tpu_torch.models.off import OffParseError

        raise OffParseError(f"native OFF parse failed for {path} (code {got})")
    return out[: int(got)]


def native_ppm_body(pixels: np.ndarray, reverse: bool) -> bytes | None:
    """Encode gamma-quantized 'r g b ' ASCII triplets; None → no library.
    ``render.image.ppm_body`` does not call it (its numpy digit scatter is as
    fast); it is an independent reference of the PPM body format."""
    lib = load_native()
    if lib is None:
        return None
    px = np.ascontiguousarray(pixels, np.float32).reshape(-1)
    n = px.size // 3
    cap = n * 12 + 16
    buf = ctypes.create_string_buffer(cap)
    written = lib.pt_ppm_encode(
        px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(n),
        ctypes.c_int(1 if reverse else 0),
        buf,
        ctypes.c_longlong(cap),
    )
    if written < 0:
        return None
    return buf.raw[: int(written)]


def native_hash_image(pixels: np.ndarray) -> int | None:
    """FNV-1a 64 over the float32 bytes of ``pixels``; None → no library."""
    lib = load_native()
    if lib is None:
        return None
    px = np.ascontiguousarray(pixels, np.float32).reshape(-1)
    return int(
        lib.pt_hash_image(
            px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_longlong(px.size),
        )
    )


def native_morton3d(points01: np.ndarray) -> np.ndarray | None:
    """30-bit Morton codes for points normalized to [0,1)."""
    lib = load_native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points01, np.float32)
    n = pts.shape[0]
    out = np.empty(n, np.uint32)
    lib.pt_morton3d(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out
