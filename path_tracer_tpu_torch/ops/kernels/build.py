"""Build a CUDA source of the port with nvcc and load it with ctypes.

Each ``.cu`` file has a plain C interface and is compiled on first use into
``path_tracer_tpu_torch/_build/<stem>-<hash>.so``, keyed by a hash of the
source, the headers (``*.cuh``) beside it and the flags, so a fresh checkout
builds it and an edited source or header rebuilds. Every library exports
``pt_cuda_error_string``; ``load_kernel`` binds it. The target is Hopper (``sm_90a``); no fast-math flags, so FMA
contraction stays at nvcc's default and division and sqrt are IEEE. Each
load appends a record of its hash, build and ``dlopen`` seconds to
``utils.profiling.loads()``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

from path_tracer_tpu_torch.utils import profiling

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float  # compile time, 0.0 when the library was already built
    log: str  # nvcc's output (register and spill report from -Xptxas -v),
    # kept beside the library as <library>.log


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


def _lock(path: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(path, threading.Lock())


def build(source: str, extra_flags: tuple[str, ...] = ()) -> Built:
    """Compile ``source`` (with ``extra_flags`` after NVCC_FLAGS) unless its
    hash-keyed library exists; load it. Threads that ask for the same
    library wait for one compile. Records the load
    (``profiling.record_load``)."""
    t0 = time.perf_counter()
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(glob.glob(os.path.join(os.path.dirname(source), "*.cuh")))
    for path in [source, *headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
    hash_s = time.perf_counter() - t0
    seconds = 0.0
    with _lock(out):
        if not os.path.exists(out):
            seconds = _compile(source, flags, out)
    log = ""
    if os.path.exists(f"{out}.log"):
        with open(f"{out}.log") as fh:
            log = fh.read()
    t0 = time.perf_counter()
    lib = ctypes.CDLL(out)
    profiling.record_load(stem, hash_s, seconds, time.perf_counter() - t0)
    return Built(lib, out, seconds, log)


def _compile(source: str, flags: tuple[str, ...], out: str) -> float:
    """nvcc ``source`` into ``out`` (and its report into ``out``.log);
    returns the seconds it took."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [find_nvcc(), *flags, "-o", tmp, source],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stderr}")
    with open(f"{tmp}.log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(f"{tmp}.log", f"{out}.log")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return seconds


@functools.lru_cache(maxsize=None)
def load_kernel(source: str, fmad: bool = True,
                defines: tuple[str, ...] = ()) -> Built:
    """Build (once per source hash and flags) and load a kernel library;
    ``fmad=False`` builds it with ``--fmad=false`` (no FMA contraction);
    ``defines`` ("NAME=VALUE", ...) become -D flags, a source's build-time
    design choices."""
    built = build(source, tuple(f"-D{d}" for d in defines)
                  + (() if fmad else ("--fmad=false",)))
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return built


def check_launch(built: Built, code: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = built.lib.pt_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
