"""Build a CUDA source of the port with nvcc and load it with ctypes.

Each ``.cu`` file has a plain C interface and is compiled on first use into
``path_tracer_tpu_torch/_build/<stem>-<hash>.so``, keyed by a hash of the
source, the headers (``*.cuh``) beside it and the flags, so a fresh checkout
builds it and an edited source or header rebuilds. Every library exports
``pt_cuda_error_string``; ``load_kernel`` binds it. The target is Hopper (``sm_90a``); no fast-math flags, so FMA
contraction stays at nvcc's default and division and sqrt are IEEE.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

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
    log: str  # nvcc's output (register and spill report from -Xptxas -v)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: str, extra_flags: tuple[str, ...] = ()) -> Built:
    """Compile ``source`` (with ``extra_flags`` after NVCC_FLAGS) unless its
    hash-keyed library exists; load it."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(glob.glob(os.path.join(os.path.dirname(source), "*.cuh")))
    for path in [source, *headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [find_nvcc(), *flags, "-o", tmp, source],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stderr}")
        log = proc.stdout + proc.stderr
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return Built(ctypes.CDLL(out), out, seconds, log)


@functools.lru_cache(maxsize=None)
def load_kernel(source: str, fmad: bool = True) -> Built:
    """Build (once per source hash and flags) and load a kernel library;
    ``fmad=False`` builds it with ``--fmad=false`` (no FMA contraction)."""
    built = build(source, () if fmad else ("--fmad=false",))
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return built


def check_launch(built: Built, code: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = built.lib.pt_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
