"""Image content hashing.

Counterpart of ``path_tracer_tpu.utils.hashing`` (role parity with
``hash_vec_of_vectors``, ``mod.rs:916-926``): a cheap, deterministic
digest over the f32 bit patterns of all pixels, used as a
cache-invalidation key by viewers. FNV-1a 64-bit through the native
runtime; only self-consistency matters.

``digest_later`` runs ``hash_image`` on one worker thread, so that a
render's digest overlaps the next render instead of holding up its
return: the native call (ctypes) and blake2b over a large buffer
(hashlib) both release the interpreter lock.
"""

from __future__ import annotations

import hashlib
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MASK64 = (1 << 64) - 1


def hash_image(pixels: np.ndarray) -> int:
    """Digest over the f32 bit patterns of all components.

    Native path: FNV-1a (C++). Python fallback: blake2b — FNV is
    byte-sequential and a Python loop costs seconds per megapixel frame (the
    hash is a cache key, so the two paths need not agree with each other)."""
    from path_tracer_tpu_torch.native import native_hash_image

    native = native_hash_image(np.asarray(pixels, np.float32))
    if native is not None:
        return native
    data = np.ascontiguousarray(pixels, np.float32).tobytes()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


_worker: ThreadPoolExecutor | None = None
_worker_pid = 0
_worker_guard = threading.Lock()


def digest_later(pixels: np.ndarray) -> Future:
    """``hash_image(pixels)`` on the digest worker: one thread, made on the
    first call (and again in a forked child, which has none of its
    parent's threads), so digests run one at a time in the order they were
    handed over. The future re-raises what the digest raised; ``pixels``
    must not change until it is done."""
    global _worker, _worker_pid
    with _worker_guard:
        if _worker is None or _worker_pid != os.getpid():
            _worker = ThreadPoolExecutor(1, thread_name_prefix="pt-digest")
            _worker_pid = os.getpid()
        return _worker.submit(hash_image, pixels)


def hash_bytes(data: bytes) -> int:
    """Content digest over raw bytes (uint8 preview frames). blake2b: the
    frames are small (~100 KB) and only self-consistency matters."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def fnv1a(data: bytes) -> int:
    """Reference FNV-1a 64 (the tests hold the native hash to it)."""
    h = FNV_OFFSET
    for b in data:
        h = ((h ^ b) * FNV_PRIME) & MASK64
    return h
