#!/usr/bin/env python3
"""Reference outputs of the JAX sorted trace (K9) for the port's CPU tests.

The JAX package's ``trace_pallas_sorted`` takes about half a minute in the
Pallas interpreter on the mesh scene, so tests/test_torch_v1.py compares the
port's plain version with outputs committed under tests/golden/gpu/, made
here: the radiance [N, 3] of ``k9_sort{1,2}.npy`` for N rays of the mesh
scene from one point in random directions, max depth 4, Russian roulette
from depth 1 (so rays die and sort last), injected uniforms
[max_depth * 4, N] riding the permutation; sort_every 1 (octant low) and 2
(dir_major, octant high).

A test marked slow regenerates them and checks that they are unchanged.
Run from the root of the repo:  JAX_PLATFORMS=cpu python3 scripts/make_torch_v1_goldens.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "gpu")
N, MAX_DEPTH, RR_START = 512, 4, 1
# golden name: (sort_every, dir_major)
CASES = {"k9_sort1": (1, False), "k9_sort2": (2, True)}


def inputs() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(o, d [N, 3], uniforms [MAX_DEPTH * 4, N]) float32."""
    g = np.random.default_rng(5)
    o = np.tile(np.array([0.0, -0.2, 7.0], np.float32), (N, 1))
    d = g.normal(0, 1, (N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, g.random((MAX_DEPTH * 4, N), dtype=np.float32)


def jax_outputs() -> dict[str, np.ndarray]:
    """Run the JAX sorted trace in interpret mode; {golden name: radiance}."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    import path_tracer_tpu as jpt
    from path_tracer_tpu.ops.pallas import trace_kernel as tk

    scene = jpt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                           os.path.join(ROOT, "meshes"))
    kscene = tk.kernel_scene_buffers(jpt.pack_scene(scene))
    o, d, u = (jnp.asarray(x) for x in inputs())
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name, (sort_every, dir_major) in CASES.items():
            rad, _ = tk.trace_pallas_sorted.__wrapped__(
                o, d, kscene, 0, block=256, uniforms=u, max_depth=MAX_DEPTH,
                rr_start_depth=RR_START, sort_every=sort_every,
                dir_major=dir_major)
            out[name] = np.asarray(rad)
    return out


def load(name: str) -> np.ndarray:
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, arr in jax_outputs().items():
        path = os.path.join(GOLDEN_DIR, f"{name}.npy")
        np.save(path, arr)
        print(f"wrote {os.path.relpath(path, ROOT)} {arr.shape}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
