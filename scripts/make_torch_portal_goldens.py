#!/usr/bin/env python3
"""Reference outputs of the JAX portal kernels for the port's CPU tests.

The JAX package's K2 (``trace_cheap_regen``) and K3
(``trace_pallas_resolve_pool``) run for minutes in the Pallas interpreter at
park depth 3, so tests/test_torch_portal.py compares the port's plain
versions with outputs committed under tests/golden/gpu/, made here:

- ``k2_park{1,3}_call{1,2}.npy``: the pool after each of two successive K2
  calls from a fresh pool (zero stub: the interpreter's PRNG returns zeros),
  step_cap 4, on the 72-triangle synthetic portal scene at 36x24;
- ``k3_park{1,3}.npy``: K3 on the pool after the second call, all parts,
  under injected uniforms (``uniforms(park_k, n)``).

A test marked slow regenerates them and checks that they are unchanged.
Run from the root of the repo:  JAX_PLATFORMS=cpu python3 scripts/make_torch_portal_goldens.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "gpu")
WIDTH, HEIGHT = 36, 24
STEP_CAP = 4
RESOLVE_SEED = 12
# (spp, max_depth) per park depth, as tests/test_portal.py:618 drives them
SHAPES = {1: (2, 3), 3: (5, 4)}
CHEAP_SEEDS = (7, 8)


def synthetic_portal_scene(pkg):
    """The 72-triangle portal scene of tests/test_portal.py:529, built with
    either package's models (``path_tracer_tpu`` or the port)."""
    g = np.random.default_rng(3)
    nx = 6
    xs = np.linspace(-3.0, 3.0, nx + 1)
    z = -6.0 + g.uniform(-0.3, 0.3, (nx + 1, nx + 1))
    tris = []
    for i in range(nx):
        for j in range(nx):
            p = [np.array([xs[a], xs[b], z[a, b]], np.float32)
                 for a, b in ((i, j), (i + 1, j), (i, j + 1), (i + 1, j + 1))]
            tris.append(np.stack([p[0], p[1], p[2]]))
            tris.append(np.stack([p[1], p[3], p[2]]))
    plate = pkg.Mesh.from_triangles(np.stack(tris).astype(np.float32))

    def mat(color, emis=(0, 0, 0)):
        return pkg.Material(np.asarray(color, np.float32),
                            np.asarray(emis, np.float32),
                            pkg.ReflectType.DIFFUSE)

    return pkg.SceneDescriptor(id="synth-portal", objects=[
        pkg.SceneObject.sphere((1.2, 0.8, -4.3), 0.6,
                               mat((1, 1, 1), (10, 10, 10))),
        pkg.SceneObject.sphere((0.0, -104.0, -6.0), 100.0, mat((0.6, 0.6, 0.6))),
        pkg.SceneObject.from_mesh(np.zeros(3, np.float32), plate,
                                  mat((0.75, 0.55, 0.35))),
    ])


def uniforms(park_k: int, n: int) -> np.ndarray:
    """K3's injected uniforms [4, (park_k + 1) * n]."""
    return np.random.default_rng(5).uniform(
        size=(4, (park_k + 1) * n)).astype(np.float32)


def jax_outputs(park_k: int) -> dict[str, np.ndarray]:
    """Run the JAX kernels in interpret mode; {golden name: array}."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    import path_tracer_tpu as jpt
    from path_tracer_tpu.ops.pallas import portal as pm
    from path_tracer_tpu.ops.pallas import trace_v2
    from path_tracer_tpu.ops.pallas.trace_kernel import kernel_scene_buffers
    from path_tracer_tpu.render import portal as rportal

    scene = synthetic_portal_scene(jpt)
    packed = jpt.pack_scene(scene)
    consts, _ = pm.build_portal_consts(packed)
    pkey = "portal:torch-goldens"
    cam_key = f"{pkey}:cam:{WIDTH}x{HEIGHT}"
    trace_v2.register_scene(pkey, consts)
    trace_v2.register_scene(cam_key, trace_v2.build_camera_consts(
        scene.camera, WIDTH, HEIGHT))
    kbufs = kernel_scene_buffers(packed)
    npix = WIDTH * HEIGHT
    n_pad = rportal._round_block(npix)
    spp, depth = SHAPES[park_k]
    pool = rportal.make_pool_v2(npix, n_pad, spp, park_k=park_k)
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for call, seed in enumerate(CHEAP_SEEDS, start=1):
            pool, _ = pm.trace_cheap_regen(
                pool, pkey, cam_key, jnp.int32(seed), jnp.int32(spp),
                jnp.int32(0), jnp.int32(STEP_CAP), max_depth=depth,
                rr_start_depth=5, block=rportal.CHEAP_BLOCK, park_k=park_k)
            out[f"k2_park{park_k}_call{call}"] = np.asarray(pool)
        res, _ = pm.trace_pallas_resolve_pool(
            jnp.asarray(out[f"k2_park{park_k}_call2"]), kbufs,
            jnp.int32(RESOLVE_SEED), parts=park_k + 1, max_depth=depth,
            rr_start_depth=5, block=rportal.RESOLVE_BLOCK,
            uniforms=jnp.asarray(uniforms(park_k, n_pad)))
        out[f"k3_park{park_k}"] = np.asarray(res)
    return out


def load(name: str) -> np.ndarray:
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for park_k in SHAPES:
        for name, arr in jax_outputs(park_k).items():
            path = os.path.join(GOLDEN_DIR, f"{name}.npy")
            np.save(path, arr)
            print(f"wrote {os.path.relpath(path, ROOT)} {arr.shape}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
