#!/usr/bin/env python3
"""K3's design parts timed one by one on a CUDA card, on one pool.

Builds K3's input pool on cycle 2 of a fresh mesh 1024x768 drive (park
depth 3, step cap 64, seed 7; chip_smoke.py's phase 3 shape) with the
kernels, or with ``--scene mesh13k`` of the benchmark's mesh13k render
(450x300, 199 tiles: rows from device memory, the group split), then
times csrc/portal_resolve.cu's launch (CUDA events, warm,
``--reps`` launches, in turns over ``--rounds`` rounds) with its parts
switched on in turn (build-time -D choices of the kernel, PARTS below):

  compact          the live items packed, in column order, rows read from
                   device memory (read-only path), no sort;
  compact+sort     + each chunk's items sorted by their tile-entry key, the
                   groups of 32 taken most key tiles first;
  compact+shared   the packing with the compact table in shared memory;
  production       all three;

then the production build's neighbours (no group order, chunks of 512 and
2,048 columns, 512 threads a block, and K3_GROUP 4, 8 and 16 lanes an
item where the tiles outnumber the key: production's is 32; on mesh the
group builds run the one-lane trace), any --builds given and, with
``--parent DIR`` (a checkout of the commit before the redesign), that
commit's one-thread-per-column kernel on the same pool. Every build with
--fmad=false must equal the plain version bit for bit (a lane's arithmetic
does not depend on its warp); the script fails otherwise, and reports each
default build's share of columns within 1e-3 of it. Prints each variant's
ms, resident blocks per SM and shared memory, the registers that
``-Xptxas -v`` reports, and the card's name and power limit.

  python3 scripts/ablate_k3.py [--parent DIR] [--builds K3_THREADS=768 ...]
      [--reps 10] [--rounds 2] [--scene mesh13k] [--parts-only]

``--parts-only`` times production, the group builds and the parent only.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import path_tracer_tpu_torch as pt  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import portal as pk  # noqa: E402
from path_tracer_tpu_torch.render import portal as rp  # noqa: E402
from path_tracer_tpu_torch.render.pipeline import prepare_render  # noqa: E402
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402
from scripts.k3_coherence import load_named_scene  # noqa: E402

PARK_K, STEP_CAP, SEED, MAX_DEPTH = 3, 64, 7, 12


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_registers(log: str) -> list[str]:
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln]


def parent_launcher(parent: str, ks, pool, kw):
    """A launch of the parent commit's K3, bound as this checkout binds its
    own (``bind_resolve``: the signature since K3's group split)
    and launched through the wrapper's ``library``."""
    lib = bound(kbuild.build(os.path.join(parent, "path_tracer_tpu_torch",
                                          "csrc", "portal_resolve.cu")))

    def launch():
        return pk.trace_resolve_pool(ks, pool, library=lib, **kw)
    return launch, lib


# The design's parts, switched on in turn (csrc/portal_resolve.cu's -D
# choices), and the production build's neighbours
PARTS = {
    "compact": "K3_SORT=0,K3_GROUP_ORDER=0,K3_SHARED_TABLE=0",
    "compact+sort": "K3_SHARED_TABLE=0",
    "compact+shared": "K3_SORT=0,K3_GROUP_ORDER=0",
    "production": "",
    "no group order": "K3_GROUP_ORDER=0",
    "window 512": "K3_WINDOW=512",
    "window 2048": "K3_WINDOW=2048",
    "512 threads": "K3_THREADS=512",
    "group 4": "K3_GROUP=4",
    "group 8": "K3_GROUP=8",
    "group 16": "K3_GROUP=16",
}
GROUPS = ("production", "group 4", "group 8", "group 16")


def variant_build(defines: str, fmad: bool):
    """csrc/portal_resolve.cu built with ``defines`` ("K3_THREADS=512,...")
    and bound."""
    flags = tuple(f"-D{d}" for d in defines.split(",") if d)
    return bound(kbuild.build(pk.RESOLVE_SOURCE,
                              flags + (() if fmad else ("--fmad=false",))))


def bound(built):
    """A build of csrc/portal_resolve.cu with its C interface declared."""
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return pk.bind_resolve(built)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--builds", nargs="*", default=[],
                    help="more builds to time, each a comma list of the "
                    "kernel's -D choices, e.g. K3_THREADS=512,K3_WINDOW=512")
    ap.add_argument("--scene", default="mesh",
                    help="mesh (1024x768) or mesh13k (450x300)")
    ap.add_argument("--parts-only", action="store_true",
                    help="time production, the group builds and the parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k3: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if args.scene == "mesh":
        scene = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                              os.path.join(ROOT, "meshes"))
        res = Resolution(768, 1024)
    else:
        scene = load_named_scene(args.scene)
        res = Resolution(300, 450)
    prep = prepare_render(scene, res, dev)
    ks = prep.kscene
    npix = res.num_pixels
    pool = rp.make_pool_v2(npix, rp._round_block(npix), 256, park_k=PARK_K,
                           device=dev)
    kw = dict(seed=SEED, parts=PARK_K + 1, park_k=PARK_K, max_depth=MAX_DEPTH,
              rr_start_depth=5)
    for cyc in range(3):
        pool = pk.trace_cheap_regen(prep.portal, prep.cam, pool, seed=SEED,
                                    quota=256, sample_base=0,
                                    step_cap=STEP_CAP, park_k=PARK_K,
                                    max_depth=MAX_DEPTH)[0]
        if cyc < 2:
            pool = pk.trace_resolve_pool(ks, pool, **kw)[0]

    variants = ({k: PARTS[k] for k in GROUPS} if args.parts_only
                else dict(PARTS))
    variants.update({d: d for d in args.builds})
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = {(d, fmad): ex.submit(variant_build, d, fmad)
                for d in set(variants.values()) for fmad in (True, False)}
        libs = {key: fut.result() for key, fut in futs.items()}
    configs = {}
    for name, d in list(variants.items()):
        try:
            configs[name] = pk.resolve_pool_config(ks, library=libs[d, True])
        except RuntimeError as e:  # no block of this build fits on an SM
            print(f"  {name}: not launchable ({e})")
            del variants[name]
    launches = {name: (lambda d=d: pk.trace_resolve_pool(
        ks, pool, library=libs[d, True], **kw)) for name, d in variants.items()}
    logs = {name: libs[d, True] for name, d in variants.items()}
    if args.parent:
        launches["parent"], logs["parent"] = parent_launcher(
            args.parent, ks, pool, dict(kw, seed=SEED))

    failed = False
    plain = pk.trace_resolve_pool_plain(ks, pool, **kw)
    for name, d in variants.items():
        exact = pk.trace_resolve_pool(ks, pool, library=libs[d, False], **kw)
        torch.cuda.synchronize()
        if not (torch.equal(exact[0], plain[0]) and torch.equal(exact[1], plain[1])):
            print(f"FAIL: {name} built with --fmad=false differs from the "
                  "plain version")
            failed = True
    shares = {}
    for name, fn in launches.items():
        got = fn()
        torch.cuda.synchronize()
        shares[name] = float(((got[0] - plain[0]).abs().sum(dim=0) < 1e-3)
                             .float().mean())
    times = {name: [] for name in launches}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(args.rounds):
        order = list(launches) + list(reversed(launches))
        for name in order:
            fn = launches[name]
            fn()
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / args.reps)
    items = int(plain[1].sum())
    print(f"ablate_k3: {args.scene} {res.width}x{res.height} pool, cycle 2: "
          f"{pool.shape[1]} columns, {items} live items, "
          f"{ks.tiles.shape[0]} tiles ({card()})")
    for name, ts in times.items():
        print(f"  {name:24s} {min(ts):.3f}-{max(ts):.3f} ms, columns within "
              f"1e-3 of plain {shares[name]:.5f}, "
              f"{json.dumps(configs.get(name, {}))}")
    for name, built in logs.items():
        print(f"  ptxas {name}: {' | '.join(ptxas_registers(built.log))}")
    print(json.dumps({"card": card(), "scene": args.scene, "items": items,
                      "ms": times, "configs": configs}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
