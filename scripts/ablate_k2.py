#!/usr/bin/env python3
"""K2's design parts timed one by one on a CUDA card, on one pool.

Builds K2's input pool on cycle ``--cycle`` (default 2) of a fresh mesh
1024x768 drive (park depth 3, step cap 64, seed 7, quota 256;
chip_smoke.py's phase 3 shape) with the kernels, then times
csrc/portal_cheap.cu's launch (CUDA events, warm, ``--reps`` launches, in
turns over ``--rounds`` rounds) built with each of its build-time -D
choices (VARIANTS below: the refill threshold K2_REFILL_MIN, whether a
refilled slot's loads overlap the other lanes' step, where the parked
paths live, the block size, a register cap), any --builds
given and, with ``--parent DIR`` (a checkout of the commit before the
redesign), that commit's one-thread-a-slot kernel on the same pool. Every
build with --fmad=false must equal the plain version bit for bit (a
slot's arithmetic does not depend on the lane that runs it); the script
fails otherwise, and reports each default build's share of slots within
1e-3 of it. Prints each variant's ms, its launch configuration (registers,
spills, resident blocks per SM), the model's lane share for its schedule
(scripts/k2_coherence.py) and the card's name and power limit.

  python3 scripts/ablate_k2.py [--parent DIR] [--builds K2_REFILL_MIN=2 ...]
      [--reps 10] [--rounds 2] [--cycle 2]
"""

import argparse
import concurrent.futures
import ctypes
import importlib.util
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

PARK_K, STEP_CAP, SEED, MAX_DEPTH, QUOTA = 3, 64, 7, 12, 256

# The design's choices (csrc/portal_cheap.cu's -D defines), each against
# the production build
VARIANTS = {
    "production": "",
    "refill at once": "K2_REFILL_MIN=1",
    "refill at 2 idle": "K2_REFILL_MIN=2",
    "refill at 8 idle": "K2_REFILL_MIN=8",
    "refill at 16 idle": "K2_REFILL_MIN=16",
    "refill when all 32 idle": "K2_REFILL_MIN=32",
    "check a refilled slot after the step": "K2_OVERLAP_LOAD=1",
    "parked paths in shared memory": "K2_BUFS=1",
    "parked paths in device memory": "K2_BUFS=2",
    "256 threads": "K2_THREADS=256",
    "5 blocks an SM (96 registers)": "K2_MIN_BLOCKS=5",
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_registers(log: str) -> list[str]:
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln]


def variant_build(d: str, fmad: bool):
    """csrc/portal_cheap.cu built with the defines ``d`` ("K2_THREADS=256,
    ...") and bound."""
    flags = tuple(f"-D{x}" for x in d.split(",") if x)
    built = kbuild.build(pk.CHEAP_SOURCE,
                         flags + (() if fmad else ("--fmad=false",)))
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return pk.bind_cheap(built)


def parent_launcher(parent: str, pc, cam, pool, cheap):
    """A launch of the parent commit's K2 (its pt_cheap_regen signature,
    without the slot counter)."""
    built = kbuild.build(os.path.join(parent, "path_tracer_tpu_torch", "csrc",
                                      "portal_cheap.cu"))
    fn = built.lib.pt_cheap_regen
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    n = pool.shape[1]
    out = torch.empty_like(pool)
    counts = torch.empty(n, dtype=torch.int32, device=pool.device)
    cam_params = cam.params.to(torch.float32).contiguous()
    aabb = torch.tensor(pc.aabb(), dtype=torch.float32)
    steps = pk.cheap_steps(cheap["quota"], cheap["step_cap"], cheap["max_depth"])

    def launch():
        code = fn(pc.scene.prims.data_ptr(), pc.scene.prims.shape[0],
                  pk._ptr(pc.scene.gates), pc.scene.gates.shape[0],
                  cam_params.data_ptr(), cam.width, cam.height, aabb.data_ptr(),
                  pool.data_ptr(), out.data_ptr(), n, cheap["park_k"],
                  cheap["seed"], cheap["sample_base"], steps,
                  cheap["max_depth"], 5, None, counts.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        kbuild.check_launch(built, code, "parent trace_cheap_regen")
        return out, counts
    return launch, built


def k2_coherence():
    spec = importlib.util.spec_from_file_location(
        "k2_coherence", os.path.join(ROOT, "scripts", "k2_coherence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cycle", type=int, default=2)
    ap.add_argument("--builds", nargs="*", default=[],
                    help="more builds to time, each a comma list of the "
                    "kernel's -D choices, e.g. K2_REFILL_MIN=2,K2_THREADS=256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k2: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    scene = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    res = Resolution(768, 1024)
    prep = prepare_render(scene, res, dev)
    pc, cam = prep.portal, prep.cam
    npix = res.num_pixels
    pool = rp.make_pool_v2(npix, rp._round_block(npix), QUOTA, park_k=PARK_K,
                           device=dev)
    cheap = dict(seed=SEED, quota=QUOTA, sample_base=0, step_cap=STEP_CAP,
                 park_k=PARK_K, max_depth=MAX_DEPTH)
    for _ in range(args.cycle):
        pool = pk.trace_cheap_regen(pc, cam, pool, **cheap)[0]
        pool = pk.trace_resolve_pool(prep.kscene, pool, seed=SEED,
                                     parts=PARK_K + 1, park_k=PARK_K,
                                     max_depth=MAX_DEPTH)[0]

    variants = dict(VARIANTS)
    variants.update({d: d for d in args.builds})
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = {(d, fmad): ex.submit(variant_build, d, fmad)
                for d in set(variants.values()) for fmad in (True, False)}
        libs = {key: fut.result() for key, fut in futs.items()}
    configs = {}
    for name, d in list(variants.items()):
        try:
            configs[name] = pk.cheap_regen_config(pc, PARK_K,
                                                  library=libs[d, True])
        except RuntimeError as e:  # no block of this build fits on an SM
            print(f"  {name}: not launchable ({e})")
            del variants[name]
    launches = {name: (lambda d=d: pk.trace_cheap_regen(
        pc, cam, pool, library=libs[d, True], **cheap))
        for name, d in variants.items()}
    logs = {name: libs[d, True] for name, d in variants.items()}
    if args.parent:
        launches["parent"], logs["parent"] = parent_launcher(
            args.parent, pc, cam, pool, cheap)

    failed = False
    work: dict = {}
    plain = pk.trace_cheap_regen_plain(pc, cam, pool, work=work, **cheap)
    for name, d in variants.items():
        exact = pk.trace_cheap_regen(pc, cam, pool, library=libs[d, False],
                                     **cheap)
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
    model = {}
    steps = work["slot_steps"].to(torch.int64)
    coh = k2_coherence()
    model["parent"] = coh.thread_per_slot(steps)["lane_share"]
    for name, d in variants.items():
        cfg = configs[name]
        resident = cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"]
        model[name] = coh.persistent(steps, resident,
                                     cfg["refill_min"])["lane_share"]

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
    print(f"ablate_k2: mesh 1024x768 pool, cycle {args.cycle}: {pool.shape[1]} "
          f"slots, {int(steps.sum())} slot-steps, {int(plain[1].sum())} "
          f"segments ({card()})")
    for name, ts in times.items():
        print(f"  {name:30s} {min(ts):.3f}-{max(ts):.3f} ms, slots within "
              f"1e-3 of plain {shares[name]:.5f}, model lane share "
              f"{model[name]:.4f}, {json.dumps(configs.get(name, {}))}")
    for name, built in logs.items():
        print(f"  ptxas {name}: {' | '.join(ptxas_registers(built.log))}")
    print(json.dumps({"card": card(), "slot_steps": int(steps.sum()),
                      "ms": times, "configs": configs, "model": model}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
