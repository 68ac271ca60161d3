#!/usr/bin/env python3
"""K8 against the commit before its redesign, on a CUDA card, at each vote
group.

The shape (chip_smoke.py phase 3 builds the same): a fresh 1,048,576-lane
v1 pool of mesh 1024x768 camera rays (scripts/ablate_k7.py v1_pool, the
deleted v1 scheduler's refill), seed 7, max depth 12. Builds this checkout's
csrc/portal_cheap_blocked.cu and, with ``--parent DIR`` (a checkout of the
commit before the redesign, e.g. _parent/ from ``git archive``), that
commit's K8. For each vote group of ``--groups`` this checkout's build
without FMA contraction must equal the plain version at that group bit for
bit, and the default build agree on 99.5% of the pool's columns with
segment totals within 0.5%, with both uniform sources; the script fails
otherwise.
Times each group's kernel and the parent's at its group (CUDA events over
``--reps`` launches, warm, in turns forward and back over ``--rounds``
rounds). ``--check-only`` builds and checks without timing.

  python3 scripts/ablate_k8.py [--parent DIR] [--groups 32 64 128 256]
      [--reps 20] [--rounds 2] [--check-only]

PERF.md keeps the times of the design choices K8 was picked from.
"""

import argparse
import ctypes
import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import path_tracer_tpu_torch as pt  # noqa: E402
from path_tracer_tpu_torch.ops import rng  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import portal as pk  # noqa: E402
from path_tracer_tpu_torch.render import portal as rp  # noqa: E402
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402

SEED, MAX_DEPTH = 7, 12
LANE_TOL, LANE_FRAC, SEG_TOL = 1e-3, 0.995, 0.005
PARENT_GROUP = 128  # the parent's BLOCKED_GROUP
CSRC = os.path.join("path_tracer_tpu_torch", "csrc")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def v1_pool(prep, res):
    """A fresh v1 pool as the v1 scheduler sized it, every slot a camera ray
    (scripts/ablate_k7.py v1_pool)."""
    spec = importlib.util.spec_from_file_location(
        "ablate_k7", os.path.join(ROOT, "scripts", "ablate_k7.py"))
    k7 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k7)
    npix = res.num_pixels
    lanes = min(k7.V1_POOL, rp._round_block(npix * 4))
    return k7.v1_pool(prep, npix, lanes, limit=lanes, seed=SEED)


def parent_launcher(parent: str, pc, pool):
    """One launch of the parent commit's K8 (its pt_cheap_blocked: a block
    of PARENT_GROUP threads a group, the baked rows)."""
    built = kbuild.build(os.path.join(parent, CSRC, "portal_cheap_blocked.cu"))
    fn = built.lib.pt_cheap_blocked
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    n = pool.shape[1]
    aabb = torch.tensor(pc.aabb(), dtype=torch.float32)
    out = torch.empty_like(pool)
    counts = torch.empty(n, dtype=torch.int32, device=pool.device)
    sc = pc.scene

    def run():
        code = fn(sc.prims.data_ptr(), sc.prims.shape[0], pk._ptr(sc.gates),
                  sc.gates.shape[0], aabb.data_ptr(), pool.data_ptr(),
                  out.data_ptr(), n, PARENT_GROUP, SEED & rng.MASK32,
                  MAX_DEPTH, 5, None, counts.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        kbuild.check_launch(built, code, "parent trace_cheap_blocked (K8)")
        return out, counts

    return run


def agree(tag, got, plain, exact: bool) -> tuple[bool, float]:
    """(ok, column share within LANE_TOL): bit for bit where ``exact``, else
    the share at LANE_FRAC and segment totals within SEG_TOL (FMA
    contraction parts a few paths, as chip_smoke.py allows)."""
    share = float(((got[0] - plain[0]).abs().sum(dim=0) < LANE_TOL)
                  .float().mean())
    segs, want = (int(c.sum(dtype=torch.int64)) for c in (got[1], plain[1]))
    ok = (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
          if exact else share >= LANE_FRAC and abs(segs - want) <= SEG_TOL * want)
    if not ok:
        print(f"FAIL: {tag}: {'not bit-exact' if exact else 'disagrees'} "
              f"(column share {share:.6f}, segments {segs}/{want})")
    return ok, share


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--groups", type=int, nargs="+", default=[32, 64, 128, 256])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k8: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    mesh = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                         os.path.join(ROOT, "meshes"))
    res = Resolution(768, 1024)
    prep = prepare_render(mesh, res, dev)
    pc = prep.portal
    pool = v1_pool(prep, res)
    g = np.random.default_rng(6)
    table = torch.from_numpy(g.random((4, pool.shape[1]),
                                      dtype=np.float32)).to(dev)
    failed = False
    calls, shares, frozen = {}, {}, {}
    for group in args.groups:
        for source, uni in (("counter", None), ("table", table)):
            kw = dict(seed=SEED, max_depth=MAX_DEPTH, group=group, uniforms=uni)
            plain = pk.trace_cheap_blocked_plain(pc, pool, **kw)
            for fmad in (True, False):
                got = pk.trace_cheap_blocked(pc, pool, fmad=fmad, **kw)
                torch.cuda.synchronize()
                ok, share = agree(f"group {group} fmad={fmad}/{source}", got,
                                  plain, not fmad)
                failed |= not ok
                shares[group, fmad, source] = share
            if source == "counter":
                frozen[group] = int((plain[0][pk.ROW_ALIVE] > 0).sum())
                calls[f"group {group}"] = functools.partial(
                    pk.trace_cheap_blocked, pc, pool, seed=SEED,
                    max_depth=MAX_DEPTH, group=group)
            del plain
    if args.parent:
        run = parent_launcher(args.parent, pc, pool)
        plain = pk.trace_cheap_blocked_plain(pc, pool, seed=SEED,
                                             max_depth=MAX_DEPTH,
                                             group=PARENT_GROUP)
        got = run()
        torch.cuda.synchronize()
        ok, shares["parent", True, "counter"] = agree(
            f"parent group {PARENT_GROUP}", got, plain, False)
        failed |= not ok
        calls[f"parent (group {PARENT_GROUP})"] = run

    times = {key: [] for key in calls}
    if not args.check_only:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(args.rounds):
            for key in list(calls) + list(reversed(calls)):
                fn = calls[key]
                fn()
                start.record()
                for _ in range(args.reps):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times[key].append(start.elapsed_time(end) / args.reps)
    print(f"ablate_k8: mesh 1024x768 v1 pool of {pool.shape[1]} lanes, seed "
          f"{SEED} ({card()})")
    for key, t in times.items():
        ts = f"{min(t):.4f}-{max(t):.4f} ms" if t else "not timed"
        print(f"  {key:24s} {ts}")
    log = pk.blocked_library(True).log
    print("  ptxas production: " + " | ".join(
        ln.split(":", 1)[-1].strip() for ln in log.splitlines()
        if "registers" in ln))
    print(json.dumps({
        "card": card(), "lanes": pool.shape[1], "frozen": frozen,
        "ms": times,
        "shares": {" ".join(map(str, k)): v for k, v in shares.items()}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
