#!/usr/bin/env python3
"""K4 against the commit before its redesign, on a CUDA card, at the shape
its render launches.

The shapes: 1024x768 in Morton order, seed 7, sample base 4, at quota 64
(the one launch of a 64-spp `prim` render: pipeline.pass_size caps the
route at QUOTA_CAP_PRIM) and at quota 4, on two scenes: ``mesh`` (824
triangles; the `prim` route under PT_TPU_NO_PORTAL) and ``two-mesh``
(scripts/k4_coherence.py two_mesh_scene, 1,634 triangles, which the
default router sends to `prim`). The plain version's outputs come from
scripts/k4_coherence.py's model, which runs the plain loop and counts
its rows on the way (its useful-row shares are printed).

Builds this checkout's csrc/trace_regen_prim.cu and, with ``--parent
DIR`` (a checkout of the commit before the redesign: ``git archive
<commit> | tar -x -C DIR`` into a git-ignored directory such as _parent/),
that commit's K4, and runs both on the same pixels. This checkout's build
with --fmad=false must equal the plain version bit for bit at both quotas
on both scenes; both default builds must count exactly the quota, and
this checkout's keep 99.5% of pixels within 1e-3 at quota 4 and, at both
quotas, no fewer than the parent's default build. The script fails
otherwise. Times both (CUDA events, warm, ``--reps`` launches at quota 64
and 10x that at quota 4, in turns over ``--rounds`` rounds, forward and
back) and prints their launch configuration and the schedule model's
numbers (scripts/k4_coherence.py ``scheduled`` at quota 4 on this card's
resident blocks: the kernel's warp queries, and the sorted lane groups
they replaced). With --parent it also compares the SASS (cuobjdump) of
the other kernels that include csrc/isect_full.cuh or common.cuh with the
parent's builds (scripts/ablate_k1.py GUARDED: K2);
``--fingerprints PATH`` writes the parent's as the fixture of
tests/test_torch_cuda.py (tests/golden/gpu/k1_shared_sass.json).
``--quick`` runs the plain version at quota 4 only; ``--check-only``
builds and checks without timing. ~10 min on an H100 with --parent (the
plain version at quota 64 is ~2 min on mesh, ~4 on two-mesh).

  python3 scripts/ablate_k4.py [--parent DIR] [--scenes mesh two-mesh]
      [--reps 2] [--rounds 2] [--quick] [--check-only] [--fingerprints PATH]
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

from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.render.pipeline import (  # noqa: E402
    morton_pixel_order, prepare_render,
)
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402

QUOTA, SMALL_QUOTA = 64, 4
LANE_FRAC = 0.995
CSRC = os.path.join("path_tracer_tpu_torch", "csrc")


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COH = script("k4_coherence")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def parent_launcher(parent: str, ks, cam, pix, kw):
    """One launch of the parent commit's K4 (its pt_trace_regen_prim: the
    32-float rows through the read-only path, one thread a pixel)."""
    built = kbuild.build(os.path.join(parent, CSRC, "trace_regen_prim.cu"))
    fn = built.lib.pt_trace_regen_prim
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    n = pix.shape[0]
    params = cam.params.to(torch.float32).contiguous()

    def run():
        rad = torch.empty((n, 3), dtype=torch.float32, device=pix.device)
        segs = torch.empty(n, dtype=torch.int32, device=pix.device)
        done = torch.empty(n, dtype=torch.int32, device=pix.device)
        code = fn(*tk._scene_args(ks), params.data_ptr(), cam.width,
                  cam.height, pix.data_ptr(), n, kw["seed"],
                  kw["sample_base"], kw["quota"], 12, 5, None,
                  rad.data_ptr(), segs.data_ptr(), done.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        kbuild.check_launch(built, code, "parent trace_regen_prim (K4)")
        return rad, segs, done

    return run


def registers(log: str) -> list[str]:
    """The register lines of nvcc's -Xptxas -v report, one a kernel."""
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln]


def share(rad, ref) -> float:
    """The share of pixels whose radiance is within 1e-3 (|d|_1) of ref's."""
    return float(((rad - ref).abs().sum(dim=1) < 1e-3).float().mean())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--scenes", nargs="+", default=["mesh", "two-mesh"])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="the plain version at quota 4 only: at quota 64 the "
                    "builds are timed and their counts checked")
    ap.add_argument("--fingerprints", default=None,
                    help="with --parent: write the parent's SASS fingerprints "
                    "of the other kernels to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k4: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ab1 = script("ablate_k1")
    res = Resolution(768, 1024)
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(dev)
    quotas = (QUOTA, SMALL_QUOTA)
    kw = {q: dict(seed=COH.SEED, sample_base=COH.SAMPLE_BASE, quota=q)
          for q in quotas}

    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        futs = [ex.submit(tk.prim_library, f) for f in (True, False)]
        if args.parent:
            futs.append(ex.submit(kbuild.build, os.path.join(
                args.parent, CSRC, "trace_regen_prim.cu")))
            futs += [ex.submit(kbuild.build, os.path.join(root, CSRC, src), f)
                     for root in (ROOT, args.parent) for src in ab1.SHARED
                     for f in ((), ("--fmad=false",))]
        for fut in futs:
            fut.result()
    builds = ["production"] + (["parent"] if args.parent else [])

    failed = False
    calls, shares, models, configs, schedules = {}, {}, {}, {}, {}
    os.environ["PT_TPU_NO_PORTAL"] = "1"  # mesh's kscene and camera alike
    for sid in args.scenes:
        prep = prepare_render(COH.load(sid), res, dev)
        ks, cam = prep.kscene, prep.cam
        cfg = configs[sid] = tk.regen_prim_config(ks)
        # the kernel's schedule (warp queries) and the sorted lane groups it
        # replaced, on this card's resident blocks
        schedules[sid] = {heavy: COH.scheduled(
            ks, cam, pix, quota=SMALL_QUOTA, threads=cfg["threads"],
            blocks=cfg["blocks_per_sm"] * cfg["sms"], heavy=heavy)[1]
            for heavy in (1, 99)}
        for q in quotas:
            plain = None
            if not (args.quick and q == QUOTA):
                print(f"ablate_k4: {sid} quota {q}: the plain version and "
                      "the model...", flush=True)
                models[sid, q], plain = COH.model(ks, cam, pix, quota=q)
                exact = tk.trace_regen_prim(ks, cam, pix, fmad=False, **kw[q])
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(exact, plain)):
                    print(f"FAIL: {sid} quota {q}: the --fmad=false build "
                          "differs from the plain version")
                    failed = True
            calls["production", sid, q] = (
                lambda ks=ks, cam=cam, q=q: tk.trace_regen_prim(
                    ks, cam, pix, **kw[q]))
            if args.parent:
                calls["parent", sid, q] = parent_launcher(args.parent, ks,
                                                          cam, pix, kw[q])
            for b in builds:
                got = calls[b, sid, q]()
                torch.cuda.synchronize()
                shares[b, sid, q] = (share(got[0], plain[0]) if plain
                                     is not None else float("nan"))
                if not bool((got[2] == q).all()):
                    print(f"FAIL: {b} on {sid} at quota {q}: samples != quota")
                    failed = True
            del plain
            if (sid, q) not in models:
                continue
            if shares["production", sid, q] < LANE_FRAC and q == SMALL_QUOTA:
                print(f"FAIL: production on {sid} at quota {q}: "
                      f"{shares['production', sid, q]:.6f} of pixels within "
                      "1e-3")
                failed = True
            if args.parent and (shares["production", sid, q]
                                < shares["parent", sid, q]):
                print(f"FAIL: production on {sid} at quota {q}: "
                      f"{shares['production', sid, q]:.6f} of pixels within "
                      f"1e-3, the parent's {shares['parent', sid, q]:.6f}")
                failed = True
    if args.parent:
        print("ablate_k4: the other kernels' SASS against the parent:")
        for src in ab1.SHARED:
            for flags in ((), ("--fmad=false",)):
                a, b = (ab1.guarded_sass(kbuild.build(
                    os.path.join(root, CSRC, src), flags).path)
                        for root in (ROOT, args.parent))
                same = a == b
                print(f"  SASS {src}{' fmad=false' if flags else ''}: "
                      f"{'same' if same else 'DIFFERENT'} "
                      f"({sum(map(len, a.values()))} instructions)")
                if not same:
                    failed = True
        if args.fingerprints:
            with open(args.fingerprints, "w") as fh:
                json.dump(ab1.fingerprints(args.parent), fh, indent=1,
                          sort_keys=True)

    times = {key: [] for key in calls}
    clocks = []
    if not args.check_only:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(args.rounds):
            for key in list(calls) + list(reversed(calls)):
                fn = calls[key]
                reps = args.reps if key[2] == QUOTA else 10 * args.reps
                fn()
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                if key[2] == QUOTA:
                    clocks.append(sm_clock_mhz())  # while the launches run
                torch.cuda.synchronize()
                times[key].append(start.elapsed_time(end) / reps)
    print(f"ablate_k4: 1024x768, seed {COH.SEED}, sample base "
          f"{COH.SAMPLE_BASE} ({card()}; SM clock under load "
          f"{min(clocks, default=0):.0f}-{max(clocks, default=0):.0f} MHz)")
    for sid in args.scenes:
        for q in quotas:
            m = models.get((sid, q))
            if m:
                print(f" {sid} quota {q}: {m['segments']} segments; useful "
                      "rows one thread a pixel "
                      f"{m['thread_per_pixel']['useful_row_share']:.4f}, "
                      "sorted in chunks of 256 "
                      f"{m['chunks_of_256_sorted']['useful_row_share']:.4f}, "
                      "of 1024 "
                      f"{m['chunks_of_1024_sorted']['useful_row_share']:.4f}; "
                      f"quota tail {m['quota_tail_share']:.4f}")
            else:
                print(f" {sid} quota {q}: not checked against the plain "
                      "version (--quick)")
            for b in builds:
                t = times[b, sid, q]
                ts = f"{min(t):.3f}-{max(t):.3f} ms" if t else "not timed"
                print(f"  {b:28s} {ts}; pixels within 1e-3 "
                      f"{shares[b, sid, q]:.6f}")
        print(f"  {sid} production: {json.dumps(configs[sid])}")
        for heavy, num in schedules[sid].items():
            print(f"  {sid} schedule model at quota {SMALL_QUOTA}, "
                  f"{'warp queries' if heavy == 1 else 'sorted lane groups'}: "
                  f"useful rows {num['useful_row_share']:.4f}, a step's "
                  f"balance {num['step_balance']:.4f}, {num['steps']} steps")
    log = tk.prim_library(True).log
    print(f"  ptxas production: {' | '.join(registers(log))}")
    if args.parent:
        log = kbuild.build(os.path.join(args.parent, CSRC,
                                        "trace_regen_prim.cu")).log
        print(f"  ptxas parent: {' | '.join(registers(log))}")
    print(json.dumps({
        "card": card(), "clocks_mhz": clocks,
        "ms": {f"{k[0]} @ {k[1]} quota {k[2]}": v for k, v in times.items()},
        "shares": {f"{k[0]} @ {k[1]} quota {k[2]}": v
                   for k, v in shares.items()},
        "models": {f"{k[0]} quota {k[1]}": v for k, v in models.items()},
        "schedules": schedules, "configs": configs}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
