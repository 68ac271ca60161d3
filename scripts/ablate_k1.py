#!/usr/bin/env python3
"""K1 against the commit before its redesign, on a CUDA card, at the main
path's shape.

The shapes: cornell 1024x768 in Morton order, seed 7, sample_base 0, quota
256 (one launch of a 512-spp render's two: the main path, as chip_smoke.py
phase 3 launches it) and quota 4 (phase 3's shape before). Builds this
checkout's csrc/trace_regen.cu and, with ``--parent DIR`` (a checkout of
the commit before the redesign), that commit's K1, and runs both on the
same pixels. This checkout's build with --fmad=false must equal the plain
version bit for bit (radiance, segments, samples) at both quotas, and its
default build count exactly the quota and keep 99.5% of pixels within
1e-3 at quota 4; at quota 256, where each pixel sums 256 samples and a few
FMA-parted paths reach more pixels, its share of pixels within 1e-3 must
be no lower than the parent's default build's on the same pixels. The
script fails otherwise. Times both (CUDA events, warm, ``--reps`` launches
at quota 256 and 20x that at quota 4, in turns over ``--rounds`` rounds,
forward and back) and prints, for each, its ms at both shapes, its share
of pixels within 1e-3 at both, its launch configuration (registers,
spills, resident blocks per SM, shared bytes), its SASS count a warp-step
and issue estimate (scripts/k1_sass.py weighed by scripts/k1_coherence.py's
branch shares at quota 4 and the warp-steps of the quota-256 run: a static
count, no lower bound), and the card's name, power limit and SM clock
under load. With --parent it also compares the SASS (cuobjdump) of the
kernels that must keep it with the parent's builds: K2 (portal_cheap.cu)
and K5 (trace_stepped.cu); ``--fingerprints PATH`` writes the parent's
SASS fingerprints of those and of the other kernels that include
csrc/isect_full.cuh (``FIXTURE``) as the fixture of
tests/test_torch_cuda.py (tests/golden/gpu/k1_shared_sass.json).
``--check-only`` builds, checks and counts without timing.

  python3 scripts/ablate_k1.py [--parent DIR] [--reps 3] [--rounds 2]
      [--check-only] [--fingerprints PATH]

PERF.md keeps the times of the design choices the production build was
picked from (each once a -D define of csrc/trace_regen.cu).
"""

import argparse
import concurrent.futures
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import path_tracer_tpu_torch as pt  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_v2 as tv2  # noqa: E402
from path_tracer_tpu_torch.render.pipeline import (  # noqa: E402
    morton_pixel_order, prepare_scene,
)
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402

SEED, QUOTA, SMALL_QUOTA = 7, 256, 4
CSRC = os.path.join("path_tracer_tpu_torch", "csrc")
# the kernel that shares common.cuh with K1 and must keep the parent's
# SASS, and its source: K2 (portal_cheap.cu). K3, K4, K5, K6, K7 and K8
# were redesigned after K1 and compile to SASS of their own
# (scripts/ablate_k{3,4,5,6,7,8}.py).
SHARED = ("portal_cheap.cu",)
GUARDED = re.compile(r"cheap_regen_kernel")
# the kernels of the fixture tests/golden/gpu/k1_shared_sass.json, by
# source: the GUARDED ones, and every kernel of the sources other than K4's
# that include csrc/isect_full.cuh (K3; K5-K7 and K9), which K4's group
# level had to leave as they were
FIXTURE = {"portal_cheap.cu": GUARDED, "portal_resolve.cu": re.compile(""),
           "trace_stepped.cu": re.compile("")}


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def max_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def parent_launcher(parent: str, scene, cam, pix, quota: int):
    """One launch of the parent commit's K1 (its pt_trace_regen takes the
    rows and gates on the device)."""
    built = kbuild.build(os.path.join(parent, CSRC, "trace_regen.cu"))
    fn = built.lib.pt_trace_regen
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    n = pix.shape[0]
    params = cam.params.contiguous()

    def run():
        rad = torch.empty((n, 3), dtype=torch.float32, device=pix.device)
        segs = torch.empty(n, dtype=torch.int32, device=pix.device)
        done = torch.empty(n, dtype=torch.int32, device=pix.device)
        code = fn(scene.prims.data_ptr(), scene.prims.shape[0],
                  scene.gates.data_ptr() if scene.gates.numel() else None,
                  scene.gates.shape[0], params.data_ptr(), cam.width,
                  cam.height, pix.data_ptr(), n, SEED, 0, quota, 12, 5, None,
                  rad.data_ptr(), segs.data_ptr(), done.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        kbuild.check_launch(built, code, "parent trace_regen (K1)")
        return rad, segs, done

    return run, built


def sass(path: str) -> dict[str, list[str]]:
    """Each kernel's SASS instructions (cuobjdump), addresses dropped and
    kernel-parameter offsets masked, by the kernel's mangled name with the
    path hashes of an anonymous namespace dropped."""
    dump = subprocess.run(
        [os.path.join(os.path.dirname(kbuild.find_nvcc()), "cuobjdump"),
         "-sass", path], capture_output=True, text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    cur = None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[-1].strip()
            # an anonymous namespace's name carries hashes of the file's path
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_[0-9a-f]{8}(?=\d)",
                          "_GLOBAL__N_", name)
            cur = out.setdefault(name, [])
        elif cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", line).split(";")[0]
            cur.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][param]", ins))
    return out


def guarded_sass(path: str) -> dict[str, list[str]]:
    """``sass`` of the GUARDED kernels of a build."""
    return {fn: ins for fn, ins in sass(path).items() if GUARDED.search(fn)}


def compare_sass(parent: str) -> bool:
    """The GUARDED kernels, here and in the parent's builds, with and
    without FMA contraction."""
    same = True
    for src in SHARED:
        for flags in ((), ("--fmad=false",)):
            a, b = (guarded_sass(kbuild.build(os.path.join(root, CSRC, src),
                                              flags).path)
                    for root in (ROOT, parent))
            for fn in sorted(set(a) | set(b)):
                x, y = a.get(fn, []), b.get(fn, [])
                equal = x == y
                same &= equal
                short = re.search(r"\d([a-z_]+_kernel\w*?)(?:E|I|P|v|$)", fn)
                print(f"  SASS {src}{' fmad=false' if flags else ''} "
                      f"{short.group(1) if short else fn}: {len(x)} "
                      f"instructions here, {len(y)} in the parent build: "
                      f"{'same' if equal else 'DIFFERENT'}")
    return same


def nvcc_release() -> str:
    """The last line of ``nvcc --version``: the toolkit's release."""
    version = subprocess.run([kbuild.find_nvcc(), "--version"],
                             capture_output=True, text=True, check=True).stdout
    return version.strip().splitlines()[-1]


def fingerprints(root: str) -> dict:
    """The nvcc release and a sha256 of each FIXTURE kernel's SASS (as
    ``sass`` gives it) in root's builds, with and without FMA contraction:
    the fixture tests/golden/gpu/k1_shared_sass.json holds a parent
    commit's. A change that rightly alters one of these kernels writes the
    fixture anew from its own builds once they are checked:
    ``--parent . --check-only --fingerprints PATH``."""
    kernels = {}
    for src, pattern in FIXTURE.items():
        for flags in ((), ("--fmad=false",)):
            built = kbuild.build(os.path.join(root, CSRC, src), flags)
            for fn, ins in sass(built.path).items():
                if pattern.search(fn):
                    key = f"{src}{' fmad=false' if flags else ''} {fn}"
                    kernels[key] = hashlib.sha256("\n".join(ins).encode()).hexdigest()
    return {"nvcc": nvcc_release(), "kernels": kernels}


def share(rad, ref) -> float:
    """The share of pixels whose radiance is within 1e-3 (|d|_1) of ref's."""
    return float(((rad - ref).abs().sum(dim=1) < 1e-3).float().mean())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--fingerprints", default=None,
                    help="with --parent: write the parent's SASS fingerprints "
                    "of the shared kernels to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k1: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    k1s, coh = script("k1_sass"), script("k1_coherence")
    scene = pt.load_scene("cornell", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    res = Resolution(768, 1024)
    scene_c, cam_c = prepare_scene(scene, res, dev)
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(dev)
    quotas = (QUOTA, SMALL_QUOTA)
    kw = {q: dict(seed=SEED, sample_base=0, quota=q) for q in quotas}

    builds = ["production"] + (["parent"] if args.parent else [])
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        libs = [ex.submit(tv2.regen_library, f) for f in (True, False)]
        counted = {"production": ex.submit(k1s.report, ROOT)}
        if args.parent:
            counted["parent"] = ex.submit(k1s.report, args.parent)
            shared = [ex.submit(kbuild.build, os.path.join(root, CSRC, src), f)
                      for root in (ROOT, args.parent) for src in SHARED
                      for f in ((), ("--fmad=false",))]
            for fut in shared:
                fut.result()
        for fut in libs:
            fut.result()
        counted = {b: fut.result() for b, fut in counted.items()}
    failed = False
    model, plain_small = coh.model(scene_c, cam_c, pix, **kw[SMALL_QUOTA])
    print("ablate_k1: plain version at quota 256 (the bit-exact reference)...",
          flush=True)
    plain = {QUOTA: tv2.trace_regen_plain(scene_c, cam_c, pix, **kw[QUOTA]),
             SMALL_QUOTA: plain_small}
    segs = plain[QUOTA][1].to(torch.int64)
    n_w = -(-pix.shape[0] // 32)
    segs_w = torch.cat([segs, segs.new_zeros(n_w * 32 - segs.shape[0])])
    warp_steps = int(segs_w.view(n_w, 32).max(dim=1).values.sum())
    segments = int(segs.sum())
    configs = {"production": tv2.regen_config(scene_c)}
    calls, shares = {}, {}
    for q in quotas:
        exact = tv2.trace_regen(scene_c, cam_c, pix, fmad=False, **kw[q])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(exact, plain[q])):
            print(f"FAIL: the --fmad=false build differs from the plain "
                  f"version at quota {q}")
            failed = True
        calls["production", q] = (lambda q=q: tv2.trace_regen(
            scene_c, cam_c, pix, **kw[q]))
        if args.parent:
            calls["parent", q], _ = parent_launcher(args.parent, scene_c,
                                                    cam_c, pix, q)
        for b in builds:
            got = calls[b, q]()
            torch.cuda.synchronize()
            shares[b, q] = share(got[0], plain[q][0])
            if not bool((got[2] == q).all()):
                print(f"FAIL: {b} at quota {q}: samples != quota")
                failed = True
    if shares["production", SMALL_QUOTA] < 0.995:
        print(f"FAIL: production at quota {SMALL_QUOTA}: "
              f"{shares['production', SMALL_QUOTA]:.5f} of pixels within 1e-3")
        failed = True
    if args.parent:
        if shares["production", QUOTA] < shares["parent", QUOTA]:
            print(f"FAIL: production at quota {QUOTA}: "
                  f"{shares['production', QUOTA]:.5f} of pixels within 1e-3, "
                  f"the parent's {shares['parent', QUOTA]:.5f}")
            failed = True
        print("ablate_k1: kernels that share common.cuh, against the parent:")
        if not compare_sass(args.parent):
            print("FAIL: a shared kernel's SASS changed")
            failed = True
        if args.fingerprints:
            with open(args.fingerprints, "w") as fh:
                json.dump(fingerprints(args.parent), fh, indent=1,
                          sort_keys=True)

    times = {key: [] for key in calls}
    clocks = []
    if not args.check_only:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(args.rounds):
            for key in list(calls) + list(reversed(calls)):
                fn = calls[key]
                reps = args.reps if key[1] == QUOTA else 20 * args.reps
                fn()
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                if key[1] == QUOTA:
                    clocks.append(sm_clock_mhz())  # while the launches run
                torch.cuda.synchronize()
                times[key].append(start.elapsed_time(end) / reps)
    # the SM clock under load; without a timed run, the card's maximum
    clock = float(np.median(clocks)) if clocks else max_clock_mhz()
    estimates = {}
    for b, rep in counted.items():
        step = k1s.per_warp_step(rep, model)
        estimates[b] = {
            "per_warp_step": round(step["total"], 1),
            "per_segment": round(step["total"] * warp_steps / (segments / 32), 1),
            "issue_estimate_ms": k1s.issue_estimate_ms(step["total"],
                                                       warp_steps, clock)}
    print(f"ablate_k1: cornell {res.width}x{res.height}, quota {QUOTA}: "
          f"{segments} segments, {warp_steps} warp-steps; quota {SMALL_QUOTA}: "
          f"{int(plain_small[1].sum())} segments ({card()}, SM clock "
          f"{clock:.0f} MHz {'under load' if clocks else '(maximum)'})")
    for b in builds:
        ts = "; ".join(
            f"quota {q} {min(times[b, q]):.3f}-{max(times[b, q]):.3f} ms"
            if times[b, q] else f"quota {q} not timed" for q in quotas)
        sh = ", ".join(f"{shares[b, q]:.5f} at quota {q}" for q in quotas)
        print(f"  {b:10s} {ts}; pixels within 1e-3 {sh}; SASS "
              f"{counted[b]['instructions']} instructions, "
              f"{estimates[b]['per_warp_step']} a warp-step, issue estimate "
              f"{estimates[b]['issue_estimate_ms']:.2f} ms; "
              f"{json.dumps(configs.get(b))}")
        print(f"  ptxas {b}: {' | '.join(counted[b]['ptxas'])}")
    print(json.dumps({
        "card": card(), "clock_mhz": clock, "segments": segments,
        "warp_steps": warp_steps,
        "ms": {f"{k[0]} @ quota {k[1]}": x for k, x in times.items()},
        "shares": {f"{k[0]} @ quota {k[1]}": x for k, x in shares.items()},
        "configs": configs, "estimates": estimates, "model_quota4": model,
        "sass": {b: {"instructions": r["instructions"],
                     "production_instructions": r["production_instructions"],
                     "same_opcodes": r["lineinfo_build_same_opcodes"],
                     "parts": r["parts"], "ptxas": r["ptxas"]}
                 for b, r in counted.items()}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
