#!/usr/bin/env python3
"""K4 against another checkout's K4, on a CUDA card, at the shapes its
renders launch.

The shapes: ``mesh`` (824 triangles; the `prim` route under
PT_TPU_NO_PORTAL) and ``two-mesh`` (scripts/k4_coherence.py
two_mesh_scene, 1,634 triangles, which the default router sends to
`prim`), both on shared rows, at 1024x768 in Morton order, seed 7, sample
base 4, at quota 64 (the one launch of a 64-spp `prim` render:
pipeline.pass_size caps the route at QUOTA_CAP_PRIM) and at quota 4; and
``panda_arm`` (the benchmark's configuration: 133,768 rows in 2,090
tiles, on the read-only path) at its cell's 450x300 in Morton order, seed
7, as a 100-spp render launches it: quota 64 at sample base 0, then 36 at
64, timed together. The plain version's outputs on mesh and two-mesh come
from scripts/k4_coherence.py's model, which runs the plain loop and counts
its rows on the way (its useful-row shares are printed); panda_arm's plain
version at that shape takes hours, so there the two builds are held to
each other.

Builds this checkout's csrc/trace_regen_prim.cu and, with ``--parent
DIR`` (a checkout of the commit before this one's K4 change: ``git
archive <commit> | tar -x -C DIR`` into a git-ignored directory such as
_parent/; its pt_trace_regen_prim takes no hit_tiles), that commit's K4,
and runs both on the same pixels. This checkout's build with --fmad=false
must equal the plain version bit for bit at both quotas on mesh and
two-mesh; every default build must count exactly the quota, and this
checkout's keep 99.5% of pixels within 1e-3 at quota 4 and, at both
quotas, no fewer than the parent's default build; on panda_arm this
checkout's default build must equal the parent's bit for bit, with its
four counters (``trace_kernel.WORK_KEYS``) equal. The script fails
otherwise. Times the builds (CUDA events, warm, ``--reps`` calls at quota
64 and on panda_arm and 10x that at quota 4, in turns over ``--rounds``
rounds, forward and back) and prints their launch configuration, ptxas's
registers, stacks and spills of both instantiations (SharedRows,
GlobalRows), K4's ns a segment and the schedule model's numbers
(scripts/k4_coherence.py ``scheduled`` at quota 4 on this card's resident
blocks: the kernel's warp queries, and the sorted lane groups they
replaced). ``--rows-twice`` also builds each K4 with its warp queries'
tile rows tested twice (a copy of the sources with warp_tiles' row call
repeated: the second pass finds nothing strictly closer, so the outputs
must equal the single build's) and prints the rows' share of K4's time,
(twice - once) / once. With --parent it also compares the SASS
(cuobjdump) with the parent's builds: of K4's SharedRows instantiation
and of the other sources that include csrc/isect_full.cuh (K3, K5-K7,
K9) or common.cuh (scripts/ablate_k1.py GUARDED: K2);
``--fingerprints PATH`` writes the parent's as the fixture of
tests/test_torch_cuda.py (tests/golden/gpu/k1_shared_sass.json).
``--quick`` runs the plain version at quota 4 only; ``--check-only``
builds and checks without timing. ~12 min on an H100 with --parent (the
plain version at quota 64 is ~2 min on mesh, ~4 on two-mesh; a panda_arm
call of the parent's K4 ~3.8 s).

  python3 scripts/ablate_k4.py [--parent DIR] [--scenes mesh two-mesh
      panda_arm] [--reps 2] [--rounds 2] [--rows-twice] [--quick]
      [--check-only] [--fingerprints PATH]
"""

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import path_tracer_tpu_torch as tpt  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.render.pipeline import (  # noqa: E402
    morton_pixel_order, prepare_render,
)
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402

QUOTA, SMALL_QUOTA = 64, 4
LANE_FRAC = 0.995
CSRC = os.path.join("path_tracer_tpu_torch", "csrc")
PANDA = "panda_arm"
PANDA_RES = Resolution(300, 450)
PANDA_PASSES = ((0, 64), (64, 36))  # (sample base, quota): a 100-spp render
# the other sources whose SASS K4's change must leave as it was
OTHERS = ("portal_resolve.cu", "trace_stepped.cu")


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


def rows_twice(root: str) -> str:
    """A copy of root's csrc (in a temporary directory) whose K4 tests each
    tile a warp query enters twice: warp_tiles' row call repeated. Returns
    the copy's trace_regen_prim.cu."""
    out = tempfile.mkdtemp(prefix="ablate_k4_rows2_")
    for name in os.listdir(os.path.join(root, CSRC)):
        if name.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(root, CSRC, name), out)
    path = os.path.join(out, "isect_full.cuh")
    with open(path) as fh:
        src = fh.read()
    at = src.index("void warp_tiles(")
    call = re.compile(r"\b(?:warp_rows|warp_tile)<R, Ops>\([^;]*\);").search(src, at)
    src = src[:call.end()] + "\n      " + call.group(0) + src[call.end():]
    with open(path, "w") as fh:
        fh.write(src)
    return os.path.join(out, "trace_regen_prim.cu")


def bind(built, hit_tiles: bool):
    """A call of ``built``'s pt_trace_regen_prim: this checkout's arguments
    (``hit_tiles``) or the parent commit's, which take no hit_tiles. The
    call takes (ks, cam, pix, kw, work) and returns (rad, segs, done)."""
    fn = built.lib.pt_trace_regen_prim
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p] + [ctypes.c_void_p] * hit_tiles
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7)
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]

    def run(ks, cam, pix, kw, work=None):
        n, dev = pix.shape[0], pix.device
        rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
        segs = torch.empty(n, dtype=torch.int32, device=dev)
        done = torch.empty(n, dtype=torch.int32, device=dev)
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        params = cam.params.to(torch.float32).contiguous()
        global_tiles = ks.tiles.shape[0] and not tk.k4_shared_table(ks)
        tiles = [tk._ptr(ks.hit_tiles) if global_tiles else None] * hit_tiles
        code = fn(*tk._prim_scene_args(ks, tk.K4_SHARED_BUDGET),
                  tk._ptr(ks.tile_groups), *tiles, params.data_ptr(),
                  cam.width, cam.height, pix.data_ptr(), n, kw["seed"],
                  kw["sample_base"], kw["quota"], 12, 5, None,
                  rad.data_ptr(), segs.data_ptr(), done.data_ptr(),
                  nxt.data_ptr(), tk._ptr(work),
                  torch.cuda.current_stream().cuda_stream)
        kbuild.check_launch(built, code, "trace_regen_prim (K4)")
        return rad, segs, done

    return run


def ptxas(log: str) -> list[str]:
    """Each kernel's registers, stack and spills from nvcc's -Xptxas -v
    report: "<instantiation>: <stack line>; <registers line>"."""
    out, name, stack = [], "", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ("SharedRows" if "SharedRows" in ln else
                    "GlobalRows" if "GlobalRows" in ln else ln.split("'")[1])
        elif "stack frame" in ln:
            stack = ln.strip()
        elif "registers" in ln:
            out.append(f"{name}: {stack}; {ln.split(':', 1)[-1].strip()}")
    return out


def share(rad, ref) -> float:
    """The share of pixels whose radiance is within 1e-3 (|d|_1) of ref's."""
    return float(((rad - ref).abs().sum(dim=1) < 1e-3).float().mean())


def panda_case(dev):
    """The benchmark's panda_arm configuration at its cell's shape: (kernel
    scene, camera, Morton pixel order)."""
    path = os.path.join(ROOT, "bench_torch", "configs", PANDA, f"{PANDA}.json")
    with open(path) as fh:
        scene = tpt.SceneDescriptor.from_json_dict(
            json.load(fh), base_dir=os.path.dirname(path))
    prep = prepare_render(scene, PANDA_RES, dev)
    pix = morton_pixel_order(PANDA_RES.width, PANDA_RES.height)[0]
    return prep.kscene, prep.cam, torch.from_numpy(pix).to(dev)


def passes(run):
    """A panda_arm render's two launches by ``run(kw, work)``: the outputs
    of both, concatenated, and K4's four counters over both."""
    work = torch.zeros(len(tk.WORK_KEYS), dtype=torch.int64, device="cuda")
    outs = [run(dict(seed=COH.SEED, sample_base=b, quota=q), work)
            for b, q in PANDA_PASSES]
    return tuple(torch.cat(x) for x in zip(*outs)), work


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--scenes", nargs="+", default=["mesh", "two-mesh", PANDA])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--rows-twice", action="store_true",
                    help="also time builds that test each warp query's tile "
                    "rows twice: the rows' share of K4")
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

    roots = {"production": ROOT}
    if args.parent:
        roots["parent"] = args.parent
    sources = {b: os.path.join(root, CSRC, "trace_regen_prim.cu")
               for b, root in roots.items()}
    if args.rows_twice:
        sources.update({f"{b} rows x2": rows_twice(root)
                        for b, root in roots.items()})
    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        futs = [ex.submit(tk.prim_library, f) for f in (True, False)]
        futs += [ex.submit(kbuild.load_kernel, src) for src in sources.values()]
        if args.parent:
            futs += [ex.submit(kbuild.build, os.path.join(root, CSRC, src), f)
                     for root in (ROOT, args.parent)
                     for src in ab1.SHARED + OTHERS + ("trace_regen_prim.cu",)
                     for f in ((), ("--fmad=false",))]
        for fut in futs:
            fut.result()
    # each build's call (ks, cam, pix, kw, work) -> (rad, segs, done)
    runs = {b: bind(kbuild.load_kernel(src), not b.startswith("parent"))
            for b, src in sources.items()}
    runs["production"] = (lambda ks, cam, pix, kw, work=None:
                          tk.trace_regen_prim(ks, cam, pix, work=work, **kw))
    builds = list(sources)
    single = {b: b.split()[0] for b in builds}  # a rows-x2 build's own

    failed = False
    calls, shares, models, configs, schedules = {}, {}, {}, {}, {}
    segments, counters = {}, {}
    os.environ["PT_TPU_NO_PORTAL"] = "1"  # mesh's kscene and camera alike
    for sid in args.scenes:
        if sid == PANDA:
            ks, cam, ppix = panda_case(dev)
            configs[sid] = tk.regen_prim_config(ks)
            got = {}
            for b in builds:
                calls[b, sid, "render"] = (
                    lambda run=runs[b], ks=ks, cam=cam, ppix=ppix: passes(
                        lambda kw_, work: run(ks, cam, ppix, kw_, work)))
                got[b] = calls[b, sid, "render"]()
                torch.cuda.synchronize()
            out, work = got["production"]
            segments[sid] = int(out[1].sum())
            counters[sid] = dict(zip(tk.WORK_KEYS, work.tolist()))
            want = sum(q for _, q in PANDA_PASSES)
            if not bool((out[2].view(2, -1).sum(0) == want).all()):
                print(f"FAIL: production on {sid}: samples != {want}")
                failed = True
            for b in builds[1:]:
                o, w = got[b]
                if not (all(torch.equal(x, y) for x, y in zip(o, out))
                        and torch.equal(w, work)):
                    print(f"FAIL: {b} on {sid}: outputs or counters differ "
                          "from production's")
                    failed = True
            del got
            continue
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
            got = {}
            for b in builds:
                calls[b, sid, q] = (lambda run=runs[b], ks=ks, cam=cam, q=q:
                                    run(ks, cam, pix, kw[q]))
                got[b] = calls[b, sid, q]()
                torch.cuda.synchronize()
                shares[b, sid, q] = (share(got[b][0], plain[0]) if plain
                                     is not None else float("nan"))
                if not bool((got[b][2] == q).all()):
                    print(f"FAIL: {b} on {sid} at quota {q}: samples != quota")
                    failed = True
            if q == QUOTA:
                segments[sid] = int(got["production"][1].sum())
            for b in builds:
                if b != single[b] and not all(torch.equal(x, y) for x, y in
                                              zip(got[b], got[single[b]])):
                    print(f"FAIL: {b} on {sid} at quota {q}: not the single "
                          "build's outputs")
                    failed = True
            if "parent" in got and not all(torch.equal(x, y) for x, y in
                                           zip(got["parent"], got["production"])):
                print(f"FAIL: production on {sid} at quota {q}: not the "
                      "parent's outputs (shared rows)")
                failed = True
            del plain, got
            if (sid, q) not in models:
                continue
            if shares["production", sid, q] < LANE_FRAC and q == SMALL_QUOTA:
                print(f"FAIL: production on {sid} at quota {q}: "
                      f"{shares['production', sid, q]:.6f} of pixels within "
                      "1e-3")
                failed = True
    if args.parent:
        print("ablate_k4: SASS against the parent's builds:")
        for src in ab1.SHARED + OTHERS + ("trace_regen_prim.cu",):
            for flags in ((), ("--fmad=false",)):
                a, b = (ab1.sass(kbuild.build(
                    os.path.join(root, CSRC, src), flags).path)
                        for root in (ROOT, args.parent))
                if src in ab1.SHARED:
                    keep = ab1.GUARDED
                elif src in OTHERS:
                    keep = re.compile("")
                else:
                    keep = re.compile("SharedRows")
                for fn in sorted(f for f in set(a) | set(b) if keep.search(f)):
                    same = a.get(fn) == b.get(fn)
                    print(f"  SASS {src}{' fmad=false' if flags else ''} "
                          f"{fn}: {'same' if same else 'DIFFERENT'} "
                          f"({len(a.get(fn, []))} instructions)")
                    failed |= not same
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
                reps = 10 * args.reps if key[2] == SMALL_QUOTA else args.reps
                fn()
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                if key[2] != SMALL_QUOTA:
                    clocks.append(sm_clock_mhz())  # while the launches run
                torch.cuda.synchronize()
                times[key].append(start.elapsed_time(end) / reps)
    print(f"ablate_k4: seed {COH.SEED} ({card()}; SM clock under load "
          f"{min(clocks, default=0):.0f}-{max(clocks, default=0):.0f} MHz)")
    for sid in args.scenes:
        shape = ((f"{PANDA_RES.width}x{PANDA_RES.height}, a render's "
                  f"launches {PANDA_PASSES}") if sid == PANDA else
                 f"1024x768, sample base {COH.SAMPLE_BASE}")
        print(f" {sid} ({shape}): {segments.get(sid)} segments at "
              f"{'the render' if sid == PANDA else f'quota {QUOTA}'}")
        for q in (("render",) if sid == PANDA else quotas):
            m = models.get((sid, q))
            if m:
                print(f"  quota {q}: {m['segments']} segments; useful "
                      "rows one thread a pixel "
                      f"{m['thread_per_pixel']['useful_row_share']:.4f}, "
                      "sorted in chunks of 256 "
                      f"{m['chunks_of_256_sorted']['useful_row_share']:.4f}, "
                      "of 1024 "
                      f"{m['chunks_of_1024_sorted']['useful_row_share']:.4f}; "
                      f"quota tail {m['quota_tail_share']:.4f}")
            elif sid != PANDA:
                print(f"  quota {q}: not checked against the plain version "
                      "(--quick)")
            for b in builds:
                t = times[b, sid, q]
                ts = f"{min(t):.3f}-{max(t):.3f} ms" if t else "not timed"
                ns = (f"; {min(t) * 1e6 / segments[sid]:.3f} ns a segment"
                      if t and q in (QUOTA, "render") else "")
                px = ("" if sid == PANDA else
                      f"; pixels within 1e-3 {shares[b, sid, q]:.6f}")
                print(f"  {q} {b:22s} {ts}{ns}{px}")
            for b in builds:
                if b != single[b] and times[b, sid, q]:
                    once = min(times[single[b], sid, q])
                    print(f"  {q} {single[b]} rows' share of K4: "
                          f"{(min(times[b, sid, q]) - once) / once:.4f}")
        print(f"  {sid} production: {json.dumps(configs[sid])}")
        if sid in counters:
            print(f"  {sid} counters over the render: {json.dumps(counters[sid])}")
        for heavy, num in schedules.get(sid, {}).items():
            print(f"  {sid} schedule model at quota {SMALL_QUOTA}, "
                  f"{'warp queries' if heavy == 1 else 'sorted lane groups'}: "
                  f"useful rows {num['useful_row_share']:.4f}, a step's "
                  f"balance {num['step_balance']:.4f}, {num['steps']} steps")
    for b in ("production", "parent"):
        if b in sources:
            print(f"  ptxas {b}: "
                  f"{' | '.join(ptxas(kbuild.load_kernel(sources[b]).log))}")
    print(json.dumps({
        "card": card(), "clocks_mhz": clocks,
        "ms": {f"{k[0]} @ {k[1]} {k[2]}": v for k, v in times.items()},
        "shares": {f"{k[0]} @ {k[1]} quota {k[2]}": v
                   for k, v in shares.items()},
        "segments": segments, "counters": counters,
        "models": {f"{k[0]} quota {k[1]}": v for k, v in models.items()},
        "schedules": schedules, "configs": configs}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
