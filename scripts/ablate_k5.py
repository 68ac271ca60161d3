#!/usr/bin/env python3
"""K5 against the commit before its redesign, on a CUDA card, on cornell
preview frames.

The frames (chip_smoke.py phase 3 builds the 2-spp one): cornell at
450x300 (the reference GUI's preview) x 1, 2 and 4 spp, the rays of
ProgressiveRenderer's first frame, seed 7, max depth 12. Builds this
checkout's csrc/trace_stepped.cu and, with ``--parent DIR`` (a checkout of
the commit before the redesign: ``git archive <commit> | tar -x -C DIR``
into a git-ignored directory such as _parent/), that commit's K5. On the
2-spp frame, this checkout's build without FMA contraction must equal the
plain version bit for bit (the camera entry in calls of 12 and 5 steps
with both uniform sources, given rays in calls of 12 and 5), and each
default build agree on 99.5% of rays or on no fewer than the parent's;
the script fails otherwise.

Prints each build's launch configuration (registers, spills, blocks an SM;
the parent's registers from its ptxas report and its blocks an SM by the
occupancy rule), the waves of each frame, and scripts/k5_coherence.py's
lane shares at each build's resident lanes: one thread a ray, a grid that
refills a lane as soon as its ray stops, blocks that pack their live rays
each step. Unless ``--check-only``, times each build named by ``--time``
(default both) with CUDA events over ``--reps`` runs, warm, in turns
forward and back over ``--rounds`` rounds, at each frame: the camera
entry's one 12-step launch on a state allocated once and its whole trace
(the wrapper's allocations and the radiance's transpose included, as
chip_smoke.py times it), and the given rays' whole trace (the wrapper's
state set-up included) in calls of 12 and of 5 steps. ~1 min on an H100.

  python3 scripts/ablate_k5.py [--parent DIR] [--spp 1 2 4] [--reps 20]
      [--rounds 2] [--check-only] [--time parent production]

PERF.md keeps the times of the design choices K5 was picked from (each
once a -D define).
"""

import argparse
import concurrent.futures
import ctypes
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
from path_tracer_tpu_torch.ops import rng  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_v2 as tv2  # noqa: E402
from path_tracer_tpu_torch.render import integrator  # noqa: E402
from path_tracer_tpu_torch.render.raygen import (  # noqa: E402
    camera_arrays, camera_rays, preview_cam_params,
)
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402

SEED, MAX_DEPTH, RR_START = 7, 12, 5
LANE_TOL, LANE_FRAC = 1e-3, 0.995
PARENT_THREADS = 128  # the parent's block
CSRC = os.path.join("path_tracer_tpu_torch", "csrc")


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


def ptxas(log: str, kernel: str = "trace_stepped_static_kernel") -> list[str]:
    """The register lines of ptxas's report for ``kernel``."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif "registers" in ln and name and kernel in name:
            out.append(ln.split(":", 1)[-1].strip())
    return out


def blocks_by_registers(registers: int, threads: int) -> int:
    """Resident blocks an SM of an H100 for a kernel of ``registers`` a
    thread and little shared memory: registers go to warps in units of
    256, 65,536 an SM, at most 64 warps and 32 blocks an SM."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = threads // 32
    return min(32, 65536 // (per_warp * warps), 64 // warps)


def frame(scene, spp, dev):
    res = Resolution(300, 450)
    pix, smp = integrator.pass_rays(
        torch.arange(res.num_pixels, dtype=torch.int32, device=dev), spp)
    return res, pix, smp


def parent_library(parent: str):
    """The parent commit's K5 entry: (prims, n_prims, gates, n_gates, cam,
    width, height, pixel, sample, n, seed, depth0, n_steps, max_depth,
    rr_start_depth, uniforms, state, counts, stream)."""
    built = kbuild.load_kernel(os.path.join(parent, CSRC, "trace_stepped.cu"))
    fn = built.lib.pt_trace_stepped_static
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_uint32] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4)
    return built


def launcher(built, sc, pix, smp, res, cam, uniforms, parent: bool):
    """launch(state, counts, depth0, steps, camera): one launch of a
    build's K5 over ``state`` and ``counts``."""
    fn = built.lib.pt_trace_stepped_static
    params = preview_cam_params(cam)
    scene = ((sc.prims.data_ptr(), sc.prims.shape[0], tk._ptr(sc.gates),
              sc.gates.shape[0]) if parent else tv2._stepped_scene_args(sc))

    def launch(state, counts, depth0, steps, camera):
        cam_args = (params.data_ptr(), res.width, res.height) if camera else (
            None, 0, 0)
        code = fn(*scene, *cam_args, pix.data_ptr(), smp.data_ptr(),
                  pix.shape[0], SEED & rng.MASK32, depth0, steps, MAX_DEPTH,
                  RR_START, tk._ptr(uniforms), state.data_ptr(),
                  counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
        kbuild.check_launch(built, code, "trace_stepped (K5)")

    return launch


def traces(launch, o, d, n, dev):
    """(camera(steps), given(steps)): a build's whole trace from the
    camera entry and of the given rays o, d, in calls of ``steps``, as
    (radiance, rays traced)."""

    def camera(steps):
        def start(state, counts, s):
            launch(state, counts, 0, s, True)

        return tk.call_loop(start, lambda st, c, d0, s: launch(st, c, d0, s, False),
                            n, dev, MAX_DEPTH, steps)

    def given(steps):
        return tk.stepped_trace(
            lambda st, c, d0, s: launch(st, c, d0, s, False), o, d, MAX_DEPTH,
            steps)

    return camera, given


def share(a, b) -> float:
    return float(((a - b).abs().sum(dim=1) < LANE_TOL).float().mean())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--spp", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--time", nargs="*", default=None,
                    help="time only these builds: production, parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k5: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = {("production", f): ex.submit(tk.stepped_library, f)
                for f in (True, False)}
        if args.parent:
            futs["parent", True] = ex.submit(parent_library, args.parent)
        libs = {k: v.result() for k, v in futs.items()}
    scene = pt.load_scene("cornell", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    sc = tv2.build_scene_consts(pt.pack_scene(scene)).to(dev)
    cam = camera_arrays(scene.camera)
    coh = script("k5_coherence")
    builds = ["production"] + (["parent"] if args.parent else [])
    failed = False
    configs, shares, models, waves, calls = {}, {}, {}, {}, {}
    for b in builds:
        log = libs[b, True].log
        if b == "parent":
            regs = max(int(r) for r in re.findall(r"Used (\d+) registers",
                                                   " ".join(ptxas(log))))
            configs[b] = {"registers": regs, "threads": PARENT_THREADS,
                          "blocks_per_sm": blocks_by_registers(regs, PARENT_THREADS),
                          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
                          "ptxas": ptxas(log)}
        else:
            configs[b] = dict(tv2.stepped_static_config(sc), ptxas=ptxas(log))
    for spp in args.spp:
        res, pix, smp = frame(scene, spp, dev)
        n = pix.shape[0]
        o, d = camera_rays(cam, pix, smp, seed=0, width=res.width,
                           height=res.height)
        g = np.random.default_rng(5)
        table = torch.from_numpy(g.random((MAX_DEPTH * 4, n),
                                          dtype=np.float32)).to(dev)
        kw = dict(seed=SEED, pixel_idx=pix, sample_idx=smp, max_depth=MAX_DEPTH)
        ckw = dict(kw, width=res.width, height=res.height)
        plain_cam = tv2.trace_camera_plain(sc, cam, **ckw)
        counts = plain_cam[1]
        state, per_ray = coh.camera_state(cam, pix, smp, seed=SEED,
                                          width=res.width, height=res.height)
        tk.stepped_call_plain(tv2.stepped_isect(sc),
                              tk.stepped_draw(SEED, pix, smp, None), state,
                              per_ray, depth0=0, n_steps=MAX_DEPTH,
                              max_depth=MAX_DEPTH, rr_start_depth=RR_START)
        assert int(per_ray.sum()) == int(counts)
        checks = spp == 2
        if checks:
            plains = {("camera", "counter", s): tv2.trace_camera_plain(
                sc, cam, steps_per_call=s, **ckw) for s in (12, 5)}
            plains.update({("camera", "table", s): tv2.trace_camera_plain(
                sc, cam, steps_per_call=s, uniforms=table, **ckw) for s in (12, 6)})
            plains.update({("given", "counter", s): tv2.trace_stepped_plain(
                sc, o, d, steps_per_call=s, **kw) for s in (12, 5)})
        for b in builds:
            cfg = configs[b]
            resident = cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"]
            m = coh.model(per_ray, resident)
            waves[b, spp] = -(-n // cfg["threads"]) / (cfg["blocks_per_sm"] * cfg["sms"])
            models[b, spp] = {"rays_per_lane": m["rays_per_lane"],
                              "thread_per_ray": m["thread_per_ray"]["lane_share"],
                              "persistent_refill_1": m["persistent_refill_1"]["lane_share"],
                              "compacted": coh.compacted(
                                  per_ray.to(torch.int64), cfg["threads"])["lane_share"]}
            for fmad in (True, False):
                if (b, fmad) not in libs:
                    continue
                lib = libs[b, fmad]
                for source, uni in (("counter", None), ("table", table)):
                    launch = launcher(lib, sc, pix, smp, res, cam, uni, b == "parent")
                    camera, given = traces(launch, o, d, n, dev)
                    if checks:
                        for (entry, src, s), want in plains.items():
                            if src != source:
                                continue
                            got = (camera if entry == "camera" else given)(s)
                            torch.cuda.synchronize()
                            tag = f"{b} fmad={fmad} {spp} spp {entry}/{src}/{s} steps"
                            exact = torch.equal(got[0], want[0]) and torch.equal(
                                got[1], want[1])
                            sh = share(got[0], want[0])
                            shares[tag] = sh
                            if not fmad and not exact:
                                print(f"FAIL: {tag}: not bit-exact (share {sh:.6f}, "
                                      f"rays {int(got[1])}/{int(want[1])})")
                                failed = True
                    if fmad and source == "counter" and (
                            args.time is None or b in args.time):
                        st = torch.empty((tk.STATE_ROWS, n), dtype=torch.float32,
                                         device=dev)
                        cn = torch.empty(n, dtype=torch.int32, device=dev)
                        calls[b, spp, "camera entry, one launch"] = (
                            lambda launch=launch, st=st, cn=cn: launch(st, cn, 0, 12, True))
                        calls[b, spp, "camera entry, whole trace"] = (
                            lambda camera=camera: camera(12))
                        calls[b, spp, "given rays, 12 steps"] = (
                            lambda given=given: given(12))
                        calls[b, spp, "given rays, 5 steps"] = (
                            lambda given=given: given(5))
        if checks:  # the default builds against the plain version, or the parent
            for b in builds:
                for key, want in plains.items():
                    tag = f"{b} fmad=True 2 spp {key[0]}/{key[1]}/{key[2]} steps"
                    if tag not in shares:
                        continue
                    ptag = f"parent fmad=True 2 spp {key[0]}/{key[1]}/{key[2]} steps"
                    floor = min(LANE_FRAC, shares.get(ptag, LANE_FRAC))
                    if shares[tag] < floor:
                        print(f"FAIL: {tag}: share {shares[tag]:.6f} below {floor}")
                        failed = True
            del plains

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
    print(f"ablate_k5: cornell 450x300, seed {SEED} ({card()})")
    for b in builds:
        print(f" {b}: {json.dumps(configs[b])}")
        for spp in args.spp:
            print(f"  {spp} spp: waves {waves[b, spp]:.3f}; model "
                  f"{json.dumps(models[b, spp])}")
            for (bb, s, what), t in times.items():
                if bb == b and s == spp:
                    ts = f"{min(t):.4f}-{max(t):.4f} ms" if t else "not timed"
                    print(f"    {what:28s} {ts}")
    print(json.dumps({
        "card": card(), "configs": configs,
        "waves": {f"{b} @ {s}": w for (b, s), w in waves.items()},
        "models": {f"{b} @ {s}": m for (b, s), m in models.items()},
        "ms": {f"{b} @ {s} spp @ {w}": v for (b, s, w), v in times.items()},
        "shares": shares}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
