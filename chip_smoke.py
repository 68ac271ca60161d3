#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line or more each (any failure exits non-zero, with no result
line):
  1. a CUDA device is present; the card's name and power limit;
  2. the nine CUDA kernels build from the checkout's six sources (nvcc,
     sm_90a), each with and without FMA contraction, all builds started
     together: K1 trace_regen, K2 trace_cheap_regen, K3 trace_resolve_pool,
     K4 trace_regen_prim, K5 trace_stepped_static, K6 trace_stepped_prim,
     K7 trace_resolve and K9 trace_sorted (K5, K6, K7 and K9 one source),
     K8 trace_cheap_blocked;
  3. each kernel against its plain torch version on the card, at the main
     path's inputs: a build without FMA contraction must equal the plain
     version bit for bit, the default build agree on a stated share of
     lanes. K1: cornell and three-spheres at 256x192 and cornell at
     1024x768, quota 4, both uniform sources; then cornell 1024x768 at
     quota 256, the main path's launch (its --fmad=false build bit-exact;
     the default build's counts, channel means and segments, and its share
     of pixels within 1e-3 no lower than the commit before K1's redesign
     kept there), timed beside its plain version, with its design line:
     registers, its SASS count (scripts/k1_sass.py) weighed by
     scripts/k1_coherence.py's branch shares at quota 256 into an issue
     estimate (no lower bound), the flop bound. K4: mesh at 256x192, quota 4,
     both sources; mesh and two-mesh (mesh with a second copy of its
     MeshFile, scripts/k4_coherence.py) at 1024x768, quota 64, the launch of
     a 64-spp `prim` render (the --fmad=false build bit-exact, the default
     build's pixels within 1e-3 no fewer than the commit before K4's
     redesign kept there), timed beside the plain version, with its design
     line: registers, blocks per SM, shared bytes, the model's useful rows
     (scripts/k4_coherence.py scheduled); K4 also where the panda_arm cell
     runs it, on the cell's scene (2,090 tiles in 66 runs, rows from device
     memory) at its 450x300, and where the rtiow_final cell runs it (484
     spheres and a quad, no tile, rows in shared memory) at its 1200x800,
     the first PANDA_PIXELS pixels of each Morton order at quota 2: the
     --fmad=false build's one call (launches counted from 0) bit-exact with
     the plain version, its four counters (warp queries, tested tiles,
     opened runs, tested sphere rows) too. K2 and K3: a mesh pool at 256x192 with park depth 3 and
     step cap 64 over six cycles, both with both sources; then three
     cycles of a fresh 1024x768 pool; K2 also at park depths 0-3 on cycle
     1 of a fresh 1024x768 pool and on cycles 0-2 of a 1024x768 pool of a
     random portal-eligible scene (scripts/portal_fuzz_scenes.py), wider
     than one wave of its persistent grid. Times of every kernel and its
     plain version at the main path's shapes (CUDA events; K2 and K3 on
     the third cycle of the 1024x768 pool, the bulk phase of a drive),
     with K2's and K3's registers (nvcc -Xptxas -v), resident threads or
     blocks per SM and the shares of scripts/k2_coherence.py's and
     scripts/k3_coherence.py's models on their input pools. K5 on
     cornell and K6 on mesh: one preview frame's rays at 450x300 x 2 spp,
     both uniform sources, in calls of 12 and of 5 steps, given rays and
     from the camera entries (the rays made in the kernel, held against
     camera_rays and the plain trace); K5's design line: registers,
     blocks per SM, the waves of the 1-, 2- and 4-spp frames and
     scripts/k5_coherence.py's lane shares there; K6 also on the frame of a
     random portal scene and of a scene whose table exceeds its shared
     budget (the read-only path), and its design line: registers, blocks
     per SM, shared bytes, scripts/k6_coherence.py's shares. K3 and K6 on a scene
     of 35 tiles in a row (scripts/portal_fuzz_scenes.py strip_scene) with
     rays along it, whose keys are the largest a key can be: every ray
     bounced and counted (the sort pad). K8 on a fresh 1,048,576-lane v1
     pool of mesh primary rays at 1024x768, K7 on its first 524,288 lanes
     after K8 and the partition (the v1 shape) and on the 4 x 786,432 lanes
     of a mid-drive park-3 pool (the glue shape, timed beside K3 on the same
     pool), both sources (the lanes of the deleted v1 and glue routes, from
     scripts/ablate_k7.py; K7, K8 and K9 have no route, so their launches
     are those of one call each, counted from 0), with K7's and K8's
     design lines: registers, shared bytes, blocks an SM, time against
     the bound, and K7's schedule model (scripts/k4_coherence.py
     resolve_model). K9 on the mesh preview frame,
     sorted every bounce, equal to K6 on the same rays, timed beside K6;
  4. the main paths through render(), each with the launch counts set to
     0 just before and read just after: cornell 1024x768 at 512 spp (K1),
     twice, with each render's wall and Mray/s;
     mesh 1024x768 at 1024 spp through the portal (K2 and K3; per-pixel
     counts exact); mesh 1024x768 at 64 spp under PT_TPU_NO_PORTAL (K4);
     two-mesh 1024x768 at 64 spp, which the default router sends to `prim`
     (K4 and no portal kernel; per-pixel counts exact); small cornell and
     mesh renders on
     the card agree with the same renders on the CPU far inside Monte Carlo
     noise; a portal render cancelled at its first poll keeps exactly the
     samples it traced;
  5. the CLI in a subprocess writes a PPM that parses (cornell and mesh);
  6. the interactive preview, ProgressiveRenderer(device="cuda") at 450x300
     (the reference GUI's size) on cornell (K5) and mesh (K6) at 1, 2 and 4
     spp a frame, the launch counts set to 0 just before each and read just
     after: warm frame times (2nd best of 8) of step and step_u8, fps, the
     restart latency (move_camera and the first frame), device operations
     a frame (torch.profiler over 5 frames); step_u8 byte-equal
     to quantize_np of the accumulator; 8 frames of 2 spp against a 16-spp
     render() of the same seed;
  7. the viewer app (viewer.app.make_server on 127.0.0.1, an ephemeral
     port, served from a thread): /state, three /preview.png (decoded here;
     the etag changes), /control orbit, /pick, /probe, /select_scene
     cornell, /start_render at 16 spp and res_y 120 until done with no
     render error, /render.png; each request's latency;
  8. the wavefront integrator on the card (plain torch, no kernel: the
     launch counts stay 0), each render's per-pixel sample counts exact
     and its wall, Mray/s and peak device memory: cornell 1024x768 at 64
     spp in backend fast, twice, against the K1 route's image of the same
     seed beside K1's two-seed noise; mesh 1024x768 at 4 spp in fast (six
     pixel chunks a pass); cornell 256x192 at 16 spp in exact (against
     fast) and with the literal estimator; a mock_random render at 96x64 on
     the card against the same render on the CPU (the share of pixels
     within 1e-4: TF32 would part far more); render_samples in each mode;
     two preview frames on the wavefront; the raster preview
     (viewer.raster.render_preview) at 450x300 on the card against the CPU.
     Phase 5 also runs the CLI with --backend fast --debug-nans --profile.
Then a JSON line per kernel, the card's line, and last
{"ok": true, "device": {...}}.
"""

import concurrent.futures
import glob
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
LANE_TOL = 1e-3  # |Δ|₁ per pixel (or per pool column) counted as agreeing
# Share of lanes that must agree: the lane share the CPU tests hold the
# plain versions to against JAX. nvcc contracts a*b+c into FMAs where torch
# rounds twice; along long closed-box paths (cornell, depth 12) such ulps
# part a few trajectories (H100: 0.9975 counter, 0.9961 table for K1). A
# build with --fmad=false is held to bit equality instead.
LANE_FRAC = 0.995
# The same share for K2 on the random portal scene of phase 3, whose glass
# and mirror spheres part more paths on an FMA: 0.976-0.981 of slots on the
# card (NVIDIA H100 80GB HBM3), the parent commit's kernel bit-equal to this
# one there. K2 is deterministic, so the share repeats exactly.
FUZZ_LANE_FRAC = 0.97
SEG_TOL = 0.005  # segment totals, kernel against plain, as in the CPU tests
# K1 at the main path's shape (cornell 1024x768, quota 256, seed 7): a pixel
# sums 256 samples, so the few paths an FMA parts reach more pixels than at
# quota 4. The commit before K1's redesign kept 0.920901 of these pixels
# within LANE_TOL (scripts/ablate_k1.py --parent, NVIDIA H100 80GB HBM3,
# CUDA 12.8), as many as the redesign does: the default build keeps no fewer.
K1_MAIN_LANE_FRAC = 0.9209
# K4 at its render's shape (1024x768, quota 64, seed 7, sample base 4): the
# commit before K4's redesign kept these pixels of 786,432 within LANE_TOL
# on mesh and on two-mesh (scripts/ablate_k4.py --parent, NVIDIA H100 80GB
# HBM3): the default build keeps no fewer.
K4_MAIN_PIXELS = {"mesh": 786234, "two-mesh": 786079}
# K4 on panda_arm: the pixels of the cell's frame checked against the
# plain version, few enough for it (2,090 tiles) to take seconds
PANDA_PIXELS = 768

# Bounds (published peaks of an H100 SXM at 700 W)
PEAK_FP32 = 67e12  # flop/s, FP32 outside the tensor cores
MEM_BW = 3.35e12  # bytes/s of HBM
# Essential flops (adds, muls, divides, square roots, as
# scripts/count_flops.py counts them) of the kernels' pieces:
FLOPS_K1_SEGMENT = 608  # a cornell segment of K1, count_flops.py
FLOPS_TRI = 41  # one triangle/quad row, affine feature form
FLOPS_SPHERE = 41  # one expanded sphere test
FLOPS_SLAB = 24  # one AABB slab test
FLOPS_SHADE = 152  # shade_phase, count_flops.py
FLOPS_HIT = 29  # m = o x d, the hit point and its normal
FLOPS_RAYGEN = 40  # a tent-filtered camera ray
# a K5 segment: K1's cornell segment less count_flops.py's raygen share (64
# of its 608), since K5's rays come from outside
FLOPS_K5_SEGMENT = FLOPS_K1_SEGMENT - 64

FAILURES: list[str] = []


def fail(msg: str) -> None:
    """Record a failed check; the script goes on to the next phase and
    exits non-zero at the end, so one run reports every phase."""
    print(f"FAIL: {msg}", flush=True)
    FAILURES.append(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time for the work: bytes over HBM rate or flops over the
    FP32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / MEM_BW * 1e3, flops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def isect_flops(work: dict, segments: int) -> float:
    return (segments * (FLOPS_SHADE + FLOPS_HIT)
            + work.get("sph", 0) * FLOPS_SPHERE
            + work.get("tri", 0) * FLOPS_TRI + work.get("slab", 0) * FLOPS_SLAB)


def lane_share(a, b, dim=1) -> float:
    """Share of lanes whose values agree within LANE_TOL (|Δ|₁)."""
    return float(((a - b).abs().sum(dim=dim) < LANE_TOL).float().mean())


KERNELS = (  # name, source, the TPU kernel it replaces
    ("trace_regen", "trace_regen.cu",
     "path_tracer_tpu/ops/pallas/trace_v2.py:615"),
    ("trace_cheap_regen", "portal_cheap.cu",
     "path_tracer_tpu/ops/pallas/portal.py:557"),
    ("trace_resolve_pool", "portal_resolve.cu",
     "path_tracer_tpu/ops/pallas/portal.py:802"),
    ("trace_regen_prim", "trace_regen_prim.cu",
     "path_tracer_tpu/ops/pallas/trace_kernel.py:1296"),
    ("trace_stepped_static", "trace_stepped.cu",
     "path_tracer_tpu/ops/pallas/trace_v2.py:336"),
    ("trace_stepped_prim", "trace_stepped.cu",
     "path_tracer_tpu/ops/pallas/trace_kernel.py:1467"),
    ("trace_resolve", "trace_stepped.cu",
     "path_tracer_tpu/ops/pallas/trace_kernel.py:1367"),
    ("trace_cheap_blocked", "portal_cheap_blocked.cu",
     "path_tracer_tpu/ops/pallas/portal.py:879"),
    ("trace_sorted", "trace_stepped.cu",
     "path_tracer_tpu/ops/pallas/trace_kernel.py:1607"),
)
CSRC = "path_tracer_tpu_torch/csrc/"
PREVIEW = (300, 450)  # the reference GUI's preview size (main.rs:91-92)


def build_all():
    """Build every source both ways, one nvcc per build, started together."""
    from path_tracer_tpu_torch.ops.kernels.build import load_kernel

    from path_tracer_tpu_torch.ops.kernels.build import build

    sources = sorted({src for _, src, _ in KERNELS})
    jobs = {f"{src} fmad={fmad}": (os.path.join(ROOT, CSRC, src), fmad)
            for fmad in (True, False) for src in sources}
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as ex:
        futs = {name: ex.submit(load_kernel, *args) for name, args in jobs.items()}
        # K1 with line information, for its SASS count (scripts/k1_sass.py)
        futs["trace_regen.cu -lineinfo"] = ex.submit(
            build, os.path.join(ROOT, CSRC, "trace_regen.cu"), ("-lineinfo",))
        lines = []
        for name, fut in futs.items():
            built = fut.result()
            BUILT[name] = built
            lines.append(f"{name}: {os.path.relpath(built.path, ROOT)} in "
                         f"{built.seconds:.1f} s, ptxas: "
                         f"{' | '.join(ptxas_registers(built.log))}")
    return lines


BUILT: dict = {}  # "source fmad=..." -> build_all's Built


def ptxas_registers(log: str, kernel: str = "") -> list[str]:
    """The register lines of nvcc's -Xptxas -v report, one a kernel (those
    of the kernels whose names hold ``kernel``)."""
    out, name = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln
        elif "registers" in ln and kernel in name:
            out.append(ln.split(":", 1)[-1].strip())
    return out


def script_module(name: str):
    """scripts/<name>.py as a module: k3_coherence and k2_coherence (the
    models of K3's and K2's schedules), portal_fuzz_scenes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k1_design(scene_c, cam_c, pix, plain256, kw, clock, card):
    """K1's design line: registers, its SASS count weighed by the coherence
    model (the main path's shape, quota 256, on the first eighth of its
    warps) into an issue estimate over the run's warp-steps at the SM clock
    under its load (a static count: no lower bound), the flop bound;
    returns the issue estimate (ms)."""
    import torch

    from path_tracer_tpu_torch.ops.kernels import trace_v2

    k1s, coh = script_module("k1_sass"), script_module("k1_coherence")
    cfg = trace_v2.regen_config(scene_c)
    rep = k1s.report(ROOT)
    part = pix.shape[0] // 8 // 32 * 32
    model, out = coh.model(scene_c, cam_c, pix[:part], **kw)
    if not all(torch.equal(a, b[:part]) for a, b in zip(out, plain256)):
        fail("K1's coherence model traced other paths than trace_regen_plain")
    segs = plain256[1].to(torch.int64)
    n_w = -(-segs.shape[0] // 32)
    segs_w = torch.cat([segs, segs.new_zeros(n_w * 32 - segs.shape[0])])
    warp_steps = int(segs_w.view(n_w, 32).max(dim=1).values.sum())
    step = k1s.per_warp_step(rep, model)
    issue = k1s.issue_estimate_ms(step["total"], warp_steps, clock)
    flop = int(segs.sum()) * FLOPS_K1_SEGMENT / PEAK_FP32 * 1e3
    br = model["branches"]
    print(f"phase 3 K1 design: ptxas {' | '.join(rep['ptxas'])}; {cfg}; SASS "
          f"{rep['instructions']} instructions (production build "
          f"{rep['production_instructions']}, same opcodes as the counted "
          f"-lineinfo build: {rep['lineinfo_build_same_opcodes']}); "
          f"{step['total']:.1f} warp-instructions a warp-step, "
          f"{step['total'] * warp_steps / (int(segs.sum()) / 32):.1f} a "
          f"segment; issue estimate {issue:.3f} ms at {clock:.0f} MHz over "
          f"{warp_steps} warp-steps, flop bound {flop:.3f} ms "
          f"({int(segs.sum())} segments x {FLOPS_K1_SEGMENT}) ({card})",
          flush=True)
    print(f"phase 3 K1 coherence (scripts/k1_coherence.py), quota 256, "
          f"{part} pixels: "
          + ", ".join(f"{b} {v['warp_step_share']:.3f} of warp-steps x "
                      f"{v['lanes_when_run']:.1f} lanes" for b, v in br.items())
          + f"; distinct hit rows {model['hit_rows']['distinct_rows_per_warp_step']:.2f}"
          f" a warp-step; lane share {model['quota_tail']['lane_share']:.4f}",
          flush=True)
    return issue


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def check_k1(scenes, dev, card):
    """K1 against its plain version; returns its kernels-line numbers, at
    the main path's shape (cornell 1024x768, quota 256)."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.ops.kernels import trace_v2
    from path_tracer_tpu_torch.render.pipeline import (
        morton_pixel_order, prepare_scene,
    )
    from path_tracer_tpu_torch.utils.config import Resolution

    quota, seed, base = 4, 7, 4
    main_res = Resolution(768, 1024)
    cases = [(sid, Resolution(192, 256)) for sid in ("cornell", "three-spheres")]
    cases.append(("cornell", main_res))
    out = {"max_abs_err": 0.0}
    for sid, res in cases:
        scene_c, cam_c = prepare_scene(scenes[sid], res, dev)
        pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(dev)
        table = torch.from_numpy(np.random.default_rng(3).random(
            (6, pix.shape[0]), dtype=np.float32)).to(dev)
        for source, uni in (("counter", None), ("table", table)):
            tag = f"K1 {sid} {res.width}x{res.height}/{source}"
            kw = dict(seed=seed, sample_base=base, quota=quota, uniforms=uni)
            rad_k, seg_k, done_k = trace_v2.trace_regen(scene_c, cam_c, pix, **kw)
            rad_p, seg_p, done_p = trace_v2.trace_regen_plain(
                scene_c, cam_c, pix, **kw)
            torch.cuda.synchronize()
            if not (bool((done_k == quota).all()) and bool((done_p == quota).all())):
                fail(f"{tag}: per-pixel sample counts != quota")
            if not bool(torch.isfinite(rad_k).all()):
                fail(f"{tag}: non-finite kernel radiance")
            frac = lane_share(rad_k, rad_p)
            err = float((rad_k - rad_p).abs().max())
            seg_ratio = int(seg_k.sum(dtype=torch.int64)) / max(
                int(seg_p.sum(dtype=torch.int64)), 1)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            print(f"phase 3 {tag}: {frac:.5f} of pixels within {LANE_TOL} "
                  f"(need {LANE_FRAC}); max |err| {err:.3g}; "
                  f"segments kernel/plain {seg_ratio:.5f}", flush=True)
            if frac < LANE_FRAC or abs(seg_ratio - 1.0) > SEG_TOL:
                fail(f"{tag}: kernel disagrees with its plain version")
            exact = trace_v2.trace_regen(scene_c, cam_c, pix, fmad=False, **kw)
            if not all(torch.equal(a, b) for a, b in
                       zip(exact, (rad_p, seg_p, done_p))):
                fail(f"{tag}: the --fmad=false kernel is not bit-exact with "
                     "its plain version")
            if res == main_res and source == "counter":
                out["ms4"] = cuda_ms(
                    lambda: trace_v2.trace_regen(scene_c, cam_c, pix, **kw), 10)
    # the main path's launch: quota 256, one of a 512-spp render's two. The
    # --fmad=false build is held to bit equality; the default build to exact
    # counts, the channel means and the segment total, as the CPU tests hold
    # whole renders, and to K1_MAIN_LANE_FRAC of pixels within LANE_TOL
    kw = dict(seed=seed, sample_base=0, quota=256)
    t0 = time.perf_counter()
    plain = trace_v2.trace_regen_plain(scene_c, cam_c, pix, **kw)
    torch.cuda.synchronize()
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    got = trace_v2.trace_regen(scene_c, cam_c, pix, **kw)
    exact = trace_v2.trace_regen(scene_c, cam_c, pix, fmad=False, **kw)
    torch.cuda.synchronize()
    frac = lane_share(got[0], plain[0])
    out["max_abs_err"] = max(out["max_abs_err"],
                             float((got[0] - plain[0]).abs().max()))
    bit = all(torch.equal(a, b) for a, b in zip(exact, plain))
    means = (got[0].mean(dim=0), plain[0].mean(dim=0))
    means_ok = bool(torch.allclose(*means, rtol=1e-3, atol=1e-3))
    seg_ratio = int(got[1].sum(dtype=torch.int64)) / int(
        plain[1].sum(dtype=torch.int64))
    print(f"phase 3 K1 cornell 1024x768/counter quota 256: --fmad=false "
          f"bit-exact {bit}; default build: {frac:.5f} of pixels within "
          f"{LANE_TOL} (need {K1_MAIN_LANE_FRAC}), channel means "
          f"{means[0].tolist()} against {means[1].tolist()}, segments "
          f"kernel/plain {seg_ratio:.6f}",
          flush=True)
    if not (bit and means_ok and abs(seg_ratio - 1.0) <= SEG_TOL
            and frac >= K1_MAIN_LANE_FRAC and bool((got[2] == 256).all())):
        fail("K1 at the main path's shape disagrees with its plain version")
    run = lambda: trace_v2.trace_regen(scene_c, cam_c, pix, **kw)  # noqa: E731
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        run()
    end.record()
    clock = sm_clock_mhz()  # while the launches run
    torch.cuda.synchronize()
    out["ms"] = start.elapsed_time(end) / reps
    segs = int(plain[1].sum(dtype=torch.int64))
    n = pix.shape[0]
    out["bound_ms"], out["bound_by"] = bound_ms(n * (4 + 20),
                                                segs * FLOPS_K1_SEGMENT)
    issue = k1_design(scene_c, cam_c, pix, plain, kw, clock, card)
    print(f"phase 3 K1 cornell 1024x768 quota 256 (the main path's launch): "
          f"kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.1f} ms, bound "
          f"{out['bound_ms']:.3f} ms ({out['bound_by']}), issue estimate "
          f"{issue:.3f} ms; quota 4: kernel {out['ms4']:.3f} ms ({card})",
          flush=True)
    return out


def k4_design(ks, cam, pix, card):
    """K4's design line: registers, blocks per SM, shared bytes, and the
    model of its schedule at quota 4 (scripts/k4_coherence.py
    ``scheduled``: this card's resident blocks of owner threads, each
    step's queries split into a warp's and a lane's): the useful-row share
    and a step's balance."""
    from path_tracer_tpu_torch.ops.kernels import trace_kernel

    cfg = trace_kernel.regen_prim_config(ks)
    _, num = script_module("k4_coherence").scheduled(
        ks, cam, pix, quota=4, threads=cfg["threads"],
        blocks=cfg["blocks_per_sm"] * cfg["sms"])
    print(f"phase 3 K4 design: {cfg['registers']} registers "
          f"({cfg['local_bytes']} B local), {cfg['blocks_per_sm']} block(s) of "
          f"{cfg['threads']} an SM, {cfg['smem_bytes']} B of dynamic shared "
          f"memory (table in shared memory: {cfg['shared_table']}); the "
          f"model at quota 4: useful rows {num['useful_row_share']:.4f}, a "
          f"step's balance {num['step_balance']:.4f}, {num['steps']} steps "
          f"({card})", flush=True)


def check_k4(scenes, dev, card, small, main):
    """K4 against its plain version: mesh at ``small``, quota 4, both
    uniform sources; mesh and two-mesh at ``main``, quota 64 (the one launch
    of a 64-spp `prim` render), the counter generator. Returns its
    kernels-line numbers (mesh at quota 64)."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.ops.kernels import trace_kernel
    from path_tracer_tpu_torch.render.pipeline import (
        morton_pixel_order, prepare_render,
    )

    seed, base = 7, 4
    out = {"max_abs_err": 0.0}
    for sid, res, quota in (("mesh", small, 4), ("mesh", main, 64),
                            ("two-mesh", main, 64)):
        prep = prepare_render(scenes[sid], res, dev)
        ks = prep.kscene
        pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(dev)
        table = torch.from_numpy(np.random.default_rng(3).random(
            (6, pix.shape[0]), dtype=np.float32)).to(dev)
        sources = (("counter", None), ("table", table)) if res == small else (
            ("counter", None),)
        n = pix.shape[0]
        need = (math.ceil(LANE_FRAC * n) if quota == 4 else
                K4_MAIN_PIXELS[sid])
        for source, uni in sources:
            tag = f"K4 {sid} {res.width}x{res.height} quota {quota}/{source}"
            kw = dict(seed=seed, sample_base=base, quota=quota, uniforms=uni)
            work: dict = {}
            rad_k, seg_k, done_k = trace_kernel.trace_regen_prim(
                ks, prep.cam, pix, **kw)
            t0 = time.perf_counter()
            rad_p, seg_p, done_p = trace_kernel.trace_regen_prim_plain(
                ks, prep.cam, pix, work=work, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if not (bool((done_k == quota).all()) and bool((done_p == quota).all())):
                fail(f"{tag}: per-pixel sample counts != quota")
            if not bool(torch.isfinite(rad_k).all()):
                fail(f"{tag}: non-finite kernel radiance")
            within = int(((rad_k - rad_p).abs().sum(dim=1) < LANE_TOL).sum())
            err = float((rad_k - rad_p).abs().max())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            seg_ratio = int(seg_k.sum(dtype=torch.int64)) / max(
                int(seg_p.sum(dtype=torch.int64)), 1)
            print(f"phase 3 {tag}: {within} of {n} pixels within {LANE_TOL} "
                  f"(need {need}); max |err| {err:.3g}; segments "
                  f"kernel/plain {seg_ratio:.5f}; plain {plain_s:.1f} s", flush=True)
            if within < need or abs(seg_ratio - 1.0) > SEG_TOL:
                fail(f"{tag}: kernel disagrees with its plain version")
            exact = trace_kernel.trace_regen_prim(ks, prep.cam, pix, fmad=False, **kw)
            if not all(torch.equal(a, b) for a, b in
                       zip(exact, (rad_p, seg_p, done_p))):
                fail(f"{tag}: the --fmad=false kernel is not bit-exact with "
                     "its plain version")
        if res != main:
            continue
        ms = cuda_ms(lambda: trace_kernel.trace_regen_prim(
            ks, prep.cam, pix, seed=seed, sample_base=base, quota=quota), 2)
        ms4 = cuda_ms(lambda: trace_kernel.trace_regen_prim(
            ks, prep.cam, pix, seed=seed, sample_base=base, quota=4), 10)
        segs = int(seg_p.sum(dtype=torch.int64))
        bound, by = bound_ms(n * (4 + 20), isect_flops(work, segs)
                             + n * quota * FLOPS_RAYGEN)
        print(f"phase 3 K4 {sid} {main.width}x{main.height} quota {quota}: "
              f"kernel {ms:.3f} ms, plain {plain_s * 1e3:.1f} ms, bound "
              f"{bound:.3f} ms ({by}); quota 4: kernel {ms4:.3f} ms ({card})",
              flush=True)
        if sid == "mesh":
            out.update(ms=ms, ms4=ms4, plain_ms=plain_s * 1e3, bound_ms=bound,
                       bound_by=by)
            k4_design(ks, prep.cam, pix, card)
    return out


# the benchmark cells whose scenes K4 is checked on (check_k4_cell): width
# and height, and whether K4 reads the rows from shared memory (then with
# no tile) or from device memory over two runs of tiles or more
K4_CELLS = {"panda_arm": (450, 300, False), "rtiow_final": (1200, 800, True)}


def check_k4_cell(name, scene, dev, card):
    """K4 where a benchmark cell runs it (K4_CELLS): panda_arm's scene at
    450x300 on the group level over rows in device memory, rtiow_final's
    (484 spheres and a quad, no tile) at 1200x800 on shared rows; the
    first PANDA_PIXELS pixels of the Morton order, quota 2. Its
    --fmad=false build, one call with the launches counted from 0, equals
    the plain version bit for bit: radiance, segments, samples and the
    four counters."""
    import torch

    from path_tracer_tpu_torch.ops.kernels import trace_kernel
    from path_tracer_tpu_torch.render.pipeline import (
        morton_pixel_order, prepare_render,
    )
    from path_tracer_tpu_torch.utils.config import Resolution

    width, height, shared = K4_CELLS[name]
    res = Resolution(height, width)
    prep = prepare_render(scene, res, dev)
    ks = prep.kscene
    tag = (f"K4 {name} {res.width}x{res.height}, first {PANDA_PIXELS} "
           "pixels, quota 2")
    n_runs = ks.tile_groups.shape[0]
    if (prep.route != "prim" or trace_kernel.k4_shared_table(ks) != shared
            or (n_runs != 0 if shared else n_runs < 2)):
        fail(f"{tag}: route {prep.route}, {ks.tiles.shape[0]} tiles, shared "
             f"table {trace_kernel.k4_shared_table(ks)}: not the cell's K4")
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]
                           [:PANDA_PIXELS]).to(dev)
    kw = dict(seed=7, sample_base=4, quota=2)
    plain: dict = {}
    t0 = time.perf_counter()
    want = trace_kernel.trace_regen_prim_plain(ks, prep.cam, pix, work=plain, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    trace_kernel.trace_regen_prim.launches = 0
    got = trace_kernel.trace_regen_prim(ks, prep.cam, pix, fmad=False,
                                        work=work, **kw)
    launches = trace_kernel.trace_regen_prim.launches
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    counts = work.tolist()
    plain_counts = [plain.get(k, 0) for k in trace_kernel.WORK_KEYS]
    segments = int(want[1].sum())
    print(f"phase 3 {tag}: {ks.sph.shape[0]} sphere rows, {ks.tiles.shape[0]} "
          f"tiles in {n_runs} runs; --fmad=false bit-exact {exact}; queries, "
          f"tiles, runs, sphere rows {counts} (plain {plain_counts}), "
          f"{segments} segments; {launches} launch(es); plain {plain_s:.1f} s "
          f"({card})", flush=True)
    if not exact:
        fail(f"{tag}: the --fmad=false kernel is not bit-exact with its "
             "plain version")
    # no tile, no warp query; else each query opens a run at least
    queries_ok = counts[0] == 0 if shared else 0 < counts[0] <= counts[2]
    if (counts != plain_counts or counts[3] != segments * ks.sph.shape[0]
            or not queries_ok):
        fail(f"{tag}: counters {counts}, the plain version's {plain_counts}")
    if launches != 1:
        fail(f"{tag}: {launches} launches for one call")


def compare(tag, kern, exact, plain, rec, frac=LANE_FRAC):
    """(pool or state [rows, n], counts) of a kernel, its --fmad=false build
    and its plain version: the second must equal the third bit for bit, the
    first agree on ``frac`` of the columns, with segment totals within
    SEG_TOL; rec["max_abs_err"] grows."""
    import torch

    (pk_, ck), (pe, ce), (pp, cp) = kern, exact, plain
    torch.cuda.synchronize()
    if not (torch.equal(pe, pp) and torch.equal(ce, cp)):
        fail(f"{tag}: the --fmad=false kernel is not bit-exact with its "
             "plain version")
    if not bool(torch.isfinite(pk_).all()):
        fail(f"{tag}: non-finite pool")
    err = float((pk_ - pp).abs().max())
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    share = lane_share(pk_, pp, dim=0)
    segs, want = int(ck.sum(dtype=torch.int64)), int(cp.sum(dtype=torch.int64))
    print(f"phase 3 {tag}: {share:.5f} of slots within {LANE_TOL} "
          f"(need {frac}); max |err| {err:.3g}; segments {segs}/{want}",
          flush=True)
    if share < frac or abs(segs - want) > SEG_TOL * want:
        fail(f"{tag}: kernel disagrees with its plain version")


def k3_design(ks, pool, card):
    """K3's registers, resident blocks and the coherence model's shares on
    its input pool (the phase-3 shape), on lines of their own."""
    from path_tracer_tpu_torch.ops.kernels import portal as pk

    regs = ptxas_registers(BUILT["portal_resolve.cu fmad=True"].log)
    cfg = pk.resolve_pool_config(ks)
    window = cfg["window"]
    print(f"phase 3 K3 design: ptxas {' | '.join(regs)}; chunk {window} "
          f"columns, {cfg['smem_bytes']} bytes of shared memory a block, "
          f"{cfg['blocks_per_sm']} resident blocks per SM, table in shared "
          f"memory {cfg['shared_table']} ({card})", flush=True)
    model = script_module("k3_coherence").coherence(ks, pool, windows=(window,))
    col = model["column_schedule"]
    new = model[f"window_{window}_sorted"]
    print(f"phase 3 K3 coherence (scripts/k3_coherence.py) on its input pool: "
          f"{model['items']} live items of {model['columns']} columns, live "
          f"share per part {[round(x, 4) for x in model['live_share_per_part']]}; "
          f"one thread a column: lane slots {col['lane_slot_share']:.4f}, "
          f"useful rows {col['useful_row_share']:.4f}; packed and sorted in "
          f"chunks of {window}: lane slots "
          f"{new['lane_slot_share']:.4f}, useful rows "
          f"{new['useful_row_share']:.4f}", flush=True)


def k2_design(pc, park_k, slot_steps, card):
    """K2's registers, resident threads and the coherence model's lane
    shares on its input pool (the phase-3 shape), on lines of their own."""
    import torch

    from path_tracer_tpu_torch.ops.kernels import portal as pk

    regs = ptxas_registers(BUILT["portal_cheap.cu fmad=True"].log)
    cfg = pk.cheap_regen_config(pc, park_k)
    resident = cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"]
    print(f"phase 3 K2 design: ptxas {' | '.join(regs)}; park depth {park_k}: "
          f"{cfg['registers']} registers, {cfg['local_bytes']} local bytes a "
          f"thread, {cfg['blocks_per_sm']} blocks of {cfg['threads']} threads "
          f"an SM = {cfg['blocks_per_sm'] * cfg['threads']} resident threads "
          f"an SM, {resident} on the card; a warp takes slots at "
          f"{cfg['refill_min']} idle lanes ({card})", flush=True)
    coh = script_module("k2_coherence")
    steps = slot_steps.to(torch.int64)
    one = coh.thread_per_slot(steps)
    pers = coh.persistent(steps, resident, cfg["refill_min"])
    print(f"phase 3 K2 coherence (scripts/k2_coherence.py) on its input pool: "
          f"{int(steps.sum())} slot-steps of {steps.numel()} slots; one thread "
          f"a slot: lane-steps doing work {one['lane_share']:.4f}; persistent, "
          f"refill at {cfg['refill_min']} idle: {pers['lane_share']:.4f} "
          f"({pers['refills_per_warp_step']:.4f} refills a warp-step, grid "
          f"{pers['grid_share']:.4f} with the tail)", flush=True)


def check_k2_shapes(mesh, dev, card, main, k2):
    """The production K2 against its plain version beyond the drive of
    check_portal: at park depths 0-3 on cycle 1 of a fresh 1024x768 mesh
    pool, and on cycles 0-2 of a 1024x768 pool of a random portal-eligible
    scene (scripts/portal_fuzz_scenes.py), with both uniform sources on
    cycle 1; every pool wider than one wave of resident threads."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.ops.kernels import portal as pk
    from path_tracer_tpu_torch.render import portal as rp
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    seed, max_depth = 7, 12
    fuzz = script_module("portal_fuzz_scenes").fuzz_scene(3)
    npix = main.num_pixels
    n = rp._round_block(npix)
    table = torch.from_numpy(np.random.default_rng(9).random(
        (6, n), dtype=np.float32)).to(dev)
    for sid, scene, park_ks, cycles in (("mesh", mesh, (0, 1, 2, 3), (1,)),
                                        ("fuzz3", fuzz, (3,), (0, 1, 2))):
        prep = prepare_render(scene, main, dev)
        if prep.route != "portal":
            fail(f"K2 {sid}: the scene took the {prep.route} route")
            continue
        for park_k in park_ks:
            pool = rp.make_pool_v2(npix, n, 256, park_k=park_k, device=dev)
            cheap = dict(seed=seed, quota=256, sample_base=0, step_cap=64,
                         park_k=park_k, max_depth=max_depth)
            for cyc in range(max(cycles) + 1):
                plain = pk.trace_cheap_regen_plain(prep.portal, prep.cam,
                                                   pool, **cheap)
                if cyc in cycles:
                    sources = (("counter", None), ("table", table)) if (
                        cyc == 1) else (("counter", None),)
                    for source, uni in sources:
                        kw = dict(cheap, uniforms=uni)
                        p = plain if uni is None else pk.trace_cheap_regen_plain(
                            prep.portal, prep.cam, pool, **kw)
                        compare(f"K2 {sid} {main.width}x{main.height} park "
                                f"{park_k} cycle {cyc}/{source}",
                                pk.trace_cheap_regen(prep.portal, prep.cam,
                                                     pool, **kw),
                                pk.trace_cheap_regen(prep.portal, prep.cam,
                                                     pool, fmad=False, **kw),
                                p, k2, LANE_FRAC if sid == "mesh" else
                                FUZZ_LANE_FRAC)
                pool = pk.trace_resolve_pool_plain(
                    prep.kscene, plain[0], seed=seed, parts=park_k + 1,
                    park_k=park_k, max_depth=max_depth)[0]


def check_portal(mesh, dev, card, small, main):
    """K2 and K3 against their plain versions over cycles of a drive, and
    timed on the third cycle of a fresh 1024x768 pool (the bulk phase);
    returns the two kernels-line dicts."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.ops.kernels import portal as pk
    from path_tracer_tpu_torch.render import portal as rp
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    park_k, step_cap, seed, max_depth = 3, 64, 7, 12
    k2 = {"max_abs_err": 0.0}
    k3 = {"max_abs_err": 0.0}

    for res, cycles in ((small, 6), (main, 3)):
        prep = prepare_render(mesh, res, dev)
        pc, cam, ks = prep.portal, prep.cam, prep.kscene
        npix = res.num_pixels
        n = rp._round_block(npix)
        pool = rp.make_pool_v2(npix, n, 256, park_k=park_k, device=dev)
        cheap = dict(seed=seed, quota=256, sample_base=0, step_cap=step_cap,
                     park_k=park_k, max_depth=max_depth)
        resolve = dict(seed=seed, parts=park_k + 1, park_k=park_k,
                       max_depth=max_depth)
        table = torch.from_numpy(np.random.default_rng(4).random(
            (4, (park_k + 1) * n), dtype=np.float32)).to(dev)
        table2 = torch.from_numpy(np.random.default_rng(5).random(
            (6, n), dtype=np.float32)).to(dev)
        for cyc in range(cycles):
            tag = f"{res.width}x{res.height} cycle {cyc}"
            last = res == main and cyc == cycles - 1
            if last:  # the main path's shape, bulk phase: time both kernels
                w2: dict = {}
                w3: dict = {}
                k2["ms"] = cuda_ms(lambda: pk.trace_cheap_regen(
                    pc, cam, pool, **cheap), 5)
                t0 = time.perf_counter()
                p2 = pk.trace_cheap_regen_plain(pc, cam, pool, work=w2, **cheap)
                torch.cuda.synchronize()
                k2["plain_ms"] = (time.perf_counter() - t0) * 1e3
                nbytes = 2 * pool.numel() * 4 + n * 4
                # a slot's runnable step is one slab test and one scan: the
                # steps the slots need, not the plain version's lane-steps
                # (work["scan"] also counts stopped frozen lanes)
                flops = (int(w2["slot_steps"].sum()) * (
                    FLOPS_SLAB + pc.scene.prims.shape[0] * FLOPS_TRI)
                    + w2.get("shade", 0) * (FLOPS_SHADE + FLOPS_HIT)
                    + w2.get("regen", 0) * FLOPS_RAYGEN)
                k2["bound_ms"], k2["bound_by"] = bound_ms(nbytes, flops)
                k2_design(pc, park_k, w2["slot_steps"], card)
            else:
                p2 = pk.trace_cheap_regen_plain(pc, cam, pool, **cheap)
            compare(f"K2 {tag}", pk.trace_cheap_regen(pc, cam, pool, **cheap),
                    pk.trace_cheap_regen(pc, cam, pool, fmad=False, **cheap),
                    p2, k2)
            if res == small:
                kw2 = dict(cheap, uniforms=table2)
                compare(f"K2 {tag}/table",
                        pk.trace_cheap_regen(pc, cam, pool, **kw2),
                        pk.trace_cheap_regen(pc, cam, pool, fmad=False, **kw2),
                        pk.trace_cheap_regen_plain(pc, cam, pool, **kw2), k2)
            pool = p2[0]
            sources = (("counter", None), ("table", table)) if (
                res == small) else (("counter", None),)
            for source, uni in sources:
                kw = dict(resolve, uniforms=uni)
                if last and source == "counter":
                    k3_design(ks, pool, card)
                    k3["ms"] = cuda_ms(lambda: pk.trace_resolve_pool(
                        ks, pool, **kw), 5)
                    t0 = time.perf_counter()
                    p3 = pk.trace_resolve_pool_plain(ks, pool, work=w3, **kw)
                    torch.cuda.synchronize()
                    k3["plain_ms"] = (time.perf_counter() - t0) * 1e3
                    k3["bound_ms"], k3["bound_by"] = bound_ms(
                        2 * pool.numel() * 4 + n * 4,
                        isect_flops(w3, int(p3[1].sum())))
                else:
                    p3 = pk.trace_resolve_pool_plain(ks, pool, **kw)
                compare(f"K3 {tag}/{source}",
                        pk.trace_resolve_pool(ks, pool, **kw),
                        pk.trace_resolve_pool(ks, pool, fmad=False, **kw),
                        p3, k3)
                if uni is None:
                    next_pool = p3[0]
            pool = next_pool
    for name, rec in (("K2", k2), ("K3", k3)):
        print(f"phase 3 {name} mesh {main.width}x{main.height} pool, cycle 2: "
              f"kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms, "
              f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}) ({card})",
              flush=True)
    return k2, k3


def preview_rays(scene, res, spp, dev):
    """One preview frame's rays (integrator.render_samples) at ``res`` and
    ``spp`` samples a pixel: (o, d, pixel_idx, sample_idx)."""
    import torch

    from path_tracer_tpu_torch.render.raygen import camera_arrays, camera_rays

    npix = res.num_pixels
    pix = torch.arange(npix, dtype=torch.int32, device=dev).repeat_interleave(spp)
    smp = torch.arange(spp, dtype=torch.int32, device=dev).repeat(npix)
    o, d = camera_rays(camera_arrays(scene.camera), pix, smp, seed=0,
                       width=res.width, height=res.height)
    return o, d, pix, smp


def check_stepped(scenes, dev, card):
    """K5 (cornell) and K6 (mesh) against their plain versions on one
    preview frame's rays at 450x300 x 2 spp, given rays and from their
    camera entries; K6 also on a random portal scene's frame and on a scene
    whose table exceeds its shared budget. Returns their kernels-line
    numbers."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.models.scene import pack_scene
    from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
    from path_tracer_tpu_torch.render.raygen import camera_arrays
    from path_tracer_tpu_torch.utils.config import Resolution

    res, spp, max_depth = Resolution(*PREVIEW), 2, 12
    out = {}
    for name, sid in (("K5", "cornell"), ("K6", "mesh")):
        packed = pack_scene(scenes[sid])
        if name == "K5":
            fn, plain = trace_v2.trace_stepped, trace_v2.trace_stepped_plain
            cam_fn, cam_plain = trace_v2.trace_camera, trace_v2.trace_camera_plain
            scene = trace_v2.build_scene_consts(packed).to(dev)
        else:
            fn, plain = trace_kernel.trace_stepped, trace_kernel.trace_stepped_plain
            cam_fn = trace_kernel.trace_camera
            cam_plain = trace_kernel.trace_camera_plain
            scene = trace_kernel.build_kernel_scene(packed).to(dev)
        o, d, pix, smp = preview_rays(scenes[sid], res, spp, dev)
        cam = camera_arrays(scenes[sid].camera)
        n = o.shape[0]
        table = torch.from_numpy(np.random.default_rng(5).random(
            (max_depth * 4, n), dtype=np.float32)).to(dev)
        rec = {"max_abs_err": 0.0}
        for source, uni in (("counter", None), ("table", table)):
            for steps in (12, 6 if uni is not None else 5):
                tag = f"{name} {sid} {res.width}x{res.height}x{spp}/{source}/{steps} steps"
                kw = dict(seed=7, pixel_idx=pix, sample_idx=smp, uniforms=uni,
                          max_depth=max_depth, steps_per_call=steps)
                rad_k, rays_k = fn(scene, o, d, **kw)
                t0 = time.perf_counter()
                rad_p, rays_p = plain(scene, o, d, **kw)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                stepped_compare(tag, (rad_k, rays_k), fn(scene, o, d, fmad=False, **kw),
                                (rad_p, rays_p), rec, f"plain {plain_s:.2f} s")
                ckw = dict(kw, width=res.width, height=res.height)
                work: dict = {}
                t0 = time.perf_counter()
                cam_p = (cam_plain(scene, cam, work=work, **ckw) if name == "K6"
                         else cam_plain(scene, cam, **ckw))
                torch.cuda.synchronize()
                cam_plain_s = time.perf_counter() - t0
                stepped_compare(f"{tag}/camera entry", cam_fn(scene, cam, **ckw),
                                cam_fn(scene, cam, fmad=False, **ckw), cam_p, rec)
                if source == "counter" and steps == max_depth:
                    # the preview's launch, the camera entry, on the kernels
                    # line; the given-ray call beside it
                    kw_t = dict(kw)
                    rec["given_ms"] = cuda_ms(lambda: fn(scene, o, d, **kw_t), 10)
                    rec["ms"] = cuda_ms(lambda: cam_fn(scene, cam, **ckw), 10)
                    rec["plain_ms"] = cam_plain_s * 1e3
                    segs = int(cam_p[1])
                    flops = n * FLOPS_RAYGEN + (
                        segs * FLOPS_K5_SEGMENT if name == "K5"
                        else isect_flops(work, segs))
                    # each ray reads its pixel and sample index once and
                    # writes its 14 state rows and its count once
                    rec["bound_ms"], rec["bound_by"] = bound_ms(
                        n * (8 + 56 + 4), flops)
        print(f"phase 3 {name} {sid} {res.width}x{res.height}x{spp}: camera "
              f"entry {rec['ms']:.3f} ms (given rays {rec['given_ms']:.3f} ms), "
              f"plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']}) ({card})", flush=True)
        out[name] = rec
    k5_design(scenes["cornell"], dev, card)
    check_k6_scenes(scenes["mesh"], dev, out["K6"])
    k6_design(scenes["mesh"], dev, card)
    return out["K5"], out["K6"]


def k5_design(cornell, dev, card):
    """K5's registers, resident blocks, the waves of the 1-, 2- and 4-spp
    preview frames and scripts/k5_coherence.py's lane shares there, on a
    line of its own."""
    import torch

    from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
    from path_tracer_tpu_torch.ops.kernels import trace_v2 as tv2
    from path_tracer_tpu_torch.utils.config import Resolution

    coh = script_module("k5_coherence")
    res = Resolution(*PREVIEW)
    regs = ptxas_registers(BUILT["trace_stepped.cu fmad=True"].log,
                           "trace_stepped_static_kernel")
    waves, shares = [], []
    for spp in (1, 2, 4):
        sc, cam, pix, smp = coh.frame(cornell, res, dev, spp)
        cfg = tv2.stepped_static_config(sc)
        state, steps = coh.camera_state(cam, pix, smp, seed=7, width=res.width,
                                        height=res.height)
        tk.stepped_call_plain(tv2.stepped_isect(sc),
                              tk.stepped_draw(7, pix, smp, None), state, steps,
                              depth0=0, n_steps=12, max_depth=12,
                              rr_start_depth=5)
        blocks = -(-pix.shape[0] // cfg["threads"])
        waves.append(f"{blocks / (cfg['blocks_per_sm'] * cfg['sms']):.3f}")
        shares.append(f"{coh.K2.thread_per_slot(steps.to(torch.int64))['lane_share']:.4f}")
    print(f"phase 3 K5 design: ptxas {' | '.join(regs)}; camera entry "
          f"{cfg['registers']} registers, {cfg['local_bytes']} local bytes a "
          f"thread, {cfg['blocks_per_sm']} blocks of {cfg['threads']} threads "
          f"an SM ({cfg['min_blocks']} asked of ptxas), {cfg['smem_bytes']} "
          f"shared bytes a block; waves of the 1/2/4-spp frames "
          f"{'/'.join(waves)}; lane-steps working (scripts/k5_coherence.py, "
          f"one thread a ray) {'/'.join(shares)} ({card})", flush=True)


def stepped_compare(tag, kern, exact, plain, rec, note="",
                    frac=LANE_FRAC) -> None:
    """(radiance, rays traced) of a stepped kernel, its --fmad=false build
    and its plain version: the second must equal the third bit for bit, the
    first agree on ``frac`` of the rays, with ray totals within SEG_TOL;
    rec["max_abs_err"] grows."""
    import torch

    torch.cuda.synchronize()
    if not (torch.equal(exact[0], plain[0]) and torch.equal(exact[1], plain[1])):
        fail(f"{tag}: the --fmad=false kernel is not bit-exact with its plain "
             "version")
    if not bool(torch.isfinite(kern[0]).all()):
        fail(f"{tag}: non-finite kernel radiance")
    share = lane_share(kern[0], plain[0])
    err = float((kern[0] - plain[0]).abs().max())
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    ratio = int(kern[1]) / max(int(plain[1]), 1)
    print(f"phase 3 {tag}: {share:.5f} of rays within {LANE_TOL} (need "
          f"{frac}); max |err| {err:.3g}; rays kernel/plain {ratio:.5f}"
          + (f"; {note}" if note else ""), flush=True)
    if share < frac or abs(ratio - 1.0) > SEG_TOL:
        fail(f"{tag}: kernel disagrees with its plain version")


def check_k6_scenes(mesh, dev, rec):
    """K6 beyond the mesh frame, given rays (12 steps) and from the camera
    entry: a 450x300 x 2 spp frame of a random portal-eligible scene
    (scripts/portal_fuzz_scenes.py) and of mesh with its tiles four times
    over, whose tables exceed the shared budget and take the read-only
    path."""
    import torch

    from path_tracer_tpu_torch.models.scene import pack_scene
    from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
    from path_tracer_tpu_torch.render.raygen import camera_arrays
    from path_tracer_tpu_torch.utils.config import Resolution

    res = Resolution(*PREVIEW)
    fuzz = script_module("portal_fuzz_scenes").fuzz_scene(3)
    ks = tk.build_kernel_scene(pack_scene(mesh)).to(dev)
    tiles = ks.tri[ks.tile_base:]
    big = tk.KernelScene(ks.sph, ks.bnd,
                         torch.cat([ks.tri[:ks.tile_base]] + [tiles] * 4),
                         torch.cat([ks.tiles] * 4), ks.tile_base)
    for sid, scene, tables, frac in (
            ("fuzz3", fuzz, tk.build_kernel_scene(pack_scene(fuzz)).to(dev),
             FUZZ_LANE_FRAC),
            ("mesh, tiles x4", mesh, big, LANE_FRAC)):
        shared = tk.k6_shared_table(tables)
        if sid.startswith("mesh") and shared:
            fail("K6: a table above the shared budget was staged")
        o, d, pix, smp = preview_rays(scene, res, 2, dev)
        kw = dict(seed=7, pixel_idx=pix, sample_idx=smp)
        tag = (f"K6 {sid} {res.width}x{res.height}x2 ({tk.k6_table_bytes(tables)} "
               f"table bytes, shared memory {shared})")
        stepped_compare(tag, tk.trace_stepped(tables, o, d, **kw),
                        tk.trace_stepped(tables, o, d, fmad=False, **kw),
                        tk.trace_stepped_plain(tables, o, d, **kw), rec, frac=frac)
        ckw = dict(kw, width=res.width, height=res.height)
        cam = camera_arrays(scene.camera)
        stepped_compare(f"{tag}/camera entry", tk.trace_camera(tables, cam, **ckw),
                        tk.trace_camera(tables, cam, fmad=False, **ckw),
                        tk.trace_camera_plain(tables, cam, **ckw), rec, frac=frac)


def k6_design(mesh, dev, card):
    """K6's registers, resident blocks, shared bytes and the coherence
    model's shares on the preview frame, on lines of their own."""
    from path_tracer_tpu_torch.models.scene import pack_scene
    from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
    from path_tracer_tpu_torch.utils.config import Resolution

    regs = ptxas_registers(BUILT["trace_stepped.cu fmad=True"].log)
    ks = tk.build_kernel_scene(pack_scene(mesh)).to(dev)
    cfg = tk.stepped_prim_config(ks, camera=True)
    print(f"phase 3 K6 design: ptxas {' | '.join(regs)}; camera entry "
          f"{cfg['registers']} registers, {cfg['local_bytes']} local bytes a "
          f"thread, {cfg['blocks_per_sm']} blocks of {cfg['threads']} threads "
          f"an SM, {cfg['smem_bytes']} dynamic + {cfg['static_smem_bytes']} "
          f"static shared bytes a block, table in shared memory "
          f"{cfg['shared_table']}, chunk sort {cfg['sort']} in chunks of "
          f"{cfg['window']} rays ({card})", flush=True)
    coh = script_module("k6_coherence")
    res = Resolution(*PREVIEW)
    ks, cam, pix, smp = coh.frame(mesh, res, dev)
    steps, tiles, keys, live, _ = coh.trace_record(ks, cam, pix, smp, res.width,
                                                   res.height)
    resident = cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"]
    m = coh.coherence(ks, steps, tiles, keys, live, resident, refill_mins=(4,),
                      windows=(cfg["window"],))
    w = cfg["window"]
    print(f"phase 3 K6 coherence (scripts/k6_coherence.py) on the frame: "
          f"{m['rays']} rays, {m['steps']} steps, path lengths "
          f"{m['path_length_p10_25_50_75_90']} (10/25/50/75/90th); one thread "
          f"a ray: lane-steps {m['thread_per_ray']['lane_share']:.4f}, useful "
          f"rows {m['thread_per_ray']['useful_row_share']:.4f}; persistent, "
          f"refill at 4: lane-steps {m['persistent_refill_4']['lane_share']:.4f}; "
          f"chunks of {w} packed / sorted: useful rows "
          f"{m[f'chunks_of_{w}_packed']['useful_row_share']:.4f} / "
          f"{m[f'chunks_of_{w}_sorted']['useful_row_share']:.4f}", flush=True)


def k7_call(fn, ks, state, pix, smp, **kw):
    """K7 (or its plain version) as (state [15, n], counts [n])."""
    import torch

    out = fn(ks, *state, pixel_idx=pix, sample_idx=smp, **kw)
    return torch.cat(out[:7]), out[7][0]


def check_v1(mesh, dev, card, main):
    """K8 on a fresh v1 pool of mesh primary rays at 1024x768 (1,048,576
    lanes, as the deleted v1 scheduler sized it), K7 on the first F_cap
    lanes of that pool after K8 and the v1 cycle's partition, and K7 at the
    glue shape (the 4 x 786,432 lanes of a mid-drive park-3 v2 pool), each
    against its plain version with both uniform sources; the lanes are
    scripts/ablate_k7.py's. Returns the K8 and K7 kernels-line dicts (K7
    timed at the v1 shape; the glue shape's time in k7["glue_ms"]), with
    the launches of one call each (K8 on the v1 pool, K7 at the v1 front),
    counted from 0 just before it."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.ops.kernels import portal as pk
    from path_tracer_tpu_torch.ops.kernels import trace_kernel
    from path_tracer_tpu_torch.render import portal as rp
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    lanes_of = script_module("ablate_k7")
    seed, max_depth = 7, 12
    prep = prepare_render(mesh, main, dev)
    pc, ks = prep.portal, prep.kscene
    npix = main.num_pixels
    C = min(lanes_of.V1_POOL, rp._round_block(npix * 4))
    F_cap = C // 2
    pool = lanes_of.v1_pool(prep, npix, C, limit=C, seed=seed)
    if not bool((pool[pk.ROW_ALIVE] > 0).all()):
        fail("the v1 refill left free slots")
    rng = np.random.default_rng(6)
    k8 = {"max_abs_err": 0.0}
    for source in ("counter", "table"):
        uni = None if source == "counter" else torch.from_numpy(
            rng.random((4, C), dtype=np.float32)).to(dev)
        kw = dict(seed=seed, max_depth=max_depth, uniforms=uni)
        work: dict = {}
        kern = pk.trace_cheap_blocked(pc, pool, **kw)
        exact = pk.trace_cheap_blocked(pc, pool, fmad=False, **kw)
        t0 = time.perf_counter()
        plain = pk.trace_cheap_blocked_plain(pc, pool, work=work, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        compare(f"K8 mesh v1 pool {C}/{source}", kern, exact, plain, k8)
        if source == "counter":
            k8["ms"] = cuda_ms(lambda: pk.trace_cheap_blocked(pc, pool, **kw), 5)
            k8["plain_ms"] = plain_s * 1e3
            k8["bound_ms"], k8["bound_by"] = bound_ms(
                2 * pool.numel() * 4 + C * 4,
                work.get("scan", 0) * (FLOPS_SLAB + pc.scene.prims.shape[0] * FLOPS_TRI)
                + work.get("shade", 0) * (FLOPS_SHADE + FLOPS_HIT))
            frozen = plain[0]
    pk.trace_cheap_blocked.launches = 0  # one K8 call on the v1 pool
    pk.trace_cheap_blocked(pc, pool, seed=seed, max_depth=max_depth)
    torch.cuda.synchronize()
    k8["launches"] = pk.trace_cheap_blocked.launches
    print(f"phase 3 K8 mesh v1 pool {C}: {int((frozen[pk.ROW_ALIVE] > 0).sum())} "
          f"lanes frozen at the portal; kernel {k8['ms']:.3f} ms, plain "
          f"{k8['plain_ms']:.1f} ms, bound {k8['bound_ms']:.3f} ms "
          f"({k8['bound_by']}); {k8['launches']} launches a call ({card})",
          flush=True)
    cfg = pk.cheap_blocked_config(pc)
    print(f"phase 3 K8 design: ptxas "
          f"{' | '.join(ptxas_registers(BUILT['portal_cheap_blocked.cu fmad=True'].log))}; "
          f"group {pk.BLOCKED_GROUP} (a warp's vote): {cfg['registers']} "
          f"registers, {cfg['local_bytes']} local bytes a thread, "
          f"{cfg['blocks_per_sm']} blocks of {cfg['threads']} threads an SM, "
          f"{cfg['smem_bytes']} shared bytes a block; {k8['ms']:.3f} ms "
          f"against a {k8['bound_ms']:.3f} ms bound ({card})", flush=True)

    v1_lanes = lanes_of.v1_front(frozen, F_cap)
    # the glue shape: a park-3 v2 pool two cycles into a drive, then K2
    park_k = 3
    n2 = rp._round_block(npix)
    pool2 = rp.make_pool_v2(npix, n2, 256, park_k=park_k, device=dev)
    cheap = dict(seed=seed, quota=256, sample_base=0, step_cap=64,
                 park_k=park_k, max_depth=max_depth)
    for _ in range(2):
        pool2, _ = pk.trace_cheap_regen(pc, prep.cam, pool2, **cheap)
        pool2, _, _ = rp.portal_resolve_phase(pool2, ks, seed=seed, park_k=park_k,
                                              max_depth=max_depth, rr_start_depth=5)
    pool2, _ = pk.trace_cheap_regen(pc, prep.cam, pool2, **cheap)
    glue_lanes = lanes_of.glue_lanes(pool2, park_k)

    k7 = {"max_abs_err": 0.0}
    for shape, (state, pix, smp) in (("v1 front", v1_lanes), ("glue", glue_lanes)):
        n = pix.shape[0]
        live = int((state[4] > 0).sum())
        for source in ("counter", "table"):
            uni = None if source == "counter" else torch.from_numpy(
                rng.random((4, n), dtype=np.float32)).to(dev)
            kw = dict(seed=seed, max_depth=max_depth, uniforms=uni)
            work = {}
            kern = k7_call(trace_kernel.trace_resolve, ks, state, pix, smp, **kw)
            exact = k7_call(trace_kernel.trace_resolve, ks, state, pix, smp,
                            fmad=False, **kw)
            t0 = time.perf_counter()
            plain = k7_call(trace_kernel.trace_resolve_plain, ks, state, pix, smp,
                            work=work, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            compare(f"K7 mesh {shape} {n} lanes ({live} alive)/{source}", kern,
                    exact, plain, k7)
            if source != "counter":
                continue
            ms = cuda_ms(lambda: trace_kernel.trace_resolve(
                ks, *state, pixel_idx=pix, sample_idx=smp, **kw), 5)
            # 15 state rows in, 16 out, pixel and sample index
            bound = bound_ms(n * (15 * 4 + 16 * 4 + 8), isect_flops(work, live))
            print(f"phase 3 K7 mesh {shape} {n} lanes: kernel {ms:.3f} ms, plain "
                  f"{plain_s * 1e3:.1f} ms, bound {bound[0]:.3f} ms ({bound[1]}) "
                  f"({card})", flush=True)
            if shape == "glue":
                k3_ms = cuda_ms(lambda: pk.trace_resolve_pool(
                    ks, pool2, seed=seed, parts=park_k + 1, park_k=park_k,
                    max_depth=max_depth), 5)
                print(f"phase 3 K7 glue {ms:.3f} ms beside K3 {k3_ms:.3f} ms on "
                      f"the same pool (the same bounces) ({card})", flush=True)
            else:
                k7["ms"], k7["plain_ms"] = ms, plain_s * 1e3
                k7["bound_ms"], k7["bound_by"] = bound
                trace_kernel.trace_resolve.launches = 0  # one K7 call, v1 front
                k7_call(trace_kernel.trace_resolve, ks, state, pix, smp, **kw)
                torch.cuda.synchronize()
                k7["launches"] = trace_kernel.trace_resolve.launches
            k7_design(ks, shape, state, card)
    return k8, k7


def k7_design(ks, shape, state, card):
    """K7's registers, shared bytes, blocks an SM and the schedule model's
    shares on one of its shapes, on lines of their own."""
    from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk

    cfg = tk.resolve_config(ks)
    regs = ptxas_registers(BUILT["trace_stepped.cu fmad=True"].log)
    m = script_module("k4_coherence").resolve_model(
        ks, list(state[0]), list(state[1]), state[5][0], state[4][0] > 0,
        threads=cfg["threads"])
    print(f"phase 3 K7 design ({shape}): ptxas {' | '.join(regs)}; "
          f"{cfg['registers']} registers, {cfg['local_bytes']} local bytes a "
          f"thread, {cfg['blocks_per_sm']} block of {cfg['threads']} threads "
          f"an SM, {cfg['smem_bytes']} dynamic + {cfg['static_smem_bytes']} "
          f"static shared bytes, table in shared memory {cfg['shared_table']}, "
          f"{cfg['group']} lanes a tile query; model: {m['live']} live lanes, "
          f"{m['warp_queries']} enter a tile; useful rows one thread a lane "
          f"{m['thread_per_lane']['useful_row_share']:.4f}, split "
          f"{m['split']['useful_row_share']:.4f}, sorted "
          f"{m['sorted']['useful_row_share']:.4f} ({card})", flush=True)


def check_strip(dev, card):
    """K3 and K6 on scripts/portal_fuzz_scenes.py's strip scene (35 tiles
    in a row): every other column of a K3 pool, and half of K6's rays, run
    along the strip, so their tile-entry keys hold every key tile, next to
    the sort's pad key; the --fmad=false builds must equal the plain
    versions bit for bit, every ray bounced and counted."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.ops.kernels import portal as pk
    from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
    from path_tracer_tpu_torch.render.raygen import camera_arrays, camera_rays
    from path_tracer_tpu_torch.utils.config import Resolution

    scenes = script_module("portal_fuzz_scenes")
    scene = scenes.strip_scene()
    res = Resolution(96, 128)
    ks, pool = script_module("k3_coherence").k3_input_pool(scene, res, dev)
    g = np.random.default_rng(12)
    cols = torch.arange(0, pool.shape[1], 2, device=dev)
    o, d = (torch.from_numpy(a.T.copy()).to(dev)
            for a in scenes.strip_rays(cols.numel(), g))
    pool[pk.ROW_O:pk.ROW_O + 3, cols] = o
    pool[pk.ROW_D:pk.ROW_D + 3, cols] = d
    pool[pk.ROW_THR:pk.ROW_THR + 3, cols] = 1.0
    pool[pk.ROW_ALIVE, cols] = 1.0
    pool[pk.ROW_PREV, cols] = -1.0
    kw = dict(seed=3, parts=4, park_k=3)
    plain = pk.trace_resolve_pool_plain(ks, pool, **kw)
    exact = pk.trace_resolve_pool(ks, pool, fmad=False, **kw)
    torch.cuda.synchronize()
    k3_lost = int((exact[0] != plain[0]).any(dim=0).sum())
    npix = res.num_pixels
    pix = torch.arange(npix, dtype=torch.int32, device=dev).repeat_interleave(2)
    smp = torch.arange(2, dtype=torch.int32, device=dev).repeat(npix)
    o, d = camera_rays(camera_arrays(scene.camera), pix, smp, seed=0,
                       width=res.width, height=res.height)
    along = torch.from_numpy(g.random(o.shape[0]) < 0.5).to(dev)
    so, sd = (torch.from_numpy(a).to(dev) for a in scenes.strip_rays(o.shape[0], g))
    o = torch.where(along[:, None], so, o).contiguous()
    d = torch.where(along[:, None], sd, d).contiguous()
    skw = dict(seed=4, pixel_idx=pix, sample_idx=smp)
    p6 = tk.trace_stepped_plain(ks, o, d, **skw)
    e6 = tk.trace_stepped(ks, o, d, fmad=False, **skw)
    torch.cuda.synchronize()
    k6_lost, k6_extra = int((e6[0] != p6[0]).any(dim=1).sum()), int(e6[1]) - int(p6[1])
    print(f"phase 3 strip scene ({ks.tiles.shape[0]} tiles in a row): K3 "
          f"{k3_lost} of {pool.shape[1]} columns differ, counts equal "
          f"{torch.equal(exact[1], plain[1])}; K6 {k6_lost} of {o.shape[0]} rays "
          f"differ, bounces kernel - plain {k6_extra} ({card})", flush=True)
    if k3_lost or k6_lost or k6_extra or not torch.equal(exact[1], plain[1]):
        fail("a sort pad dropped or doubled a ray on the strip scene")


def check_sorted(mesh, dev, card):
    """K9 on one preview frame's mesh rays at 450x300 x 2 spp against K6 on
    the same rays (scripts/bench_sorted.py's measurement of the JAX
    package): the sorted trace equals K6 ray for ray in both builds, the
    --fmad=false build equals the plain version bit for bit. Times K9 sorted
    every 1 and 3 bounces and K6 in calls of 12 and 1 steps; returns the
    kernels-line dict, whose launches are one sorted trace's."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.models.scene import pack_scene
    from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
    from path_tracer_tpu_torch.utils.config import Resolution

    res, spp, max_depth = Resolution(*PREVIEW), 2, 12
    ks = tk.build_kernel_scene(pack_scene(mesh)).to(dev)
    o, d, pix, smp = preview_rays(mesh, res, spp, dev)
    n = o.shape[0]
    rec = {"max_abs_err": 0.0}
    for source in ("counter", "table"):
        uni = None if source == "counter" else torch.from_numpy(
            np.random.default_rng(8).random((max_depth * 4, n),
                                            dtype=np.float32)).to(dev)
        tag = f"K9 mesh {res.width}x{res.height}x{spp}/{source}"
        kw = dict(seed=7, pixel_idx=pix, sample_idx=smp, uniforms=uni,
                  max_depth=max_depth)
        work: dict = {}
        k9 = tk.trace_sorted(ks, o, d, sort_every=1, **kw)
        k6 = tk.trace_stepped(ks, o, d, steps_per_call=1, **kw)
        e9 = tk.trace_sorted(ks, o, d, sort_every=1, fmad=False, **kw)
        e6 = tk.trace_stepped(ks, o, d, steps_per_call=1, fmad=False, **kw)
        t0 = time.perf_counter()
        p9 = tk.trace_sorted_plain(ks, o, d, sort_every=1, work=work, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(k9 + e9, k6 + e6)):
            fail(f"{tag}: the sorted trace differs from K6 on the same rays")
        if not all(torch.equal(a, b) for a, b in zip(e9, p9)):
            fail(f"{tag}: the --fmad=false kernel is not bit-exact with its "
                 "plain version")
        frac = lane_share(k9[0], p9[0])
        err = float((k9[0] - p9[0]).abs().max())
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"phase 3 {tag}: equals K6 {torch.equal(k9[0], k6[0])}; {frac:.5f} "
              f"of rays within {LANE_TOL} of the plain version (need "
              f"{LANE_FRAC}); max |err| {err:.3g}; plain {plain_s:.2f} s",
              flush=True)
        if frac < LANE_FRAC:
            fail(f"{tag}: kernel disagrees with its plain version")
        if source != "counter":
            continue
        times = {f"K9 sort every {k}": cuda_ms(lambda k=k: tk.trace_sorted(
            ks, o, d, sort_every=k, **kw), 5) for k in (1, 3)}
        times.update({f"K6 {k} steps a call": cuda_ms(lambda k=k: tk.trace_stepped(
            ks, o, d, steps_per_call=k, **kw), 5) for k in (12, 1)})
        rec["ms"] = times["K9 sort every 1"]
        rec["plain_ms"] = plain_s * 1e3
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            n * (24 + 8 + 12), isect_flops(work, int(p9[1])))
        tk.trace_sorted.launches = 0  # one sorted trace, as bench_sorted runs it
        tk.trace_sorted(ks, o, d, sort_every=1, **kw)
        torch.cuda.synchronize()
        rec["launches"] = tk.trace_sorted.launches
        print(f"phase 3 K9 vs K6 mesh {res.width}x{res.height}x{spp}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
              + f"; K9 plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.3f} "
              f"ms ({rec['bound_by']}); {rec['launches']} launches a trace ({card})",
              flush=True)
    return rec


OPS_FRAMES = 5  # frames of step_u8 under torch.profiler, phase 6


def device_ops_per_frame(step) -> float:
    """Device operations (kernels, copies, fills: torch.profiler's CUDA
    events) a frame of ``step``, over OPS_FRAMES frames."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(OPS_FRAMES):
            step()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / OPS_FRAMES


def check_preview(scenes, dev, card, counters):
    """Phase 6: the progressive preview on the card. Returns the launches
    of K5 and K6 over its runs."""
    import numpy as np
    import torch

    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.ops import tonemap
    from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
    from path_tracer_tpu_torch.render import integrator
    from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
    from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer

    res = Resolution(*PREVIEW)
    want = {"cornell": trace_v2.trace_stepped, "mesh": trace_kernel.trace_stepped}
    launches = {"cornell": 0, "mesh": 0}
    for sid in ("cornell", "mesh"):
        for spp in (1, 2, 4):
            for c in counters:
                c.launches = 0
            r = ProgressiveRenderer(scenes[sid], res, spp_per_frame=spp,
                                    device=dev)
            r.step()  # warm-up
            times = {}
            for name, fn in (("step", r.step), ("step_u8", r.step_u8)):
                ts = []
                for _ in range(8):
                    t0 = time.perf_counter()
                    fn()  # both end in a device-to-host copy
                    ts.append(time.perf_counter() - t0)
                times[name] = sorted(ts)[1]
            ops = device_ops_per_frame(r.step_u8)
            frame = r.step_u8()
            fin = integrator.finalize(r._accum, r.samples_done).cpu().numpy()
            if not np.array_equal(frame, tonemap.quantize_np(fin)):
                fail(f"preview {sid} {spp} spp: step_u8 differs from quantize_np")
            restarts = []
            cam = r.scene.camera
            for k in range(3):
                moved = pt.Camera.looking(cam.position + np.float32(0.01 * (k + 1)),
                                          cam.direction)
                t0 = time.perf_counter()
                r.move_camera(moved)
                r.step_u8()
                restarts.append(time.perf_counter() - t0)
            counts = {c.__module__.rsplit(".", 1)[-1] + "." + c.__name__: c.launches
                      for c in counters}
            frames = 1 + 8 + 8 + OPS_FRAMES + 1 + 3
            others = [k for c, (k, v) in zip(counters, counts.items())
                      if c is not want[sid] and v]
            if want[sid].launches != frames or others:
                fail(f"preview {sid} {spp} spp: launches {counts}, want "
                     f"{frames} of {want[sid].__module__}.trace_stepped only")
            launches[sid] += want[sid].launches
            print(f"phase 6 preview {sid} {res.width}x{res.height} {spp} spp/frame: "
                  f"step {times['step'] * 1e3:.2f} ms ({1 / times['step']:.1f} fps), "
                  f"step_u8 {times['step_u8'] * 1e3:.2f} ms "
                  f"({1 / times['step_u8']:.1f} fps), restart "
                  f"{sorted(restarts)[1] * 1e3:.2f} ms (2nd best of 3); "
                  f"{ops:.1f} device operations a frame (torch.profiler); "
                  f"launches {counts} ({card})", flush=True)
        # 8 frames at 2 spp against a 16-spp render of the same seed
        r = ProgressiveRenderer(scenes[sid], res, spp_per_frame=2, device=dev)
        for _ in range(8):
            img = r.step().pixels
        cfg = RenderConfig(samples_per_pixel=16, resolution=res)
        ref = pt.render(scenes[sid], cfg, device=dev, out_dir=None, verbose=False)
        ref1 = pt.render(scenes[sid], cfg.with_(seed=1), device=dev, out_dir=None,
                         verbose=False)
        same = float(np.abs(img - ref.image.pixels).mean())
        noise = float(np.abs(ref1.image.pixels - ref.image.pixels).mean())
        print(f"phase 6 preview {sid} 8 x 2 spp vs render() 16 spp: mean |Δ| "
              f"{same:.6f}, render seed 0 vs 1 {noise:.5f}", flush=True)
        if not (np.isfinite(img).all() and same <= 0.25 * noise):
            fail(f"preview {sid}: 8 frames of 2 spp disagree with render()")
    return launches["cornell"], launches["mesh"]


def decode_png(png: bytes):
    """8-bit RGB PNG with filter 0 on every row (what the app writes) →
    [H, W, 3] uint8; checks every chunk's CRC."""
    import numpy as np

    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(png):
        n, tag = struct.unpack(">I4s", png[pos:pos + 8])
        data = png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat += data
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype = header[:4]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if depth != 8 or ctype != 2 or (rows[:, 0] != 0).any():
        raise ValueError("not 8-bit RGB with filter 0")
    return rows[:, 1:].reshape(h, w, 3)


def check_app(dev, card):
    """Phase 7: the viewer app on the card, driven over HTTP."""
    import numpy as np

    from path_tracer_tpu_torch.ops import tonemap
    from path_tracer_tpu_torch.render import integrator
    from path_tracer_tpu_torch.viewer.app import make_server

    server = make_server(0, os.path.join(ROOT, "scenes"),
                         os.path.join(ROOT, "meshes"), device=dev)
    state = server.state
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None, quiet=False):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode())
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            data, etag = resp.read(), resp.headers.get("ETag")
        ms = (time.perf_counter() - t0) * 1e3
        if not quiet:
            print(f"phase 7 {method} {path} {json.dumps(body) if body else ''}: "
                  f"{ms:.2f} ms, {len(data)} bytes", flush=True)
        return data, etag

    try:
        s = json.loads(call("GET", "/state")[0])
        if s["scene"] != "mesh":
            fail(f"the app opened on {s['scene']}, not mesh")
        tags = []
        for _ in range(3):
            png, etag = call("GET", "/preview.png")
            img = decode_png(png)
            tags.append(etag)
            r = state.preview
            h, w = r.resolution.height, r.resolution.width
            if img.shape != (h, w, 3):
                fail(f"/preview.png is {img.shape}, want {(h, w, 3)}")
        want = tonemap.quantize_np(integrator.finalize(
            r._accum, r.samples_done).cpu().numpy()).astype(np.uint8)
        if not np.array_equal(img, want.reshape(h, w, 3)[::-1, ::-1, :]):
            fail("the last /preview.png is not the preview's frame")
        if len(set(tags)) != 3:
            fail(f"/preview.png etags did not change: {tags}")
        call("POST", "/control", {"action": "orbit", "dx": 40, "dy": 25})
        call("POST", "/pick", {"relx": 0.5, "rely": 0.5})
        probe = json.loads(call("POST", "/probe", {"relx": 0.5, "rely": 0.5})[0])
        if not probe.get("distance", 0) > 0:
            fail(f"/probe found nothing: {probe}")
        call("POST", "/select_scene", {"id": "cornell"})
        t0 = time.perf_counter()
        call("POST", "/start_render", {"spp": 16, "res_y": 120})
        polls = 0
        while time.perf_counter() - t0 < 120:
            s = json.loads(call("GET", "/state", quiet=True)[0])
            polls += 1
            if s["render_state"] == "done" or s["render_error"]:
                break
            time.sleep(0.1)
        print(f"phase 7 render to done in {time.perf_counter() - t0:.2f} s "
              f"({polls} polls of /state): "
              f"state {s['render_state']}, error {s['render_error']}, "
              f"{s['render_seconds']:.3f} s in render() ({card})", flush=True)
        if s["render_state"] != "done" or s["render_error"]:
            fail(f"the app's render did not finish: {s}")
        img = decode_png(call("GET", "/render.png")[0])
        if img.shape != (120, 180, 3) or img.max() == 0:
            fail(f"/render.png is {img.shape}, max {img.max()}")
    except (urllib.error.URLError, ValueError, KeyError) as e:
        fail(f"the viewer app: {e!r}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if state._render_thread is not None:
            state._render_thread.join(timeout=120)
    print("phase 7 done", flush=True)


def check_wavefront(scenes, card, counters):
    """Phase 8: the wavefront integrator and the raster preview on the
    card, each against what it must agree with."""
    import numpy as np
    import torch

    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.render import integrator, pipeline, raygen
    from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
    from path_tracer_tpu_torch.viewer import raster
    from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the fast form needs float32")
    from path_tracer_tpu_torch import native

    print(f"phase 8 host native runtime: "
          f"{native.library_path() if native.native_available() else 'not built (no C++ compiler), Python fallbacks'}",
          flush=True)

    def run(tag, scene, cfg, device="cuda", route="wavefront"):
        """render() with the launch counts zeroed just before and read
        just after; fails on a wrong route, a kernel launched on the
        wavefront, inexact counts or a bad image."""
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        done = pt.render(scene, cfg, device=device, out_dir=None, verbose=False)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launched = [c.launches for c in counters]
        s = done.stats
        res = cfg.resolution
        img = done.image.pixels
        if s.extra.get("route") != route:
            fail(f"{tag}: route {s.extra.get('route')!r}, want {route!r}")
        if route == "wavefront" and any(launched):
            fail(f"{tag}: the wavefront launched kernels {launched} (K1..K9)")
        if s.num_samples != cfg.samples_per_pixel * res.num_pixels:
            fail(f"{tag}: {s.num_samples} samples, want "
                 f"{cfg.samples_per_pixel * res.num_pixels}")
        if img.shape != (res.num_pixels, 3) or not np.isfinite(img).all():
            fail(f"{tag}: bad image, shape {img.shape}")
        if device == "cuda":
            print(f"phase 8 {tag}: wall {s.wall_seconds:.4f} s, "
                  f"{s.mrays_per_sec:.1f} Mray/s, {s.num_rays} segments, "
                  f"{s.num_dispatches} dispatches, peak "
                  f"{peak:.3f} GiB allocated; mean "
                  f"{img.mean(axis=0).round(4).tolist()} ({card})", flush=True)
        return done

    def mean_abs(a, b):
        return float(np.abs(a.image.pixels - b.image.pixels).mean())

    big = Resolution(768, 1024)
    cfg = RenderConfig(samples_per_pixel=64, resolution=big, backend="fast")
    for when in ("first", "warm"):
        wave = run(f"cornell 1024x768 64 spp fast (wavefront), {when} render",
                   scenes["cornell"], cfg)
    k1 = run("cornell 1024x768 64 spp K1", scenes["cornell"],
             cfg.with_(backend="auto"), route="regen")
    k1_seed1 = run("cornell 1024x768 64 spp K1 seed 1", scenes["cornell"],
                   cfg.with_(backend="auto", seed=1), route="regen")
    same, noise = mean_abs(wave, k1), mean_abs(k1_seed1, k1)
    print(f"phase 8 cornell 1024x768 64 spp: wavefront vs K1 (same seed, the "
          f"same keyed draws) mean |Δ| {same:.6f}, K1 seed 0 vs 1 {noise:.5f}; "
          f"K1 wall {k1.stats.wall_seconds:.4f} s, "
          f"{k1.stats.mrays_per_sec:.1f} Mray/s", flush=True)
    if not same <= 0.25 * noise:
        fail("the wavefront image disagrees with K1's beyond ulp flips")

    run("mesh 1024x768 4 spp fast (wavefront, pixel chunks)", scenes["mesh"],
        RenderConfig(samples_per_pixel=4, resolution=big, backend="fast"))

    small = Resolution(192, 256)
    fast = run("cornell 256x192 16 spp fast", scenes["cornell"],
               RenderConfig(samples_per_pixel=16, resolution=small,
                            backend="fast"))
    fast1 = run("cornell 256x192 16 spp fast seed 1", scenes["cornell"],
                RenderConfig(samples_per_pixel=16, resolution=small,
                             backend="fast", seed=1))
    exact = run("cornell 256x192 16 spp exact", scenes["cornell"],
                RenderConfig(samples_per_pixel=16, resolution=small,
                             backend="exact"))
    lit = run("cornell 256x192 16 spp literal estimator", scenes["cornell"],
              RenderConfig(samples_per_pixel=16, resolution=small,
                           estimator="literal"))
    noise = mean_abs(fast1, fast)
    print(f"phase 8 cornell 256x192 16 spp: exact vs fast mean |Δ| "
          f"{mean_abs(exact, fast):.6f}, literal vs shipped "
          f"{mean_abs(lit, fast):.5f}, fast seed 0 vs 1 {noise:.5f}", flush=True)
    if not mean_abs(exact, fast) <= 0.25 * noise:
        fail("the exact form disagrees with the fast form beyond ulp flips")

    mock_cfg = RenderConfig(samples_per_pixel=8, resolution=Resolution(64, 96),
                            mock_random=True)
    card_mock = run("cornell 96x64 8 spp mock_random", scenes["cornell"], mock_cfg)
    cpu_mock = run("cpu mock", scenes["cornell"], mock_cfg, device="cpu")
    diff = np.abs(card_mock.image.pixels - cpu_mock.image.pixels).max(axis=1)
    share = float((diff <= 1e-4).mean())
    print(f"phase 8 mock_random cornell 96x64 8 spp: card vs cpu {share:.5f} of "
          f"pixels within 1e-4 (need 0.99), segments {card_mock.stats.num_rays} "
          f"vs {cpu_mock.stats.num_rays}", flush=True)
    if share < 0.99:
        fail("the card's mock_random render parts from the CPU's")

    res = Resolution(64, 96)
    cam = raygen.camera_arrays(scenes["cornell"].camera)
    pix = torch.arange(res.num_pixels, dtype=torch.int32, device="cuda")
    smp = torch.zeros_like(pix)
    for backend in ("exact", "fast"):
        prep = pipeline.prepare_render(scenes["cornell"], res, "cuda",
                                       backend=backend)
        for opts in ({}, {"mock_random": True}, {"literal": True}):
            out = integrator.render_samples(prep, cam, pix, smp, seed=0,
                                            width=res.width, height=res.height,
                                            **opts)
            if (out.radiance.device.type != "cuda"
                    or not bool(torch.isfinite(out.radiance).all())
                    or int(out.rays_traced) < res.num_pixels):
                fail(f"render_samples {backend} {opts} on the card")
    preview = ProgressiveRenderer(scenes["cornell"], Resolution(*PREVIEW),
                                  backend="fast", device="cuda")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        preview.step_u8()
        times.append(time.perf_counter() - t0)
    print(f"phase 8 preview on the wavefront, cornell 450x300 2 spp a frame: "
          f"frame {sorted(times)[1] * 1e3:.2f} ms (2nd best of 3)", flush=True)

    t0 = time.perf_counter()
    card_r = raster.render_preview(scenes["cornell"], 450, 300, device="cuda")
    first = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        raster.render_preview(scenes["cornell"], 450, 300, device="cuda")
        times.append(time.perf_counter() - t0)
    cpu_r = raster.render_preview(scenes["cornell"], 450, 300, device="cpu")
    depth = np.abs(card_r["depth"] - cpu_r["depth"])
    color = np.abs(card_r["color"] - cpu_r["color"]).max(axis=2)
    d_share, c_share = float((depth <= 1e-5).mean()), float((color <= 1e-5).mean())
    print(f"phase 8 raster preview cornell 450x300: card vs cpu depth "
          f"{d_share:.5f} and color {c_share:.5f} of pixels within 1e-5 (need "
          f"0.999), max |Δ| depth {depth.max():.2e}; first {first:.3f} s, warm "
          f"{sorted(times)[1] * 1e3:.1f} ms (2nd best of 3) ({card})", flush=True)
    if d_share < 0.999 or c_share < 0.999:
        fail("the card's raster preview parts from the CPU's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.ops.kernels import portal as pk
    from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
    from path_tracer_tpu_torch.render.image import read_ppm
    from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution

    dev = torch.device("cuda")
    card = card_line()
    print(f"phase 1 ok: card {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lines = build_all()
    for line in lines:
        print(f"phase 2 built {line}", flush=True)
    print(f"phase 2 ok: {len(lines)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)

    scenes = {sid: pt.load_scene(sid, os.path.join(ROOT, "scenes"),
                                 os.path.join(ROOT, "meshes"))
              for sid in ("cornell", "three-spheres", "mesh")}
    # mesh with a second copy of its MeshFile: the default router's `prim`
    scenes["two-mesh"] = script_module("k4_coherence").two_mesh_scene(pt, ROOT)
    for name in K4_CELLS:  # the K4 cells' scenes
        path = os.path.join(ROOT, "bench_torch", "configs", name, name + ".json")
        with open(path) as fh:
            scenes[name] = pt.SceneDescriptor.from_json_dict(
                json.load(fh), base_dir=os.path.dirname(path))
    small, main_res = Resolution(192, 256), Resolution(768, 1024)

    # ---- phase 3: kernels against their plain versions ----
    k1 = check_k1(scenes, dev, card)
    k4 = check_k4(scenes, dev, card, small, main_res)
    for name in K4_CELLS:
        check_k4_cell(name, scenes[name], dev, card)
    k2, k3 = check_portal(scenes["mesh"], dev, card, small, main_res)
    check_k2_shapes(scenes["mesh"], dev, card, main_res, k2)
    k5, k6 = check_stepped(scenes, dev, card)
    check_strip(dev, card)
    k8, k7 = check_v1(scenes["mesh"], dev, card, main_res)
    k9 = check_sorted(scenes["mesh"], dev, card)
    print("phase 3 done", flush=True)

    # ---- phase 4: the main paths through render() ----
    counters = (trace_v2.trace_regen, pk.trace_cheap_regen,
                pk.trace_resolve_pool, trace_kernel.trace_regen_prim,
                trace_v2.trace_stepped, trace_kernel.trace_stepped,
                trace_kernel.trace_resolve, pk.trace_cheap_blocked,
                trace_kernel.trace_sorted)

    def run(scene, cfg, env=None):
        """render() on the card with the launch counts zeroed just before
        and read just after; returns (RenderDone, launches per kernel)."""
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            for c in counters:
                c.launches = 0
            with tempfile.TemporaryDirectory() as tmp:
                done = pt.render(scene, cfg, device="cuda", out_dir=tmp,
                                 verbose=False)
            return done, [c.launches for c in counters]
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def report(tag, done, launches, want_mean=None):
        img = done.image.pixels
        s = done.stats
        if img.shape != (1024 * 768, 3) or not np.isfinite(img).all():
            fail(f"{tag}: bad image, shape {img.shape}")
        mean = img.mean(axis=0)
        if want_mean and not ((mean > want_mean[0]).all()
                              and (mean < want_mean[1]).all()):
            fail(f"{tag}: mean radiance {mean} outside {want_mean}")
        print(f"phase 4 {tag}: launches K1/K2/K3/K4/K5/K6/K7/K8/K9 {launches}; "
              f"{s.wall_seconds:.3f} s, {s.mrays_per_sec:.1f} Mray/s, "
              f"{s.msamples_per_sec:.1f} Msamples/s, {s.num_samples} samples, "
              f"{s.num_rays} segments, {s.extra}; mean {mean.round(4).tolist()} "
              f"({card})", flush=True)

    big = Resolution(768, 1024)
    for when in ("first", "warm"):
        done, l1 = run(scenes["cornell"], RenderConfig(samples_per_pixel=512,
                                                       resolution=big))
        report(f"cornell 1024x768 512 spp (regen), {when} render", done, l1,
               (0.2, 0.8))
        print(f"phase 4 cornell 1024x768 512 spp, {when} render: wall "
              f"{done.stats.wall_seconds:.4f} s, "
              f"{done.stats.mrays_per_sec:.1f} Mray/s ({card})", flush=True)
        if l1[0] <= 0:
            fail("the cornell render did not launch K1")

    spp = 1024  # the JAX package's mesh headline
    done, lp = run(scenes["mesh"], RenderConfig(samples_per_pixel=spp,
                                                resolution=big))
    report(f"mesh 1024x768 {spp} spp (portal)", done, lp, (0.05, 0.95))
    if lp[1] <= 0 or lp[2] <= 0:
        fail("the portal render did not launch K2 and K3")
    if done.stats.num_samples != spp * big.num_pixels:
        fail(f"portal render: {done.stats.num_samples} samples, want "
             f"{spp * big.num_pixels}")
    mesh_portal = done.image.pixels

    done, lr = run(scenes["mesh"], RenderConfig(samples_per_pixel=64,
                                                resolution=big),
                   env={"PT_TPU_NO_PORTAL": "1"})
    report("mesh 1024x768 64 spp (prim, PT_TPU_NO_PORTAL)", done, lr, (0.05, 0.95))
    if lr[3] <= 0:
        fail("the PT_TPU_NO_PORTAL render did not launch K4")
    # two copies of mesh's MeshFile: the default router's `prim` route
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    route = prepare_render(scenes["two-mesh"], big, dev).route
    done, lt = run(scenes["two-mesh"], RenderConfig(samples_per_pixel=64,
                                                    resolution=big))
    report(f"two-mesh 1024x768 64 spp ({route}, the default route)", done, lt,
           (0.05, 0.95))
    if route != "prim" or lt[3] <= 0 or lt[1] or lt[2]:
        fail(f"the two-mesh render took route {route!r} and launched {lt} "
             "(K1..K9), not K4 alone")
    if done.stats.num_samples != 64 * big.num_pixels:
        fail(f"the two-mesh render counted {done.stats.num_samples} samples")
    launches = {"trace_regen": l1[0], "trace_cheap_regen": lp[1],
                "trace_resolve_pool": lp[2], "trace_regen_prim": lr[3],
                "trace_resolve": k7["launches"],
                "trace_cheap_blocked": k8["launches"],
                "trace_sorted": k9["launches"]}
    diff = float(np.abs(done.image.pixels - mesh_portal).mean())
    print(f"phase 4 mesh portal {spp} spp vs prim 64 spp: mean |Δ| {diff:.4f}",
          flush=True)

    # the same counter-based random numbers on both devices: a small render
    # on the card differs from the CPU's only where ulps part a path
    for sid, spp_small in (("cornell", 64), ("mesh", 8)):
        small_cfg = RenderConfig(samples_per_pixel=spp_small,
                                 resolution=Resolution(24, 36))
        img = {}
        for key, devname, cfg in (("gpu", "cuda", small_cfg),
                                  ("cpu", "cpu", small_cfg),
                                  ("cpu1", "cpu", small_cfg.with_(seed=1))):
            img[key] = pt.render(scenes[sid], cfg, device=devname,
                                 out_dir=None, verbose=False).image.pixels
        same_seed = float(np.abs(img["gpu"] - img["cpu"]).mean())
        noise = float(np.abs(img["cpu1"] - img["cpu"]).mean())
        print(f"phase 4 small {sid} cuda vs cpu mean |Δ| {same_seed:.6f}, "
              f"cpu seed 0 vs 1 {noise:.5f}", flush=True)
        if not same_seed <= 0.25 * noise:
            fail(f"the CUDA {sid} render disagrees with the CPU render "
                 "beyond ulp flips")

    # cancel at the first poll: every retired sample is kept and counted; at
    # depth 1 each sample is one segment, so the counts are checked exactly
    polls = []
    spp1 = 256
    cfg1 = RenderConfig(samples_per_pixel=spp1, resolution=Resolution(192, 256),
                        max_depth=1)
    done = pt.render(scenes["mesh"], cfg1, device="cuda", out_dir=None,
                     verbose=False, cancel=lambda: polls.append(1) or len(polls) > 1)
    s = done.stats
    print(f"phase 4 mesh cancel at the first poll: cancelled {done.cancelled}, "
          f"{s.num_samples} samples retired, {s.num_rays} segments of "
          f"{spp1 * 192 * 256}", flush=True)
    if not (done.cancelled and 0 < s.num_samples < spp1 * 192 * 256
            and s.num_rays == s.num_samples):
        fail("a portal render cancelled at its first poll did not keep exact "
             "counts")
    print("phase 4 done", flush=True)

    # ---- phase 5: the CLI ----
    for args, wh in ((["100", "300", "cornell"], (450, 300)),
                     (["16", "300", "mesh"], (450, 300)),
                     (["16", "300", "cornell", "--backend", "fast",
                       "--debug-nans", "--profile"], (450, 300))):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            if args[-1] == "--profile":
                args = args + [os.path.join(tmp, "prof")]
            proc = subprocess.run(
                [sys.executable, "-m", "path_tracer_tpu_torch.cli", *args,
                 "--out-dir", tmp],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            if "--profile" in args:
                trace = os.path.join(tmp, "prof", "trace.json")
                kinds = set()
                if os.path.exists(trace):
                    with open(trace) as fh:
                        kinds = {e.get("cat") for e in json.load(fh)["traceEvents"]}
                print(f"phase 5 CLI --profile: trace.json event kinds "
                      f"{sorted(k for k in kinds if k)}", flush=True)
                if "kernel" not in kinds:
                    fail("the CLI's --profile trace holds no device kernel")
            if proc.returncode != 0:
                fail(f"CLI {args} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
            ppms = glob.glob(os.path.join(tmp, "*.ppm"))
            if len(ppms) != 1:
                fail(f"CLI {args} wrote {len(ppms)} PPMs")
            else:
                vals, w, h = read_ppm(ppms[0])
                if (w, h) != wh or vals.shape != (wh[0] * wh[1], 3):
                    fail(f"CLI {args} PPM is {w}x{h}")
        last = proc.stdout.strip().splitlines()[-2:]
        print(f"phase 5 CLI {' '.join(args)} in {time.perf_counter() - t0:.1f} s: "
              f"{' / '.join(last)}", flush=True)

    # ---- phase 6: the interactive preview ----
    launches["trace_stepped_static"], launches["trace_stepped_prim"] = (
        check_preview(scenes, dev, card, counters))
    print("phase 6 done", flush=True)

    # ---- phase 7: the viewer app ----
    check_app(dev, card)

    # ---- phase 8: the wavefront integrator and the raster preview ----
    check_wavefront(scenes, card, counters)
    print("phase 8 done", flush=True)

    for name, _, _ in KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"{name} was launched no time on its main path (or, for "
                 "K7, K8 and K9, which have no route, in phase 3)")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    recs = {"trace_regen": k1, "trace_cheap_regen": k2,
            "trace_resolve_pool": k3, "trace_regen_prim": k4,
            "trace_stepped_static": k5, "trace_stepped_prim": k6,
            "trace_resolve": k7, "trace_cheap_blocked": k8, "trace_sorted": k9}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": CSRC + src, "replaces": replaces,
        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None,
    } for name, src, replaces in KERNELS for rec in [recs[name]]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
