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
     1024x768, quota 4, both uniform sources. K4: mesh at 256x192, quota 4,
     both sources. K2 and K3: a mesh pool at 256x192 with park depth 3 and
     step cap 64 over several cycles, K3 with both sources; then three
     cycles of a fresh 1024x768 pool. Times of every kernel and its plain
     version at the main path's shapes (CUDA events; K2 and K3 on the
     third cycle of the 1024x768 pool, the bulk phase of a drive). K5 on
     cornell and K6 on mesh: one preview frame's rays at 450x300 x 2 spp,
     both uniform sources, in calls of 12 and of 5 steps. K8 on a fresh
     1,048,576-lane v1 pool of mesh primary rays at 1024x768, K7 on its
     first 524,288 lanes after K8 and the partition (the v1 shape) and on
     the 4 x 786,432 lanes of a mid-drive park-3 pool (the glue shape),
     both sources. K9 on the mesh preview frame, sorted every bounce, equal
     to K6 on the same rays, timed beside K6;
  4. the main paths through render(), each with the launch counts set to
     0 just before and read just after: cornell 1024x768 at 512 spp (K1);
     mesh 1024x768 at 1024 spp through the portal (K2 and K3; per-pixel
     counts exact); mesh 1024x768 at 64 spp under PT_TPU_NO_PORTAL (K4);
     mesh 1024x768 at 64 spp through the v2 portal, the v1 scheduler (K8
     and K7, not K2 or K3) and the glue route (K2 and K7, not K3), each
     within ulp flips of the v2 image; small cornell and mesh renders on
     the card agree with the same renders on the CPU far inside Monte Carlo
     noise; a portal render cancelled at its first poll keeps exactly the
     samples it traced;
  5. the CLI in a subprocess writes a PPM that parses (cornell and mesh);
  6. the interactive preview, ProgressiveRenderer(device="cuda") at 450x300
     (the reference GUI's size) on cornell (K5) and mesh (K6) at 1, 2 and 4
     spp a frame, the launch counts set to 0 just before each and read just
     after: warm frame times (2nd best of 8) of step and step_u8, fps, the
     restart latency (move_camera and the first frame); step_u8 byte-equal
     to quantize_np of the accumulator; 8 frames of 2 spp against a 16-spp
     render() of the same seed;
  7. the viewer app (viewer.app.make_server on 127.0.0.1, an ephemeral
     port, served from a thread): /state, three /preview.png (decoded here;
     the etag changes), /control orbit, /pick, /probe, /select_scene
     cornell, /start_render at 16 spp and res_y 120 until done with no
     render error, /render.png; each request's latency.
Then a JSON line per kernel, the card's line, and last
{"ok": true, "device": {...}}.
"""

import concurrent.futures
import glob
import json
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
SEG_TOL = 0.005  # segment totals, kernel against plain, as in the CPU tests

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

    sources = sorted({src for _, src, _ in KERNELS})
    jobs = {f"{src} fmad={fmad}": (os.path.join(ROOT, CSRC, src), fmad)
            for fmad in (True, False) for src in sources}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(load_kernel, *args) for name, args in jobs.items()}
        lines = []
        for name, fut in futs.items():
            built = fut.result()
            regs = [ln.split(":", 1)[-1].strip() for ln in built.log.splitlines()
                    if "registers" in ln]
            lines.append(f"{name}: {os.path.relpath(built.path, ROOT)} in "
                         f"{built.seconds:.1f} s, ptxas: {' | '.join(regs)}")
    return lines


def check_k1(scenes, dev, card):
    """K1 against its plain version; returns its kernels-line numbers."""
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
                out["ms"] = cuda_ms(
                    lambda: trace_v2.trace_regen(scene_c, cam_c, pix, **kw), 10)
                out["plain_ms"] = cuda_ms(
                    lambda: trace_v2.trace_regen_plain(scene_c, cam_c, pix, **kw), 1)
                segs = int(seg_p.sum(dtype=torch.int64))
                n = pix.shape[0]
                out["bound_ms"], out["bound_by"] = bound_ms(
                    n * (4 + 20), segs * FLOPS_K1_SEGMENT)
    print(f"phase 3 K1 cornell 1024x768 quota {quota}: kernel {out['ms']:.3f} ms, "
          f"plain {out['plain_ms']:.1f} ms, bound {out['bound_ms']:.3f} ms "
          f"({out['bound_by']}) ({card})", flush=True)
    return out


def check_k4(mesh, dev, card, small, main):
    """K4 against its plain version; returns its kernels-line numbers."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.ops.kernels import trace_kernel
    from path_tracer_tpu_torch.render.pipeline import (
        morton_pixel_order, prepare_render,
    )

    quota, seed, base = 4, 7, 4
    out = {"max_abs_err": 0.0}
    for res in (small, main):
        prep = prepare_render(mesh, res, dev)
        ks = prep.kscene
        pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(dev)
        table = torch.from_numpy(np.random.default_rng(3).random(
            (6, pix.shape[0]), dtype=np.float32)).to(dev)
        sources = (("counter", None), ("table", table)) if res == small else (
            ("counter", None),)
        for source, uni in sources:
            tag = f"K4 mesh {res.width}x{res.height}/{source}"
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
            frac = lane_share(rad_k, rad_p)
            err = float((rad_k - rad_p).abs().max())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            seg_ratio = int(seg_k.sum(dtype=torch.int64)) / max(
                int(seg_p.sum(dtype=torch.int64)), 1)
            print(f"phase 3 {tag}: {frac:.5f} of pixels within {LANE_TOL} "
                  f"(need {LANE_FRAC}); max |err| {err:.3g}; segments "
                  f"kernel/plain {seg_ratio:.5f}; plain {plain_s:.1f} s", flush=True)
            if frac < LANE_FRAC or abs(seg_ratio - 1.0) > SEG_TOL:
                fail(f"{tag}: kernel disagrees with its plain version")
            exact = trace_kernel.trace_regen_prim(ks, prep.cam, pix, fmad=False, **kw)
            if not all(torch.equal(a, b) for a, b in
                       zip(exact, (rad_p, seg_p, done_p))):
                fail(f"{tag}: the --fmad=false kernel is not bit-exact with "
                     "its plain version")
            if res == main:
                out["ms"] = cuda_ms(
                    lambda: trace_kernel.trace_regen_prim(ks, prep.cam, pix, **kw), 3)
                out["plain_ms"] = plain_s * 1e3
                n = pix.shape[0]
                segs = int(seg_p.sum(dtype=torch.int64))
                out["bound_ms"], out["bound_by"] = bound_ms(
                    n * (4 + 20), isect_flops(work, segs)
                    + n * quota * FLOPS_RAYGEN)
    print(f"phase 3 K4 mesh {main.width}x{main.height} quota {quota}: kernel "
          f"{out['ms']:.3f} ms, plain {out['plain_ms']:.1f} ms, bound "
          f"{out['bound_ms']:.3f} ms ({out['bound_by']}) ({card})", flush=True)
    return out


def compare(tag, kern, exact, plain, rec):
    """(pool or state [rows, n], counts) of a kernel, its --fmad=false build
    and its plain version: the second must equal the third bit for bit, the
    first agree on LANE_FRAC of the columns; rec["max_abs_err"] grows."""
    import torch

    (pk_, ck), (pe, ce), (pp, cp) = kern, exact, plain
    torch.cuda.synchronize()
    if not (torch.equal(pe, pp) and torch.equal(ce, cp)):
        fail(f"{tag}: the --fmad=false kernel is not bit-exact with its "
             "plain version")
    if not bool(torch.isfinite(pk_).all()):
        fail(f"{tag}: non-finite pool")
    frac = lane_share(pk_, pp, dim=0)
    err = float((pk_ - pp).abs().max())
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    print(f"phase 3 {tag}: {frac:.5f} of slots within {LANE_TOL} "
          f"(need {LANE_FRAC}); max |err| {err:.3g}; segments "
          f"{int(ck.sum())}/{int(cp.sum())}", flush=True)
    if frac < LANE_FRAC:
        fail(f"{tag}: kernel disagrees with its plain version")


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
                flops = (w2.get("scan", 0) * (
                    FLOPS_SLAB + pc.scene.prims.shape[0] * FLOPS_TRI)
                    + w2.get("shade", 0) * (FLOPS_SHADE + FLOPS_HIT)
                    + w2.get("regen", 0) * FLOPS_RAYGEN)
                k2["bound_ms"], k2["bound_by"] = bound_ms(nbytes, flops)
            else:
                p2 = pk.trace_cheap_regen_plain(pc, cam, pool, **cheap)
            compare(f"K2 {tag}", pk.trace_cheap_regen(pc, cam, pool, **cheap),
                    pk.trace_cheap_regen(pc, cam, pool, fmad=False, **cheap),
                    p2, k2)
            pool = p2[0]
            sources = (("counter", None), ("table", table)) if (
                res == small) else (("counter", None),)
            for source, uni in sources:
                kw = dict(resolve, uniforms=uni)
                if last and source == "counter":
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

    from path_tracer_tpu_torch.render.integrator import camera_rays
    from path_tracer_tpu_torch.render.raygen import camera_arrays

    npix = res.num_pixels
    pix = torch.arange(npix, dtype=torch.int32, device=dev).repeat_interleave(spp)
    smp = torch.arange(spp, dtype=torch.int32, device=dev).repeat(npix)
    o, d = camera_rays(camera_arrays(scene.camera), pix, smp, seed=0,
                       width=res.width, height=res.height)
    return o, d, pix, smp


def check_stepped(scenes, dev, card):
    """K5 (cornell) and K6 (mesh) against their plain versions on one
    preview frame's rays at 450x300 x 2 spp; returns their kernels-line
    numbers."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.models.scene import pack_scene
    from path_tracer_tpu_torch.ops.kernels import trace_kernel, trace_v2
    from path_tracer_tpu_torch.utils.config import Resolution

    res, spp, max_depth = Resolution(*PREVIEW), 2, 12
    out = {}
    for name, sid in (("K5", "cornell"), ("K6", "mesh")):
        packed = pack_scene(scenes[sid])
        if name == "K5":
            fn, plain = trace_v2.trace_stepped, trace_v2.trace_stepped_plain
            scene = trace_v2.build_scene_consts(packed).to(dev)
        else:
            fn, plain = trace_kernel.trace_stepped, trace_kernel.trace_stepped_plain
            scene = trace_kernel.build_kernel_scene(packed).to(dev)
        o, d, pix, smp = preview_rays(scenes[sid], res, spp, dev)
        n = o.shape[0]
        table = torch.from_numpy(np.random.default_rng(5).random(
            (max_depth * 4, n), dtype=np.float32)).to(dev)
        rec = {"max_abs_err": 0.0}
        for source, uni in (("counter", None), ("table", table)):
            for steps in (12, 6 if uni is not None else 5):
                tag = f"{name} {sid} {res.width}x{res.height}x{spp}/{source}/{steps} steps"
                kw = dict(seed=7, pixel_idx=pix, sample_idx=smp, uniforms=uni,
                          max_depth=max_depth, steps_per_call=steps)
                work: dict = {}
                rad_k, rays_k = fn(scene, o, d, **kw)
                t0 = time.perf_counter()
                rad_p, rays_p = (plain(scene, o, d, work=work, **kw) if name == "K6"
                                 else plain(scene, o, d, **kw))
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                if not bool(torch.isfinite(rad_k).all()):
                    fail(f"{tag}: non-finite kernel radiance")
                frac = lane_share(rad_k, rad_p)
                err = float((rad_k - rad_p).abs().max())
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                ratio = int(rays_k) / max(int(rays_p), 1)
                print(f"phase 3 {tag}: {frac:.5f} of rays within {LANE_TOL} "
                      f"(need {LANE_FRAC}); max |err| {err:.3g}; rays "
                      f"kernel/plain {ratio:.5f}; plain {plain_s:.2f} s", flush=True)
                if frac < LANE_FRAC or abs(ratio - 1.0) > SEG_TOL:
                    fail(f"{tag}: kernel disagrees with its plain version")
                exact = fn(scene, o, d, fmad=False, **kw)
                if not (torch.equal(exact[0], rad_p) and torch.equal(exact[1], rays_p)):
                    fail(f"{tag}: the --fmad=false kernel is not bit-exact with "
                         "its plain version")
                if source == "counter" and steps == max_depth:
                    kw_t = dict(kw)
                    rec["ms"] = cuda_ms(lambda: fn(scene, o, d, **kw_t), 10)
                    rec["plain_ms"] = plain_s * 1e3
                    segs = int(rays_p)
                    flops = (segs * FLOPS_K5_SEGMENT if name == "K5"
                             else isect_flops(work, segs))
                    # each ray reads o, d, pixel and sample index once and
                    # writes its radiance once
                    rec["bound_ms"], rec["bound_by"] = bound_ms(
                        n * (24 + 8 + 12), flops)
        print(f"phase 3 {name} {sid} {res.width}x{res.height}x{spp}: kernel "
              f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms, bound "
              f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}) ({card})", flush=True)
        out[name] = rec
    return out["K5"], out["K6"]


def k7_call(fn, ks, state, pix, smp, **kw):
    """K7 (or its plain version) as (state [15, n], counts [n])."""
    import torch

    out = fn(ks, *state, pixel_idx=pix, sample_idx=smp, **kw)
    return torch.cat(out[:7]), out[7][0]


def check_v1(mesh, dev, card, main):
    """K8 on a fresh v1 pool of mesh primary rays at 1024x768 (1,048,576
    lanes, as the v1 runner sizes it), K7 on the first F_cap lanes of that
    pool after K8 and the cycle's partition, and K7 at the glue shape (the
    4 x 786,432 lanes of a mid-drive park-3 v2 pool), each against its
    plain version with both uniform sources. Returns the K8 and K7
    kernels-line dicts (K7 timed at the v1 shape; the glue shape's time in
    k7["glue_ms"])."""
    import numpy as np
    import torch

    from path_tracer_tpu_torch.ops.kernels import portal as pk
    from path_tracer_tpu_torch.ops.kernels import trace_kernel
    from path_tracer_tpu_torch.render import portal as rp
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    seed, max_depth = 7, 12
    prep = prepare_render(mesh, main, dev)
    pc, ks = prep.portal, prep.kscene
    npix = main.num_pixels
    C = max(min(rp.DEFAULT_POOL, rp._round_block(npix * 4)), rp.CHEAP_BLOCK)
    F_cap = max(rp.RESOLVE_BLOCK, rp._round_resolve(C // 2))
    pool = torch.zeros((pk.V1_PORT_ROWS, C), device=dev)
    pool[pk.ROW_PIX] = -1.0
    pool, _, _, _ = rp.portal_cycle(  # the refill fills every slot
        pool, torch.zeros((npix, 3), device=dev), torch.zeros(npix, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev), limit=64 * npix,
        sample_base=0, pc=pc, cam=prep.cam, ks=ks, seed=seed, npix=npix,
        max_depth=max_depth, rr_start_depth=5, F_cap=F_cap)
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
    print(f"phase 3 K8 mesh v1 pool {C}: {int((frozen[pk.ROW_ALIVE] > 0).sum())} "
          f"lanes frozen at the portal; kernel {k8['ms']:.3f} ms, plain "
          f"{k8['plain_ms']:.1f} ms, bound {k8['bound_ms']:.3f} ms "
          f"({k8['bound_by']}) ({card})", flush=True)

    perm = torch.argsort((frozen[pk.ROW_ALIVE] <= 0.0).to(torch.int32), stable=True)
    front = frozen[:, perm][:, :F_cap]
    v1_state = tuple(front[a:b] for a, b in ((0, 3), (3, 6), (6, 9), (9, 12),
                                             (12, 13), (13, 14), (14, 15)))
    v1_lanes = (v1_state, front[pk.ROW_PIX].to(torch.int32),
                front[pk.V1_ROW_SAMPLE].to(torch.int32))
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
    glue_lanes = rp.glue_lanes(pool2, park_k)[:3]

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
                k7["glue_ms"] = ms
            else:
                k7["ms"], k7["plain_ms"] = ms, plain_s * 1e3
                k7["bound_ms"], k7["bound_by"] = bound
    return k8, k7


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
            frames = 1 + 8 + 8 + 1 + 3
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
    from path_tracer_tpu_torch.render import portal as rportal
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
    small, main_res = Resolution(192, 256), Resolution(768, 1024)

    # ---- phase 3: kernels against their plain versions ----
    k1 = check_k1(scenes, dev, card)
    k4 = check_k4(scenes["mesh"], dev, card, small, main_res)
    k2, k3 = check_portal(scenes["mesh"], dev, card, small, main_res)
    k5, k6 = check_stepped(scenes, dev, card)
    k8, k7 = check_v1(scenes["mesh"], dev, card, main_res)
    k9 = check_sorted(scenes["mesh"], dev, card)
    print("phase 3 done", flush=True)

    # ---- phase 4: the main paths through render() ----
    counters = (trace_v2.trace_regen, pk.trace_cheap_regen,
                pk.trace_resolve_pool, trace_kernel.trace_regen_prim,
                trace_v2.trace_stepped, trace_kernel.trace_stepped,
                trace_kernel.trace_resolve, pk.trace_cheap_blocked,
                trace_kernel.trace_sorted)

    def run(scene, cfg, env=None, pool_resolve=True):
        """render() on the card with the launch counts zeroed just before
        and read just after; returns (RenderDone, launches per kernel)."""
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        rportal.POOL_RESOLVE = pool_resolve
        try:
            for c in counters:
                c.launches = 0
            with tempfile.TemporaryDirectory() as tmp:
                done = pt.render(scene, cfg, device="cuda", out_dir=tmp,
                                 verbose=False)
            return done, [c.launches for c in counters]
        finally:
            rportal.POOL_RESOLVE = True
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
    done, l1 = run(scenes["cornell"], RenderConfig(samples_per_pixel=512,
                                                   resolution=big))
    report("cornell 1024x768 512 spp (regen)", done, l1, (0.2, 0.8))
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
    launches = {"trace_regen": l1[0], "trace_cheap_regen": lp[1],
                "trace_resolve_pool": lp[2], "trace_regen_prim": lr[3],
                "trace_sorted": k9["launches"]}
    diff = float(np.abs(done.image.pixels - mesh_portal).mean())
    print(f"phase 4 mesh portal {spp} spp vs prim 64 spp: mean |Δ| {diff:.4f}",
          flush=True)

    # the v1 scheduler (K8, K7) and the v2 glue route (K2, K7) against the
    # v2 route (K2, K3) of the same seed, at 64 spp: the same paths, so the
    # images differ only where ulps part a path
    cfg64 = RenderConfig(samples_per_pixel=64, resolution=big)
    v2, lv2 = run(scenes["mesh"], cfg64)
    report("mesh 1024x768 64 spp (portal v2)", v2, lv2, (0.05, 0.95))
    v2_seed1, _ = run(scenes["mesh"], cfg64.with_(seed=1))
    noise = float(np.abs(v2_seed1.image.pixels - v2.image.pixels).mean())
    for name, kw, want, absent in (
            ("v1, PT_TPU_PORTAL_V1=1", dict(env={"PT_TPU_PORTAL_V1": "1"}),
             (6, 7), (1, 2)),
            ("glue, POOL_RESOLVE False", dict(pool_resolve=False), (1, 6), (2,))):
        done, lv = run(scenes["mesh"], cfg64, **kw)
        report(f"mesh 1024x768 64 spp (portal {name})", done, lv, (0.05, 0.95))
        same = float(np.abs(done.image.pixels - v2.image.pixels).mean())
        print(f"phase 4 mesh {name} vs v2, 64 spp: mean |Δ| {same:.6f}, v2 seed "
              f"0 vs 1 {noise:.5f}; Mray/s {done.stats.mrays_per_sec:.1f} vs "
              f"{v2.stats.mrays_per_sec:.1f}", flush=True)
        if not all(lv[i] > 0 for i in want) or any(lv[i] for i in absent):
            fail(f"the {name} render launched {lv} (K1..K9)")
        if done.stats.num_samples != 64 * big.num_pixels:
            fail(f"the {name} render counted {done.stats.num_samples} samples")
        if not same <= 0.25 * noise:
            fail(f"the {name} render disagrees with v2 beyond ulp flips")
        if name.startswith("v1"):
            launches["trace_cheap_blocked"], launches["trace_resolve"] = lv[7], lv[6]
        else:
            glue_k7 = lv[6]
    print(f"phase 4 K7 launches: {launches['trace_resolve']} in the v1 render, "
          f"{glue_k7} in the glue render", flush=True)

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
                     (["16", "300", "mesh"], (450, 300))):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "path_tracer_tpu_torch.cli", *args,
                 "--out-dir", tmp],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
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

    for name, _, _ in KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"{name} was launched no time on its main path")
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
