#!/usr/bin/env python3
"""K7 against the commit before its redesign, on a CUDA card, at the two
shapes its routes launch.

The shapes (chip_smoke.py phase 3 builds the same): mesh 1024x768, seed 7,
max depth 12,
  - the v1 front: a fresh 1,048,576-lane v1 pool (``v1_pool``) after K8
    (its plain version) and the v1 cycle's partition, its first F_cap =
    524,288 lanes, the live ones first;
  - the glue shape: a park-3 v2 pool two cycles into a drive, then K2, its
    active paths and three park buffers side by side (``glue_lanes``: 4 x
    786,432 lanes), where K3 on the same pool is the yardstick: on that
    route K7 makes exactly K3's bounces.

The port runs neither route since they were deleted for the v2 scheduler
(ROADMAP.md crosswalk); this script keeps their lane builders, which the
card tests (tests/test_torch_cuda.py) and chip_smoke.py load, so that K7
and K8 stay checked at their shapes.

Builds this checkout's csrc/trace_stepped.cu and, with ``--parent DIR``
(a checkout of the commit before the redesign: ``git archive <commit> |
tar -x -C DIR`` into a git-ignored directory such as _parent/), that
commit's K7, and runs both on the same lanes with both uniform sources.
This checkout's build without FMA contraction must equal the plain version
bit for bit, and its default build (and the parent's) agree on 99.5% of
lanes within 1e-3 with every count exact; the script fails otherwise.
Times K7, the parent's K7 and K3 (CUDA events over ``--reps`` launches,
warm, in turns forward and back over ``--rounds`` rounds; K7's input
buffer is built once, so the times are the kernel's), with ``--parent``
also the parent's K3 on the same pool and K6 and the parent's K6 on a
mesh preview frame (450x300 x 2 spp, given rays, 12 steps: the two
kernels whose sort pad changed), and prints K7's
launch configuration (registers, spills, shared bytes, blocks an SM) and
the schedule model of both shapes (scripts/k4_coherence.py resolve_model:
useful rows and a chunk's balance under the parent's thread a lane, the
split into warp and lane queries, and the sort). ``--check-only`` builds
and checks without timing; ``--fingerprints PATH`` (with --parent) writes
the parent's SASS fingerprints of the kernels scripts/ablate_k1.py guards
(K2), the fixture tests/golden/gpu/k1_shared_sass.json. ~1 min on an
H100. PERF.md keeps the times of the design choices K7 was picked from
(each once a -D define).

  python3 scripts/ablate_k7.py [--parent DIR] [--reps 20] [--rounds 2]
      [--check-only] [--fingerprints PATH]
"""

import argparse
import concurrent.futures
import ctypes
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
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.render import portal as rp  # noqa: E402
from path_tracer_tpu_torch.render.pipeline import prepare_render  # noqa: E402
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402

SEED, MAX_DEPTH, RR_START, PARK_K = 7, 12, 5, 3
LANE_TOL, LANE_FRAC = 1e-3, 0.995
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


V1_POOL = 1 << 20  # the v1 scheduler's largest pool: 1M lanes


def v1_pool(prep, npix: int, lanes: int, *, limit: int, seed: int):
    """A v1 pool [pk.V1_PORT_ROWS, lanes] as the v1 cycle's refill left an
    empty one: slot i < limit holds a fresh camera ray of pixel i % npix,
    sample i // npix at depth 0 (the kernels' camera sampling), the other
    slots are free (pix -1)."""
    dev = prep.kscene.tri.device
    sid = torch.arange(lanes, dtype=torch.int64, device=dev)
    can = sid < limit
    pixel = torch.remainder(sid, npix)
    samp = torch.div(sid, npix, rounding_mode="floor")
    raygen, lc = tk.make_raygen(prep.cam, pixel)
    d0 = raygen(samp, *tk.path_uniforms(seed, pixel, samp,
                                        torch.zeros_like(samp), (4, 5)))
    pool = torch.zeros((pk.V1_PORT_ROWS, lanes), device=dev)
    pool[pk.ROW_PIX] = -1.0
    rows = {pk.ROW_ALIVE: 1.0, pk.ROW_PREV: -1.0, pk.ROW_DEPTH: 0.0,
            pk.ROW_PIX: pixel.to(torch.float32),
            pk.V1_ROW_SAMPLE: samp.to(torch.float32)}
    for k in range(3):
        rows.update({pk.ROW_O + k: lc[k], pk.ROW_D + k: d0[k],
                     pk.ROW_THR + k: 1.0, pk.ROW_ACC + k: 0.0})
    for row, value in rows.items():
        pool[row] = torch.where(can, value, pool[row])
    return pool


def v1_front(frozen, front: int):
    """K7's lanes in a v1 cycle: the pool after K8 (``frozen``) stably
    partitioned with its live lanes first, its first ``front`` lanes, as
    (the seven state tensors, pixel_idx, sample_idx)."""
    perm = torch.argsort((frozen[pk.ROW_ALIVE] <= 0.0).to(torch.int32),
                         stable=True)
    lanes = frozen[:, perm][:, :front]
    return (tuple(lanes[a:b] for a, b in ((0, 3), (3, 6), (6, 9), (9, 12),
                                          (12, 13), (13, 14), (14, 15))),
            lanes[pk.ROW_PIX].to(torch.int32),
            lanes[pk.V1_ROW_SAMPLE].to(torch.int32))


def glue_lanes(pool, park_k: int):
    """K7's lanes on the glue route: the active paths and the park_k
    buffers of a v2 pool side by side ((park_k + 1) * n lanes, part-major,
    as the JAX package's ``render/portal.py:462-487``); a buffer lane is
    alive only where it holds a frozen path, with a zero acc. Returns (the
    seven state tensors, pixel_idx, sample_idx)."""
    n = pool.shape[1]

    def part_rows(r0, rb, k):
        return torch.cat([pool[r0:r0 + k]]
                         + [pool[pk.buf_row(j, rb):pk.buf_row(j, rb) + k]
                            for j in range(park_k)], dim=1)

    state = pool[[pk.buf_row(j, pk.BUF_STATE) for j in range(park_k)]]
    frozen = ((state > 0.5) & (state < 1.5)).to(torch.float32)
    acc = torch.cat([pool[pk.ROW_ACC:pk.ROW_ACC + 3],
                     torch.zeros((3, park_k * n), device=pool.device)], dim=1)
    alive = torch.cat([pool[pk.ROW_ALIVE], frozen.reshape(-1)])[None]
    pix = pool[pk.V2_ROW_PIX].to(torch.int32).repeat(park_k + 1)
    smp = torch.cat([pool[pk.sample_row(park_k)]] + [
        pool[pk.sample_row(park_k, j)] for j in range(park_k)]).to(torch.int32)
    return ((part_rows(pk.ROW_O, pk.BUF_O, 3), part_rows(pk.ROW_D, pk.BUF_D, 3),
             part_rows(pk.ROW_THR, pk.BUF_THR, 3), acc, alive,
             part_rows(pk.ROW_PREV, pk.BUF_PREV, 1),
             part_rows(pk.ROW_DEPTH, pk.BUF_DEPTH, 1)), pix, smp)


def k7_shapes(mesh, res, dev):
    """(prep, the fresh v1 pool, {"v1 front": lanes, "glue": lanes}, the
    glue shape's v2 pool), lanes being (the seven state tensors, pixel_idx,
    sample_idx): K7's inputs on its two routes, from mesh at ``res``."""
    prep = prepare_render(mesh, res, dev)
    pc, ks = prep.portal, prep.kscene
    npix = res.num_pixels
    C = min(V1_POOL, rp._round_block(npix * 4))
    pool = v1_pool(prep, npix, C, limit=C, seed=SEED)
    frozen = pk.trace_cheap_blocked_plain(pc, pool, seed=SEED,
                                          max_depth=MAX_DEPTH)[0]
    v1 = v1_front(frozen, C // 2)
    pool2 = rp.make_pool_v2(npix, rp._round_block(npix), 256, park_k=PARK_K,
                            device=dev)
    cheap = dict(seed=SEED, quota=256, sample_base=0, step_cap=64,
                 park_k=PARK_K, max_depth=MAX_DEPTH)
    for _ in range(2):
        pool2, _ = pk.trace_cheap_regen(pc, prep.cam, pool2, **cheap)
        pool2, _, _ = rp.portal_resolve_phase(
            pool2, ks, seed=SEED, park_k=PARK_K, max_depth=MAX_DEPTH,
            rr_start_depth=RR_START)
    pool2, _ = pk.trace_cheap_regen(pc, prep.cam, pool2, **cheap)
    return prep, pool, {"v1 front": v1, "glue": glue_lanes(pool2, PARK_K)}, pool2


def launcher(built, ks, lanes, uniforms, parent: bool):
    """run() launching one build's pt_trace_resolve on ``lanes`` from an
    input buffer made once; returns the output [16, n]. The parent's entry
    takes no compact table."""
    state, pix, smp = lanes
    n = pix.shape[0]
    dev = pix.device
    buf = torch.empty((tk.RESOLVE_ROWS, n), dtype=torch.float32, device=dev)
    torch.cat(state, out=buf[:tk.ROW_COUNT])
    out = torch.empty_like(buf)
    fn = built.lib.pt_trace_resolve
    scene = tk._scene_args(ks) if parent else tk.k7_scene_args(ks)
    if parent:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_uint32]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)

    def run():
        code = fn(*scene, buf.data_ptr(), out.data_ptr(), pix.data_ptr(),
                  smp.data_ptr(), n, SEED & rng.MASK32, MAX_DEPTH, RR_START,
                  tk._ptr(uniforms), torch.cuda.current_stream().cuda_stream)
        kbuild.check_launch(built, code, "trace_resolve (K7)")
        return out

    return run


def preview_frame(mesh, dev):
    """(o, d) and the keyword arguments of K6 on one mesh preview frame at
    450x300 x 2 spp, seed 5, as chip_smoke.py phase 3 gives it rays."""
    from path_tracer_tpu_torch.render import integrator
    from path_tracer_tpu_torch.render.raygen import camera_arrays, camera_rays

    res = Resolution(300, 450)
    pix, smp = integrator.pass_rays(
        torch.arange(res.num_pixels, dtype=torch.int32, device=dev), 2)
    o, d = camera_rays(camera_arrays(mesh.camera), pix, smp, seed=0,
                       width=res.width, height=res.height)
    return o, d, dict(seed=5, pixel_idx=pix, sample_idx=smp)


def compare(tag, got, plain, exact: bool) -> tuple[bool, float]:
    """(ok, lane share within LANE_TOL) of a build's [16, n] output against
    the plain version's."""
    want = torch.cat(plain)
    share = float(((got[:15] - want[:15]).abs().sum(dim=0) < LANE_TOL)
                  .float().mean())
    counts_equal = torch.equal(got[15:], want[15:])
    ok = torch.equal(got, want) if exact else (share >= LANE_FRAC
                                               and counts_equal)
    if not ok:
        print(f"FAIL: {tag}: {'not bit-exact' if exact else 'disagrees'} "
              f"(lane share {share:.6f}, counts equal {counts_equal})")
    return ok, share


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--fingerprints", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k7: no CUDA device", file=sys.stderr)
        return 1
    if args.fingerprints and args.parent:
        with open(args.fingerprints, "w") as fh:
            json.dump(script("ablate_k1").fingerprints(args.parent), fh,
                      indent=1, sort_keys=True)
    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        libs = {("production", f): ex.submit(tk.stepped_library, f)
                for f in (True, False)}
        if args.parent:
            libs["parent", True] = ex.submit(kbuild.build, os.path.join(
                args.parent, CSRC, "trace_stepped.cu"))
        libs = {k: v.result() for k, v in libs.items()}
    if args.parent:  # the parent's K6 entries take this checkout's arguments
        for name in ("pt_trace_stepped_prim", "pt_trace_stepped_prim_config"):
            f = getattr(libs["parent", True].lib, name)
            ref = getattr(libs["production", True].lib, name)
            f.restype, f.argtypes = ref.restype, ref.argtypes
    mesh = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                         os.path.join(ROOT, "meshes"))
    prep, _, shapes, pool2 = k7_shapes(mesh, Resolution(768, 1024), dev)
    ks = prep.kscene
    coh = script("k4_coherence")
    failed = False
    calls, shares, models, lives = {}, {}, {}, {}
    g = np.random.default_rng(6)
    for shape, lanes in shapes.items():
        state, pix, smp = lanes
        n = pix.shape[0]
        lives[shape] = int((state[4] > 0).sum())
        m = coh.resolve_model(ks, [state[0][k] for k in range(3)],
                              [state[1][k] for k in range(3)], state[5][0],
                              state[4][0] > 0)
        m.pop("visits")
        models[shape] = m
        for source in ("counter", "table"):
            uni = None if source == "counter" else torch.from_numpy(
                g.random((4, n), dtype=np.float32)).to(dev)
            plain = tk.trace_resolve_plain(ks, *state, pixel_idx=pix,
                                           sample_idx=smp, seed=SEED,
                                           max_depth=MAX_DEPTH, uniforms=uni)
            for (b, fmad), built in libs.items():
                run = launcher(built, ks, lanes, uni, b == "parent")
                got = run()
                torch.cuda.synchronize()
                ok, share = compare(f"{b} fmad={fmad} {shape}/{source}",
                                    got, plain, not fmad)
                failed |= not ok
                shares[b, fmad, shape, source] = share
                if fmad and source == "counter":
                    calls[b, shape] = run
            del plain
    k3 = dict(seed=SEED, parts=PARK_K + 1, park_k=PARK_K, max_depth=MAX_DEPTH)
    calls["K3 (same pool)", "glue"] = lambda: pk.trace_resolve_pool(
        ks, pool2, **k3)
    if args.parent:
        parent_k3 = pk.bind_resolve(kbuild.build(os.path.join(
            args.parent, CSRC, "portal_resolve.cu")))
        calls["parent's K3 (same pool)", "glue"] = (
            lambda: pk.trace_resolve_pool(ks, pool2, library=parent_k3, **k3))
        o6, d6, kw6 = preview_frame(mesh, dev)
        for b, lib in (("K6", None), ("parent's K6", libs["parent", True])):
            calls[b, "preview frame"] = (lambda lib=lib: tk.trace_stepped(
                ks, o6, d6, library=lib, **kw6))

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
    print(f"ablate_k7: mesh 1024x768, seed {SEED} ({card()})")
    for shape, lanes in shapes.items():
        print(f" {shape}: {lanes[1].shape[0]} lanes, {lives[shape]} alive; "
              f"model {json.dumps(models[shape])}")
        for (b, s), t in times.items():
            if s == shape:
                ts = f"{min(t):.4f}-{max(t):.4f} ms" if t else "not timed"
                print(f"  {b:28s} {ts}")
    for (b, s), t in times.items():
        if s == "preview frame":
            ts = f"{min(t):.4f}-{max(t):.4f} ms" if t else "not timed"
            print(f" {b} on a mesh preview frame, 450x300 x 2 spp: {ts}")
    config = tk.resolve_config(ks)
    ptxas = [ln.split(":", 1)[-1].strip()
             for ln in libs["production", True].log.splitlines()
             if "registers" in ln]
    print(f"  production: {json.dumps(config)}; ptxas {' | '.join(ptxas)}")
    print(json.dumps({
        "card": card(), "lanes": {s: lanes[1].shape[0] for s, lanes in shapes.items()},
        "alive": lives,
        "ms": {f"{k[0]} @ {k[1]}": v for k, v in times.items()},
        "shares": {" ".join(map(str, k)): v for k, v in shares.items()},
        "models": models, "config": config}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
