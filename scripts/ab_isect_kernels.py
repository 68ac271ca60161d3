#!/usr/bin/env python3
"""K4, K6 and K7 built from this checkout against the same kernels built from
another checkout (``--parent DIR``), timed in turns in one process on one
card: parent, this, this, parent, per round.

The three kernels share csrc/isect_full.cuh with K3; this measures whether a
change to that header moved them. Shapes as chip_smoke.py's phase 3: K4 on
mesh 1024x768 at quota 4; K6 on one preview frame's rays at 450x300 x 2 spp
in one 12-step call; K7 on the 4 x 786,432 lanes of K3's input pool on
cycle 2 of a fresh mesh 1024x768 drive (park depth 3), the glue shape. Each
build's outputs must equal the other's bit for bit under --fmad=false. Also
prints, per kernel, how many of its SASS instructions (cuobjdump) the two
default builds share in place, kernel-parameter offsets masked.

  python3 scripts/ab_isect_kernels.py --parent DIR [--rounds 3] [--reps 5]
"""

import argparse
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import path_tracer_tpu_torch as pt  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import portal as pk  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.render.pipeline import (  # noqa: E402
    morton_pixel_order, prepare_render,
)
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402

CSRC = os.path.join("path_tracer_tpu_torch", "csrc")


def libraries(root: str, fmad: bool):
    """K4's and K6/K7's libraries built from ``root``'s sources, bound as
    the port binds its own."""
    saved = tk.CSRC_REGEN_PRIM, tk.CSRC_STEPPED
    tk.CSRC_REGEN_PRIM = os.path.join(root, CSRC, "trace_regen_prim.cu")
    tk.CSRC_STEPPED = os.path.join(root, CSRC, "trace_stepped.cu")
    try:
        return (tk._prim_library.__wrapped__(fmad),
                tk.stepped_library.__wrapped__(fmad))
    finally:
        tk.CSRC_REGEN_PRIM, tk.CSRC_STEPPED = saved


def sass(path: str) -> dict[str, list[str]]:
    """Each kernel's SASS instructions (cuobjdump), addresses dropped, by
    the kernel's unmangled name."""
    dump = subprocess.run(
        [os.path.join(os.path.dirname(kbuild.find_nvcc()), "cuobjdump"),
         "-sass", path], capture_output=True, text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    cur = None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[-1].strip()
            m = re.search(r"\d([a-z_]+_kernel)", name)
            cur = out.setdefault(m.group(1) if m else name, [])
        elif cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", line).split(";")[0]
            # a kernel parameter's constant-bank offset moves with the
            # parameters before it; the instruction is the same
            cur.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][param]", ins))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_isect_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    mesh = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                         os.path.join(ROOT, "meshes"))
    res = Resolution(768, 1024)
    prep = prepare_render(mesh, res, dev)
    ks = prep.kscene
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0]).to(dev)
    o6, d6, pix6, smp6 = chip_smoke.preview_rays(
        mesh, Resolution(*chip_smoke.PREVIEW), 2, dev)
    coh = chip_smoke.k3_coherence()
    _, pool = coh.k3_input_pool(mesh, res, dev)
    n = pool.shape[1]
    parts = [(pk.ROW_O, pk.ROW_ALIVE, pk.ROW_PREV, pk.ROW_DEPTH, pk.sample_row(3))]
    for j in range(3):
        b = pk.buf_row(j)
        parts.append((b, b + pk.BUF_STATE, b + pk.BUF_PREV, b + pk.BUF_DEPTH,
                      pk.sample_row(3, j)))
    cat = lambda rows: torch.cat([pool[r] for r in rows])  # noqa: E731
    state = [torch.stack([cat([p[0] + off + k for p in parts]) for k in range(3)])
             for off in (0, 3, 6)]
    acc = torch.zeros_like(state[0])
    alive = (cat([p[1] for p in parts]) == 1.0).to(torch.float32)[None]
    alive[0, :n] = (pool[pk.ROW_ALIVE] > 0).to(torch.float32)
    prev = cat([p[2] for p in parts])[None]
    depth = cat([p[3] for p in parts])[None]
    pix7 = pool[pk.V2_ROW_PIX].to(torch.int32).repeat(4)
    smp7 = cat([p[4] for p in parts]).to(torch.int32)

    calls = {
        "K4": lambda: tk.trace_regen_prim(ks, prep.cam, pix, seed=7,
                                          sample_base=4, quota=4),
        "K6": lambda: tk.trace_stepped(ks, o6, d6, seed=0, pixel_idx=pix6,
                                       sample_idx=smp6),
        "K7": lambda: tk.trace_resolve(ks, state[0], state[1], state[2], acc,
                                       alive, prev, depth, pixel_idx=pix7,
                                       sample_idx=smp7, seed=7),
    }
    builds = {(name, fmad): libraries(root, fmad)
              for name, root in (("this", ROOT), ("parent", args.parent))
              for fmad in (True, False)}
    for i, src in enumerate(("trace_regen_prim.cu", "trace_stepped.cu")):
        a, b = (sass(builds[name, True][i].path) for name in ("this", "parent"))
        for fn in sorted(set(a) | set(b)):
            x, y = a.get(fn, []), b.get(fn, [])
            same = sum(p == q for p, q in zip(x, y))
            print(f"SASS {src} {fn}: {len(x)} instructions here, {len(y)} "
                  f"in the parent build, {same} equal in place")
    saved = tk._prim_library, tk.stepped_library

    def use(name, fmad=True):
        prim, stepped = builds[name, fmad]
        tk._prim_library = lambda fmad=True: prim
        tk.stepped_library = lambda fmad=True: stepped

    failed = False
    try:
        outs = {}
        for name in ("this", "parent"):
            use(name, False)
            outs[name] = {k: fn() for k, fn in calls.items()}
        torch.cuda.synchronize()
        for k in calls:
            a, b = outs["this"][k], outs["parent"][k]
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                print(f"FAIL: {k} --fmad=false differs between the builds")
                failed = True
        times = {(name, k): [] for name in ("this", "parent") for k in calls}
        for _ in range(args.rounds):
            for name in ("parent", "this", "this", "parent"):
                use(name)
                for k, fn in calls.items():
                    times[name, k].append(chip_smoke.cuda_ms(fn, args.reps))
    finally:
        tk._prim_library, tk.stepped_library = saved
    for k in calls:
        for name in ("parent", "this"):
            ts = times[name, k]
            print(f"{k} {name}: {min(ts):.3f}-{max(ts):.3f} ms over {len(ts)} "
                  f"timings of {args.reps} launches ({card})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
