#!/usr/bin/env python3
"""K6's design parts timed one by one on a CUDA card, on the preview frame.

The frame is chip_smoke.py's phase-3 shape: one mesh preview frame at
450x300 x 2 spp (270,000 rays; camera_rays of seed 0, traced under seed 7
in one 12-step call), and the same frame started by the camera entry
(``trace_camera``, the preview's path). Builds csrc/trace_stepped.cu with
each of its build-time -D choices (VARIANTS below: the refill threshold
K6_REFILL_MIN, the persistent grid, the shared-memory table, the chunk
sort and its window, the block size), any --builds given and, with
``--parent DIR`` (a checkout of the commit before the redesign), that
commit's K6 on the same rays; times each (CUDA events, warm, ``--reps``
launches, in turns over ``--rounds`` rounds). Every build with
--fmad=false must equal the plain version bit for bit, on the given rays
and from the camera entry; the script fails otherwise. Prints, per build,
its ms, its share of rays within 1e-3 of the plain version, its launch
configuration (registers, spills, resident blocks per SM, shared bytes),
the share scripts/k6_coherence.py's model gives its schedule, and the
card's name and power limit. With --parent it also compares the SASS
(cuobjdump) of the kernels that share this code and must not change: K4
(trace_regen_prim.cu), K7 (trace_resolve_kernel) and K3
(portal_resolve.cu). ``--check-only`` builds, checks and reports without
timing.

  python3 scripts/ablate_k6.py [--parent DIR] [--builds K6_THREADS=512 ...]
      [--reps 10] [--rounds 2] [--check-only]
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

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import path_tracer_tpu_torch as pt  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.render.raygen import camera_rays  # noqa: E402
from path_tracer_tpu_torch.utils.config import Resolution  # noqa: E402

SEED = 7
CSRC = os.path.join("path_tracer_tpu_torch", "csrc")

# The design's choices (csrc/trace_stepped.cu's -D defines), each against
# the production build
VARIANTS = {
    "production: chunk sort, group order, shared table": "",
    "chunk sort, no group order": "K6_GROUP_ORDER=0",
    "chunks packed, not sorted": "K6_SORT_BY_KEY=0",
    "chunk sort, read-only rows (c alone)": "K6_SHARED_TABLE=0",
    "chunk sort, 512 rays a chunk": "K6_WINDOW=512",
    "chunk sort, 2048 rays, 512 threads": "K6_WINDOW=2048,K6_THREADS=512",
    "chunk sort, 3 blocks an SM": "K6_MIN_BLOCKS=3",
    "chunk sort, 128 threads": "K6_THREADS=128",
    "refill at 4 idle (a and b)": "K6_SORT=0",
    "refill at once": "K6_SORT=0,K6_REFILL_MIN=1",
    "refill at 8 idle": "K6_SORT=0,K6_REFILL_MIN=8",
    "one thread a ray (a alone)": "K6_SORT=0,K6_PERSISTENT=0",
    "refill, read-only rows (b alone)": "K6_SORT=0,K6_SHARED_TABLE=0",
    "neither (the parent's schedule)": "K6_SORT=0,K6_PERSISTENT=0,K6_SHARED_TABLE=0",
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_registers(log: str) -> list[str]:
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln]


def defines(d: str) -> tuple[str, ...]:
    return tuple(x for x in d.split(",") if x)


def define(d: str, name: str, default: int) -> int:
    m = re.search(rf"{name}=(\d+)", d)
    return int(m.group(1)) if m else default


def parent_launcher(parent: str, ks, o, d, pix, smp):
    """A 12-step K6 call of the parent commit's kernel (its
    pt_trace_stepped_prim: given rays, no compact table, no counter)."""
    built = kbuild.build(os.path.join(parent, CSRC, "trace_stepped.cu"))
    fn = built.lib.pt_trace_stepped_prim
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = built.lib.pt_cuda_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]

    def run_call(state, counts, depth0, steps):
        code = fn(*tk._scene_args(ks), pix.data_ptr(), smp.data_ptr(),
                  state.shape[1], SEED, depth0, steps, 12, 5, None,
                  state.data_ptr(), counts.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        kbuild.check_launch(built, code, "parent trace_stepped (K6)")

    return (lambda: tk.stepped_trace(run_call, o, d, 12, 12)), built


def sass(path: str) -> dict[str, list[str]]:
    """Each kernel's SASS instructions (cuobjdump), addresses dropped and
    kernel-parameter offsets masked, by the kernel's unmangled name."""
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
            cur.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][param]", ins))
    return out


def compare_sass(parent: str) -> bool:
    """K4's, K7's and K3's SASS here and in the parent's builds."""
    same = True
    for src, kernels in (("trace_regen_prim.cu", None),
                         ("trace_stepped.cu", ("trace_resolve_kernel",)),
                         ("portal_resolve.cu", None)):
        a, b = (sass(kbuild.build(os.path.join(root, CSRC, src)).path)
                for root in (ROOT, parent))
        for fn in kernels or sorted(set(a) | set(b)):
            x, y = a.get(fn, []), b.get(fn, [])
            equal = x == y
            same &= equal
            print(f"  SASS {src} {fn}: {len(x)} instructions here, {len(y)} "
                  f"in the parent build, {sum(p == q for p, q in zip(x, y))} "
                  f"equal in place: {'same' if equal else 'DIFFERENT'}")
    return same


def model_share(model: dict, d: str) -> str:
    """The coherence model's shares for a build's schedule."""
    if define(d, "K6_SORT", 1):
        w = define(d, "K6_WINDOW", 1024)
        how = "sorted" if define(d, "K6_SORT_BY_KEY", 1) else "packed"
        key = f"chunks_of_{w}_{how}"
        return (f"useful rows {model[key]['useful_row_share']:.4f} ({how} "
                f"chunks of {w})" if key in model else "not modelled")
    if not define(d, "K6_PERSISTENT", 1):
        m = model["thread_per_ray"]
    else:
        m = model.get(f"persistent_refill_{define(d, 'K6_REFILL_MIN', 4)}")
        if m is None:
            return "not modelled"
    return (f"lane-steps {m['lane_share']:.4f}, useful rows "
            f"{m['useful_row_share']:.4f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--builds", nargs="*", default=[],
                    help="more builds to time, each a comma list of the "
                    "kernel's -D choices, e.g. K6_REFILL_MIN=3,K6_THREADS=128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_k6: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    spec = importlib.util.spec_from_file_location(
        "k6_coherence", os.path.join(ROOT, "scripts", "k6_coherence.py"))
    coh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(coh)
    scene = pt.load_scene("mesh", os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    res = Resolution(300, 450)
    ks, cam, pix, smp = coh.frame(scene, res, dev)
    o, d = camera_rays(cam, pix, smp, seed=0, width=res.width, height=res.height)
    kw = dict(seed=SEED, pixel_idx=pix, sample_idx=smp)
    ckw = dict(kw, width=res.width, height=res.height)

    variants = dict(VARIANTS)
    variants.update({b: b for b in args.builds})
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = {(v, f): ex.submit(tk.stepped_library, f, defines(v))
                for v in set(variants.values()) for f in (True, False)}
        libs = {key: fut.result() for key, fut in futs.items()}
    failed = False
    plain = tk.trace_stepped_plain(ks, o, d, **kw)
    plain_cam = tk.trace_camera_plain(ks, cam, **ckw)
    steps, tiles, keys, live, _ = coh.trace_record(ks, cam, pix, smp, res.width,
                                                   res.height)
    configs, models, shares, calls, modelled = {}, {}, {}, {}, {}
    for name, v in variants.items():
        lib = libs[v, True]
        cfg = tk.stepped_prim_config(ks, camera=True, library=lib)
        configs[name] = cfg
        exact = tk.trace_stepped(ks, o, d, library=libs[v, False], **kw)
        exact_cam = tk.trace_camera(ks, cam, library=libs[v, False], **ckw)
        torch.cuda.synchronize()
        for got, want, what in ((exact, plain, "given rays"),
                                (exact_cam, plain_cam, "camera entry")):
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                print(f"FAIL: {name} built with --fmad=false differs from the "
                      f"plain version ({what})")
                failed = True
        got = tk.trace_stepped(ks, o, d, library=lib, **kw)
        shares[name] = float(((got[0] - plain[0]).abs().sum(dim=1) < 1e-3)
                             .float().mean())
        at = (cfg["blocks_per_sm"] * cfg["threads"] * cfg["sms"],
              define(v, "K6_WINDOW", 1024))
        if at not in modelled:
            modelled[at] = coh.coherence(ks, steps, tiles, keys, live, at[0],
                                         windows=(at[1],))
        models[name] = model_share(modelled[at], v)
        calls[name] = (lambda lib=lib: tk.trace_stepped(ks, o, d, library=lib, **kw))
        calls[f"{name}, camera entry"] = (
            lambda lib=lib: tk.trace_camera(ks, cam, library=lib, **ckw))
    logs = {name: libs[v, True] for name, v in variants.items()}
    if args.parent:
        calls["parent"], logs["parent"] = parent_launcher(args.parent, ks, o, d,
                                                          pix, smp)
        got = calls["parent"]()
        torch.cuda.synchronize()
        shares["parent"] = float(((got[0] - plain[0]).abs().sum(dim=1) < 1e-3)
                                 .float().mean())
        print("ablate_k6: kernels that share the code, against the parent:")
        if not compare_sass(args.parent):
            print("NOTE: a shared kernel's SASS changed; time it against the "
                  "parent's build (chip_smoke.py phase 3)")

    times = {name: [] for name in calls}
    if not args.check_only:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(args.rounds):
            for name in list(calls) + list(reversed(calls)):
                fn = calls[name]
                fn()
                start.record()
                for _ in range(args.reps):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / args.reps)
    print(f"ablate_k6: mesh {res.width}x{res.height} x 2 spp preview frame: "
          f"{pix.shape[0]} rays, {int(plain[1])} segments ({card()})")
    for name, ts in times.items():
        base = name.split(", camera entry")[0]
        t = f"{min(ts):.3f}-{max(ts):.3f} ms" if ts else "not timed"
        extra = ""
        if base in configs and not name.endswith("camera entry"):
            extra = (f", rays within 1e-3 of plain {shares[base]:.5f}, model "
                     f"{models[base]}, {json.dumps(configs[base])}")
        elif name == "parent":
            extra = f", rays within 1e-3 of plain {shares[name]:.5f}"
        print(f"  {name:45s} {t}{extra}")
    for name, built in logs.items():
        print(f"  ptxas {name}: {' | '.join(ptxas_registers(built.log))}")
    print(json.dumps({"card": card(), "ms": times, "configs": configs,
                      "model": models, "shares": shares}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
