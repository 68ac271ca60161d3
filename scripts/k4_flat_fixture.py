#!/usr/bin/env python3
"""The fixture that holds K4's group level to the flat tile scan it
replaced, on a CUDA card: tests/golden/gpu/k4_flat_parent.json.

K4 (csrc/trace_regen_prim.cu) tests a level of boxes above the tiles,
one a run of 32 (KernelScene.tile_groups); the commit before it scanned
every tile's box. Both must give
the same image bit for bit in the default build (FMA contraction on).
With ``--parent DIR`` (a checkout of the commit before the group level:
``git archive <commit> | tar -x -C DIR`` into a git-ignored directory
such as _parent/) this script builds that commit's K4 and writes, to
``--out``:

- ``flat_panda_arm``: the shape (the benchmark's panda_arm scene, 2,090
  tiles, at 200x150 in Morton order, the production quota of 64) and the
  sha256 of DIR's default-build outputs there (radiance, segments,
  finished samples: ``digests``);
- ``nvcc``: the toolkit's release, which they depend on.

tests/test_torch_cuda.py holds this checkout's K4 to them, and skips
under another nvcc. The script also prints whether this checkout's
outputs already match. The SASS of the other kernels that include
csrc/isect_full.cuh is held by scripts/ablate_k1.py's fixture.

  python3 scripts/k4_flat_fixture.py --parent DIR --out PATH
"""

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import path_tracer_tpu_torch as tpt  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.render.pipeline import (  # noqa: E402
    morton_pixel_order, prepare_render,
)

CSRC = os.path.join("path_tracer_tpu_torch", "csrc")
SHAPE = dict(width=200, height=150, seed=11, sample_base=0, quota=64)


def nvcc_release() -> str:
    """The toolkit's release (scripts/ablate_k1.py ``nvcc_release``)."""
    spec = importlib.util.spec_from_file_location(
        "ablate_k1", os.path.join(ROOT, "scripts", "ablate_k1.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.nvcc_release()


def panda_case(dev):
    """The benchmark's panda_arm scene on ``dev`` at SHAPE: (kernel scene,
    camera, Morton pixel order)."""
    path = os.path.join(ROOT, "bench_torch", "configs", "panda_arm",
                        "panda_arm.json")
    with open(path) as fh:
        scene = tpt.SceneDescriptor.from_json_dict(
            json.load(fh), base_dir=os.path.dirname(path))
    prep = prepare_render(scene, tpt.Resolution(SHAPE["height"], SHAPE["width"]), dev)
    pix = morton_pixel_order(SHAPE["width"], SHAPE["height"])[0]
    return prep.kscene, prep.cam, torch.from_numpy(pix).to(dev)


def digests(outs) -> dict[str, str]:
    """The sha256 of K4's outputs (radiance, segments, finished samples)."""
    return {k: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
            for k, t in zip(("rad", "segs", "done"), outs)}


def flat_launch(parent: str, ks, cam, pix):
    """The parent commit's K4 (the flat tile scan) at SHAPE: its outputs."""
    built = kbuild.load_kernel(os.path.join(parent, CSRC, "trace_regen_prim.cu"))
    fn = built.lib.pt_trace_regen_prim
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7)
    n, dev = pix.shape[0], pix.device
    rad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    segs = torch.empty(n, dtype=torch.int32, device=dev)
    done = torch.empty(n, dtype=torch.int32, device=dev)
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)
    params = cam.params.to(torch.float32).contiguous()
    code = fn(*tk._prim_scene_args(ks, tk.K4_SHARED_BUDGET), params.data_ptr(),
              cam.width, cam.height, pix.data_ptr(), n, SHAPE["seed"],
              SHAPE["sample_base"], SHAPE["quota"], 12, 5, None,
              rad.data_ptr(), segs.data_ptr(), done.data_ptr(), nxt.data_ptr(),
              None, torch.cuda.current_stream().cuda_stream)
    kbuild.check_launch(built, code, "parent trace_regen_prim (K4)")
    return rad, segs, done


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_flat_fixture: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ks, cam, pix = panda_case(dev)
    kw = {k: SHAPE[k] for k in ("seed", "sample_base", "quota")}
    flat = digests(flat_launch(args.parent, ks, cam, pix))
    mine = digests(tk.trace_regen_prim(ks, cam, pix, **kw))
    fixture = {"nvcc": nvcc_release(), "flat_panda_arm": dict(SHAPE, sha256=flat)}
    with open(args.out, "w") as fh:
        json.dump(fixture, fh, indent=1, sort_keys=True)
    print(json.dumps({"outputs_equal": flat == mine}))
    return 0 if flat == mine else 1


if __name__ == "__main__":
    sys.exit(main())
