#!/usr/bin/env python3
"""Where ``pipeline.prepare_render``'s host time goes: each stage of a
render's preparation timed on its own with ``perf_counter``.

Stages, for each scene (mesh at 450x300, cornell at 1024x768, the
benchmark's render cells):

  pack_scene          models.scene.pack_scene
  scene_consts        trace_v2.build_scene_consts on the full scene
  quad_pairs          trace_kernel.detect_quad_pairs on the full scene
  buffers_rest        trace_kernel.kernel_scene_buffers less quad_pairs
  kernel_scene        trace_kernel.kernel_scene_from_jax (post_init included)
  post_init           KernelScene.__post_init__'s hit table alone
  portal_consts       portal.build_portal_consts
  camera_consts       trace_v2.build_camera_consts
  upload              the route's tables' .to(device), synchronized
  prepare_render      the whole call, as render() makes it

Each stage runs ``--warm`` times, then ``--repeats`` times timed; prints
the median, min and max in ms and writes them as JSON to ``--out``.
``--threads N`` sets torch's CPU threads (default: torch's own).
``--root DIR`` imports the package and loads the scenes from another
checkout (``git archive <commit> | tar -x -C DIR``), so two commits can be
compared in one call:

  python3 scripts/prep_split.py --device cuda --out chiprun_out/split.json
  python3 scripts/prep_split.py --root _parent --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

SCENES = (("mesh", 450, 300), ("cornell", 1024, 768))


def _time(fn, warm, repeats, sync):
    for _ in range(warm):
        fn()
        sync()
    out = []
    for _ in range(repeats):
        s = time.perf_counter()
        fn()
        sync()
        out.append(1e3 * (time.perf_counter() - s))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch's CPU threads (0: torch's default)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else ""
    sys.path.insert(0, root)
    os.chdir(root)  # MeshFile paths are relative to the checkout

    import torch

    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.models.scene import pack_scene
    from path_tracer_tpu_torch.ops.kernels import portal, trace_kernel, trace_v2
    from path_tracer_tpu_torch.render import pipeline
    from path_tracer_tpu_torch.utils.config import Resolution

    if args.threads:
        torch.set_num_threads(args.threads)
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    report = {"root": root, "device": str(dev),
              "torch_threads": torch.get_num_threads(), "scenes": {}}
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(dev)
    for sid, w, h in SCENES:
        scene = pt.load_scene(sid, "scenes", "meshes")
        res = Resolution(height=h, width=w)
        packed = pack_scene(scene)
        bufs = trace_kernel.kernel_scene_buffers(packed)
        ks = trace_kernel.kernel_scene_from_jax(bufs)
        pc = portal.build_portal_consts(packed)
        consts = trace_v2.build_scene_consts(packed)
        cls = trace_kernel.KernelScene
        parts = (ks.sph, ks.bnd, ks.tri, ks.tiles, ks.tile_base)

        def upload():
            if consts is not None:
                consts.to(dev)
            else:
                ks.to(dev)
                if pc is not None:
                    pc[0].to(dev)

        stages = {
            "pack_scene": lambda: pack_scene(scene),
            "scene_consts": lambda: trace_v2.build_scene_consts(packed),
            "quad_pairs": lambda: trace_kernel.detect_quad_pairs(packed),
            "buffers": lambda: trace_kernel.kernel_scene_buffers(packed),
            "kernel_scene": lambda: trace_kernel.kernel_scene_from_jax(bufs),
            "post_init": lambda: cls(*parts),
            "portal_consts": lambda: portal.build_portal_consts(packed),
            "camera_consts": lambda: trace_v2.build_camera_consts(
                scene.camera, w, h),
            "upload": upload,
            "prepare_render": lambda: pipeline.prepare_render(scene, res, dev),
        }
        times = {k: _time(fn, args.warm, args.repeats, sync)
                 for k, fn in stages.items()}
        med = {k: statistics.median(v) for k, v in times.items()}
        rows = {k: {"median": med[k], "min": min(v), "max": max(v)}
                for k, v in times.items()}
        rows["buffers_rest"] = {"median": med["buffers"] - med["quad_pairs"]}
        report["scenes"][sid] = rows
        print(f"{sid} {w}x{h} ({torch.get_num_threads()} torch threads, "
              f"{root}):", flush=True)
        for k, r in rows.items():
            extra = (f"  min {r['min']:8.3f}  max {r['max']:8.3f}"
                     if "min" in r else "")
            print(f"  {k:15s} {r['median']:8.3f} ms{extra}", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
