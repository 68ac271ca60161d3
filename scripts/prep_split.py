#!/usr/bin/env python3
"""Where ``pipeline.prepare_render``'s host time goes, stage by stage, as
the program's own spans name the stages.

For each configuration of the benchmark's render cells (``BENCHMARK.json``
cells whose traffic is of kind ``render``, at the traffic's resolution),
calls ``prepare_render`` ``--warm`` times, then ``--repeats`` times under
a CPU ``torch.profiler``, and prints for each ``render.prepare`` span and
each stage span inside it (``render.prepare.pack``, ``.consts``,
``.kscene`` with ``.kscene.rows`` and ``.kscene.table``, ``.portal``,
``.copy``) the median, min and max over the calls in ms (a stage logged
twice in a call counts its sum), ``rest`` the prepare less its stages, and
``.copy``'s bytes. The times are profiled host times, as a ``--trace 1``
benchmark run reads them. ``--out PATH`` writes them as JSON. ``--root
DIR`` imports the package and loads the configurations from another
checkout (``git archive <commit> | tar -x -C DIR``), so two commits can be
compared in one call; a checkout without the stage spans shows the whole
``render.prepare`` alone:

  python3 scripts/prep_split.py --device cuda --out chiprun_out/split.json
  python3 scripts/prep_split.py --root _parent --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

PREPARE = "render.prepare"


def render_configs(root: str) -> list[tuple[str, str, int, int]]:
    """(name, scene file, width, height) of each configuration of the
    benchmark's render cells, in the cells' order."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    files = {c["name"]: os.path.join(root, c["file"]) for c in bench["configs"]}
    out, seen = [], set()
    for cell in bench["workloads"]:
        with open(os.path.join(root, "bench_torch", "traffic",
                               cell["traffic"] + ".json")) as fh:
            traffic = json.load(fh)
        if traffic["kind"] != "render" or cell["config"] in seen:
            continue
        seen.add(cell["config"])
        cfg_file = files[cell["config"]]
        with open(cfg_file) as fh:
            scene = os.path.join(os.path.dirname(cfg_file), json.load(fh)["scene"])
        out.append((cell["config"], scene, traffic["width"], traffic["height"]))
    return out


def load_scene(pt, path: str):
    """The scene file as the program's SceneDescriptor, its mesh files
    taken from beside it (as the benchmark loads it)."""
    with open(path) as fh:
        desc = json.load(fh)
    for obj in desc["objects"]:
        if "MeshFile" in obj["type_"]:
            f = obj["type_"]["MeshFile"]
            f["path"] = os.path.join(os.path.dirname(path), f["path"])
    return pt.SceneDescriptor.from_json_dict(desc)


def split(log) -> list[dict]:
    """Each ``render.prepare`` span of the log → {name: ms} of it and of
    the spans inside it (summed by name), ``rest`` and ``copy_bytes``."""
    calls, owner, staged = [], {}, []
    for i, s in enumerate(log):
        if s.name == PREPARE:
            owner[i] = len(calls)
            calls.append({PREPARE: 1e-6 * (s.end_ns - s.start_ns)})
            staged.append(0.0)
        elif s.parent in owner:
            owner[i] = call = owner[s.parent]
            ms = 1e-6 * (s.end_ns - s.start_ns)
            calls[call][s.name] = calls[call].get(s.name, 0.0) + ms
            if log[s.parent].name == PREPARE:
                staged[call] += ms
            if s.name == PREPARE + ".copy" and s.size is not None:
                calls[call]["copy_bytes"] = calls[call].get("copy_bytes", 0) + s.size
    for c, ms in zip(calls, staged):
        c["rest"] = c[PREPARE] - ms
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--configs", nargs="*", help="these configurations only")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else ""
    sys.path.insert(0, root)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.render import pipeline
    from path_tracer_tpu_torch.utils import profiling
    from path_tracer_tpu_torch.utils.config import Resolution

    dev = torch.device(args.device)
    report = {"root": root, "device": str(dev),
              "torch_threads": torch.get_num_threads(), "configs": {}}
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(dev)
    for name, path, w, h in render_configs(root):
        if args.configs and name not in args.configs:
            continue
        scene = load_scene(pt, path)
        res = Resolution(height=h, width=w)
        for _ in range(args.warm):
            pipeline.prepare_render(scene, res, dev)
        profiling.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(args.repeats):
                pipeline.prepare_render(scene, res, dev)
        calls = split(profiling.spans())
        profiling.clear()
        keys = list(dict.fromkeys(k for c in calls for k in c))
        rows = {}
        for k in keys:
            vals = [c.get(k, 0.0) for c in calls]
            rows[k] = {"median": statistics.median(vals), "min": min(vals),
                       "max": max(vals)}
        report["configs"][name] = rows
        print(f"{name} {w}x{h} ({len(calls)} calls, {root}):", flush=True)
        for k, r in rows.items():
            unit = "B " if k == "copy_bytes" else "ms"
            print(f"  {k:30s} {r['median']:12.3f} {unit}  min {r['min']:12.3f}"
                  f"  max {r['max']:12.3f}", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
