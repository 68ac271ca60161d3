#!/usr/bin/env python3
"""The benchmark of path_tracer_tpu_torch, the path tracer on PyTorch and
hand-written CUDA, on NVIDIA H100 cards.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. A cell is an entry of ``workloads`` in
``BENCHMARK.json``: a configuration (``configs``, a file under
``bench_torch/configs/``) under a traffic mix (``bench_torch/traffic/<name>.json``,
whose ``kind`` names its generator, ``bench_torch/kinds/<kind>.py``). A run:

1. loads the program and the cell's scene, builds or loads the program's
   kernels (``path_tracer_tpu_torch/_build/``), and warms up this cell's
   shapes alone: that is ``setup_s``, counted from the process's start;
2. drives the traffic for ``--seconds``, with ``--trace 1`` under
   torch.profiler for the traffic's first ``trace_units``;
3. reads the peak of device memory, frees the program's state, and holds a
   sample of the window's answers, drawn from the seed, to the plain
   reference (``reference.py``): each number compared has its limit in
   ``bench_torch/checks/<cell>.json``;
4. prints those numbers beside their limits on standard error and, as the
   last line of standard output, one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer metrics, each read by
   ``bench_torch/metrics/<name>.py``), ``device``, ``breakdown`` (traced
   runs) and ``checks``.

It needs CUDA and as many cards as the cell asks for; without them it
exits non-zero and prints no result. It never falls back to the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (_HERE, os.path.dirname(_HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from common import HERE, ROOT, load_module, unit_seed  # noqa: E402


@dataclass
class Ctx:
    """One run: the cell, its configuration and traffic, and the device."""

    cell: dict
    config: dict
    config_dir: str
    traffic: dict
    limits: dict
    bench: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float = T0
    control: object = None  # a dtype: the control takes the program's place

    def path(self, rel: str) -> str:
        return os.path.join(self.config_dir, rel)

    def scene_path(self) -> str:
        return self.path(self.config["scene"])

    def program_scene(self):
        """The configuration's scene as the program's SceneDescriptor, its
        mesh files taken from beside the scene file."""
        import path_tracer_tpu_torch as pt

        with open(self.scene_path()) as fh:
            desc = json.load(fh)
        base = os.path.dirname(self.scene_path())
        for obj in desc["objects"]:
            if "MeshFile" in obj["type_"]:
                f = obj["type_"]["MeshFile"]
                f["path"] = os.path.join(base, f["path"])
        return pt.SceneDescriptor.from_json_dict(desc)

    def unit_seed(self, i: int) -> int:
        return unit_seed(self.seed, i)

    def rng(self, stream: int):
        import numpy as np

        return np.random.default_rng([int(self.seed) & (2**64 - 1), stream])


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    for w in bench["workloads"]:
        if w["name"] == name:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise SystemExit(f"cell {name!r} names no configuration {w['config']!r}")
    raise SystemExit(f"BENCHMARK.json has no cell {name!r}")


def make_ctx(args, device, root: str = ROOT) -> Ctx:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell, conf = find_cell(bench, args.workload)
    cfg_file = os.path.join(root, conf["file"])
    with open(cfg_file) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    with open(os.path.join(HERE, "checks", cell["name"] + ".json")) as fh:
        limits = json.load(fh)
    return Ctx(cell=cell, config=config, config_dir=os.path.dirname(cfg_file),
               traffic=traffic, limits=limits, bench=bench, seed=args.seed,
               seconds=float(args.seconds), trace=bool(args.trace), device=device)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def run(ctx: Ctx) -> dict:
    """Drive the cell and check it; returns the result line's object."""
    import torch

    kind = load_module(os.path.join(HERE, "kinds", ctx.traffic["kind"] + ".py"))
    out = kind.run(ctx)
    cuda = torch.device(ctx.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    answers = out.answers
    if out.free is not None:
        out.free()
    out.answers = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = kind.check(ctx, answers)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    e2e = [m for m in ctx.bench["end_to_end"] if applies(m, ctx.cell["name"], set())]
    metrics = {}
    if not ctx.trace:
        for m in e2e:
            metrics[m["name"]] = {"value": out.metrics[m["name"]], "unit": m["unit"]}
    else:
        names = {m["name"] for m in e2e}
        for m in ctx.bench["per_layer"]:
            if not applies(m, ctx.cell["name"], names):
                continue
            reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"))
            value = reader.read(ctx, out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(ctx.cell.get("chips", 1)),
              "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.device_ops,
                               "idle_gaps": out.trace.idle_gaps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        cell, _ = find_cell(json.load(fh), args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    result = run(make_ctx(args, torch.device("cuda")))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
