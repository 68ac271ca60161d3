#!/usr/bin/env python3
"""Readings for a cell's limits: the program's number and the control's.

    python3 bench_torch/control.py --workload <cell> --seeds 11,12,13 [--seconds 3] [--out FILE]

For each seed, one run of the cell at its own size and load, with a short
window (``--seconds``), then its check twice: with the program's answers
(a sound run's reading, the limit's lower side) and with the control in the
program's place: the plain reference computed in bfloat16, the precision
below the configuration's float32 (the upper side). One process holds the
program and its built kernels for every seed. Each seed's readings are
printed and appended to ``--out`` as a JSON line. The benchmark's runs do
not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import run  # noqa: E402
from common import load_module  # noqa: E402


def readings(ctx) -> dict:
    """(program's checks, control's checks) of one run of ``ctx``."""
    kind = load_module(os.path.join(HERE, "kinds", ctx.traffic["kind"] + ".py"))
    out = kind.run(ctx)
    answers = out.answers
    if out.free is not None:
        out.free()
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    program = kind.check(ctx, answers)
    ctx.control = torch.bfloat16
    control = kind.check(ctx, answers)
    ctx.control = None
    return {"program": {k: v["value"] for k, v in program.items()},
            "control": {k: v["value"] for k, v in control.items()},
            "attempted": out.attempted}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {run.card_line()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = run.make_ctx(argparse.Namespace(workload=args.workload, seed=seed,
                                              seconds=args.seconds, trace=0),
                           torch.device(args.device))
        rec = dict(readings(ctx), workload=args.workload, seed=seed)
        print(json.dumps(rec), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
