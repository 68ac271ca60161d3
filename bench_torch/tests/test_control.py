"""The control fails every cell's comparison: the plain reference computed
in bfloat16, the precision below the configuration's float32, put in the
program's place, reads over the cell's limit. Its readings on the chip at
the cells' own sizes come from ``bench_torch/control.py``."""

import numpy as np
import pytest
import torch

import run
from common import load_module
from conftest import CELLS, tiny


def _answers(ctx):
    """Answers whose content the control replaces: only their seeds,
    poses and sample counts matter."""
    if ctx.traffic["kind"] == "render":
        return [(ctx.unit_seed(i), None) for i in range(2)]
    kind = load_module(f"{run.HERE}/kinds/preview.py")
    scene = ctx.program_scene()
    poses = kind.gestures(ctx.traffic, {"position": scene.camera.position,
                                        "direction": scene.camera.direction})
    (p1, d1), (p2, d2) = poses[0][0], poses[1][-1]
    return [("restart", (p1, d1, 1, None)),
            ("settled", (p2, d2, ctx.traffic["still_frames"] + 1, None))]


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_reads_over_the_limit(cell):
    ctx = tiny(cell)
    kind = load_module(f"{run.HERE}/kinds/{ctx.traffic['kind']}.py")
    ctx.control = torch.bfloat16
    checks = kind.check(ctx, _answers(ctx))
    assert checks and all(np.isfinite(c["value"]) for c in checks.values())
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
