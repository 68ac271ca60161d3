#!/usr/bin/env python3
"""How K1's warps spend their steps: the coherence model of the main path's
regenerative kernel, measured with its plain version.

Runs ``trace_regen_plain`` (``trace_kernel.regen_loop`` over the baked
scene's plain scan) with every step recorded, and groups the lanes into
warps of 32 consecutive lanes, as K1 does: lane i is pixel pixel_idx[i],
Morton order on the main path. A warp steps until its longest lane has
traced its quota, and at every step it runs each branch that one of its
lanes takes. Prints

  1. for each branch (regen: a fresh camera ray and its two draws; hit: the
     hit-row read, the surface and shading's common part; diffuse, mirror,
     refract: shading's three BSDF branches, and specular: mirror or
     refract, which share the reflected direction; miss), the share of warp-steps
     that run it and the mean lanes active in those warp-steps, and the
     lanes in each branch over the segments (diffuse, mirror, refract and
     miss partition them);
  2. the distinct hit rows a warp reads a step (lanes that hit), and the
     shared-memory wavefronts one read of a hit row costs at the rows'
     32-float stride (a warp replays it once per distinct row) and at the
     hit table's odd stride of 13;
  3. each warp's quota tail: the lane-steps lost while a warp waits for its
     longest pixel, and the share of lane-steps doing work;
  4. the scene's kinds (spheres, quads, triangles, gated rows), which weigh
     the scan's parts in scripts/k1_sass.py's issue bound.

Everything counts steps, lanes and rows, not time. On the card it runs at
the main path's shape (cornell 1024x768, quota 256, sample_base 0, Morton
order, seed 0); on the CPU at a small size:

  python3 scripts/k1_coherence.py --res 64x48 --quota 4 --device cpu
  python3 scripts/k1_coherence.py --res 1024x768 --quota 256 --device cuda
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_v2 as tv2  # noqa: E402

WARP = 32
BRANCHES = ("regen", "hit", "diffuse", "specular", "mirror", "refract",
            "miss")
STRIDES = (tv2.PRIM_F, tv2.HIT_F)


def wavefronts(rows, hit, n_rows: int, stride: int):
    """([W] distinct rows, [W] shared-memory wavefronts) of a warp's hit
    read: the rows its hitting lanes read, and the wavefronts one column
    read of them costs at ``stride`` floats a row (the most distinct rows
    that fall in one bank)."""
    ids = torch.arange(n_rows, device=rows.device)
    one_hot = ((rows[..., None] == ids) & hit[..., None]).any(dim=1)
    bank = (ids * stride) % 32
    per_bank = torch.zeros(rows.shape[0], 32, dtype=torch.int64,
                           device=rows.device)
    per_bank.index_add_(1, bank, one_hot.to(torch.int64))
    return one_hot.sum(dim=1), per_bank.max(dim=1).values


class Recorder:
    """Accumulates the per-warp numbers of each step of regen_loop."""

    def __init__(self, scene, n: int, dev):
        self.scene = scene
        self.n = n
        self.warps = -(-n // WARP)
        self.pad = self.warps * WARP - n
        self.n_rows = scene.prims.shape[0]
        self.need = None
        # the first color channel of each row, for the tagged scan (tagged)
        self.color0 = scene.prims[:, tv2.COL_COLOR].clone()
        self.steps = 0
        self.warp_steps = 0
        self.branch_warp_steps = dict.fromkeys(BRANCHES, 0)
        self.branch_lanes = dict.fromkeys(BRANCHES, 0)
        self.hit_warp_steps = 0
        self.distinct_rows = 0
        self.distinct_hist = torch.zeros(9, dtype=torch.int64)
        self.waves = dict.fromkeys(STRIDES, 0)

    def _w(self, x, fill=False):
        if self.pad:
            x = torch.cat([x, x.new_full((self.pad,), fill)])
        return x.view(self.warps, WARP)

    def draw(self, inner):
        def draw(sample_idx, depth):
            self.need = depth == 0  # a lane regenerates at depth 0 only
            return inner(sample_idx, depth)
        return draw

    def isect(self, inner):
        """The plain isect over the tagged scene (``tagged``), recording the
        row each lane hit, with the rows' own first color channel put back."""
        def isect(o, d, prev, alive):
            found, point, nrm, color, emis, rtype, new_prev = inner(
                o, d, prev, alive)
            row = color[0].to(torch.int64) - 1  # -1 for a miss
            color = [torch.where(row >= 0, self.color0[row.clamp(min=0)],
                                 color[0]), color[1], color[2]]
            self.record(alive, found, rtype, row)
            return found, point, nrm, color, emis, rtype, new_prev
        return isect

    def record(self, live, found, rtype, row):
        live_w = self._w(live)
        active = live_w.any(dim=1)
        self.steps += 1
        self.warp_steps += int(active.sum())
        need = self.need & live
        hit = found
        masks = {
            "regen": need, "hit": hit,
            "diffuse": hit & (rtype < 0.5),
            "specular": hit & (rtype >= 0.5),
            "mirror": hit & (rtype >= 0.5) & (rtype < 1.5),
            "refract": hit & (rtype >= 1.5),
            "miss": live & ~found,
        }
        for b, m in masks.items():
            mw = self._w(m)
            self.branch_warp_steps[b] += int(mw.any(dim=1).sum())
            self.branch_lanes[b] += int(m.sum())
        hit_w = self._w(hit)
        rows_w = self._w(torch.where(hit, row, 0), 0)
        any_hit = hit_w.any(dim=1)
        self.hit_warp_steps += int(any_hit.sum())
        for stride in STRIDES:
            distinct, waves = wavefronts(rows_w, hit_w, self.n_rows, stride)
            self.waves[stride] += int(waves[any_hit].sum())
        self.distinct_rows += int(distinct[any_hit].sum())
        self.distinct_hist += torch.bincount(
            distinct[any_hit].clamp(max=8), minlength=9).cpu()

    def result(self, segs) -> dict:
        segs_w = self._w(segs.to(torch.int64), 0)
        longest = segs_w.max(dim=1).values
        warp_lane_steps = int(longest.sum()) * WARP
        prims = self.scene.prims.cpu()
        kind = prims[:, tv2.COL_KIND]
        out = {
            "lanes": self.n, "warps": self.warps, "loop_steps": self.steps,
            "segments": int(segs.sum()), "warp_steps": self.warp_steps,
            "segments_per_warp_step": int(segs.sum()) / max(self.warp_steps, 1),
            "lanes_by_branch": dict(self.branch_lanes),
            "lane_shares": {b: self.branch_lanes[b] / max(int(segs.sum()), 1)
                            for b in BRANCHES},
            "branches": {
                b: {"warp_step_share": self.branch_warp_steps[b]
                    / max(self.warp_steps, 1),
                    "lanes_when_run": self.branch_lanes[b]
                    / max(self.branch_warp_steps[b], 1)}
                for b in BRANCHES},
            "hit_rows": {
                "warp_steps_with_a_hit": self.hit_warp_steps,
                "distinct_rows_per_warp_step": self.distinct_rows
                / max(self.hit_warp_steps, 1),
                "distinct_rows_histogram_0_to_8plus":
                    self.distinct_hist.tolist(),
                **{f"wavefronts_per_read_stride_{s}": self.waves[s]
                   / max(self.hit_warp_steps, 1) for s in STRIDES}},
            "quota_tail": {
                "lane_steps_lost": warp_lane_steps - int(segs.sum()),
                "lane_share": int(segs.sum()) / max(warp_lane_steps, 1)},
            "scene": {
                "prims": int(prims.shape[0]),
                "spheres": int((kind == tv2.KIND_SPHERE).sum()),
                "quads": int((kind == tv2.KIND_QUAD).sum()),
                "triangles": int((kind == tv2.KIND_TRI).sum()),
                "gated": int((prims[:, tv2.COL_GATE] >= 0).sum())},
        }
        return out


def tagged(scene):
    """A copy of ``scene`` whose rows hold their index plus one in the first
    color channel. The scan picks a hit without reading colors, so the plain
    scan over the copy hits the same rows and reports which one as that
    channel (0 for a miss)."""
    prims = scene.prims.clone()
    prims[:, tv2.COL_COLOR] = torch.arange(1, prims.shape[0] + 1,
                                           dtype=prims.dtype,
                                           device=prims.device)
    return tv2.SceneConsts(prims, scene.gates)


def model(scene, cam, pixel_idx, *, seed: int = 0, sample_base: int = 0,
          quota: int, max_depth: int = 12, rr_start_depth: int = 5,
          uniforms=None):
    """(the model's numbers, (radiance, segments, done) of the plain run):
    trace_regen_plain's loop with every step recorded."""
    tv2._check_args(scene, pixel_idx, quota, max_depth, uniforms)
    pix = pixel_idx.to(torch.int64)
    rec = Recorder(scene, pix.shape[0], pix.device)
    isect = rec.isect(tv2.make_isect(tagged(scene)))
    draw = rec.draw(tk.regen_draw(seed, pix, uniforms))
    acc, counts, done = tk.regen_loop(sample_base, pix, isect, draw, cam,
                                      quota, max_depth, rr_start_depth)
    out = rec.result(counts)
    return out, (torch.stack(acc, dim=1), counts.to(torch.int32),
                 done.to(torch.int32))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--res", default="64x48", help="WIDTHxHEIGHT")
    ap.add_argument("--quota", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    import path_tracer_tpu_torch as pt
    from path_tracer_tpu_torch.render.pipeline import (
        morton_pixel_order, prepare_scene,
    )
    from path_tracer_tpu_torch.utils.config import Resolution

    w, h = (int(x) for x in args.res.split("x"))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("k1_coherence: no CUDA device", file=sys.stderr)
        return 1
    scene = pt.load_scene(args.scene, os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))
    res = Resolution(h, w)
    scene_c, cam_c = prepare_scene(scene, res, dev)
    pix = torch.from_numpy(morton_pixel_order(w, h)[0]).to(dev)
    out, _ = model(scene_c, cam_c, pix, seed=args.seed, quota=args.quota)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"scene": args.scene, "res": args.res,
                      "quota": args.quota, "device": where, **out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
