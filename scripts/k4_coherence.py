#!/usr/bin/env python3
"""How much of K4's work its warps spend on triangle rows a lane needs: the
coherence model of the `prim` route's regenerative kernel, measured with
the plain version.

``model`` runs K4's plain loop (``trace_kernel.regen_loop`` with
``isect_full_plain``, as ``trace_regen_prim_plain`` runs it: the same
outputs, bit for bit) on a scene at ``--res`` in Morton order, seed 7,
sample base 4, and records every step: which lanes trace a segment, the
tiles each one's scan tests (the base set, then each Morton tile its ray
enters closer than its best hit so far) and its tile-entry key
(``tile_entry_keys``: the tiles of the first 32 its ray's line enters).
Prints, per quota:

  1. segments, steps, live lanes a warp-step and the quota tail's share of
     lane-steps (a warp of 32 consecutive lanes, one thread a pixel, runs
     until its last lane has finished its quota);
  2. the share of the triangle rows executed that a lane needs, where a
     warp executes the base set and the union of its live lanes' tiles
     (scripts/k3_coherence.py's count):
     - one thread a pixel (the parent kernel);
     - each step's live lanes packed in chunks of ``window`` consecutive
       lanes, in lane order or sorted by tile-entry key, and traced 32 at
       a time (the chunk sort of K3 and K6, step by step).

``scheduled`` is the kernel's own schedule in plain torch (blocks of owner
threads that take pixels from a counter, each step's queries sorted by key
within the block), whose outputs equal the plain loop's bit for bit;
``--schedule THREADSxBLOCKS [--heavy H]`` prints its useful-row share and
its steps' balance too. ``resolve_model`` counts K7's schedules the same
way on one launch's lanes (scripts/ablate_k7.py, chip_smoke.py).

Everything counts rows and lane-steps, not time. Runs on the CPU at a tiny
size and on a card at the full one (the plain version on CUDA tensors):

  python3 scripts/k4_coherence.py --res 32x24 --quota 4 --device cpu
  python3 scripts/k4_coherence.py --res 1024x768 --quota 64 --device cuda

``--scene two-mesh`` takes ``two_mesh_scene``: scenes/mesh.json with a
second copy of its MeshFile, meshes/mctri.off, at another place. The
portal takes one heavy mesh beside at most 128 other primitives, so that
scene goes to the `prim` route (K4) by default.
"""

import argparse
import copy
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from path_tracer_tpu_torch.ops import rng  # noqa: E402
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk  # noqa: E402

SEED, SAMPLE_BASE, MAX_DEPTH, RR_START = 7, 4, 12, 5
WARP = 32
WINDOWS = (256, 1024)
SECOND_MESH_AT = [1.0, -1.5, -3.0]  # behind the first copy, to its right


def two_mesh_scene(pkg, root: str = ROOT):
    """scenes/mesh.json with a second copy of its MeshFile object at
    SECOND_MESH_AT, built with ``pkg`` (the port, or the JAX package in the
    tests): 1,634 triangles in two meshes of 810."""
    with open(os.path.join(root, "scenes", "mesh.json")) as fh:
        d = json.load(fh)
    first = next(o for o in d["objects"] if "MeshFile" in o["type_"])
    second = copy.deepcopy(first)
    second["position"] = list(SECOND_MESH_AT)
    d["objects"].append(second)
    d["id"] = "two-mesh"
    return pkg.SceneDescriptor.from_json_dict(d, base_dir=root)


def load(name: str, root: str = ROOT):
    """The port's scene ``name``: "two-mesh" or a scene of scenes/."""
    import path_tracer_tpu_torch as pt

    if name == "two-mesh":
        return two_mesh_scene(pt, root)
    return pt.load_scene(name, os.path.join(root, "scenes"),
                         os.path.join(root, "meshes"))


def _union_rows(group, tiles, base_rows: int) -> int:
    """Σ over groups of 32 lanes of 32 × (base rows + TRI_TILE × the tiles
    any lane of the group tests)."""
    if not group.numel():
        return 0
    n_groups = int(group.max()) + 1
    union = torch.zeros((n_groups, tiles.shape[1]), dtype=torch.int32,
                        device=tiles.device)
    union.index_add_(0, group, tiles.to(torch.int32))
    used = torch.unique(group).numel()
    return WARP * (used * base_rows + tk.TRI_TILE * int((union > 0).sum()))


def _chunk_groups(ids, keys, window: int, sort: bool):
    """Group ids for lanes ``ids`` packed in chunks of ``window``
    consecutive lanes, in lane order or sorted by key, 32 a group; and the
    permutation that puts the lanes in group order."""
    chunk = ids // window
    order = (torch.argsort(chunk * (1 << 33) + keys, stable=True) if sort
             else torch.arange(ids.numel(), device=ids.device))
    c = chunk[order]
    per = torch.bincount(c)
    start = torch.cumsum(per, 0) - per
    rank = torch.arange(ids.numel(), device=ids.device) - start[c]
    groups = -(-per // WARP)
    gbase = torch.cumsum(groups, 0) - groups
    return gbase[c] + rank // WARP, order


class Recorder:
    """isect(o, d, prev, alive) for regen_loop: ``isect_full_plain`` that
    counts, step by step, what the module doc lists."""

    def __init__(self, ks, n: int, windows=WINDOWS):
        self.ks = ks
        self.n = n
        self.windows = windows
        self.base_rows = ks.tile_base if ks.tiles.shape[0] else ks.tri.shape[0]
        self.n_warps = -(-n // WARP)
        self.c = dict(steps=0, lane_steps=0, warp_steps=0, needed=0,
                      thread_rows=0)
        for w in windows:
            for kind in ("packed", "sorted"):
                self.c[f"{kind}_{w}"] = 0

    def __call__(self, o, d, prev, alive):
        t: list = []
        out = tk.isect_full_plain(self.ks, o, d, prev, alive, tiles_out=t)
        dev = alive.device
        tiles = (torch.stack(t, dim=1) if t else
                 torch.zeros((self.n, 0), dtype=torch.bool, device=dev))
        c, base = self.c, self.base_rows
        live = int(alive.sum())
        c["steps"] += 1
        c["lane_steps"] += live
        c["needed"] += live * base + tk.TRI_TILE * int(tiles.sum())
        pad = self.n_warps * WARP - self.n
        lw = torch.cat([alive, alive.new_zeros(pad)]).view(self.n_warps, WARP)
        tw = torch.cat([tiles, tiles.new_zeros((pad, tiles.shape[1]))]).view(
            self.n_warps, WARP, -1)
        busy = lw.any(dim=1)
        c["warp_steps"] += int(busy.sum())
        c["thread_rows"] += WARP * (int(busy.sum()) * base + tk.TRI_TILE
                                    * int(tw.any(dim=1).sum()))
        ids = torch.nonzero(alive).squeeze(1)
        keys = tk.tile_entry_keys(self.ks, o, d)[ids]
        for w in self.windows:
            for kind in ("packed", "sorted"):
                group, order = _chunk_groups(ids, keys, w, kind == "sorted")
                c[f"{kind}_{w}"] += _union_rows(group, tiles[ids][order], base)
        return out


def model(ks, cam, pix, *, seed: int = SEED, sample_base: int = SAMPLE_BASE,
          quota: int, windows=WINDOWS):
    """(the model's numbers, the plain outputs (radiance [N, 3], segments,
    samples, as trace_regen_prim_plain returns them)) for K4's launch over
    pixels ``pix`` (see the module doc)."""
    rec = Recorder(ks, pix.shape[0], windows)
    p = pix.to(torch.int64)
    acc, counts, done = tk.regen_loop(
        sample_base, p, rec, tk.regen_draw(seed, p, None), cam, quota,
        MAX_DEPTH, RR_START)
    c = rec.c
    needed = max(c["needed"], 1)
    out = {
        "lanes": pix.shape[0], "quota": quota, "n_tiles": int(ks.tiles.shape[0]),
        "base_rows": int(rec.base_rows), "triangles": int(ks.tri.shape[0]),
        "segments": c["lane_steps"], "steps": c["steps"],
        "warp_steps": c["warp_steps"],
        "live_lanes_per_warp_step": c["lane_steps"] / max(c["warp_steps"], 1),
        "quota_tail_share": 1.0 - c["lane_steps"] / max(WARP * c["warp_steps"], 1),
        "rows_needed_per_segment": c["needed"] / max(c["lane_steps"], 1),
        "thread_per_pixel": {"useful_row_share": needed / max(c["thread_rows"], 1)},
    }
    for w in windows:
        for kind in ("packed", "sorted"):
            out[f"chunks_of_{w}_{kind}"] = {
                "useful_row_share": needed / max(c[f"{kind}_{w}"], 1)}
    plain = (torch.stack(acc, dim=1), counts.to(torch.int32),
             done.to(torch.int32))
    return out, plain


def _popcount(keys):
    return sum((keys >> c) & 1 for c in range(tk.KEY_TILES))


def _step_work(ids, keys, tiles, threads: int, blocks: int, base_rows: int,
               heavy: int):
    """One step of K4's schedule for the live owners ``ids`` (their keys and
    the tiles their scans test): (lane-rows executed, Σ over busy blocks of
    the rows a warp runs if the step's tasks spread evenly, Σ of the rows
    of the step: the larger of that and its longest task). A task's rows are
    the rows each lane tests in series: a warp query ceil(base / 32) + 2 a
    tile it tests, a group of 32 lane queries the base set + 64 a tile any
    of them tests."""
    dev = ids.device
    if not ids.numel():
        return 0, 0.0, 0.0
    warp_q = _popcount(keys) >= heavy
    blk = ids // threads
    wq_rows = (-(-base_rows // WARP) + 2 * tiles[warp_q].sum(dim=1)).double()
    lid = ids[~warp_q]
    group, order = _chunk_groups(lid, keys[~warp_q], threads, heavy >= 99)
    n_g = int(group.max()) + 1 if group.numel() else 0
    union = torch.zeros((n_g, tiles.shape[1]), dtype=torch.int32, device=dev)
    union.index_add_(0, group, tiles[~warp_q][order].to(torch.int32))
    g_rows = (base_rows + tk.TRI_TILE * (union > 0).sum(dim=1)).double()
    g_blk = torch.zeros(n_g, dtype=torch.int64, device=dev).scatter_(
        0, group, lid[order] // threads)
    task_blk = torch.cat([blk[warp_q], g_blk])
    task_rows = torch.cat([wq_rows, g_rows])
    total = torch.zeros(blocks, dtype=torch.float64, device=dev).index_add_(
        0, task_blk, task_rows)
    most = torch.zeros(blocks, dtype=torch.float64, device=dev)
    most.scatter_reduce_(0, task_blk, task_rows, "amax")
    busy = torch.bincount(task_blk, minlength=blocks) > 0
    even = total / (threads // WARP)
    return (WARP * int(task_rows.sum()), float(even[busy].sum()),
            float(torch.maximum(even, most)[busy].sum()))


BATCH = 1 << 18  # lanes per isect_full_plain call (bounds its temporaries)


def resolve_model(ks, o, d, prev, alive, *, threads: int = 1024) -> dict:
    """K7's schedules on one launch's lanes (o, d: 3 lists of [n] f32;
    prev [n]; alive [n] bool), each live lane's tiles and key recorded as
    ``Recorder`` records a step of K4's, and counted as ``_step_work``
    counts it:

    - ``thread_per_lane``: the kernel before its redesign, warps of 32
      consecutive lanes, the dead ones included: the share of lane slots on
      a live lane, and of the rows executed that a lane needs;
    - ``split`` and ``sorted``: chunks of ``threads`` consecutive lanes (a
      block each, csrc/trace_stepped.cu K7_THREADS), whose live lanes are
      split into warp queries (a line that enters a tile) and lane queries
      32 to a warp, or sorted by tile-entry key and traced 32 to a warp:
      the useful-row share and a chunk's balance (``scheduled``'s
      step_balance).

    ``visits`` [n]: how many of the split schedule's tasks trace each lane
    (1 for a live lane, 0 for a dead one)."""
    dev = alive.device
    n = alive.shape[0]
    ids = torch.nonzero(alive).squeeze(1)
    lo_, do_ = [x[ids] for x in o], [x[ids] for x in d]
    tiles = []
    for lo in range(0, ids.numel(), BATCH):
        sl = slice(lo, lo + BATCH)
        t: list = []
        tk.isect_full_plain(ks, [x[sl] for x in lo_], [x[sl] for x in do_],
                            prev[ids][sl], torch.ones_like(ids[sl], dtype=torch.bool),
                            tiles_out=t)
        tiles.append(torch.stack(t, dim=1) if t else torch.zeros(
            (ids[sl].numel(), 0), dtype=torch.bool, device=dev))
    tiles = (torch.cat(tiles) if tiles else
             torch.zeros((0, ks.tiles.shape[0]), dtype=torch.bool, device=dev))
    keys = tk.tile_entry_keys(ks, lo_, do_)
    base = ks.tile_base if ks.tiles.shape[0] else ks.tri.shape[0]
    needed = ids.numel() * base + tk.TRI_TILE * int(tiles.sum())
    warp_q = _popcount(keys) >= 1
    out = {"lanes": n, "live": ids.numel(), "warp_queries": int(warp_q.sum()),
           "lane_queries": int((~warp_q).sum()),
           "rows_needed_per_lane": needed / max(ids.numel(), 1),
           "thread_per_lane": {
               "lane_slot_share": ids.numel() / (WARP * -(-n // WARP)),
               "useful_row_share": needed / max(
                   _union_rows(ids // WARP, tiles, base), 1)}}
    blocks = -(-n // threads)
    for name, heavy in (("split", 1), ("sorted", 99)):
        executed, even, step = _step_work(ids, keys, tiles, threads, blocks,
                                          base, heavy)
        out[name] = {"useful_row_share": needed / max(executed, 1),
                     "chunk_balance": even / max(step, 1.0)}
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    visits.index_add_(0, ids[warp_q], torch.ones_like(ids[warp_q]))
    lid = ids[~warp_q]
    group, order = _chunk_groups(lid, keys[~warp_q], threads, False)
    visits.index_add_(0, lid[order], torch.ones_like(group))
    out["visits"] = visits
    return out


def scheduled(ks, cam, pix, *, seed: int = SEED,
              sample_base: int = SAMPLE_BASE, quota: int, uniforms=None,
              threads: int = 1024, blocks: int | None = None, heavy: int = 1,
              max_depth: int = MAX_DEPTH, rr_start_depth: int = RR_START):
    """K4's schedule (csrc/trace_regen_prim.cu) in plain torch: ``blocks``
    blocks of ``threads`` owner threads (default: enough blocks for every
    item at once). Owner t of block b starts with item b * threads + t and,
    once its item has finished its quota (outputs written), takes the next
    item from a counter. Each step every owner with an item traces one
    segment of it, which the row count follows (``_step_work``): a query
    whose line enters at least ``heavy`` tiles (of its key's 32) is traced
    by a whole warp, the others 32 at a time (the kernel: ``heavy`` 1; 99
    for the design it replaced, no warp queries and each block's queries
    sorted by key). Per item this is the plain loop's
    arithmetic in its order, so the outputs (radiance [N, 3], segments,
    samples) equal trace_regen_prim_plain's bit for bit. Returns (outputs,
    numbers): the useful-row share of the schedule's warps, the steps, and
    the balance of a block's step: the rows a warp runs if the step's tasks
    spread evenly over its warps, over the rows of the step, which lasts at
    least as long as its longest task."""
    n = pix.shape[0]
    dev = pix.device
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    segs_out = torch.zeros(n, dtype=torch.int32, device=dev)
    done_out = torch.zeros(n, dtype=torch.int32, device=dev)
    if quota == 0:  # no segment: the kernel writes zeros
        return (rad, segs_out, done_out), {"useful_row_share": 0.0,
                                           "steps": 0, "step_balance": 0.0}
    blocks = blocks or -(-n // threads)
    lanes = blocks * threads
    owner = torch.arange(lanes, device=dev)
    item = torch.where(owner < n, owner, 0)
    has = owner < n
    nxt = lanes
    zero = torch.zeros(lanes, dtype=torch.float32, device=dev)
    lc = cam.floats()[3]
    o = [zero + lc[0], zero + lc[1], zero + lc[2]]
    d = [zero, zero, zero + 1.0]
    thr, acc = [zero] * 3, [zero] * 3
    alive = torch.zeros(lanes, dtype=torch.bool, device=dev)
    prev = torch.full((lanes,), -1, dtype=torch.int64, device=dev)
    depth, done, segs = (torch.zeros(lanes, dtype=torch.int64, device=dev)
                         for _ in range(3))
    base_rows = ks.tile_base if ks.tiles.shape[0] else ks.tri.shape[0]
    needed = executed = steps = 0
    ideal = step_rows = 0.0
    while True:
        idle = torch.nonzero(~has).squeeze(1)
        take = min(idle.numel(), n - nxt)
        if take > 0:  # owners in order take the counter's next items
            idx = idle[:take]
            item[idx] = torch.arange(nxt, nxt + take, device=dev)
            has[idx] = True
            nxt += take
            fresh = torch.zeros_like(has)
            fresh[idx] = True
            done = torch.where(fresh, 0, done)
            segs = torch.where(fresh, 0, segs)
            acc = [torch.where(fresh, 0.0, a) for a in acc]
            alive = alive & ~fresh
        if not bool(has.any()):
            break
        steps += 1
        p = pix[item].to(torch.int64)
        need = has & ~alive
        depth = torch.where(need, 0, depth)
        s_global = sample_base + done
        if uniforms is None:
            key = rng.path_key(seed, p, s_global)
            u = [rng.uniform(key, depth, k) for k in range(rng.N_SLOTS)]
        else:
            u = [uniforms[k][item] for k in range(rng.N_SLOTS)]
        raygen, _ = tk.make_raygen(cam, p)
        d_new = raygen(s_global, u[4], u[5])
        o = [torch.where(need, lc[k], o[k]) for k in range(3)]
        d = [torch.where(need, d_new[k], d[k]) for k in range(3)]
        thr = [torch.where(need, 1.0, thr[k]) for k in range(3)]
        prev = torch.where(need, -1, prev)
        live = has
        segs = segs + live
        t: list = []
        found, point, nrm, color, emis, rtype, new_prev = tk.isect_full_plain(
            ks, o, d, prev, live, tiles_out=t)
        tiles = (torch.stack(t, dim=1) if t else
                 torch.zeros((lanes, 0), dtype=torch.bool, device=dev))
        ids = torch.nonzero(live).squeeze(1)
        keys = tk.tile_entry_keys(ks, o, d)[ids]
        work = _step_work(ids, keys, tiles[ids], threads, blocks, base_rows,
                          heavy)
        executed += work[0]
        ideal += work[1]
        step_rows += work[2]
        needed += ids.numel() * base_rows + tk.TRI_TILE * int(tiles.sum())
        new_depth = depth + 1
        acc, thr_new, d2, alive_new = tk.shade_phase(
            d, nrm, color, emis, rtype, found, thr, acc, u[:4], new_depth,
            max_depth, rr_start_depth)
        am = alive_new.to(torch.float32)
        done = done + (live & ~alive_new)
        o = [torch.where(alive_new, point[k], o[k]) for k in range(3)]
        d = [torch.where(alive_new, d2[k], d[k]) for k in range(3)]
        thr = [thr_new[k] * am for k in range(3)]
        prev = torch.where(alive_new, new_prev, -1)
        depth = new_depth
        alive = alive_new
        fin = live & (done == quota)
        if bool(fin.any()):  # finished items write their outputs
            f = item[fin]
            rad[f] = torch.stack([a[fin] for a in acc], dim=1)
            segs_out[f] = segs[fin].to(torch.int32)
            done_out[f] = done[fin].to(torch.int32)
            has = has & ~fin
    return (rad, segs_out, done_out), {
        "useful_row_share": needed / max(executed, 1), "steps": steps,
        "step_balance": ideal / max(step_rows, 1.0)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="32x24", help="WIDTHxHEIGHT")
    ap.add_argument("--quota", type=int, nargs="+", default=[4])
    ap.add_argument("--scene", default="mesh", help="mesh or two-mesh")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--schedule", default=None,
                    help="THREADSxBLOCKS: also the kernel's schedule's share")
    ap.add_argument("--heavy", type=int, default=1,
                    help="with --schedule: the tiles that make a warp query "
                    "(99: none, the lane queries sorted by key)")
    args = ap.parse_args()
    from path_tracer_tpu_torch.render.pipeline import (
        morton_pixel_order, prepare_render,
    )
    from path_tracer_tpu_torch.utils.config import Resolution

    w, h = (int(x) for x in args.res.split("x"))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("k4_coherence: no CUDA device", file=sys.stderr)
        return 1
    res = Resolution(h, w)
    os.environ["PT_TPU_NO_PORTAL"] = "1"  # mesh too takes the prim route
    prep = prepare_render(load(args.scene), res, dev)
    pix = torch.from_numpy(morton_pixel_order(w, h)[0]).to(dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for q in args.quota:
        out, _ = model(prep.kscene, prep.cam, pix, quota=q)
        if args.schedule:
            threads, blocks = (int(x) for x in args.schedule.split("x"))
            _, out[f"schedule_{args.schedule}"] = scheduled(
                prep.kscene, prep.cam, pix, quota=q, threads=threads,
                blocks=blocks, heavy=args.heavy)
        print(json.dumps({"scene": args.scene, "res": args.res,
                          "device": where, **out}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
