#!/usr/bin/env python3
"""How much of K3's work its warps spend on rows a lane needs: the coherence
model of the portal pool resolve, measured with the plain versions.

Runs the v2 cycle as chip_smoke.py's phase 3 does (mesh, park depth 3, step
cap 64, seed 7): K2 and K3 through their plain versions on cycles 0 and 1,
then K2 of cycle 2, which gives K3's input pool on cycle 2. For every live
(column, part) item it records the tiles the item's bounce tests
(``isect_full_plain``'s per-lane cull) and prints

  1. the live share of each part (columns whose part has a live path);
  2. under the one-thread-per-column schedule (warps of 32 columns, the
     parts in turn; a warp runs a part if one of its lanes has it live):
     the share of lane slots that hold a live bounce, and the share of the
     triangle rows executed per lane slot that a lane needs (a warp
     executes the base set and the union of its lanes' tiles);
  3. the same two shares under csrc/portal_resolve.cu's schedule: the live
     items packed in column order, in chunks of ``window`` columns, each
     chunk sorted by the tile-entry key (``tile_entry_keys``), warps of 32
     consecutive items; and with the packing alone (no sort);
  4. the group-split model (``group_union``, chunks of 1,024 columns
     sorted as in 3): the mean number of tiles in the union of the tiles
     tested by R consecutive sorted items, for R in 1, 2, 4, 8, 16 and 32
     (R = 32 is a warp of today's one-lane-an-item trace; a warp that
     traces R items with 32 / R lanes each runs 2 x that union of row
     iterations an item), over every live item (``all``) and over the
     items whose line enters a tile (``tile_queries``), in the order the
     kernel traces them where the tiles outnumber the key: those with an
     empty key first, in column order, then the others by key.

Everything counts rows (a triangle distance test each), not time: the gap
between these shares and the kernel's measured time is what latency and
occupancy cost. Runs on the CPU at a small size and on a card at the full
one (plain versions on CUDA tensors):

  python3 scripts/k3_coherence.py --res 128x96 --device cpu
  python3 scripts/k3_coherence.py --res 1024x768 --device cuda
  python3 scripts/k3_coherence.py --scene mesh13k --res 64x48 --device cpu

``--scene`` takes ``mesh`` (scenes/mesh.json, the default) or a benchmark
configuration's scene (``mesh13k``: bench_torch/configs/mesh13k/, 199
tiles, past the key's 31).
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from path_tracer_tpu_torch.ops.kernels import portal as pk  # noqa: E402
from path_tracer_tpu_torch.ops.kernels.trace_kernel import (  # noqa: E402
    KEY_TILES, TRI_TILE, _inv_dir, _tile_slab, isect_full_plain,
    tile_entry_keys,
)

PARK_K, STEP_CAP, SEED, MAX_DEPTH = 3, 64, 7, 12
WARP = 32
BATCH = 1 << 18  # items per isect_full_plain call (bounds its temporaries)
GROUP_WINDOW = 1024  # csrc/portal_resolve.cu's K3_WINDOW
GROUP_RS = (1, 2, 4, 8, 16, 32)


def load_named_scene(name: str):
    """``mesh`` from scenes/, or a benchmark configuration's scene
    (bench_torch/configs/<name>/<name>.json, its meshes beside it)."""
    import path_tracer_tpu_torch as pt

    path = os.path.join(ROOT, "bench_torch", "configs", name, f"{name}.json")
    if name == "mesh" or not os.path.exists(path):
        return pt.load_scene(name, os.path.join(ROOT, "scenes"),
                             os.path.join(ROOT, "meshes"))
    with open(path) as fh:
        desc = json.load(fh)
    return pt.SceneDescriptor.from_json_dict(desc,
                                             base_dir=os.path.dirname(path))


def k3_input_pool(scene, res, dev, cycle: int = 2):
    """(KernelScene, K3's input pool on ``cycle`` of a fresh drive), from
    the plain versions, as chip_smoke.py's phase 3 builds it."""
    from path_tracer_tpu_torch.render import portal as rp
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    prep = prepare_render(scene, res, dev)
    npix = res.num_pixels
    pool = rp.make_pool_v2(npix, rp._round_block(npix), 256, park_k=PARK_K,
                           device=dev)
    cheap = dict(seed=SEED, quota=256, sample_base=0, step_cap=STEP_CAP,
                 park_k=PARK_K, max_depth=MAX_DEPTH)
    for cyc in range(cycle + 1):
        pool = pk.trace_cheap_regen_plain(prep.portal, prep.cam, pool, **cheap)[0]
        if cyc < cycle:
            pool = pk.trace_resolve_pool_plain(
                prep.kscene, pool, seed=SEED, parts=PARK_K + 1, park_k=PARK_K,
                max_depth=MAX_DEPTH)[0]
    return prep.kscene, pool


def _item_rays(pool, cols, parts):
    """o, d (3 lists of [L]) and prev [L] of each item's path."""
    base = torch.where(parts == 0, pk.ROW_O,
                       pk.buf_row(0) + (parts - 1) * pk.BUF_ROWS + pk.BUF_O)
    prev_row = torch.where(parts == 0, pk.ROW_PREV, base + pk.BUF_PREV)
    o = [pool[base + k, cols] for k in range(3)]
    d = [pool[base + 3 + k, cols] for k in range(3)]
    return o, d, pool[prev_row, cols]


def item_tiles(ks, pool, cols, parts):
    """[L, C] bool: the tiles each item's bounce tests (per-lane cull)."""
    o, d, prev = _item_rays(pool, cols, parts)
    out = []
    for lo in range(0, cols.shape[0], BATCH):
        sl = slice(lo, lo + BATCH)
        tiles: list = []
        isect_full_plain(ks, [x[sl] for x in o], [x[sl] for x in d], prev[sl],
                         torch.ones_like(prev[sl], dtype=torch.bool),
                         tiles_out=tiles)
        out.append(torch.stack(tiles, dim=1) if tiles else
                   torch.zeros((o[0][sl].shape[0], 0), dtype=torch.bool,
                               device=pool.device))
    return torch.cat(out)


def line_tiles(ks, pool, cols, parts):
    """[L, C] bool: the tiles each item's line enters (the slab test
    without the distance cull, every tile; the key holds the first 31)."""
    o, d, _ = _item_rays(pool, cols, parts)
    inv = _inv_dir(d)
    out = [_tile_slab(ks.tiles[c], o, inv)[1] for c in range(ks.tiles.shape[0])]
    return (torch.stack(out, dim=1) if out else
            torch.zeros((cols.shape[0], 0), dtype=torch.bool, device=pool.device))


def union_tiles(chunk, tiles, r):
    """The mean number of tiles in the union of ``tiles`` [L, C] over each
    group of ``r`` consecutive items of a chunk (``chunk`` [L], items in
    trace order, each chunk's items together)."""
    if not chunk.numel():
        return 0.0
    per_chunk = torch.bincount(chunk)
    start = torch.cumsum(per_chunk, 0) - per_chunk
    rank = torch.arange(chunk.shape[0], device=chunk.device) - start[chunk]
    n_groups = -(-per_chunk // r)
    group = (torch.cumsum(n_groups, 0) - n_groups)[chunk] + rank // r
    union = torch.zeros((int(n_groups.sum()), tiles.shape[1]),
                        dtype=torch.int32, device=tiles.device)
    union.index_add_(0, group, tiles.to(torch.int32))
    return float((union > 0).sum()) / union.shape[0]


def group_union(ks, pool, cols, part, tiles, keys, *,
                window: int = GROUP_WINDOW, rs=GROUP_RS) -> dict:
    """The group-split model (see the module doc, 4.)."""
    chunk = cols // window
    order = torch.argsort(chunk * (1 << 33) + keys, stable=True)
    enters = line_tiles(ks, pool, cols, part).any(dim=1)
    tq = order[enters[order]]  # empty keys first, in column order
    L = max(cols.shape[0], 1)
    return {
        "window": window,
        "tile_query_share": float(enters.sum()) / L,
        "empty_key_tile_query_share": float((enters & (keys == 0)).sum()) / L,
        "all": {r: union_tiles(chunk[order], tiles[order], r) for r in rs},
        "tile_queries": {r: union_tiles(chunk[tq], tiles[tq], r) for r in rs},
    }


def _executed_rows(group, tiles, base_rows):
    """Σ over groups (warps) of 32 × (base rows + 64 × tiles of the union)."""
    n_groups = int(group.max()) + 1 if group.numel() else 0
    union = torch.zeros((n_groups, tiles.shape[1]), dtype=torch.int32,
                        device=tiles.device)
    union.index_add_(0, group, tiles.to(torch.int32))
    used = torch.unique(group).numel()
    return WARP * (used * base_rows + TRI_TILE * int((union > 0).sum())), used


def coherence(ks, pool, *, parts: int = PARK_K + 1, park_k: int = PARK_K,
              windows=(256, 512, 1024)) -> dict:
    """The model's shares for K3's input ``pool`` (see the module doc)."""
    n = pool.shape[1]
    cols, part = pk.live_items(pool, parts=parts, park_k=park_k)
    L = cols.shape[0]
    tiles = item_tiles(ks, pool, cols, part)
    base_rows = ks.tile_base if ks.tiles.shape[0] else ks.tri.shape[0]
    needed = L * base_rows + TRI_TILE * int(tiles.sum())
    live = torch.bincount(part, minlength=parts).tolist()
    out = {
        "columns": n, "items": L,
        "live_share_per_part": [c / n for c in live],
        "tiles_needed_per_item": float(tiles.sum()) / max(L, 1),
        "n_tiles": int(ks.tiles.shape[0]), "base_rows": int(base_rows),
    }
    # one thread per column, the parts in turn
    rows, warps = _executed_rows((cols // WARP) * parts + part, tiles, base_rows)
    out["column_schedule"] = {"lane_slot_share": L / (WARP * warps),
                              "useful_row_share": needed / rows}
    o, d, _ = _item_rays(pool, cols, part)
    keys = tile_entry_keys(ks, o, d)
    out["key_tiles_per_item"] = float(sum(
        ((keys >> c) & 1).sum() for c in range(min(ks.tiles.shape[0], KEY_TILES)))) / max(L, 1)
    out["line_tiles_per_item"] = float(
        line_tiles(ks, pool, cols, part).sum()) / max(L, 1)
    for window in windows:
        chunk = cols // window
        for sort in (False, True):
            order = (torch.argsort(chunk * (1 << 33) + keys, stable=True)
                     if sort else torch.arange(L, device=pool.device))
            c_sorted = chunk[order]
            per_chunk = torch.bincount(c_sorted)
            start = torch.cumsum(per_chunk, 0) - per_chunk
            rank = torch.arange(L, device=pool.device) - start[c_sorted]
            warp_base = torch.cumsum(-(-per_chunk // WARP), 0) - (-(-per_chunk // WARP))
            group = warp_base[c_sorted] + rank // WARP
            rows, warps = _executed_rows(group, tiles[order], base_rows)
            out[f"window_{window}{'_sorted' if sort else ''}"] = {
                "items_per_chunk": L / max(int((per_chunk > 0).sum()), 1),
                "lane_slot_share": L / (WARP * warps),
                "useful_row_share": needed / rows,
            }
    out["group_union"] = group_union(ks, pool, cols, part, tiles, keys)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="128x96", help="WIDTHxHEIGHT")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--windows", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument("--scene", default="mesh",
                    help="mesh, or a benchmark configuration (mesh13k)")
    args = ap.parse_args()
    from path_tracer_tpu_torch.utils.config import Resolution

    w, h = (int(x) for x in args.res.split("x"))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("k3_coherence: no CUDA device", file=sys.stderr)
        return 1
    scene = load_named_scene(args.scene)
    ks, pool = k3_input_pool(scene, Resolution(h, w), dev)
    res = coherence(ks, pool, windows=args.windows)
    res["scene"] = args.scene
    res["res"] = args.res
    res["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
