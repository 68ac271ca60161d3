"""K3's redesign for the card: what its host side and its schedule rest on.

The packed, sorted kernel (csrc/portal_resolve.cu) runs only on a card;
tests/test_torch_cuda.py holds it to its plain version there. Here, on the
CPU:

1. ``KernelScene.hit``, the compact hit-test table the kernel stages into
   shared memory, is a byte-equal column subset of ``KernelScene.tri``
   (the 19 columns the distance test reads, then a zero pad).
2. ``tile_entry_keys``, the kernel's sort key, is the slab test of
   ``isect_full_plain`` on each tile without the distance cull: its bits
   equal a numpy float32 slab test, and every tile a lane tests (the cull)
   and every tile a lane hits in is among them.
3. ``live_items`` enumerates exactly the live (column, part) items, each
   once, in the kernel's packing order.
4. The coherence model (scripts/k3_coherence.py) counts consistently,
   its group-split model too.
5. ``group_items_plain``, the count of items the kernel traces with a
   group of lanes, is the numpy slab test's past the key's tiles, and 0
   where the key holds every tile.
6. ``KernelScene.hit_tiles``, the rows the group split reads, is ``hit``'s
   tiled rows field by field.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch.ops.kernels import portal as pk
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
from path_tracer_tpu_torch.render import portal as rp
from path_tracer_tpu_torch.render.pipeline import prepare_render
from path_tracer_tpu_torch.utils.config import Resolution
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "k3_coherence", os.path.join(ROOT, "scripts", "k3_coherence.py"))
COHERENCE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(COHERENCE)


def _scene(sid):
    return tpt.load_scene(sid, os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))


def _kscene(sid):
    return tk.build_kernel_scene(tpt.pack_scene(_scene(sid)))


@pytest.mark.parametrize("sid", ["mesh", "cornell"])
def test_hit_table_is_a_column_subset_of_tri(sid):
    ks = _kscene(sid)
    assert ks.hit.shape == (ks.tri.shape[0], tk.HIT_F)
    assert ks.hit.dtype == torch.float32 and ks.hit.is_contiguous()
    cols = list(tk.HIT_COLS)
    assert cols == list(range(16)) + [tk.T_QUAD, tk.T_PID, tk.T_GATE]
    hit = ks.hit.numpy().view(np.int32)
    tri = ks.tri.numpy().view(np.int32)
    np.testing.assert_array_equal(hit[:, :len(cols)], tri[:, cols])
    np.testing.assert_array_equal(hit[:, len(cols):], 0)
    moved = ks.to("cpu")
    assert torch.equal(moved.hit, ks.hit)


def test_hit_tiles_are_the_tiles_rows_field_by_field():
    """``KernelScene.hit_tiles`` holds each tile's compact rows field by
    field: [c, f, j] is ``hit``'s field f of row tile_base + c*64 + j."""
    ks = _kscene("mesh")
    c = ks.tiles.shape[0]
    ht = ks.hit_tiles
    assert ht.shape == (c, tk.HIT_F, tk.TRI_TILE) and ht.is_contiguous()
    rows = ks.hit[ks.tile_base:ks.tile_base + c * tk.TRI_TILE]
    for tile, f, j in ((0, 0, 0), (c - 1, tk.HIT_F - 2, 63), (c // 2, 5, 17)):
        assert ht[tile, f, j] == rows[tile * tk.TRI_TILE + j, f]
    assert torch.equal(ht.transpose(1, 2).reshape(-1, tk.HIT_F), rows)


def _random_rays(g, n, ks):
    """Rays from points in the scene box toward random directions, a share
    of them with one direction component exactly zero."""
    lo = np.asarray(ks.aabb_lo, np.float32)
    span = 1.0 / np.asarray(ks.aabb_inv_span, np.float32)
    o = (lo + span * g.random((n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d[: n // 8, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32)


def _slab_np(tiles, o, d):
    """[N, C] bool: the ray's line enters tile c ahead of its origin."""
    inv = (np.float32(1.0) / np.where(np.abs(d) < np.float32(1e-30),
                                      np.float32(1e-30), d)).astype(np.float32)
    out = np.zeros((o.shape[0], tiles.shape[0]), bool)
    for c, box in enumerate(tiles):
        t_en = np.zeros(o.shape[0], np.float32)
        t_ex = np.full(o.shape[0], np.float32(tk.BIG), np.float32)
        for k in range(3):
            ta = (box[k] - o[:, k]) * inv[:, k]
            tb = (box[3 + k] - o[:, k]) * inv[:, k]
            t_en = np.maximum(t_en, np.minimum(ta, tb))
            t_ex = np.minimum(t_ex, np.maximum(ta, tb))
        out[:, c] = (t_ex >= t_en) & (t_ex >= 0.0)
    return out


def test_tile_entry_keys_are_the_slab_test():
    ks = _kscene("mesh")
    n_tiles = ks.tiles.shape[0]
    assert 0 < n_tiles <= tk.KEY_TILES
    o, d = _random_rays(np.random.default_rng(11), 4096, ks)
    ot = [torch.from_numpy(o[:, k].copy()) for k in range(3)]
    dt = [torch.from_numpy(d[:, k].copy()) for k in range(3)]
    keys = tk.tile_entry_keys(ks, ot, dt)
    bits = ((keys[:, None] >> torch.arange(n_tiles)) & 1).bool().numpy()
    np.testing.assert_array_equal(bits, _slab_np(ks.tiles.numpy(), o, d))
    assert 0.0 < bits.mean() < 1.0

    tested: list = []
    tk.isect_full_plain(ks, ot, dt, torch.full((o.shape[0],), -1.0),
                        torch.ones(o.shape[0], dtype=torch.bool),
                        tiles_out=tested)
    tested = torch.stack(tested, dim=1).numpy()
    assert tested.any() and not (tested & ~bits).any()
    assert tested.sum() < bits.sum()  # the distance cull drops some


def test_key_of_a_ray_holds_the_tile_it_hits():
    """A lane whose closest hit is a tiled triangle row has that tile's bit
    in its key: the hit lies inside the tile's AABB, ahead of the ray."""
    ks = _kscene("mesh")
    o, d = _random_rays(np.random.default_rng(5), 8192, ks)
    ot = [torch.from_numpy(o[:, k].copy()) for k in range(3)]
    dt = [torch.from_numpy(d[:, k].copy()) for k in range(3)]
    keys = tk.tile_entry_keys(ks, ot, dt)
    found, *_, new_prev = tk.isect_full_plain(
        ks, ot, dt, torch.full((o.shape[0],), -1.0),
        torch.ones(o.shape[0], dtype=torch.bool))
    pid = ks.tri[:, tk.T_PID]
    hits = 0
    for lane in torch.nonzero(found & (new_prev >= 0)).flatten().tolist():
        row = int(torch.nonzero(pid == new_prev[lane])[0])
        if row < ks.tile_base:
            continue
        c = (row - ks.tile_base) // tk.TRI_TILE
        assert (int(keys[lane]) >> c) & 1, (lane, row, c)
        hits += 1
    assert hits > 50


@pytest.fixture(scope="module")
def k3_pool():
    """(KernelScene, K3's input pool on cycle 2 of a 64x48 mesh drive)."""
    return COHERENCE.k3_input_pool(_scene("mesh"), Resolution(48, 64),
                                   torch.device("cpu"))


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_live_items_are_each_live_item_once(k3_pool, parts):
    _, pool = k3_pool
    cols, part = pk.live_items(pool, parts=parts, park_k=3)
    want = []
    alive = pool[pk.ROW_ALIVE].tolist()
    states = [pool[pk.buf_row(j, pk.BUF_STATE)].tolist() for j in range(3)]
    for i in range(pool.shape[1]):
        if alive[i] > 0.0:
            want.append((i, 0))
        for j in range(1, parts):
            if states[j - 1][i] == 1.0:
                want.append((i, j))
    assert list(zip(cols.tolist(), part.tolist())) == want
    assert len(want) > pool.shape[1] // 2
    counts = pk.trace_resolve_pool_plain(
        k3_pool[0], pool, seed=7, parts=parts, park_k=3)[1]
    assert int(counts.sum()) == len(want)


def test_live_items_of_a_retired_pool_is_empty():
    pool = rp.make_pool_v2(100, 2048, 4, park_k=3, device="cpu")
    pool[pk.ROW_ALIVE] = 0.0
    cols, part = pk.live_items(pool, parts=4, park_k=3)
    assert cols.numel() == 0 and part.numel() == 0


def test_coherence_model_counts(k3_pool):
    ks, pool = k3_pool
    res = COHERENCE.coherence(ks, pool, windows=(256,))
    n = pool.shape[1]
    assert res["items"] == round(sum(res["live_share_per_part"]) * n)
    assert 0 < res["tiles_needed_per_item"] <= res["key_tiles_per_item"]
    col = res["column_schedule"]
    packed, ordered = res["window_256"], res["window_256_sorted"]
    for r in (col, packed, ordered):
        assert 0.0 < r["useful_row_share"] <= 1.0
        assert 0.0 < r["lane_slot_share"] <= 1.0
    assert packed["lane_slot_share"] > col["lane_slot_share"]
    assert packed["lane_slot_share"] == ordered["lane_slot_share"]
    assert ordered["useful_row_share"] > packed["useful_row_share"]


def test_k3_input_pool_matches_a_drive_cycle():
    """The model's pool is K3's input: K2 of cycle 2 after two full
    cycles of the plain versions, as chip_smoke.py's phase 3 drives it."""
    res = Resolution(24, 32)
    scene = _scene("mesh")
    ks, pool = COHERENCE.k3_input_pool(scene, res, torch.device("cpu"), cycle=0)
    prep = prepare_render(scene, res, torch.device("cpu"))
    fresh = rp.make_pool_v2(res.num_pixels, rp._round_block(res.num_pixels),
                            256, park_k=3, device="cpu")
    want = pk.trace_cheap_regen_plain(
        prep.portal, prep.cam, fresh, seed=7, quota=256, sample_base=0,
        step_cap=64, park_k=3, max_depth=12)[0]
    assert torch.equal(pool, want)
    assert torch.equal(ks.hit, prep.kscene.hit)


def test_group_union_model_spans_item_and_warp(k3_pool):
    """The group-split model's union at R = 1 is the tiles an item tests,
    at R = 32 a sorted warp's union as the row model counts it, and it
    grows with R; the tile queries are the items whose line enters a
    tile."""
    ks, pool = k3_pool
    res = COHERENCE.coherence(ks, pool, windows=(1024,))
    g = res["group_union"]
    assert g["window"] == 1024
    assert g["all"][1] == pytest.approx(res["tiles_needed_per_item"])
    cols, part = pk.live_items(pool, parts=4, park_k=3)
    tiles = COHERENCE.item_tiles(ks, pool, cols, part)
    o, d, _ = COHERENCE._item_rays(pool, cols, part)
    keys = tk.tile_entry_keys(ks, o, d)
    chunk = cols // 1024
    order = torch.argsort(chunk * (1 << 33) + keys, stable=True)
    c_sorted = chunk[order]
    per_chunk = torch.bincount(c_sorted)
    start = torch.cumsum(per_chunk, 0) - per_chunk
    rank = torch.arange(cols.shape[0]) - start[c_sorted]
    warps = -(-per_chunk // 32)
    group = (torch.cumsum(warps, 0) - warps)[c_sorted] + rank // 32
    rows, used = COHERENCE._executed_rows(group, tiles[order], ks.tile_base)
    warp_union = (rows / 32 - used * ks.tile_base) / tk.TRI_TILE / used
    assert g["all"][32] == pytest.approx(warp_union)
    unions = [g["all"][r] for r in COHERENCE.GROUP_RS]
    assert unions == sorted(unions) and unions[0] < unions[-1]
    enters = COHERENCE.line_tiles(ks, pool, cols, part).any(dim=1)
    assert g["tile_query_share"] == pytest.approx(
        float(enters.float().mean()))
    assert 0.0 < g["tile_query_share"] < 1.0
    assert g["tile_queries"][1] >= g["all"][1]


def test_group_items_plain_is_the_slab_test_past_the_key(k3_pool):
    ks, pool = k3_pool
    assert int(pk.group_items_plain(ks, pool, parts=4, park_k=3)) == 0
    tiles = ks.tri[ks.tile_base:]
    big = tk.KernelScene(ks.sph, ks.bnd,
                         torch.cat([ks.tri[:ks.tile_base]] + [tiles] * 3),
                         torch.cat([ks.tiles] * 3), ks.tile_base)
    assert big.tiles.shape[0] > tk.KEY_TILES
    for parts in (1, 4):
        cols, part = pk.live_items(pool, parts=parts, park_k=3)
        o, d, _ = COHERENCE._item_rays(pool, cols, part)
        o = torch.stack(o, dim=1).numpy()
        d = torch.stack(d, dim=1).numpy()
        want = int(_slab_np(big.tiles.numpy(), o, d).any(axis=1).sum())
        got = pk.group_items_plain(big, pool, parts=parts, park_k=3)
        assert int(got) == want > 0
        assert want < cols.shape[0]
        counter = torch.zeros(1, dtype=torch.int32)
        pk.trace_resolve_pool(big, pool, seed=7, parts=parts, park_k=3,
                              group_items=counter)
        pk.trace_resolve_pool(big, pool, seed=7, parts=parts, park_k=3,
                              group_items=counter)
        assert int(counter) == 2 * want
    with pytest.raises(ValueError, match="group_items"):
        pk.trace_resolve_pool(big, pool, seed=7, parts=4, park_k=3,
                              group_items=torch.zeros(2, dtype=torch.int32))
