"""K4's redesign: what it rests on, on the CPU.

The kernel (csrc/trace_regen_prim.cu) runs only on a card;
tests/test_torch_cuda.py holds it to its plain version there. Here:

1. The kernel's schedule in plain torch (scripts/k4_coherence.py
   ``scheduled``: owner threads in blocks that take items from a counter,
   each step's queries split into a warp's and a lane's) equals the plain
   loop bit for bit, both uniform sources, with and without the refill.
2. scripts/k4_coherence.py's model runs the plain loop (the same outputs,
   bit for bit), counts every segment once, and gives shares in [0, 1],
   the sorted chunks' useful rows no fewer than one thread a pixel's.
3. The two-mesh scene (two copies of mesh's MeshFile) takes the `prim`
   route in the port, as the JAX package's ``prepare_scene_and_mode``
   sends it to ``pallasr:``.
4. The size rule (K4_SHARED_BUDGET), against the source's layout.
5. The group level: ``KernelScene.tile_groups`` on synthetic tables of 0
   to 40 tiles, the run size against the source's, and the wrapper's
   three counters.
6. The rows a warp query reads on the read-only path:
   ``KernelScene.hit_tiles`` entry [c, f, j] is field f of full-table row
   ``tile_base + c*64 + j``, the row the kernel reports, past a base set
   and over several runs of 32 tiles.
"""

from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.render import pipeline as j_pipeline
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
from path_tracer_tpu_torch.render.pipeline import (
    morton_pixel_order, prepare_render,
)
from path_tracer_tpu_torch.utils.config import Resolution

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "k4_coherence", os.path.join(ROOT, "scripts", "k4_coherence.py"))
COHERENCE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(COHERENCE)

RES = Resolution(12, 16)


def two_mesh_scene(pkg, root=ROOT):
    """scripts/k4_coherence.py's two-mesh scene, built with ``pkg``."""
    return COHERENCE.two_mesh_scene(pkg, root)


def _case(sid, monkeypatch, res=RES):
    monkeypatch.setenv("PT_TPU_NO_PORTAL", "1")  # mesh too: the prim route
    scene = two_mesh_scene(tpt) if sid == "two-mesh" else COHERENCE.load(sid)
    prep = prepare_render(scene, res, "cpu")
    pix = torch.from_numpy(morton_pixel_order(res.width, res.height)[0])
    return prep.kscene, prep.cam, pix


@pytest.mark.parametrize("sid,source,blocks", [
    ("mesh", "counter", 2), ("mesh", "table", 2), ("two-mesh", "counter", 2),
    ("mesh", "counter", None)])
def test_k4_schedule_equals_the_plain_loop(monkeypatch, sid, source, blocks):
    """Owners of 64-thread blocks (2 blocks: 128 owners for 192 items, so
    owners take items from the counter; None: a block per 64 items) trace
    each step's queries in key order: every item's radiance, segments and
    samples equal the plain loop's bit for bit."""
    ks, cam, pix = _case(sid, monkeypatch)
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(3).random(
            (6, pix.shape[0]), dtype=np.float32))
    kw = dict(seed=7, sample_base=4, quota=3, uniforms=uni)
    plain = tk.trace_regen_prim_plain(ks, cam, pix, **kw)
    got, num = COHERENCE.scheduled(ks, cam, pix, threads=64, blocks=blocks,
                                   **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert 0.0 < num["useful_row_share"] <= 1.0
    assert 0.0 < num["step_balance"] <= 1.0
    # with the refill, 128 owners need more steps than the longest item
    assert num["steps"] >= int(plain[1].max())


def test_k4_schedule_at_quota_zero(monkeypatch):
    ks, cam, pix = _case("mesh", monkeypatch)
    got, num = COHERENCE.scheduled(ks, cam, pix, quota=0, threads=64)
    plain = tk.trace_regen_prim_plain(ks, cam, pix, seed=7, sample_base=4,
                                      quota=0)
    assert num["steps"] == 0
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sid", ["mesh", "two-mesh"])
def test_k4_coherence_model_counts(monkeypatch, sid):
    """The model's plain loop is the plain version; it counts each segment
    once; its shares are in [0, 1], and sorting a chunk's queries by key
    runs no more rows than one thread a pixel."""
    ks, cam, pix = _case(sid, monkeypatch)
    out, plain = COHERENCE.model(ks, cam, pix, quota=2)
    want = tk.trace_regen_prim_plain(ks, cam, pix, seed=COHERENCE.SEED,
                                     sample_base=COHERENCE.SAMPLE_BASE,
                                     quota=2)
    for a, b in zip(plain, want):
        assert torch.equal(a, b)
    assert out["segments"] == int(want[1].sum())
    assert out["n_tiles"] == (13 if sid == "mesh" else 26)
    shares = [out["thread_per_pixel"]["useful_row_share"]] + [
        out[f"chunks_of_{w}_{k}"]["useful_row_share"]
        for w in COHERENCE.WINDOWS for k in ("packed", "sorted")]
    assert all(0.0 < s <= 1.0 for s in shares)
    assert 0.0 <= out["quota_tail_share"] < 1.0
    for w in COHERENCE.WINDOWS:
        assert (out[f"chunks_of_{w}_sorted"]["useful_row_share"]
                >= out["thread_per_pixel"]["useful_row_share"])


def test_two_mesh_scene_takes_the_prim_route(monkeypatch):
    """One heavy mesh beside more than 128 other primitives: the portal
    declines it in both packages, and the default router sends it to the
    regenerative full-scene kernel (the port's `prim`, JAX's `pallasr:`);
    mesh itself takes the portal."""
    monkeypatch.delenv("PT_TPU_NO_PORTAL", raising=False)
    res = Resolution(12, 16)
    ts, js = two_mesh_scene(tpt), two_mesh_scene(jpt)
    assert tpt.pack_scene(ts).num_triangles == 1634
    assert jpt.pack_scene(js).num_triangles == 1634
    assert prepare_render(ts, res, "cpu").route == "prim"
    _, mode = j_pipeline.prepare_scene_and_mode(js, "pallas", res)
    assert mode.startswith("pallasr:")
    assert prepare_render(COHERENCE.load("mesh"), res, "cpu").route == "portal"


def _source_constant(name: str) -> int:
    with open(tk.CSRC_REGEN_PRIM) as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             fh.read()).group(1))


def test_k4_size_rule(monkeypatch):
    """mesh's and two-mesh's tables go to shared memory, mesh's tiles four
    times over (3,336 rows) read the read-only path; the budget, the
    queries of a block (K4_THREADS x 34 bytes) and its static shared memory
    fit the 232,448 bytes an H100 block may opt in to."""
    ks, cam, pix = _case("mesh", monkeypatch)
    two, _, _ = _case("two-mesh", monkeypatch)
    assert tk.k4_shared_table(ks) and tk.k4_shared_table(two)
    tiles = ks.tri[ks.tile_base:]
    big = tk.KernelScene(ks.sph, ks.bnd,
                         torch.cat([ks.tri[:ks.tile_base]] + [tiles] * 4),
                         torch.cat([ks.tiles] * 4), ks.tile_base)
    assert not tk.k4_shared_table(big)
    threads = _source_constant("K4_THREADS")
    assert tk.K4_SHARED_BUDGET + threads * (32 + 2) + 32 <= 232_448


def test_k4_wrapper_on_cpu_launches_nothing(monkeypatch):
    ks, cam, pix = _case("two-mesh", monkeypatch)
    before = tk.trace_regen_prim.launches
    kw = dict(seed=1, sample_base=0, quota=2)
    a = tk.trace_regen_prim(ks, cam, pix, **kw)
    b = tk.trace_regen_prim_plain(ks, cam, pix, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tk.trace_regen_prim.launches == before


def _tiles_scene(n_tiles: int):
    """A KernelScene of ``n_tiles`` random tile boxes (one base row)."""
    rng = np.random.default_rng(n_tiles)
    lo = rng.normal(size=(n_tiles, 3)).astype(np.float32)
    hi = lo + rng.random((n_tiles, 3), dtype=np.float32)
    return tk.KernelScene(torch.zeros((1, tk.SPH_F)), torch.zeros((0, 4)),
                          torch.zeros((1 + n_tiles * tk.TRI_TILE, tk.TRI_F)),
                          torch.from_numpy(np.concatenate([lo, hi], axis=1)), 1)


@pytest.mark.parametrize("n_tiles", [0, 1, 32, 33, 37, 40])
def test_tile_groups_are_the_unions_of_runs_of_32_tiles(n_tiles):
    """One box a run of TILE_GROUP tiles, the last run holding the rest:
    the elementwise min of the run's lo corners and max of its hi corners,
    exactly; ``to`` carries them."""
    ks = _tiles_scene(n_tiles)
    tiles, groups = ks.tiles.numpy(), ks.tile_groups.numpy()
    assert groups.shape == (-(-n_tiles // 32), 6)
    for g in range(groups.shape[0]):
        run = tiles[32 * g:32 * g + 32]
        assert (groups[g] == np.concatenate([run[:, :3].min(axis=0),
                                             run[:, 3:].max(axis=0)])).all()
    assert torch.equal(ks.to("cpu").tile_groups, ks.tile_groups)


def test_hit_tiles_hold_full_table_rows_past_a_base_set():
    """On a scene of 8 base rows and 70 tiles (runs of 32, 32 and 6), as
    panda_arm has 8 base rows and 66 runs: ``hit_tiles[c, f, j]`` is
    ``hit[tile_base + c*64 + j, f]`` for every c, f and j, which is
    ``tri``'s HIT_COLS[f] column of that row, and the pad is zero."""
    rng = np.random.default_rng(23)
    base, n_tiles = 8, 70
    tri = torch.from_numpy(
        rng.random((base + n_tiles * tk.TRI_TILE, tk.TRI_F), dtype=np.float32))
    ks = tk.KernelScene(torch.zeros((1, tk.SPH_F)), torch.zeros((0, 4)), tri,
                        _tiles_scene(n_tiles).tiles, base)
    ht = ks.hit_tiles
    assert ht.shape == (n_tiles, tk.HIT_F, tk.TRI_TILE) and ht.is_contiguous()
    c, f, j = np.meshgrid(np.arange(n_tiles), np.arange(tk.HIT_F),
                          np.arange(tk.TRI_TILE), indexing="ij")
    row = torch.from_numpy(base + c * tk.TRI_TILE + j)
    assert torch.equal(ht, ks.hit[row, torch.from_numpy(f)])
    cols = len(tk.HIT_COLS)
    assert torch.equal(ht[:, :cols], tri[row[:, :cols], torch.tensor(
        tk.HIT_COLS)[:, None].expand(cols, tk.TRI_TILE)])
    assert not ht[:, cols:].any()


def test_tile_group_matches_the_source():
    """The run size of KernelScene.tile_groups is csrc/isect_full.cuh's."""
    with open(os.path.join(os.path.dirname(tk.CSRC_REGEN_PRIM),
                           "isect_full.cuh")) as fh:
        src = int(re.search(r"constexpr int TILE_GROUP = (\d+);",
                            fh.read()).group(1))
    assert src == tk.TILE_GROUP == 32


def test_k4_wrapper_takes_three_counters(monkeypatch):
    """On the CPU the wrapper adds the plain version's counts (queries,
    tiles, opened runs: at most one a query on the two-mesh scene's 26
    tiles, a single run; and the sphere rows, every one of the 8 padding
    rows a segment) to an int64 [4] tensor, over calls, and refuses any
    other."""
    ks, cam, pix = _case("two-mesh", monkeypatch)
    kw = dict(seed=1, sample_base=0, quota=2)
    plain = {}
    _, segs, _ = tk.trace_regen_prim_plain(ks, cam, pix, work=plain, **kw)
    assert ks.tiles.shape[0] == 26 and 0 < plain["groups"] <= plain["query"]
    assert plain["sph"] == int(segs.sum()) * ks.sph.shape[0] == int(segs.sum()) * 8
    assert tk.WORK_KEYS == ("query", "tiles", "groups", "sph")
    work = torch.zeros(4, dtype=torch.int64)
    for calls in (1, 2):
        tk.trace_regen_prim(ks, cam, pix, work=work, **kw)
        assert work.tolist() == [calls * plain[k] for k in tk.WORK_KEYS]
    for bad in (torch.zeros(3, dtype=torch.int64), torch.zeros(5, dtype=torch.int64),
                torch.zeros(4, dtype=torch.int32)):
        with pytest.raises(ValueError):
            tk.trace_regen_prim(ks, cam, pix, work=bad, **kw)
