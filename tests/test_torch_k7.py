"""K7's and K8's redesigns and the sort pad's repair: what they rest on, on
the CPU.

The kernels (csrc/trace_stepped.cu pt_trace_resolve, csrc/
portal_cheap_blocked.cu) run only on a card; tests/test_torch_cuda.py holds
them to their plain versions there. Here:

1. K7's plain version on permuted lanes gives the permuted result, at small
   analogues of both of its shapes (scripts/ablate_k7.py k7_shapes: the v1
   front, the glue lanes) and with both uniform sources: a lane's result
   does not depend on where it sits, which the kernel's reordering of its
   rays rests on.
2. The size rule (K7_SHARED_BUDGET) picks the shared table or the read-only
   path by bytes, and the launch arguments follow it; the scans stop at
   ``KernelScene.sph_rows``, which finds what a scan of every sphere row
   finds.
3. scripts/k4_coherence.py resolve_model traces each live lane once, and
   its shares lie in [0, 1].
4. The tile-entry key of a ray whose line enters 35 tiles in a row
   (scripts/portal_fuzz_scenes.py strip_scene) never equals the pad key
   SORT_PAD of the chunk sorts (K3, K6, K7).
5. K8's plain version at the port's group (BLOCKED_GROUP, 32) drains a mesh
   v1 pool with K7 to the same radiance and segments as at 256 and 2048.
6. The wrappers on CPU tensors run the plain versions and launch nothing.
"""

from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

import dataclasses
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch.ops.kernels import portal as pk
from path_tracer_tpu_torch.ops.kernels import trace_kernel as tk
from path_tracer_tpu_torch.utils.config import Resolution

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ABLATE = _script("ablate_k7")
COHERENCE = _script("k4_coherence")
SCENES = _script("portal_fuzz_scenes")


def _scene(sid):
    return tpt.load_scene(sid, os.path.join(ROOT, "scenes"),
                          os.path.join(ROOT, "meshes"))


@pytest.fixture(scope="module")
def shapes():
    """(prep, the fresh v1 pool, {shape: (state, pixel_idx, sample_idx)})
    of mesh at 32x24: 2,048 lanes of a v1 front, 8,192 glue lanes."""
    prep, pool, lanes, _ = ABLATE.k7_shapes(_scene("mesh"), Resolution(24, 32),
                                            torch.device("cpu"))
    return prep, pool, lanes


def _resolve(ks, state, pix, smp, uni):
    return tk.trace_resolve_plain(ks, *state, pixel_idx=pix, sample_idx=smp,
                                  seed=7, uniforms=uni)


@pytest.mark.parametrize("shape", ["v1 front", "glue"])
@pytest.mark.parametrize("source", ["counter", "table"])
def test_resolve_plain_on_permuted_lanes(shapes, shape, source):
    prep, _, lanes = shapes
    state, pix, smp = lanes[shape]
    n = pix.shape[0]
    alive = int((state[4] > 0).sum())
    assert 0 < alive < n
    g = np.random.default_rng(4)
    uni = None if source == "counter" else torch.from_numpy(
        g.random((4, n), dtype=np.float32))
    perm = torch.from_numpy(g.permutation(n))
    want = _resolve(prep.kscene, state, pix, smp, uni)
    got = _resolve(prep.kscene, tuple(s[:, perm] for s in state), pix[perm],
                   smp[perm], None if uni is None else uni[:, perm])
    for w, x in zip(want, got):
        assert torch.equal(w[:, perm], x)
    assert int(want[7].sum()) == alive


def _source_constant(name):
    with open(os.path.join(ROOT, "path_tracer_tpu_torch", "csrc",
                           "trace_stepped.cu")) as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);", fh.read())[1])


def test_k7_size_rule(shapes):
    """mesh's tables go to shared memory; its tiles three times over (2,504
    rows, 200 KB of compact rows) read the read-only path, and the launch
    arguments pass no compact table then; the budget, a block's queries
    (K7_THREADS x 40 bytes) and its static shared memory fit the 232,448
    bytes an H100 block may opt in to."""
    ks = shapes[0].kscene
    assert tk.k7_shared_table(ks)
    assert tk.k7_scene_args(ks)[6] == ks.hit.data_ptr()
    tiles = ks.tri[ks.tile_base:]
    big = tk.KernelScene(ks.sph, ks.bnd,
                         torch.cat([ks.tri[:ks.tile_base]] + [tiles] * 3),
                         torch.cat([ks.tiles] * 3), ks.tile_base)
    assert tk.k6_table_bytes(big) > tk.K7_SHARED_BUDGET >= tk.k6_table_bytes(ks)
    assert not tk.k7_shared_table(big)
    assert tk.k7_scene_args(big)[6] is None
    threads = _source_constant("K7_THREADS")
    assert tk.K7_SHARED_BUDGET + threads * (32 + 2 + 2 + 4) + 64 <= 232_448


@pytest.mark.parametrize("sid", ["mesh", "cornell", "strip"])
def test_sphere_rows_scan_finds_what_every_row_finds(sid):
    """K7's scans stop at ``sph_rows``: the rows after it are padding (r² 0)
    and miss every ray, so the scene cut there intersects every ray as the
    whole scene does, bit for bit."""
    scene = SCENES.strip_scene() if sid == "strip" else _scene(sid)
    ks = tk.build_kernel_scene(tpt.pack_scene(scene))
    rows = ks.sph_rows
    assert 1 <= rows <= ks.sph.shape[0]
    assert not (ks.sph[rows:, tk.S_RAD2] > 0).any()
    assert tk.k7_scene_args(ks)[1] == rows
    cut = dataclasses.replace(ks, sph=ks.sph[:rows].clone())
    g = np.random.default_rng(3)
    o = torch.from_numpy(g.uniform([-3, -3, -6], [3, 3, 0], (4096, 3))
                         .astype(np.float32)).T
    d = torch.from_numpy(g.normal(size=(3, 4096)).astype(np.float32))
    d = d / d.norm(dim=0)
    prev = torch.full((4096,), -1.0)
    alive = torch.ones(4096, dtype=torch.bool)
    want = tk.isect_full_plain(ks, list(o), list(d), prev, alive)
    got = tk.isect_full_plain(cut, list(o), list(d), prev, alive)
    assert bool(want[0].any())
    flat = [(a, b) for w, x in zip(want, got)
            for a, b in (zip(w, x) if isinstance(w, list) else [(w, x)])]
    assert all(torch.equal(a, b) for a, b in flat)


@pytest.mark.parametrize("shape", ["v1 front", "glue"])
def test_resolve_model_traces_each_live_lane_once(shapes, shape):
    prep, _, lanes = shapes
    state, _, _ = lanes[shape]
    alive = state[4][0] > 0
    m = COHERENCE.resolve_model(prep.kscene, list(state[0]), list(state[1]),
                                state[5][0], alive, threads=256)
    assert torch.equal(m.pop("visits"), alive.to(torch.int64))
    assert m["live"] == int(alive.sum()) == m["warp_queries"] + m["lane_queries"]
    for key in ("thread_per_lane", "split", "sorted"):
        assert 0.0 < m[key]["useful_row_share"] <= 1.0
    assert 0.0 < m["thread_per_lane"]["lane_slot_share"] < 1.0
    for key in ("split", "sorted"):
        assert 0.0 < m[key]["chunk_balance"] <= 1.0
    assert m["split"]["useful_row_share"] >= m["thread_per_lane"]["useful_row_share"]


def test_strip_keys_never_equal_the_pad():
    """The strip's 2,240 triangles make 35 tiles in a row, and a ray along
    it enters every one: its key holds all KEY_TILES (31) tiles, one bit
    below the pad key, which sorts after every live key."""
    ks = tk.build_kernel_scene(tpt.pack_scene(SCENES.strip_scene()))
    assert ks.tiles.shape[0] >= 33
    o, d = SCENES.strip_rays(512, np.random.default_rng(8))
    keys = tk.tile_entry_keys(ks, [torch.from_numpy(o[:, k].copy()) for k in range(3)],
                              [torch.from_numpy(d[:, k].copy()) for k in range(3)])
    assert tk.KEY_TILES == 31
    assert bool((keys == (1 << tk.KEY_TILES) - 1).all())
    assert bool((keys < tk.SORT_PAD).all())


def test_k8_plain_at_the_port_group_drains_to_the_same_image():
    """A fresh mesh v1 pool, K8's plain version then K7's on every lane
    until no path lives, at the port's group (32) and at 256 and 2048: the
    same radiance per lane and the same segments."""
    assert pk.BLOCKED_GROUP == 32
    res = Resolution(12, 16)
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    prep = prepare_render(_scene("mesh"), res, "cpu")
    pool0 = _script("ablate_k8").v1_pool(prep, res)
    results = {}
    for group in (pk.BLOCKED_GROUP, 256, 2048):
        pool, segs = pool0.clone(), 0
        for _ in range(13):
            if not bool((pool[pk.ROW_ALIVE] > 0).any()):
                break
            pool, c1 = pk.trace_cheap_blocked_plain(prep.portal, pool, seed=2,
                                                    group=group)
            *state, c2 = tk.trace_resolve_plain(
                prep.kscene, pool[0:3], pool[3:6], pool[6:9], pool[9:12],
                pool[12:13], pool[13:14], pool[14:15],
                pixel_idx=pool[pk.ROW_PIX].to(torch.int32),
                sample_idx=pool[pk.V1_ROW_SAMPLE].to(torch.int32), seed=2)
            pool[:pk.ROW_PIX] = torch.cat(state)
            segs += int(c1.sum()) + int(c2.sum())
        assert not bool((pool[pk.ROW_ALIVE] > 0).any())
        results[group] = (pool[pk.ROW_ACC:pk.ROW_ACC + 3].clone(), segs)
    rad, segs = results[2048]
    assert float(rad.sum()) > 0
    for group in (pk.BLOCKED_GROUP, 256):
        assert torch.equal(results[group][0], rad)
        assert results[group][1] == segs


def test_wrappers_on_cpu_launch_nothing(shapes):
    prep, pool, lanes = shapes
    counters = (pk.trace_cheap_blocked, tk.trace_resolve)
    before = [c.launches for c in counters]
    a = pk.trace_cheap_blocked(prep.portal, pool, seed=3)
    b = pk.trace_cheap_blocked_plain(prep.portal, pool, seed=3, group=32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    state, pix, smp = lanes["glue"]
    kw = dict(pixel_idx=pix, sample_idx=smp, seed=3)
    a = tk.trace_resolve(prep.kscene, *state, **kw)
    b = tk.trace_resolve_plain(prep.kscene, *state, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [c.launches for c in counters] == before
