"""Portal host prep, K2 and K3: the port's plain versions against JAX.

1. Host: ``build_portal_consts`` equal to the JAX package's (the cheap
   scene's tables, the padded AABB bit for bit) for every built-in scene
   and the synthetic portal scene of tests/test_portal.py:529; it and
   ``detect_quad_pairs`` also on the host builders' scenes
   (``test_torch_host.PREP_SCENES``).
2. K2 ``trace_cheap_regen_plain`` against the JAX ``trace_cheap_regen`` in
   interpret mode (PRNG stub: zeros; the port given a table of zeros), park
   depths 1 and 3, step cap 4, two successive calls from a fresh pool; K3
   ``trace_resolve_pool_plain`` against ``trace_pallas_resolve_pool`` on the
   pool after those calls, all parts, under injected uniforms. The JAX
   outputs are committed under tests/golden/gpu/ by
   scripts/make_torch_portal_goldens.py (the interpreter takes minutes at
   park depth 3); a slow test regenerates them.
   Tolerance: every row of the JAX layout, per pool column, within 1e-4
   (relative and absolute) on all but MAX_BAD columns of the 864 real
   slots; the padding slots (born retired) must come out untouched. The
   limits are the measured disagreement plus one column: K2 disagrees on
   0 or 1 slot a call, K3 on 4 (park depth 1) and 5 (park depth 3).
   Reason: the interpreter runs under XLA, which contracts a*b+c into FMAs
   and rounds sqrt, rsqrt, sin and cos differently from torch; on the
   synthetic scene's 100-radius floor sphere the expanded sphere test
   cancels catastrophically, so such ulps flip a few hit decisions.
   The port's own sample rows are checked by invariants: every path in
   flight carries a distinct sample index below its slot's started count.
3. Per-slot independence, which makes one CUDA thread per slot faithful:
   K2 and K3 give a slot the same result in any pool of slots.
4. The benchmark's 12,716-triangle mesh (``bench_torch/configs/mesh13k``):
   the converter (scripts/stl_to_off.py) reproduces the committed OFF file
   from its public STL and keeps every triangle bit for bit; the port
   packs the scene to the portal route; the plain portal route renders
   it, with tiles far outnumbering the sort key's, as the benchmark's
   plain reference does and within Monte Carlo noise of the JAX package.
The CUDA kernels against these plain versions are in test_torch_cuda.py.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import path_tracer_tpu as jpt
import path_tracer_tpu_torch as tpt
from path_tracer_tpu.ops.pallas import portal as j_pm
from path_tracer_tpu.ops.pallas import trace_kernel as j_tk
from path_tracer_tpu_torch.ops.kernels import portal as t_pm
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from path_tracer_tpu_torch.render import portal as t_rp
from tests.test_torch_host import (
    PREP_SCENES, SCENE_IDS, both_scenes, load_both, packed_both,
)
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_portal_goldens",
    os.path.join(ROOT, "scripts", "make_torch_portal_goldens.py"))
GOLDENS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GOLDENS)
synthetic_portal = GOLDENS.synthetic_portal_scene

COL_TOL = 1e-4
MAX_BAD = {"k2": 2, "k3": 6}  # disagreeing real slots allowed (see above)


def _synth_port():
    """The synthetic scene in the port: (PortalConsts, camera, KernelScene,
    npix, pool width)."""
    scene = synthetic_portal(tpt)
    packed = tpt.pack_scene(scene)
    pc, _ = t_pm.build_portal_consts(packed)
    cam = t_tv2.build_camera_consts(scene.camera, GOLDENS.WIDTH, GOLDENS.HEIGHT)
    npix = GOLDENS.WIDTH * GOLDENS.HEIGHT
    return pc, cam, t_tk.build_kernel_scene(packed), npix, t_rp._round_block(npix)


@pytest.mark.parametrize("sid", SCENE_IDS + ["synth-portal"])
def test_portal_consts_equal(repo_root, sid):
    if sid == "synth-portal":
        js, ts = synthetic_portal(jpt), synthetic_portal(tpt)
    else:
        js, ts = load_both(sid, repo_root)
    j = j_pm.build_portal_consts(jpt.pack_scene(js))
    t = t_pm.build_portal_consts(tpt.pack_scene(ts))
    assert (j is None) == (t is None)
    assert (t is not None) == (sid in ("mesh", "synth-portal"))
    if t is not None:
        _assert_portal_equal(j, t)


@pytest.mark.parametrize("sid", list(PREP_SCENES))
def test_quad_pairs_and_portal_consts_equal(repo_root, sid):
    """detect_quad_pairs over the whole scene, and build_portal_consts,
    whose cheap scene runs it again, equal the JAX package's; each scene
    gets a heavy mesh where it has none, so that it takes the portal."""
    jp, tp = packed_both(sid, *both_scenes(sid, repo_root, heavy=True))
    jq, jc = j_tk.detect_quad_pairs(jp)
    tq, tc = t_tk.detect_quad_pairs(tp)
    assert jc == tc and list(jq) == list(tq)
    for k in jq:
        assert jq[k].dtype == tq[k].dtype and jq[k].tobytes() == tq[k].tobytes()
    j, t = j_pm.build_portal_consts(jp), t_pm.build_portal_consts(tp)
    assert j is not None and t is not None
    _assert_portal_equal(j, t)


def _assert_portal_equal(j, t):
    (jconsts, jheavy), (tconsts, theavy) = j, t
    assert jheavy == theavy
    want = t_pm.portal_consts_from_jax(jconsts)
    assert torch.equal(want.scene.prims, tconsts.scene.prims)
    assert torch.equal(want.scene.gates, tconsts.scene.gates)
    assert np.float32(want.lo).tobytes() == np.float32(tconsts.lo).tobytes()
    assert np.float32(want.hi).tobytes() == np.float32(tconsts.hi).tobytes()


def _check_columns(kernel, port, jax_rows, before, npix):
    """The real slots agree but for MAX_BAD[kernel] columns; the padding
    slots are left as they were, by both sides."""
    close = np.isclose(port[:, :npix], jax_rows[:, :npix], rtol=COL_TOL,
                       atol=COL_TOL).all(axis=0)
    assert (~close).sum() <= MAX_BAD[kernel], (kernel, int((~close).sum()))
    np.testing.assert_array_equal(port[:, npix:], before[:, npix:])
    np.testing.assert_array_equal(jax_rows[:, npix:], before[:, npix:])


def _check_sample_rows(pool, park_k, sample_base):
    """Every path in flight (the live active path, each non-empty buffer)
    carries a sample index in [sample_base, sample_base + started), the
    indices of one slot are distinct, and in-flight paths number
    started - done."""
    pool = pool.numpy()
    started = pool[t_pm.V3_ROW_STARTED]
    flight = [(pool[t_pm.ROW_ALIVE] > 0, pool[t_pm.sample_row(park_k)])]
    for j in range(park_k):
        flight.append((pool[t_pm.buf_row(j, t_pm.BUF_STATE)] > 0.5,
                       pool[t_pm.sample_row(park_k, j)]))
    count = sum(m.astype(np.float32) for m, _ in flight)
    np.testing.assert_array_equal(count, started - pool[t_pm.V2_ROW_DONE])
    for m, s in flight:
        assert np.all((s[m] >= sample_base) & (s[m] < sample_base + started[m]))
    for a in range(len(flight)):
        for b in range(a + 1, len(flight)):
            both = flight[a][0] & flight[b][0]
            assert np.all(flight[a][1][both] != flight[b][1][both])
    return int(count.sum())


@pytest.mark.parametrize("park_k", [1, 3])
def test_k2_plain_matches_jax_zero_stub(park_k):
    pc, cam, _, npix, n = _synth_port()
    spp, depth = GOLDENS.SHAPES[park_k]
    pool = t_rp.make_pool_v2(npix, n, spp, park_k=park_k, device="cpu")
    jrows = t_pm.pool_rows(park_k)
    in_flight = 0
    for call, seed in enumerate(GOLDENS.CHEAP_SEEDS, start=1):
        before = pool[:jrows].numpy().copy()
        pool, counts = t_pm.trace_cheap_regen_plain(
            pc, cam, pool, seed=seed, quota=spp, sample_base=0,
            step_cap=GOLDENS.STEP_CAP, park_k=park_k, max_depth=depth,
            uniforms=torch.zeros((6, n)))
        want = GOLDENS.load(f"k2_park{park_k}_call{call}")
        _check_columns("k2", pool[:jrows].numpy(), want, before, npix)
        in_flight = _check_sample_rows(pool, park_k, 0)
        assert int(counts.sum()) >= 0
    assert in_flight > 0  # paths are parked and frozen: K3 has work
    # every buffer holds frozen paths, so the resolve test below means much
    for j in range(park_k):
        assert (pool[t_pm.buf_row(j, t_pm.BUF_STATE)] == 1.0).any()


@pytest.mark.parametrize("park_k", [1, 3])
def test_k3_plain_matches_jax_injected_uniforms(park_k):
    _, _, ks, npix, n = _synth_port()
    _, depth = GOLDENS.SHAPES[park_k]
    jax_pool = GOLDENS.load(f"k2_park{park_k}_call2")
    pool = torch.cat([torch.from_numpy(jax_pool), torch.zeros((1 + park_k, n))])
    out, counts = t_pm.trace_resolve_pool_plain(
        ks, pool, seed=GOLDENS.RESOLVE_SEED, parts=park_k + 1, park_k=park_k,
        max_depth=depth,
        uniforms=torch.from_numpy(GOLDENS.uniforms(park_k, n)))
    want = GOLDENS.load(f"k3_park{park_k}")
    jrows = t_pm.pool_rows(park_k)
    _check_columns("k3", out[:jrows].numpy(), want, jax_pool, npix)
    # the port's rows are carried through untouched
    assert torch.equal(out[jrows:], pool[jrows:])
    # bookkeeping: done rose by the paths that ended, and no buffer is left
    # frozen (every frozen path was resolved to ready or empty)
    assert int(counts.sum()) > 0
    for j in range(park_k):
        assert not (out[t_pm.buf_row(j, t_pm.BUF_STATE)] == 1.0).any()


@pytest.mark.slow
def test_goldens_regenerate_unchanged():
    """The committed JAX outputs are what the JAX kernels give today."""
    for park_k in GOLDENS.SHAPES:
        for name, arr in GOLDENS.jax_outputs(park_k).items():
            np.testing.assert_array_equal(arr, GOLDENS.load(name))


def test_slots_are_independent():
    """A slot's K2 and K3 results do not depend on which other slots share
    the pool (so a thread per slot, stopping on its own, is the JAX block
    loop lane by lane): the pool run whole equals it run in two halves."""
    pc, cam, ks, npix, n = _synth_port()
    park_k, spp, depth = 3, 6, 5
    pool = t_rp.make_pool_v2(npix, n, spp, park_k=park_k, device="cpu")
    kw = dict(seed=9, quota=spp, sample_base=12, step_cap=8, park_k=park_k,
              max_depth=depth)
    for _ in range(2):
        whole, c_whole = t_pm.trace_cheap_regen_plain(pc, cam, pool, **kw)
        halves = [t_pm.trace_cheap_regen_plain(pc, cam, part, **kw)
                  for part in (pool[:, :n // 2], pool[:, n // 2:])]
        assert torch.equal(whole, torch.cat([h[0] for h in halves], dim=1))
        assert torch.equal(c_whole, torch.cat([h[1] for h in halves]))
        rkw = dict(seed=9, parts=park_k + 1, park_k=park_k, max_depth=depth)
        res, _ = t_pm.trace_resolve_pool_plain(ks, whole, **rkw)
        res_h = [t_pm.trace_resolve_pool_plain(ks, whole[:, s], **rkw)[0]
                 for s in (slice(0, n // 2), slice(n // 2, n))]
        assert torch.equal(res, torch.cat(res_h, dim=1))
        pool = res
    assert float(pool[t_pm.V2_ROW_DONE].sum()) > 0


def test_k2_step_budget():
    """A call runs at most cheap_steps(quota, step_cap, max_depth) steps a
    slot (the JAX bound rounded up to its 8-step granule); without a cap
    every slot ends the call unable to advance."""
    assert t_pm.cheap_steps(5, 4, 4) == 8
    assert t_pm.cheap_steps(256, 64, 12) == 64
    assert t_pm.cheap_steps(2, 0, 3) == 16
    pc, cam, _, npix, n = _synth_port()
    pool = t_rp.make_pool_v2(npix, n, 4, park_k=1, device="cpu")
    out, counts = t_pm.trace_cheap_regen_plain(
        pc, cam, pool, seed=1, quota=4, sample_base=0, step_cap=8, park_k=1,
        max_depth=3)
    assert int(counts.max()) <= 8
    out, _ = t_pm.trace_cheap_regen_plain(
        pc, cam, pool, seed=1, quota=4, sample_base=0, step_cap=0, park_k=1,
        max_depth=3)
    alive = out[t_pm.ROW_ALIVE] > 0
    can_start = (out[t_pm.V3_ROW_STARTED] < out[t_pm.V2_ROW_QUOTA]) | (
        out[t_pm.buf_row(0, t_pm.BUF_STATE)] > 1.5)
    buf_full = out[t_pm.buf_row(0, t_pm.BUF_STATE)] > 0.5
    # dead slots have nothing to start; live ones are frozen, buffer full
    assert not (~alive & can_start).any()
    assert (alive <= buf_full).all()


def test_wrappers_on_cpu_are_the_plain_versions():
    pc, cam, ks, npix, n = _synth_port()
    pool = t_rp.make_pool_v2(npix, n, 3, park_k=2, device="cpu")
    kw = dict(seed=2, quota=3, sample_base=0, step_cap=8, park_k=2, max_depth=4)
    before = (t_pm.trace_cheap_regen.launches, t_pm.trace_resolve_pool.launches)
    a = t_pm.trace_cheap_regen(pc, cam, pool, **kw)
    b = t_pm.trace_cheap_regen_plain(pc, cam, pool, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rkw = dict(seed=2, parts=3, park_k=2, max_depth=4)
    a = t_pm.trace_resolve_pool(ks, b[0], **rkw)
    c = t_pm.trace_resolve_pool_plain(ks, b[0], **rkw)
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    assert (t_pm.trace_cheap_regen.launches,
            t_pm.trace_resolve_pool.launches) == before
    assert torch.equal(pool, t_rp.make_pool_v2(npix, n, 3, park_k=2,
                                              device="cpu"))  # unchanged


@pytest.mark.parametrize("bad", ["rows", "park_k", "parts", "uniforms"])
def test_portal_kernels_reject_bad_arguments(bad):
    pc, cam, ks, npix, n = _synth_port()
    pool = t_rp.make_pool_v2(npix, n, 3, park_k=1, device="cpu")
    kw = dict(seed=2, quota=3, sample_base=0, park_k=1)
    rkw = dict(seed=2, parts=2, park_k=1)
    if bad == "rows":
        pool = pool[:-1]
    elif bad == "park_k":
        kw["park_k"] = rkw["park_k"] = 4
    elif bad == "parts":
        rkw["parts"] = 3
    else:
        kw["uniforms"] = torch.zeros((4, n))
        rkw["uniforms"] = torch.zeros((4, n))
    if bad != "parts":
        with pytest.raises(ValueError):
            t_pm.trace_cheap_regen(pc, cam, pool, **kw)
    with pytest.raises(ValueError):
        t_pm.trace_resolve_pool(ks, pool, **rkw)


# ---------------------------------------------------------------------------
# The benchmark's mesh13k configuration: a public 12,716-triangle CAD mesh
# ---------------------------------------------------------------------------

MESH13K = os.path.join(ROOT, "bench_torch", "configs", "mesh13k")
MESH13K_OFF = os.path.join(MESH13K, "meshes", "panda_link2.off")
# the binary STL the OFF file is converted from, as Gymnasium-Robotics 1.4.1
# ships it (bench_torch/configs/mesh13k.json names it under "assumed")
PANDA_STL = ("envs", "assets", "kitchen_franka", "franka_assets", "meshes",
             "visual", "link2.stl")
PANDA_STL_SHA256 = "f6455febcb22ed165b462f337c73c9dc428aa82b4e46f35f860f5c860705d528"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


STL_TO_OFF = _module("stl_to_off", os.path.join(ROOT, "scripts", "stl_to_off.py"))


def _scene_at(path):
    """The program's scene from a scene file, MeshFile paths taken from
    beside it (as the benchmark loads a configuration's scene)."""
    import json

    with open(path) as fh:
        desc = json.load(fh)
    return tpt.SceneDescriptor.from_json_dict(desc, base_dir=os.path.dirname(path))


def test_stl_converter_reproduces_the_committed_mesh():
    import hashlib

    spec = importlib.util.find_spec("gymnasium_robotics")
    if spec is None:
        pytest.skip("gymnasium_robotics, which ships the source STL, is not installed")
    stl = os.path.join(os.path.dirname(spec.origin), *PANDA_STL)
    with open(stl, "rb") as fh:
        data = fh.read()
    if hashlib.sha256(data).hexdigest() != PANDA_STL_SHA256:
        pytest.skip("the installed gymnasium_robotics ships another link2.stl")
    with open(MESH13K_OFF, "rb") as fh:
        committed = fh.read()
    out = STL_TO_OFF.convert(data).encode()
    assert out == committed
    assert out.splitlines()[:2] == [b"OFF", b"6360 12716 0"]


def test_stl_converter_keeps_every_triangle_bit_for_bit():
    """Triangles come back from the OFF text in order and bit for bit:
    corners shared by their bits only (``-0.0`` and ``0.0`` stay apart),
    numbered by first use; coordinates that need all nine digits too. A
    truncated file is refused."""
    import struct

    from path_tracer_tpu_torch.models.off import parse_off

    rng = np.random.default_rng(5)
    pts = rng.standard_normal((6, 3)).astype(np.float32)
    pts[4] = [0.0, 1.0, 2.0]
    pts[5] = [-0.0, 1.0, 2.0]
    faces = [(0, 1, 2), (2, 1, 3), (3, 4, 0), (5, 1, 2), (0, 1, 2)]
    tris = pts[np.asarray(faces)]
    data = bytes(80) + struct.pack("<I", len(faces)) + b"".join(
        np.zeros(3, "<f4").tobytes() + t.astype("<f4").tobytes() + bytes(2)
        for t in tris)
    text = STL_TO_OFF.convert(data)
    assert text.splitlines()[1] == "6 5 0"
    assert text.splitlines()[2 + 6:] == ["3 0 1 2", "3 2 1 3", "3 3 4 0",
                                         "3 5 1 2", "3 0 1 2"]
    assert parse_off(text).tobytes() == tris.tobytes()
    with pytest.raises(ValueError):
        STL_TO_OFF.read_stl(data[:-1])


def test_mesh13k_packs_to_the_portal_route():
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    prep = prepare_render(_scene_at(os.path.join(MESH13K, "mesh13k.json")),
                          tpt.Resolution(300, 450), "cpu")
    assert prep.route == "portal"
    assert prep.kscene.tiles.shape[0] == 199
    assert prep.kscene.tri.shape[0] == 12744  # 12,716 triangles, 28 of the box
    assert prep.kscene.hit.numel() * 4 == 1019520  # K3's compact table, bytes


MESH13K_CFG = dict(w=24, h=16, spp=4, seed=7)


@pytest.fixture(scope="module")
def mesh13k_render():
    """The port's plain portal render of mesh13k at 24x16, 4 spp, seed 7,
    and its scene's file."""
    from path_tracer_tpu_torch.render.pipeline import prepare_render

    path = os.path.join(MESH13K, "mesh13k.json")
    c = MESH13K_CFG
    scene = _scene_at(path)
    res = tpt.Resolution(c["h"], c["w"])
    ks = prepare_render(scene, res, "cpu").kscene
    assert ks.tiles.shape[0] > t_tk.KEY_TILES  # the sort key holds few
    cfg = tpt.RenderConfig(samples_per_pixel=c["spp"], resolution=res, seed=c["seed"])
    done = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    assert done.stats.extra["route"] == "portal"
    return done, cfg, path


def test_plain_portal_route_matches_reference_on_mesh13k(mesh13k_render):
    """mesh13k (199 tiles, more than the sort key's KEY_TILES) through the
    port's plain portal route against the benchmark's plain reference
    (``bench_torch/reference.py``), 128 of the 24x16 pixels at 4 spp, drawn
    from a seed as the benchmark's check draws its pixels (the brute-force
    reference takes ~0.1 s a pixel on a CPU here). Tolerance: a mean |difference| of 1e-4 and 99% of pixels within 1e-5
    in every channel. Reason: both draw the same keyed numbers and so
    trace the same paths; they part only by float32 rounding in operations
    ordered differently (a few ulps on this scene), while a path lost or
    traced wrong moves its pixel by the Monte Carlo noise between two
    seeds, ~0.2 here."""
    done, cfg, path = mesh13k_render
    ref = _module("bench_reference", os.path.join(ROOT, "bench_torch", "reference.py"))
    c = MESH13K_CFG
    pix = np.sort(np.random.default_rng(c["seed"]).choice(c["w"] * c["h"], 128,
                                                          replace=False))
    sc = ref.to_device(ref.load_scene(path), "cpu", torch.float32)
    want = torch.clamp(ref.pixel_sums(
        sc, torch.from_numpy(pix), 0, c["spp"], seed=c["seed"],
        width=c["w"], height=c["h"], max_depth=cfg.max_depth,
        rr_start_depth=cfg.rr_start_depth) / c["spp"], 0.0, 1.0).numpy()
    gap = np.abs(done.image.pixels[pix].astype(np.float64) - want)
    assert gap.mean() <= 1e-4, gap.mean()
    assert (gap.max(axis=1) <= 1e-5).mean() >= 0.99, np.sort(gap.max(axis=1))[-5:]
    assert want.mean() > 0.05  # the image is lit


def test_plain_portal_route_within_mc_noise_of_jax_on_mesh13k(mesh13k_render):
    """The same render against the JAX package's render() of the same scene
    file and configuration (on the CPU the JAX side takes its XLA mode,
    whose random stream differs): the gate of test_torch_render.py,
    RMSE(port, JAX seed 7) <= 1.5 x RMSE(JAX seed 7, JAX seed 8) and every
    channel mean within 4 standard errors."""
    import json

    done, cfg, path = mesh13k_render
    with open(path) as fh:
        js = jpt.SceneDescriptor.from_json_dict(json.load(fh),
                                                base_dir=os.path.dirname(path))
    c = MESH13K_CFG
    jcfg = jpt.RenderConfig(samples_per_pixel=c["spp"], seed=c["seed"],
                            resolution=jpt.Resolution(c["h"], c["w"]))
    j0 = jpt.render(js, jcfg, out_dir=None, verbose=False).image.pixels
    j1 = jpt.render(js, jcfg.with_(seed=c["seed"] + 1), out_dir=None,
                    verbose=False).image.pixels
    t0 = done.image.pixels

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    noise = rmse(j0, j1)
    assert noise > 0
    assert rmse(t0, j0) <= 1.5 * noise, (rmse(t0, j0), noise)
    se = (j0 - j1).std(axis=0) / np.sqrt(j0.shape[0])
    assert (np.abs(t0.mean(0) - j0.mean(0)) <= 4 * se).all(), (
        t0.mean(0), j0.mean(0), se)
