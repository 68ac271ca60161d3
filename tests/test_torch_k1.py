"""K1's redesign on the CPU: what its host side packs, its plain version on
a scene of the most primitives a static scene holds, and the scripts that
model and count it.

1. The hit table (``trace_v2.k1_hit_table``) and the split table
   (``trace_v2.k1_split_table``) hold ``SceneConsts.prims``' values at the
   offsets that ``csrc/k1_scan.cuh`` and ``csrc/common.cuh`` read, on
   cornell, three-spheres, single-sphere, the gated scene and a scene of
   128 primitives (tests/test_torch_cuda.py ceiling_scene); the plain
   version reads the rows themselves, not those tables.
2. ``trace_regen_plain`` against the JAX package's regen loop with its
   baked scan (``make_prim_scan``) on that 128-primitive scene, under the
   injected per-lane table (the harness of test_torch_regen.py), seen from
   near and from 17 units, where some paths part.
3. ``scripts/k1_coherence.py`` at a tiny size: its lane shares partition
   the segments, its segment counts equal ``trace_regen_plain``'s; and
   ``scripts/k1_sass.py``'s map from source lines to the kernel's parts.
The kernel itself against its plain version is in test_torch_cuda.py.
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
from path_tracer_tpu.ops.pallas import trace_v2 as j_tv2
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_tv2
from path_tracer_tpu_torch.render.pipeline import morton_pixel_order
from tests.test_torch_cuda import ceiling_scene
from tests.test_torch_host import SYNTH, load_both
from tests.test_torch_regen import _assert_paths_agree, _jax_regen

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "path_tracer_tpu_torch", "csrc")
SCENES = ["cornell", "three-spheres", "single-sphere", "gated", "ceiling"]


def _script(name):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(sid, repo_root):
    if sid == "ceiling":
        return ceiling_scene(jpt), ceiling_scene(tpt)
    if sid in SYNTH:
        return SYNTH[sid](jpt), SYNTH[sid](tpt)
    return load_both(sid, repo_root)


def _constexprs(name):
    with open(os.path.join(CSRC, name)) as fh:
        text = fh.read()
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for k, v in re.findall(r"(\w+) = (\w+)", decl):
            if v.isdigit():
                out[k] = int(v)
    return out


@pytest.mark.parametrize("sid", SCENES)
def test_k1_hit_and_split_tables(repo_root, sid):
    """The host packing of K1's hit table and split table."""
    _, ts = _both(sid, repo_root)
    sc = t_tv2.build_scene_consts(tpt.pack_scene(ts))
    prims, gates = sc.prims, sc.gates
    p, g = prims.shape[0], gates.shape[0]
    hit = sc.hit
    assert hit.shape == (p, t_tv2.HIT_F) and hit.dtype == torch.float32
    sphere = prims[:, t_tv2.COL_KIND] == t_tv2.KIND_SPHERE
    for k in range(3):
        want_aux = torch.where(sphere, prims[:, t_tv2.COL_GEOM + k],
                               prims[:, t_tv2.COL_GEOM + 12 + k])
        assert torch.equal(hit[:, t_tv2.H_AUX + k], want_aux)
        assert torch.equal(hit[:, t_tv2.H_COLOR + k], prims[:, t_tv2.COL_COLOR + k])
        assert torch.equal(hit[:, t_tv2.H_EMIS + k], prims[:, t_tv2.COL_EMIS + k])
    assert torch.equal(hit[:, t_tv2.H_RTYPE], prims[:, t_tv2.COL_RTYPE])
    assert torch.equal(hit[:, t_tv2.H_PREVID], prims[:, t_tv2.COL_PREVID])
    assert torch.equal(hit[:, t_tv2.H_SPHERE], sphere.to(torch.float32))
    assert not hit[:, t_tv2.H_SPHERE + 1:].any()
    if sid == "ceiling":
        kinds = set(prims[:, t_tv2.COL_KIND].tolist())
        assert p == 128 and g == 1
        assert kinds == {t_tv2.KIND_SPHERE, t_tv2.KIND_TRI}
        assert int((prims[:, t_tv2.COL_GATE] >= 0).sum()) == 2
        assert set(prims[:, t_tv2.COL_RTYPE].tolist()) == {0.0, 1.0, 2.0}
    if sid == "gated":
        assert g == 1 and (prims[:, t_tv2.COL_GATE] >= 0).any()
    # the split table: spheres, then triangles and quads, each in packed
    # order, with the columns make_prim_scan reads and the packed row
    split, n_sph = sc.split, sc.n_sph
    assert split.shape == (p, t_tv2.SPLIT_F) and n_sph == int(sphere.sum())
    rows = split[:, t_tv2.SP_ROW].long().tolist()[:n_sph] + \
        split[:, t_tv2.SQ_ROW].long().tolist()[n_sph:]
    assert rows == torch.nonzero(sphere)[:, 0].tolist() + \
        torch.nonzero(~sphere)[:, 0].tolist()
    g = t_tv2.COL_GEOM
    for i, r in enumerate(rows):
        if i < n_sph:
            assert torch.equal(split[i, t_tv2.SP_C:t_tv2.SP_C + 4], prims[r, g:g + 4])
            continue
        for col, src in ((t_tv2.SQ_N, g + 9), (t_tv2.SQ_E1, g + 3),
                         (t_tv2.SQ_E2, g + 6), (t_tv2.SQ_E2XA, g + 15),
                         (t_tv2.SQ_AXE1, g + 18)):
            assert torch.equal(split[i, col:col + 3], prims[r, src:src + 3])
        assert split[i, t_tv2.SQ_NA] == prims[r, g + 21]
        assert split[i, t_tv2.SQ_UW] == float(
            prims[r, t_tv2.COL_KIND] != t_tv2.KIND_QUAD)
        assert split[i, t_tv2.SQ_PREVID] == prims[r, t_tv2.COL_PREVID]
        assert split[i, t_tv2.SQ_GATE] == prims[r, t_tv2.COL_GATE]
    # the device copy of a scene moves the tables with the rows
    moved = sc.to("cpu")
    assert torch.equal(moved.hit, hit) and torch.equal(moved.split, split)
    assert moved.n_sph == n_sph and moved.rcp_safe == sc.rcp_safe


def test_k1_offsets_match_the_sources():
    """The columns the host packs are the ones the CUDA sources read:
    k1_scan.cuh's H_*, HIT_F, SPLIT_F, SP_* and SQ_*, and common.cuh's row
    layout."""
    k1 = _constexprs("k1_scan.cuh")
    common = _constexprs("common.cuh")
    for name in ("H_AUX", "H_COLOR", "H_EMIS", "H_RTYPE", "H_PREVID",
                 "H_SPHERE", "HIT_F", "SPLIT_F", "SP_C", "SP_ROW", "SQ_N",
                 "SQ_E1", "SQ_E2", "SQ_E2XA", "SQ_AXE1", "SQ_NA", "SQ_UW",
                 "SQ_PREVID", "SQ_GATE", "SQ_ROW"):
        assert k1[name] == getattr(t_tv2, name), name
    for name in ("PRIM_F", "GATE_F", "COL_KIND", "COL_GEOM", "COL_COLOR",
                 "COL_EMIS", "COL_RTYPE", "COL_PREVID", "COL_GATE"):
        assert common[name] == getattr(t_tv2, name), name
    assert common["MAX_PRIMS"] == t_tv2.V2_MAX_PRIMS
    assert k1["HIT_F"] % 2 == 1  # odd: distinct rows in distinct banks
    assert k1["SPLIT_F"] % 4 == 0  # a split row is five 16-byte loads
    # the split scan reads a triangle or quad row as float4s r0..r4
    with open(os.path.join(CSRC, "k1_scan.cuh")) as fh:
        split_src = fh.read()
    for col, expr in ((k1["SQ_N"], "r0.x"), (k1["SQ_E1"], "r0.w"),
                      (k1["SQ_E2"], "r1.z"), (k1["SQ_E2XA"], "r2.y"),
                      (k1["SQ_AXE1"], "r3.x"), (k1["SQ_NA"], "r3.w"),
                      (k1["SQ_UW"], "r4.x"), (k1["SQ_PREVID"], "r4.y"),
                      (k1["SQ_GATE"], "r4.z"), (k1["SQ_ROW"], "r4.w")):
        assert expr in split_src
        assert 4 * int(expr[1]) + "xyzw".index(expr[3]) == col, expr
    # K1 includes its header; K4 and K7 (trace_stepped.cu) for the row
    # tests' root and reciprocal, K8 (portal_cheap_blocked.cu) for the scan;
    # K2 (portal_cheap.cu) and K3 do not
    for src in os.listdir(CSRC):
        with open(os.path.join(CSRC, src)) as fh:
            inc = '#include "k1_scan.cuh"' in fh.read()
        assert inc == (src in ("trace_regen.cu", "trace_regen_prim.cu",
                               "trace_stepped.cu",
                               "portal_cheap_blocked.cu")), src


def test_k1_reciprocal_range_check():
    """k1_rcp_safe: every built-in scene and the 128-primitive one let the
    split scan take the unchecked reciprocal; a triangle 2e15 units across
    does not."""
    from tests.test_torch_cuda import huge_scene

    for scene in (ceiling_scene(tpt), huge_scene(tpt)):
        sc = t_tv2.build_scene_consts(tpt.pack_scene(scene))
        assert sc.rcp_safe == (scene.id != "huge")
    rows = torch.zeros((2, t_tv2.PRIM_F))
    rows[:, t_tv2.COL_KIND] = t_tv2.KIND_TRI
    rows[0, t_tv2.COL_GEOM + 9:t_tv2.COL_GEOM + 12] = torch.tensor(
        [2.0 ** 99, 2.0 ** 98, 2.0 ** 98])  # the sum reaches 2^100
    assert not t_tv2.k1_rcp_safe(rows)
    rows[0, t_tv2.COL_GEOM + 9] = 2.0 ** 98
    assert t_tv2.k1_rcp_safe(rows)


def test_k1_plain_scan_reads_the_rows(repo_root):
    """The plain version, the yardstick of K1 and of the kernels that share
    its scan (K2, K5, K8), reads SceneConsts.prims and gates, not K1's
    tables: with those tables zeroed it traces the same paths."""
    _, ts = _both("cornell", repo_root)
    sc = t_tv2.build_scene_consts(tpt.pack_scene(ts))
    blank = t_tv2.SceneConsts(sc.prims, sc.gates, torch.zeros_like(sc.hit),
                              torch.zeros_like(sc.split), 0, False)
    cam = t_tv2.build_camera_consts(ts.camera, 16, 12)
    pix = torch.arange(16 * 12, dtype=torch.int32)
    kw = dict(seed=1, sample_base=0, quota=2)
    want = t_tv2.trace_regen_plain(sc, cam, pix, **kw)
    got = t_tv2.trace_regen_plain(blank, cam, pix, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(want[0].sum()) > 0


def test_k1_plain_matches_jax_on_the_ceiling_scene(repo_root):
    """trace_regen_plain against the JAX regen loop over make_prim_scan on
    the 128-primitive scene (spheres of all three reflect types, loose
    triangles, gated triangles), under an injected table, at the tolerance
    of test_torch_regen.py. 512 lanes: about one in 500 parts at max depth
    8, where jit's FMA contraction and torch's rounding of a sphere test
    land on either side of the 1e-4 self-hit epsilon (from 17 units away
    more do: test_k1_plain_against_jax_from_far)."""
    w, h, quota, max_depth = 32, 16, 2, 8
    js, ts = _both("ceiling", repo_root)
    prims, bnd = j_tv2.build_scene_consts(jpt.pack_scene(js))
    cam = j_tv2.build_camera_consts(js.camera, w, h)
    scene_c = t_tv2.build_scene_consts(tpt.pack_scene(ts))
    cam_c = t_tv2.build_camera_consts(ts.camera, w, h)
    assert len(prims) == 128 and scene_c.prims.shape[0] == 128
    U = np.random.default_rng(4).random((6, w * h), dtype=np.float32)
    j_rad, j_counts = _jax_regen(prims, bnd, cam, U, quota, max_depth)
    t_rad, t_segs, t_done = t_tv2.trace_regen_plain(
        scene_c, cam_c, torch.arange(w * h, dtype=torch.int32), seed=0,
        sample_base=0, quota=quota, max_depth=max_depth,
        uniforms=torch.from_numpy(U))
    _assert_paths_agree(j_rad, t_rad.numpy(), j_counts.sum(), t_segs.sum(),
                        t_done.numpy(), quota)
    assert t_rad.sum() > 0


def test_k1_plain_against_jax_from_far(repo_root):
    """The same scene and harness with the camera 17 units from the spheres
    (ceiling_scene far). There the rounding of a sphere hit, by jit's FMA
    contraction on one side and torch's two roundings on the other, reaches
    the 1e-4 self-hit epsilon, so some lanes' paths part: on this scene 32
    of 512 lanes trace a different number of segments (the totals 1.3%
    apart), while 510 of 512 keep their radiance within 1e-3. Held to those
    shares with a margin (90% of lanes with equal segments, the radiance at
    test_torch_regen.py's lane share, the totals within 2%), and to a
    divergence that stays visible: some lane parts."""
    from tests.test_torch_regen import LANE_FRAC, LANE_TOL

    w, h, quota, max_depth = 32, 16, 2, 8
    js, ts = ceiling_scene(jpt, far=True), ceiling_scene(tpt, far=True)
    prims, bnd = j_tv2.build_scene_consts(jpt.pack_scene(js))
    cam = j_tv2.build_camera_consts(js.camera, w, h)
    scene_c = t_tv2.build_scene_consts(tpt.pack_scene(ts))
    cam_c = t_tv2.build_camera_consts(ts.camera, w, h)
    U = np.random.default_rng(4).random((6, w * h), dtype=np.float32)
    j_rad, j_counts = _jax_regen(prims, bnd, cam, U, quota, max_depth)
    t_rad, t_segs, t_done = t_tv2.trace_regen_plain(
        scene_c, cam_c, torch.arange(w * h, dtype=torch.int32), seed=0,
        sample_base=0, quota=quota, max_depth=max_depth,
        uniforms=torch.from_numpy(U))
    np.testing.assert_array_equal(t_done.numpy(), quota)
    same_segs = float((j_counts == t_segs.numpy()).mean())
    agree = float((np.abs(j_rad - t_rad.numpy()).sum(axis=1) < LANE_TOL).mean())
    assert 0.9 <= same_segs < 1.0, same_segs
    assert agree >= LANE_FRAC, agree
    assert abs(float(j_counts.sum()) - float(t_segs.sum())) <= \
        0.02 * float(j_counts.sum())
    assert t_rad.sum() > 0


@pytest.mark.parametrize("sid,source", [("cornell", "counter"),
                                        ("three-spheres", "table")])
def test_k1_coherence_model_counts(repo_root, sid, source):
    """The coherence model at a tiny size: the lanes it counts in each
    branch partition the segments (diffuse, mirror, refract, miss), the
    regenerations are the samples, and its run traces exactly
    trace_regen_plain's segments and samples."""
    coh = _script("k1_coherence")
    w, h, quota = 24, 16, 3
    _, ts = _both(sid, repo_root)
    sc = t_tv2.build_scene_consts(tpt.pack_scene(ts))
    cam = t_tv2.build_camera_consts(ts.camera, w, h)
    pix = torch.from_numpy(morton_pixel_order(w, h)[0])
    uni = None
    if source == "table":
        uni = torch.from_numpy(np.random.default_rng(2).random(
            (6, w * h), dtype=np.float32))
    kw = dict(seed=5, sample_base=4, quota=quota, uniforms=uni)
    model, out = coh.model(sc, cam, pix, **kw)
    plain = t_tv2.trace_regen_plain(sc, cam, pix, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    segs = int(plain[1].sum())
    assert model["segments"] == segs
    lanes = model["lanes_by_branch"]
    assert lanes["diffuse"] + lanes["mirror"] + lanes["refract"] + \
        lanes["miss"] == segs
    assert lanes["hit"] == lanes["diffuse"] + lanes["specular"]
    assert lanes["regen"] == quota * w * h
    shares = model["lane_shares"]
    assert sum(shares[b] for b in ("diffuse", "mirror", "refract", "miss")) \
        == pytest.approx(1.0, abs=1e-12)
    for b, v in model["branches"].items():
        assert 0.0 <= v["warp_step_share"] <= 1.0, b
        assert v["lanes_when_run"] <= 32, b
    if sid == "cornell":  # a closed box: every warp-step hits
        assert model["branches"]["hit"]["warp_step_share"] > 0.99
        assert shares["miss"] < 0.01
    # a warp steps until its longest lane is done: one warp-step a segment
    # of that lane
    n_w = -(-w * h // 32)
    longest = torch.nn.functional.pad(plain[1].to(torch.int64),
                                      (0, n_w * 32 - w * h)).view(n_w, 32)
    assert model["warp_steps"] == int(longest.max(dim=1).values.sum())
    assert model["quota_tail"]["lane_steps_lost"] == \
        model["warp_steps"] * 32 - segs
    rows = model["hit_rows"]
    assert rows["wavefronts_per_read_stride_13"] == 1.0  # < 32 rows
    assert rows["wavefronts_per_read_stride_32"] == pytest.approx(
        rows["distinct_rows_per_warp_step"])
    assert sum(rows["distinct_rows_histogram_0_to_8plus"]) == \
        rows["warp_steps_with_a_hit"]


def test_k1_sass_parts_cover_the_kernel():
    """scripts/k1_sass.py's map from source lines to K1's parts: every part
    of the sample loop is found in this checkout's sources, and the weights
    of a warp-step follow the model's shares and the scene's kinds."""
    k1s = _script("k1_sass")
    maps = {name: k1s.line_parts(os.path.join(CSRC, name))
            for name in ("trace_regen.cu", "common.cuh", "k1_scan.cuh")}
    found = {part for m in maps.values() for part, _ in m.values()}
    for part in ("scan-setup", "scan-loop", "scan-sphere", "scan-quad", "hit",
                 "shade-common", "shade-diffuse", "shade-specular",
                 "shade-mirror", "shade-refract", "regen", "draws", "loop",
                 "setup"):
        assert part in found, part

    def line_of(name, pattern):
        with open(os.path.join(CSRC, name)) as fh:
            for i, ln in enumerate(fh.read().splitlines(), 1):
                if re.search(pattern, ln):
                    return i
        raise AssertionError(pattern)

    assert maps["common.cuh"][line_of("common.cuh", r"sincosf\(")][0] == \
        "shade-diffuse"
    assert maps["common.cuh"][line_of("common.cuh", r"const float ddn")][0] == \
        "shade-refract"
    assert maps["k1_scan.cuh"][line_of("k1_scan.cuh", r"root0\(fmaxf\(det")][0] \
        == "scan-sphere"
    assert maps["k1_scan.cuh"][line_of("k1_scan.cuh", r"__frcp_rn\(dvalid")][0] \
        == "scan-quad"
    assert maps["trace_regen.cu"][line_of("trace_regen.cu", r"camera_ray1\(cam")][0] \
        == "regen"
    # an instruction inlined from a draw inside the regen block is regen's;
    # one from the same draw at a per-segment line is the draws'
    regen_line = line_of("trace_regen.cu", r"camera_ray1\(cam")
    seg_line = line_of("trace_regen.cu", r"u_rr = draw")
    draw_line = line_of("common.cuh", r"return to_uniform")
    fmix = line_of("common.cuh", r"h \^= h >> 16")
    chain = [("common.cuh", fmix), ("common.cuh", draw_line)]
    assert k1s.classify(chain + [("trace_regen.cu", regen_line)], maps)[0] == "regen"
    assert k1s.classify(chain + [("trace_regen.cu", seg_line)], maps)[0] == "draws"
    assert k1s.classify([("math_functions.hpp", 9)], maps) == ("out-of-line", True)
    # a listing of two sphere tests, their roots' MUFU at the root's line,
    # and one MUFU of root0's rare branch, counted apart
    sph = line_of("k1_scan.cuh", r"rsqrt\.approx")
    rare = line_of("k1_scan.cuh", r"s = sqrtf\(x\)")
    scan = line_of("k1_scan.cuh", r"root0\(fmaxf\(det")
    frames = [("k1_scan.cuh", scan), ("trace_regen.cu", seg_line)]
    listing = {"_Z18trace_regen_kernelv": [
        ("MUFU.RSQ", "MUFU.RSQ R1, R2", [("k1_scan.cuh", sph)] + frames),
        ("FFMA", "FFMA R1, R2, R3, R4", [("k1_scan.cuh", sph + 2)] + frames),
        ("MUFU.RSQ", "MUFU.RSQ R1, R2", [("k1_scan.cuh", sph)] + frames),
        ("MUFU.RSQ", "MUFU.RSQ R1, R2", [("k1_scan.cuh", rare)] + frames)]}
    sources = [os.path.join(CSRC, f) for f in maps]
    tallied = k1s.tally(listing, sources)["parts"]["scan-sphere"]
    assert (tallied["instructions"], tallied["mufu"], tallied["tests"]) == \
        (3, 2, 2)
    assert k1s.tally(listing, sources)["parts"]["rare"]["mufu"] == 1
    counts = {"kernel": "_Z18trace_regen_kernelv", "parts": {  # 2 test copies
        p: {"instructions": 10, "tests": 2 if p.startswith("scan") else 0}
        for p in k1s.PARTS}}
    model = {"scene": {"prims": 11, "spheres": 4, "quads": 7, "triangles": 0,
                       "gated": 0},
             "branches": {b: {"warp_step_share": 0.5} for b in
                          ("regen", "hit", "diffuse", "specular", "mirror",
                           "refract", "miss")}}
    step = k1s.per_warp_step(counts, model)
    assert step["by_part"]["scan-quad"] == pytest.approx(10 * 7 / 2)
    assert step["by_part"]["scan-loop"] == pytest.approx(10 * 11)
    assert step["by_part"]["regen"] == 5.0 and step["by_part"]["setup"] == 0.0
    assert step["by_part"]["scan-gate"] == 0.0  # no gated rows
    gate = line_of("k1_scan.cuh", r"valid = gate_hit")
    assert maps["k1_scan.cuh"][gate][0] == "scan-gate"
    assert maps["k1_scan.cuh"][gate - 1][0] == "scan-gate"  # its test
    assert maps["k1_scan.cuh"][gate + 1][0] == "scan-quad"
    assert maps["common.cuh"][line_of("common.cuh", r"if \(valid && gate")][0] \
        == "scan-gate"
    # the parent's loop: one copy of each test
    for p in k1s.PARTS:
        counts["parts"][p]["tests"] = 1
    assert k1s.per_warp_step(counts, model)["by_part"]["scan-sphere"] == 40
    counts["parts"]["scan-quad"]["tests"] = 3  # unrolled by two, remainder
    assert k1s.per_warp_step(counts, model)["by_part"]["scan-quad"] == \
        pytest.approx(10 * 7 / 3)
    assert k1s.issue_estimate_ms(528.0, 1980 * 10**6, 1980.0) == \
        pytest.approx(1000.0)
