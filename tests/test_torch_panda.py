"""The benchmark's panda_arm configuration (``bench_torch/configs/panda_arm``):
the Franka Panda's 11 posed visual meshes, 133,740 triangles, in the Cornell
box, rendered by the ``prim`` route's K4.

1. The scene: 11 parts and their triangle counts; the route ``prim`` with
   no gate matrix, more tiles than K3's sort key holds, and K4 reading its
   rows from device memory; every part inside the reference's bounding
   sphere of it (centre ``min + max * 0.5``), which is what keeps the scene
   tiled; the committed OFF files' md5s as the configuration records them,
   and ``scripts/panda_to_off.py`` rebuilding them byte for byte.
2. The port's plain ``prim`` route against the benchmark's plain reference
   (``bench_torch/reference.py``) on the whole arm at 6x4, 2 spp.
3. K4's counters: ``RenderStats.extra`` and the ``render.prim`` notes of a
   traced render equal the plain version's ``work`` over the same pass, one
   of each note a render.
4. K4's group level: ``KernelScene.tile_groups`` is the exact union of
   each run of 32 of the arm's 2,090 tiles (66 runs, the last of 10), and
   a ray's line that enters a tile enters its run's box, no later, on
   1,024 rays: what the group level's equality with the flat scan rests
   on.
The card's K4 against this plain version is in test_torch_cuda.py.
"""

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch.models.off import parse_off
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.render.pipeline import morton_pixel_order, prepare_render
from path_tracer_tpu_torch.render.raygen import camera_arrays, camera_rays
from path_tracer_tpu_torch.utils import profiling
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)
from tests.test_torch_tracing import PREP_STAGES, assert_prepare_stages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "bench_torch", "configs")
SCENE = os.path.join(CONFIGS, "panda_arm", "panda_arm.json")
# triangles a part, as Gymnasium-Robotics 1.4.1 ships the meshes
PARTS = {"link0": 20483, "link1": 12516, "link2": 12716, "link3": 14233,
         "link4": 14621, "link5": 18327, "link6": 21620, "link7": 12082,
         "hand": 7078, "finger_left": 32, "finger_right": 32}
ARM_TRIANGLES = 133740
CFG = dict(w=6, h=4, spp=2, seed=7)


def _desc():
    with open(SCENE) as fh:
        return json.load(fh)


def _scene():
    return tpt.SceneDescriptor.from_json_dict(_desc(), base_dir=os.path.dirname(SCENE))


def _recorded_md5() -> dict:
    """The OFF files' md5s that the configuration's ``assumed`` records."""
    with open(os.path.join(CONFIGS, "panda_arm.json")) as fh:
        text = " ".join(json.load(fh)["assumed"])
    return dict(re.findall(r"(meshes/panda_\w+\.off) \(md5 ([0-9a-f]{32})\)", text))


def test_panda_arm_scene_takes_the_prim_route_on_rows_in_device_memory():
    scene = _scene()
    parts = [o for o in scene.objects if o.mesh is not None
             and o.mesh.num_triangles > 2]
    assert [o.mesh.num_triangles for o in parts] == list(PARTS.values())
    assert sum(PARTS.values()) == ARM_TRIANGLES
    prep = prepare_render(scene, tpt.Resolution(300, 450), "cpu")
    ks = prep.kscene
    assert prep.route == "prim"
    assert ks.bnd.shape[0] == 0  # no gate: every part is tiled
    assert ks.tiles.shape[0] == 2090 > t_tk.KEY_TILES
    assert (ks.tri.shape[0], ks.tile_base) == (133768, 8)
    assert t_tk.k6_table_bytes(ks) == 10751984
    assert not t_tk.k4_shared_table(ks)
    assert t_tk.k4_table(ks, "cpu") == "plain"


@pytest.mark.parametrize("part", list(PARTS))
def test_panda_arm_part_lies_inside_its_reference_bounding_sphere(part):
    """The reference's bounding sphere of a mesh, centre ``min + max * 0.5``
    of the OFF file's vertices times its scale, plus the object's position,
    contains every vertex of the part. A part whose file's min corner is not
    at the origin would leave its sphere: the program would then gate it
    and build no tiles, and K4 would test all 133k rows a segment."""
    desc = _desc()
    base = os.path.dirname(SCENE)
    obj = next(o for o in desc["objects"] if "MeshFile" in o["type_"]
               and o["type_"]["MeshFile"]["path"] == f"meshes/panda_{part}.off")
    mf = obj["type_"]["MeshFile"]
    with open(os.path.join(base, mf["path"])) as fh:
        tris = parse_off(fh.read()) * np.float32(mf["scale"])
    assert len(tris) == PARTS[part]
    verts = tris.reshape(-1, 3).astype(np.float32)
    mn, mx = verts.min(axis=0), verts.max(axis=0)
    assert (mn == 0.0).all()  # the min corner is the object's position
    pos = np.asarray(obj["position"], np.float32)
    centre = (mn + mx * np.float32(0.5)) + pos
    radius = max(np.linalg.norm(mn + pos - centre), np.linalg.norm(mx + pos - centre))
    dist = np.linalg.norm(verts + pos - centre, axis=1)
    assert dist.max() <= radius * (1 + 1e-6), (dist.max(), radius)


@pytest.mark.parametrize("part", list(PARTS))
def test_panda_arm_off_file_has_the_recorded_md5(part):
    rel = f"meshes/panda_{part}.off"
    with open(os.path.join(CONFIGS, "panda_arm", rel), "rb") as fh:
        assert hashlib.md5(fh.read()).hexdigest() == _recorded_md5()[rel]


def test_panda_to_off_rebuilds_the_committed_files(tmp_path):
    """``scripts/panda_to_off.py`` poses the installed Gymnasium-Robotics
    meshes with MuJoCo and writes the committed OFF files and scene byte
    for byte (its own check holds every part within 1e-6 of the arm's size
    of MuJoCo's compiled vertices)."""
    for mod in ("mujoco", "gymnasium_robotics", "scipy"):
        if importlib.util.find_spec(mod) is None:
            pytest.skip(f"{mod}, which posing the arm needs, is not installed")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "panda_to_off.py"),
         "--template", os.path.join(CONFIGS, "mesh13k", "mesh13k.json"),
         "--out", str(tmp_path)], capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["triangles"] == ARM_TRIANGLES
    if report["parts"][2]["sha256"] != (
            "f6455febcb22ed165b462f337c73c9dc428aa82b4e46f35f860f5c860705d528"):
        pytest.skip("the installed gymnasium_robotics ships other meshes")
    for rel in list(_recorded_md5()) + ["panda_arm.json"]:
        with open(tmp_path / rel, "rb") as a, \
                open(os.path.join(CONFIGS, "panda_arm", rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.fixture(scope="module")
def traced_render():
    """The port's plain prim render of the arm at 6x4, 2 spp, seed 7, under
    a CPU profiler, the ``render.prim`` notes it logged, and its span log."""
    c = CFG
    cfg = tpt.RenderConfig(samples_per_pixel=c["spp"], seed=c["seed"],
                           resolution=tpt.Resolution(c["h"], c["w"]))
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            done = tpt.render(_scene(), cfg, device="cpu", out_dir=None,
                              verbose=False)
        log = list(profiling.spans())
        notes = [(s.name, s.size, s.tag) for s in log
                 if s.name.startswith("render.prim")]
    finally:
        profiling.clear()
    assert done.stats.extra["route"] == "prim"
    return done, cfg, notes, log


def test_plain_prim_route_matches_reference_on_panda_arm(traced_render):
    """Every pixel of the render against the benchmark's plain reference at
    the same seed. Tolerance: a mean |difference| of 1e-6 and every channel
    within 1e-5. Reason: both draw the same keyed numbers and so trace the
    same paths; they part only by float32 rounding in operations ordered
    differently (an ulp or two of a pixel here), while a path lost or traced
    wrong, as by a part gated or a tile skipped, moves its pixel by the
    Monte Carlo noise between two seeds, ~0.3 at 2 spp."""
    done, cfg, _, _ = traced_render
    spec = importlib.util.spec_from_file_location(
        "bench_reference", os.path.join(ROOT, "bench_torch", "reference.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    c = CFG
    sc = ref.to_device(ref.load_scene(SCENE), "cpu", torch.float32)
    want = torch.clamp(ref.pixel_sums(
        sc, torch.arange(c["w"] * c["h"]), 0, c["spp"], seed=c["seed"],
        width=c["w"], height=c["h"], max_depth=cfg.max_depth,
        rr_start_depth=cfg.rr_start_depth) / c["spp"], 0.0, 1.0).numpy()
    gap = np.abs(done.image.pixels.astype(np.float64) - want)
    assert gap.mean() <= 1e-6, gap.mean()
    assert gap.max() <= 1e-5, gap.max()
    assert want.mean() > 0.05  # the image is lit


def test_prim_counters_and_notes_equal_the_plain_work(traced_render):
    """K4's counters of a render (``prim_segments``, ``prim_queries``,
    ``prim_tiles``, ``prim_groups``, ``prim_spheres``) equal the plain
    version's segments and ``work`` counts ("query", "tiles", "groups",
    "sph": the arm has no sphere, so its 8 padding rows a segment) over the
    render's one pass, and the traced render logs each as its note once:
    ``render.prim`` tagged with the table, ``render.prim.query``,
    ``render.prim.tiles``, ``render.prim.groups`` and
    ``render.prim.spheres``."""
    done, cfg, notes, _ = traced_render
    extra = done.stats.extra
    c = CFG
    prep = prepare_render(_scene(), cfg.resolution, "cpu")
    pix = torch.from_numpy(morton_pixel_order(c["w"], c["h"])[0])
    work = {}
    _, segs, fin = t_tk.trace_regen_prim_plain(
        prep.kscene, prep.cam, pix, seed=c["seed"], sample_base=0,
        quota=c["spp"], max_depth=cfg.max_depth,
        rr_start_depth=cfg.rr_start_depth, work=work)
    assert bool((fin == c["spp"]).all())
    assert extra["prim_segments"] == int(segs.sum()) == done.stats.num_rays
    assert (extra["prim_queries"], extra["prim_tiles"], extra["prim_groups"],
            extra["prim_spheres"]) == (
        work["query"], work["tiles"], work["groups"], work["sph"])
    assert work["sph"] == 8 * extra["prim_segments"]
    assert 0 < work["query"] < extra["prim_segments"] and work["tiles"] >= work["query"]
    assert work["query"] <= work["groups"] < 66 * work["query"]
    assert extra["prim_table"] == "plain"
    assert sorted(notes) == sorted([
        ("render.prim", extra["prim_segments"], "plain"),
        ("render.prim.query", extra["prim_queries"], None),
        ("render.prim.tiles", extra["prim_tiles"], None),
        ("render.prim.groups", extra["prim_groups"], None),
        ("render.prim.spheres", extra["prim_spheres"], None)])


@pytest.fixture(scope="module")
def arm_kscene():
    return prepare_render(_scene(), tpt.Resolution(4, 6), "cpu").kscene


def test_prim_render_logs_its_prepare_stages(traced_render, arm_kscene):
    """The traced render's ``render.prepare`` holds its stages in order in
    the render's unit: the portal's split is built and refused, as the
    arm's remainder past its heaviest part has more than 128 primitives;
    the copy is the kernel scene's tables, ``tri``'s 32 floats and
    ``hit``'s 20 a row for 133,768 rows, and a few KB of spheres and
    tiles."""
    log = traced_render[3]
    assert_prepare_stages(log, PREP_STAGES["portal"])
    (copy,) = [s for s in log if s.name == "render.prepare.copy"]
    rows = arm_kscene.tri.shape[0]
    assert rows == arm_kscene.hit.shape[0] == 133768
    assert copy.size == arm_kscene.nbytes
    assert 0 < copy.size - 4 * rows * (t_tk.TRI_F + t_tk.HIT_F) < 100_000


def test_panda_arm_tile_groups_are_the_unions_of_its_runs(arm_kscene):
    """66 boxes for the 2,090 tiles, the last over the 10 that remain: each
    the elementwise min of its run's lo corners and max of its hi corners,
    exactly, and carried by ``KernelScene.to``."""
    ks = arm_kscene
    tiles, groups = ks.tiles.numpy(), ks.tile_groups.numpy()
    assert groups.shape == (66, 6) and groups.dtype == np.float32
    assert tiles.shape[0] - 65 * t_tk.TILE_GROUP == 10
    for g in range(66):
        run = tiles[32 * g:32 * g + 32]
        assert (groups[g, :3] == run[:, :3].min(axis=0)).all()
        assert (groups[g, 3:] == run[:, 3:].max(axis=0)).all()
    assert torch.equal(ks.to("cpu").tile_groups, ks.tile_groups)


def test_a_line_that_enters_a_tile_enters_its_run_no_later(arm_kscene):
    """On 1,024 rays, 512 from the camera and 512 from points in the arm's
    box along random directions (a quarter with one component zero, which
    the slab test clamps): wherever the slab test says a ray's line enters
    a tile, it says the line enters the tile's run's box, at an entry
    distance no greater than the tile's. So a run the line misses, or
    enters no closer than the bound, holds no tile the flat scan would
    test."""
    ks = arm_kscene
    pix = torch.arange(512, dtype=torch.int32) * 53 % (450 * 300)
    o_cam, d_cam = camera_rays(camera_arrays(_scene().camera), pix,
                               torch.zeros(512, dtype=torch.int32), seed=3,
                               width=450, height=300)
    rng = np.random.default_rng(5)
    lo = ks.tile_groups[:, :3].amin(dim=0).numpy()
    hi = ks.tile_groups[:, 3:].amax(dim=0).numpy()
    o_in = (lo + rng.random((512, 3)) * (hi - lo)).astype(np.float32)
    d_in = rng.normal(size=(512, 3)).astype(np.float32)
    d_in[np.arange(128), rng.integers(0, 3, 128)] = 0.0
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.from_numpy(o_in)])
    d = torch.cat([d_cam, torch.from_numpy(d_in)])
    oc = [o[:, k, None] for k in range(3)]
    ic = [x[:, None] for x in t_tk._inv_dir([d[:, k] for k in range(3)])]
    t_tile, in_tile = t_tk._tile_slab(ks.tiles.T[:, None, :], oc, ic)
    t_run, in_run = t_tk._tile_slab(ks.tile_groups.T[:, None, :], oc, ic)
    run = torch.arange(ks.tiles.shape[0]) // t_tk.TILE_GROUP
    assert in_tile.any(dim=1).float().mean() > 0.2  # many lines enter a tile
    assert not (in_tile & ~in_run[:, run]).any()
    assert not (in_tile & (t_run[:, run] > t_tile)).any()
