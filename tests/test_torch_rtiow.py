"""The benchmark's rtiow_final configuration (``bench_torch/configs/rtiow_final``):
the final scene of *Ray Tracing in One Weekend*, 484 spheres of three
materials on a ground quad under a sky sphere, rendered by the ``prim``
route's K4 with its table in shared memory and no tile.

1. The scene: ``scripts/rtiow_scene.py`` rebuilds the committed file byte
   for byte from the recorded seed; the sphere counts by material are the
   ones the configuration records, and no small sphere lies within 0.9 of
   (4, 0.2, 0), where the book skips them.
2. The route: ``prim``, no tile, no gate matrix, the table in K4's shared
   memory.
3. The port's plain ``prim`` route against the benchmark's plain reference
   (``bench_torch/reference.py``) on the whole scene at 6x4, 2 spp.
4. K4's sphere-row counter: ``RenderStats.extra["prim_spheres"]`` and the
   ``render.prim.spheres`` note of a traced render equal the plain
   version's ``work["sph"]``, every sphere row a segment.
5. The sphere test holds rays that leave a small sphere far from the
   origin: the expanded test of the JAX intersector (|c|^2 - 2 c.o + |o|^2)
   found such a ray hitting its own sphere, which parted the port from the
   reference on this scene.
The card's K4 against this plain version is in test_torch_cuda.py.
"""

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
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.render.pipeline import morton_pixel_order, prepare_render
from path_tracer_tpu_torch.utils import profiling
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "bench_torch", "configs")
SCENE = os.path.join(CONFIGS, "rtiow_final", "rtiow_final.json")
CFG = dict(w=6, h=4, spp=2, seed=7)


def _desc():
    with open(SCENE) as fh:
        return json.load(fh)


def _scene():
    return tpt.SceneDescriptor.from_json_dict(_desc(), base_dir=os.path.dirname(SCENE))


def _recorded() -> dict:
    """The seed and the counts the configuration's ``assumed`` records."""
    with open(os.path.join(CONFIGS, "rtiow_final.json")) as fh:
        text = " ".join(json.load(fh)["assumed"])
    m = re.search(r"the counts at seed (\d+): (\d+) small spheres .*?: (\d+) diffuse, "
                  r"(\d+) metal, (\d+) glass; .*?, (\d+) spheres", text)
    keys = ("seed", "small", "diffuse", "metal", "glass", "spheres")
    return dict(zip(keys, (int(x) for x in m.groups())))


def test_rtiow_scene_script_rebuilds_the_committed_file(tmp_path):
    """``scripts/rtiow_scene.py`` at the recorded seed writes the committed
    scene byte for byte and prints the recorded counts."""
    rec = _recorded()
    out = tmp_path / "rtiow_final.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "rtiow_scene.py"),
         "--seed", str(rec["seed"]), "--out", str(out)],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    printed = json.loads(proc.stdout)
    assert {k: printed[k] for k in rec} == rec
    with open(out, "rb") as a, open(SCENE, "rb") as b:
        assert a.read() == b.read()


def test_rtiow_scene_holds_the_recorded_spheres():
    """The recorded counts by material, the book's three large spheres, the
    sky, the ground's one quad, and no small sphere within 0.9 of (4, 0.2,
    0)."""
    rec = _recorded()
    scene = _scene()
    spheres = [o for o in scene.objects if o.is_sphere]
    meshes = [o for o in scene.objects if not o.is_sphere]
    assert len(spheres) == rec["spheres"] and len(meshes) == 1
    assert meshes[0].mesh.num_triangles == 2
    small = [o for o in spheres if o.radius == np.float32(0.2)]
    assert len(small) == rec["small"]
    kinds = [int(o.material.reflect_type) for o in small]
    assert [kinds.count(k) for k in range(3)] == [rec["diffuse"], rec["metal"], rec["glass"]]
    near = np.linalg.norm(np.stack([o.position for o in small])
                          - np.array([4.0, 0.2, 0.0], np.float32), axis=1)
    assert near.min() > 0.9
    big = [(tuple(o.position), int(o.material.reflect_type)) for o in spheres
           if o.radius == np.float32(1.0)]
    assert big == [((0.0, 1.0, 0.0), 2), ((-4.0, 1.0, 0.0), 0), ((4.0, 1.0, 0.0), 1)]
    sky = spheres[-1]
    assert sky.radius == np.float32(100.0) and not sky.material.color.any()
    assert sky.material.emission.tolist() == [0.75, 0.8500000238418579, 1.0]


def test_rtiow_scene_takes_the_prim_route_on_shared_rows_with_no_tile():
    """485 primitives and no mesh for the portal: the ``prim`` route, 484
    spheres in 488 rows, the ground's quad in one row of 8, no tile, no
    gate (the reference's bounding sphere of the quad contains it), and a
    24,064-byte table that K4 stages in shared memory."""
    prep = prepare_render(_scene(), tpt.Resolution(800, 1200), "cpu")
    ks = prep.kscene
    assert prep.route == "prim"
    assert ks.sph.shape[0] == 488 and ks.sph_rows == 484
    assert ks.tri.shape[0] == 8 and ks.tri[0, t_tk.T_QUAD] == 1.0
    assert ks.tiles.shape[0] == 0 and ks.tile_base == 0
    assert ks.bnd.shape[0] == 0 and (ks.tri[:, t_tk.T_GATE] == t_tk.GATE_NONE).all()
    assert t_tk.k6_table_bytes(ks) == 24064 and t_tk.k4_shared_table(ks)


@pytest.fixture(scope="module")
def traced_render():
    """The port's plain prim render of the scene at 6x4, 2 spp, seed 7,
    under a CPU profiler, and the ``render.prim`` notes it logged."""
    c = CFG
    cfg = tpt.RenderConfig(samples_per_pixel=c["spp"], seed=c["seed"],
                           resolution=tpt.Resolution(c["h"], c["w"]))
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            done = tpt.render(_scene(), cfg, device="cpu", out_dir=None,
                              verbose=False)
        notes = [(s.name, s.size, s.tag) for s in profiling.spans()
                 if s.name.startswith("render.prim")]
    finally:
        profiling.clear()
    assert done.stats.extra["route"] == "prim"
    return done, cfg, notes


def test_plain_prim_route_matches_reference_on_rtiow_final(traced_render):
    """Every pixel of the render against the benchmark's plain reference at
    the same seed. Tolerance: a mean |difference| of 1e-6 and every channel
    within 1e-5, as on panda_arm: both draw the same keyed numbers and so
    trace the same paths, parting only by float32 rounding, while a path
    traced wrong (as by a ray that hits the sphere it leaves) moves its
    pixel by the Monte Carlo noise between two seeds."""
    done, cfg, _ = traced_render
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


def test_prim_sphere_rows_and_note_equal_the_plain_work(traced_render):
    """``RenderStats.extra["prim_spheres"]`` and the ``render.prim.spheres``
    note equal the plain version's ``work["sph"]`` over the render's one
    pass: all 488 rows a segment, where no segment is a warp query."""
    done, cfg, notes = traced_render
    extra = done.stats.extra
    c = CFG
    prep = prepare_render(_scene(), cfg.resolution, "cpu")
    pix = torch.from_numpy(morton_pixel_order(c["w"], c["h"])[0])
    work = {}
    _, segs, _ = t_tk.trace_regen_prim_plain(
        prep.kscene, prep.cam, pix, seed=c["seed"], sample_base=0,
        quota=c["spp"], max_depth=cfg.max_depth,
        rr_start_depth=cfg.rr_start_depth, work=work)
    assert extra["prim_segments"] == int(segs.sum()) == done.stats.num_rays
    assert extra["prim_spheres"] == work["sph"] == 488 * extra["prim_segments"]
    assert extra["prim_queries"] == extra["prim_tiles"] == extra["prim_groups"] == 0
    assert ("render.prim.spheres", work["sph"], None) in notes
    assert ("render.prim", extra["prim_segments"], "plain") in notes


def _expanded_t(cen, rad2, o, d):
    """The JAX intersector's expanded sphere test, for comparison."""
    cd = 0.0 + cen[0] * d[0] + cen[1] * d[1] + cen[2] * d[2]
    co = 0.0 + cen[0] * o[0] + cen[1] * o[1] + cen[2] * o[2]
    cc = 0.0 + cen[0] * cen[0] + cen[1] * cen[1] + cen[2] * cen[2]
    od = 0.0 + o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
    oo = 0.0 + o[0] * o[0] + o[1] * o[1] + o[2] * o[2]
    b = cd - od
    det = b * b - (cc - 2.0 * co + oo) + rad2
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    t = torch.where(b - sq >= t_tk.EPS_SPHERE, b - sq,
                    torch.where(b + sq >= t_tk.EPS_SPHERE, b + sq, t_tk.BIG))
    return torch.where((det < 0.0) | (rad2 <= 0.0), t_tk.BIG, t)


def test_sphere_test_holds_a_ray_leaving_a_small_far_sphere():
    """4,096 rays leave points of a radius-0.2 sphere 13 units from the
    origin (as the scene's small spheres lie from the camera) outward,
    most at grazing angles. Whether each meets the sphere again at t >=
    1e-4 (a start rounded into the sphere re-exits it within ~4e-4): the
    program's test (``op = c - o`` first) agrees with the same test in
    float64 on 99% of the rays, where the expanded test of the JAX
    intersector, whose |c|^2 - 2 c.o + |o|^2 cancels to ~1e-5, is wrong on
    a quarter or more."""
    g = torch.Generator().manual_seed(3)
    n = 4096
    cen = torch.tensor([11.7, 0.2, 5.3])
    nrm = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    o = (cen + 0.2 * nrm).float()
    tang = torch.nn.functional.normalize(
        torch.linalg.cross(nrm, torch.randn(n, 3, generator=g), dim=1), dim=1)
    lift = torch.rand(n, 1, generator=g) ** 3  # mostly grazing
    d = torch.nn.functional.normalize(tang + lift * nrm, dim=1).float()

    def hits(test, dtype):
        t = test([cen[k].view(1).to(dtype) for k in range(3)],
                 torch.tensor([0.04], dtype=dtype),
                 [o[:, k:k + 1].to(dtype) for k in range(3)],
                 [d[:, k:k + 1].to(dtype) for k in range(3)])
        return t[:, 0] < t_tk.BIG

    truth = hits(t_tk._sphere_t, torch.float64)
    assert 0 < int(truth.sum()) < n // 10
    assert int((hits(t_tk._sphere_t, torch.float32) != truth).sum()) <= n // 100
    assert int((hits(_expanded_t, torch.float32) != truth).sum()) >= n // 4
