"""The port's spans (``utils.profiling``) on the CPU, the kernel
libraries' load records, the benchmark's readers of both, and the kernel
launch count ``RenderStats.num_dispatches`` on every route.

Spans are on only while a torch profiler runs: then each names the host's
work on the profiler's timeline as a ``pt.*`` range (a plain host range,
not a user annotation, so the device timeline holds none) and lands in the
span log with its parent and unit. Load records are kept with or without
a profiler.
"""

import dataclasses
import importlib.util
import json
import os
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch import cli, native
from path_tracer_tpu_torch.ops.kernels import build
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_v2
from path_tracer_tpu_torch.render import integrator as t_int
from path_tracer_tpu_torch.render import pipeline
from path_tracer_tpu_torch.render import portal as t_rp
from path_tracer_tpu_torch.utils import profiling
from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

# host prep's stages inside render.prepare, route by route ("prim" under
# PT_TPU_NO_PORTAL; where the portal is tried and refused, the prim route
# has the portal's stages)
PREP_STAGES = {
    "regen": ["render.prepare.pack", "render.prepare.consts",
              "render.prepare.copy"],
    "portal": ["render.prepare.pack", "render.prepare.consts",
               "render.prepare.kscene", "render.prepare.kscene.rows",
               "render.prepare.kscene.table", "render.prepare.portal",
               "render.prepare.copy"],
    "prim": ["render.prepare.pack", "render.prepare.consts",
             "render.prepare.kscene", "render.prepare.kscene.rows",
             "render.prepare.kscene.table", "render.prepare.copy"],
}
PREP_PARENTS = {"render.prepare.kscene.rows": "render.prepare.kscene",
                "render.prepare.kscene.table": "render.prepare.kscene"}
RENDER_SPANS = (["render", "render.prepare"] + PREP_STAGES["regen"]
                + ["render.upload", "render.pass", "render.check.wait",
                   "render.pass", "render.check.wait", "render.wait",
                   "render.fetch", "render.finish"])


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def scenes(repo_root):
    old = os.getcwd()
    os.chdir(repo_root)  # MeshFile paths are repo-relative
    try:
        return {sid: tpt.load_scene(sid, "scenes", "meshes")
                for sid in ("cornell", "mesh")}
    finally:
        os.chdir(old)


def _render(scene, spp=8, res=(12, 16), **kw):
    cfg = tpt.RenderConfig(samples_per_pixel=spp, resolution=tpt.Resolution(*res),
                           **kw)
    return tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_are_one_shared_no_op_without_a_profiler(scenes):
    assert not profiling.tracing()
    assert profiling.span("render") is profiling.span("x", 2, ("frame", 0, 0))
    profiling.sync_span("render.wait", "cpu")
    _render(scenes["cornell"])
    ProgressiveRenderer(scenes["mesh"], tpt.Resolution(6, 8), device="cpu").step_u8()
    assert profiling.spans() == []


def test_render_spans_nest_in_one_unit_a_render(scenes):
    # two passes of one sample, few bounces: the profiler's events stay few
    kw = dict(spp=2, res=(4, 6), samples_per_pass=1, max_depth=3)
    with _profiled() as prof:
        _render(scenes["cornell"], **kw)
        first = len(profiling.spans())
        _render(scenes["cornell"], **kw)
    log = profiling.spans()
    one = log[:first]
    assert [s.name for s in one] == RENDER_SPANS
    assert [s.name for s in log[first:]] == RENDER_SPANS
    assert len({s.unit for s in one}) == 1 and one[0].unit[0] == "render"
    assert log[first].unit != one[0].unit
    parents = {s.name: one[s.parent].name if s.parent >= 0 else None for s in one}
    assert parents == {"render": None, "render.prepare": "render",
                       "render.prepare.pack": "render.prepare",
                       "render.prepare.consts": "render.prepare",
                       "render.prepare.copy": "render.prepare",
                       "render.upload": "render", "render.pass": "render",
                       "render.check.wait": "render.pass", "render.wait": "render",
                       "render.fetch": "render", "render.finish": "render"}
    for s in one:
        assert one[0].start_ns <= s.start_ns <= s.end_ns <= one[0].end_ns
        if s.parent >= 0:
            p = one[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert [s.size for s in one if s.name == "render.pass"] == [1, 1]
    ranges = [e for e in prof.events() if e.name.startswith("pt.")]
    assert sorted({e.name for e in ranges}) == sorted({"pt." + n for n in RENDER_SPANS})
    assert len(ranges) == 2 * len(RENDER_SPANS)
    assert not any(e.is_user_annotation for e in ranges)


def test_portal_render_logs_a_wait_a_poll(scenes):
    with _profiled():
        done = _render(scenes["mesh"], spp=2, res=(4, 6))
    log = profiling.spans()
    names = [s.name for s in log]
    assert done.stats.extra["route"] == "portal"
    assert names.count("portal.wait") == done.stats.extra["polls"] > 0
    assert sum(s.size for s in log if s.name == "portal.issue") == \
        done.stats.extra["cycles"]
    assert names.count("portal.merge") == 1 and "portal.merge.wait" in names
    assert "portal.compact" in names
    for s in log:
        if s.name.startswith("portal."):
            assert log[s.parent].name in ("render.pass", "portal.merge")


def test_portal_render_counts_its_resolve_segments(scenes, monkeypatch):
    """``resolve_segments`` is the sum of K3's counts over the render (its
    plain version here), a share of ``num_rays``; a traced render logs it
    as the size of a ``render.resolve`` note, tagged with where K3 read
    its rows."""
    k3 = []
    real = t_rp.trace_resolve_pool

    def counted(*a, **kw):
        pool, counts = real(*a, **kw)
        k3.append(int(counts.sum()))
        return pool, counts

    monkeypatch.setattr(t_rp, "trace_resolve_pool", counted)
    done = _render(scenes["mesh"], spp=2, res=(4, 6))
    extra = done.stats.extra
    assert extra["resolve_segments"] == sum(k3) > 0
    assert extra["resolve_segments"] <= done.stats.num_rays
    assert extra["resolve_table"] == "plain"
    assert profiling.spans() == []  # no note without a profiler
    with _profiled():
        again = _render(scenes["mesh"], spp=2, res=(4, 6))
    log = profiling.spans()
    (note,) = [s for s in log if s.name == "render.resolve"]
    assert (note.size, note.tag) == (extra["resolve_segments"], "plain")
    assert again.stats.extra["resolve_segments"] == note.size
    assert log[note.parent].name == "render" and note.unit == log[0].unit
    assert note.start_ns == note.end_ns > 0


def test_resumed_render_restores_its_resolve_segments(scenes, tmp_path):
    """A checkpoint keeps ``resolve_segments`` beside ``num_rays``: a portal
    render resumed after its first pass counts what an uninterrupted one
    does. A file without them, as checkpoints were written before they
    were kept, leaves the count out rather than report the resumed part."""
    import numpy as np

    cfg = tpt.RenderConfig(samples_per_pixel=4, samples_per_pass=2,
                           resolution=tpt.Resolution(4, 6))

    def render(path, cancel=None):
        return tpt.render(scenes["mesh"], cfg, device="cpu", out_dir=None,
                          verbose=False, checkpoint_path=path,
                          checkpoint_every=1, cancel=cancel)

    full = render(None)
    ck = str(tmp_path / "ck.npz")
    part = render(ck, cancel=lambda: os.path.exists(ck))
    assert part.cancelled
    with np.load(ck) as z:
        files = {k: z[k] for k in z.files}
    assert 0 < int(files["resolve_segments"]) < full.stats.extra["resolve_segments"]
    old = str(tmp_path / "old.npz")
    np.savez(old, **{k: v for k, v in files.items() if k != "resolve_segments"})
    resumed = render(ck)
    assert resumed.stats.resumed_samples == 2
    assert resumed.stats.num_rays == full.stats.num_rays
    assert resumed.stats.extra["resolve_segments"] == full.stats.extra["resolve_segments"]
    from_old = render(old)
    assert from_old.stats.resumed_samples == 2
    assert from_old.stats.num_rays == full.stats.num_rays
    assert "resolve_segments" not in from_old.stats.extra


def test_portal_render_counts_its_group_items(scenes, monkeypatch, tmp_path):
    """``resolve_group_items`` gathers what K3 adds to the runner's
    ``group_items`` counter over the render: 0 on mesh (13 tiles, the key
    sees them all), one a launch here where a stand-in adds one; a traced
    render logs it as a ``render.resolve.group`` note beside
    ``render.resolve``, and a checkpoint keeps it beside
    ``resolve_segments``."""
    import numpy as np

    done = _render(scenes["mesh"], spp=2, res=(4, 6))
    assert done.stats.extra["resolve_group_items"] == 0
    calls = []
    real = t_rp.trace_resolve_pool

    def counted(*a, group_items=None, **kw):
        calls.append(1)
        out = real(*a, group_items=group_items, **kw)
        group_items += 1
        return out

    monkeypatch.setattr(t_rp, "trace_resolve_pool", counted)
    with _profiled():
        done = _render(scenes["mesh"], spp=2, res=(4, 6))
    extra = done.stats.extra
    assert extra["resolve_group_items"] == len(calls) == extra["cycles"] > 0
    log = profiling.spans()
    (note,) = [s for s in log if s.name == "render.resolve.group"]
    assert (note.size, note.tag) == (len(calls), "plain")
    assert log[note.parent].name == "render"

    cfg = tpt.RenderConfig(samples_per_pixel=4, samples_per_pass=2,
                           resolution=tpt.Resolution(4, 6))

    def render(path, cancel=None):
        return tpt.render(scenes["mesh"], cfg, device="cpu", out_dir=None,
                          verbose=False, checkpoint_path=path,
                          checkpoint_every=1, cancel=cancel)

    full = render(None)
    ck = str(tmp_path / "ck.npz")
    assert render(ck, cancel=lambda: os.path.exists(ck)).cancelled
    with np.load(ck) as z:
        files = {k: z[k] for k in z.files}
    assert 0 < int(files["resolve_group_items"]) < \
        full.stats.extra["resolve_group_items"]
    resumed = render(ck)
    assert resumed.stats.extra["resolve_group_items"] == \
        full.stats.extra["resolve_group_items"] == full.stats.extra["cycles"]
    old = str(tmp_path / "old.npz")
    np.savez(old, **{k: v for k, v in files.items()
                     if k != "resolve_group_items"})
    assert "resolve_group_items" not in render(old).stats.extra


def test_preview_frames_and_moves_share_units(scenes):
    r = ProgressiveRenderer(scenes["mesh"], tpt.Resolution(6, 8), device="cpu")
    with _profiled():
        r.step_u8()
        r.move_camera(r.scene.camera)
        r.step_u8()
        r.step()
    log = profiling.spans()
    frames = [s for s in log if s.name == "preview.frame"]
    (move,) = [s for s in log if s.name == "preview.move"]
    assert len(frames) == 3
    assert len({s.unit for s in frames}) == 3
    assert move.unit == frames[1].unit and move.end_ns <= frames[1].start_ns
    for f in frames:
        kids = [s.name for s in log if s.parent == log.index(f)]
        assert kids == ["preview.issue", "preview.fetch"]
    assert [f.unit for f in frames] == [("frame", r._id, n) for n in range(3)]


def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("route", ["regen", "prim", "portal", "wavefront"])
def test_num_dispatches_counts_the_kernel_launches(scenes, monkeypatch, route):
    calls = []
    scene, spp, res, kw = scenes["mesh"], 2, (4, 6), {}
    if route == "regen":
        scene, spp = scenes["cornell"], 8
        kw = dict(samples_per_pass=3)
        _counting(monkeypatch, t_v2, "trace_regen", calls)
    elif route == "prim":
        monkeypatch.setenv("PT_TPU_NO_PORTAL", "1")
        _counting(monkeypatch, t_tk, "trace_regen_prim", calls)
    elif route == "wavefront":
        scene, kw = scenes["cornell"], dict(backend="fast", pixel_chunk=10)
        _counting(monkeypatch, t_int, "render_pass", calls)
    else:
        for name in ("trace_cheap_regen", "trace_resolve_pool"):
            _counting(monkeypatch, t_rp, name, calls)
    done = _render(scene, spp=spp, res=res, **kw)
    assert done.stats.num_dispatches == len(calls) > 0
    if route == "regen":
        assert len(calls) == 3  # passes of 3, 3 and 2 samples
    if route == "wavefront":
        assert len(calls) == 3  # 24 pixels in chunks of 10, one pass
    if route == "portal":
        assert len(calls) == 2 * done.stats.extra["cycles"]


def test_cli_profile_trace_holds_the_spans(repo_root, tmp_path, monkeypatch):
    monkeypatch.chdir(repo_root)
    prof = tmp_path / "prof"
    assert cli.main(["2", "12", "cornell", "--device", "cpu", "--quiet",
                     "--profile", str(prof), "--out-dir", str(tmp_path)]) == 0
    with open(prof / profiling.TRACE_FILE) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"pt.render", "pt.render.pass", "pt.render.fetch", "pt.render.ppm"} <= names
    assert {s.name for s in profiling.spans()} >= {"render", "render.ppm"}
    assert not torch.autograd._profiler_enabled()


def assert_prepare_stages(log, names):
    """The one ``render.prepare`` span of ``log`` holds the stage spans
    ``names`` in order, each inside its parent and in the prepare's unit;
    the stages directly under it do not overlap."""
    (prep,) = [i for i, s in enumerate(log) if s.name == "render.prepare"]
    stages = [s for s in log if s.name.startswith("render.prepare.")]
    assert [s.name for s in stages] == names
    for s in stages:
        parent = log[s.parent]
        assert parent.name == PREP_PARENTS.get(s.name, "render.prepare")
        assert s.unit == log[prep].unit
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    top = [s for s in stages if s.parent == prep]
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))


@pytest.mark.parametrize("route", ["regen", "portal", "prim"])
def test_prepare_stages_nest_in_order_in_the_renders_unit(scenes, monkeypatch,
                                                         route):
    if route == "prim":
        monkeypatch.setenv("PT_TPU_NO_PORTAL", "1")
    scene = scenes["cornell" if route == "regen" else "mesh"]
    with _profiled():
        done = _render(scene, spp=1, res=(4, 6), max_depth=2)
    assert done.stats.extra["route"] == route
    log = profiling.spans()
    assert_prepare_stages(log, PREP_STAGES[route])
    assert log[0].name == "render" and log[0].unit[0] == "render"
    assert {s.unit for s in log} == {log[0].unit}


# the preview's routes (regen=False) and the render route of the same stages
PREVIEW_ROUTES = {"stepped": ("cornell", "regen"), "stepped_prim": ("mesh", "prim")}


@pytest.mark.parametrize("route", list(PREVIEW_ROUTES))
def test_preview_prepare_logs_the_same_stages_in_no_unit(scenes, route):
    sid, stages = PREVIEW_ROUTES[route]
    with _profiled():
        prep = pipeline.prepare_render(scenes[sid], tpt.Resolution(4, 6), "cpu",
                                       regen=False)
    assert prep.route == route
    log = profiling.spans()
    assert_prepare_stages(log, PREP_STAGES[stages])
    assert {s.unit for s in log} == {None}


def _tables_nbytes(prep) -> int:
    """The bytes of the tensors of a Prepared's scene tables (the camera's
    parameters stay on the host)."""
    tables = (prep.scene, prep.portal.scene if prep.portal else None, prep.kscene)
    return sum(v.nbytes for t in tables if t is not None
               for v in (getattr(t, f.name) for f in dataclasses.fields(t))
               if isinstance(v, torch.Tensor))


@pytest.mark.parametrize("route", ["regen", "portal", "prim", "stepped",
                                   "stepped_prim"])
def test_prepare_copy_size_is_its_tables_bytes(scenes, monkeypatch, route):
    if route == "prim":
        monkeypatch.setenv("PT_TPU_NO_PORTAL", "1")
    sid = "cornell" if route in ("regen", "stepped") else "mesh"
    with _profiled():
        prep = pipeline.prepare_render(scenes[sid], tpt.Resolution(4, 6), "cpu",
                                       regen=not route.startswith("stepped"))
    assert prep.route == route
    (copy,) = [s for s in profiling.spans() if s.name == "render.prepare.copy"]
    assert copy.size == _tables_nbytes(prep) > 0


def test_a_render_without_a_profiler_logs_no_span_and_one_load_a_library(
        scenes, monkeypatch):
    monkeypatch.setattr(profiling, "_loads", [])
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    _render(scenes["mesh"], spp=1, res=(4, 6), max_depth=2)  # tiles' Morton codes
    _render(scenes["cornell"], spp=1, res=(4, 6), max_depth=2)
    assert native.load_native() is not None
    assert profiling.spans() == []
    (rec,) = profiling.loads()
    assert rec.stem == "pt_native" and rec.hash_s > 0 and rec.load_s > 0
    assert rec.seconds == rec.hash_s + rec.build_s + rec.load_s


def _reader(repo_root, name):
    spec = importlib.util.spec_from_file_location(
        "bench_" + name.replace(".", "_"),
        os.path.join(repo_root, "bench_torch", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_kernel_build_records_its_load_for_setup_kernels_s(repo_root, tmp_path,
                                                             monkeypatch):
    """``build.build`` appends one record a load, its build seconds those
    of the compile (0 once built), and ``setup_kernels_s`` sums them."""
    src = tmp_path / "k9.cu"
    src.write_text("// a kernel")
    (tmp_path / "scan.cuh").write_text("// a header")

    def compiled(source, flags, out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        open(out, "w").close()
        return 2.5

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_compile", compiled)
    monkeypatch.setattr(build, "ctypes", types.SimpleNamespace(CDLL=lambda p: p))
    monkeypatch.setattr(profiling, "_loads", [])
    reader = _reader(repo_root, "setup_kernels_s")
    assert reader.read(None, None) is None
    first, again = build.build(str(src)), build.build(str(src))
    assert (first.seconds, again.seconds) == (2.5, 0.0)
    a, b = profiling.loads()
    assert (a.stem, a.build_s, b.stem, b.build_s) == ("k9", 2.5, "k9", 0.0)
    assert min(a.hash_s, a.load_s, b.hash_s, b.load_s) > 0
    assert reader.read(None, None) == pytest.approx(a.seconds + b.seconds)


def _rec(name, unit, ms=0.0, size=None, parent=-1):
    return profiling.SpanRecord(name, 1_000, 1_000 + int(ms * 1e6), parent, unit,
                                size)


# two traced renders: the second holds two kernel scenes and two copies,
# and a prepare outside any unit (a preview's) is no render's
SYNTHETIC = [
    _rec("render.prepare", ("render", 0), 12.0),
    _rec("render.prepare.pack", ("render", 0), 1.0, parent=0),
    _rec("render.prepare.kscene", ("render", 0), 10.0, parent=0),
    _rec("render.prepare.copy", ("render", 0), 0.2, 3_000_000, parent=0),
    _rec("render.prepare", ("render", 1), 40.0),
    _rec("render.prepare.pack", ("render", 1), 2.0, parent=4),
    _rec("render.prepare.kscene", ("render", 1), 10.0, parent=4),
    _rec("render.prepare.kscene", ("render", 1), 20.0, parent=4),
    _rec("render.prepare.copy", ("render", 1), 0.25, 5_000_000, parent=4),
    _rec("render.prepare.copy", ("render", 1), 0.15, 1_000_000, parent=4),
    _rec("render.prepare.pack", None, 9.0),
    _rec("render.prepare.copy", None, 9.0, 9_000_000),
]


@pytest.mark.parametrize("name, want", [
    ("prep_pack_ms.render", 1.5), ("prep_kscene_ms.render", 20.0),
    ("prep_copy_ms.render", 0.3), ("prep_copy_mb.render", 4.5)])
def test_prep_readers_read_a_synthetic_log(repo_root, monkeypatch, name, want):
    reader = _reader(repo_root, name)
    assert reader.read(None, None) is None  # an empty log
    monkeypatch.setattr(profiling, "_spans", SYNTHETIC)
    assert reader.read(None, None) == pytest.approx(want)
    monkeypatch.setattr(profiling, "_spans", SYNTHETIC[:1] + SYNTHETIC[4:5])
    assert reader.read(None, None) is None  # renders with no such span


def test_trace_ns_puts_each_span_on_its_profiler_range(scenes):
    """Each span's start and end, mapped by ``trace_ns``, fall within 1 ms
    of its ``pt.*`` range's on the profiler's clock."""
    with _profiled() as prof:
        _render(scenes["mesh"], spp=1, res=(4, 6), max_depth=2)
        _render(scenes["cornell"], spp=1, res=(4, 6), max_depth=2)
    base = prof.profiler.kineto_results.trace_start_ns()
    ranges: dict = {}
    for e in prof.events():
        if e.name.startswith("pt."):
            ranges.setdefault(e.name[3:], []).append(
                (base + 1e3 * e.time_range.start, base + 1e3 * e.time_range.end))
    seen: dict = {}
    log = [s for s in profiling.spans() if s.name in ranges]  # not the notes
    assert len(log) > 20
    for s in log:
        k = seen[s.name] = seen.get(s.name, -1) + 1
        start, end = sorted(ranges[s.name])[k]
        assert abs(profiling.trace_ns(s.start_ns) - start) < 1e6, s.name
        assert abs(profiling.trace_ns(s.end_ns) - end) < 1e6, s.name
