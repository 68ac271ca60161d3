"""The port's spans (``utils.profiling``) on the CPU, and the
kernel launch count ``RenderStats.num_dispatches`` on every route.

Spans are on only while a torch profiler runs: then each names the host's
work on the profiler's timeline as a ``pt.*`` range (a plain host range,
not a user annotation, so the device timeline holds none) and lands in the
span log with its parent and unit.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch.ops.kernels import trace_kernel as t_tk
from path_tracer_tpu_torch.ops.kernels import trace_v2 as t_v2
from path_tracer_tpu_torch.render import integrator as t_int
from path_tracer_tpu_torch.render import portal as t_rp
from path_tracer_tpu_torch.utils import profiling
from path_tracer_tpu_torch.viewer.progressive import ProgressiveRenderer
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

RENDER_SPANS = ["render", "render.prepare", "render.upload", "render.pass",
                "render.check.wait", "render.pass", "render.check.wait",
                "render.wait", "render.fetch", "render.finish"]
# the log of a render: its spans, then the note of its digest's hand-off
RENDER_LOG = RENDER_SPANS + ["render.digest"]


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
    assert [s.name for s in one] == RENDER_LOG
    assert [s.name for s in log[first:]] == RENDER_LOG
    assert len({s.unit for s in one}) == 1 and one[0].unit[0] == "render"
    assert log[first].unit != one[0].unit
    parents = {s.name: one[s.parent].name if s.parent >= 0 else None for s in one}
    assert parents == {"render": None, "render.prepare": "render",
                       "render.upload": "render", "render.pass": "render",
                       "render.check.wait": "render.pass", "render.wait": "render",
                       "render.fetch": "render", "render.finish": "render",
                       "render.digest": "render.finish"}
    for s in one:
        assert one[0].start_ns <= s.start_ns <= s.end_ns <= one[0].end_ns
        if s.parent >= 0:
            p = one[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert [s.size for s in one if s.name == "render.pass"] == [1, 1]
    # one digest a render, of the frame's float32 bytes, read by no one
    assert [(s.size, s.tag) for s in one if s.name == "render.digest"] == \
        [(4 * 6 * 3 * 4, None)]
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
