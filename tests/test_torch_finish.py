"""render()'s finish on every route: the image is put in pixel order on
the device before its copy to the host, and its digest runs on the digest
worker (``utils.hashing.digest_later``) while the caller goes on.

Each lane route (regen, prim, wavefront) keeps accum a row a lane in
Morton order, and its images must equal the host gather of the finalized
rows by the inverse permutation, bit for bit; the portal route's rows are
in pixel order already. The digest's value is ``hash_image(pixels)`` (FNV-1a
where the native runtime is built), and every render's digest runs, read
or not.
"""

import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as tpt
from path_tracer_tpu_torch import native
from path_tracer_tpu_torch.render import integrator
from path_tracer_tpu_torch.render.image import Image
from path_tracer_tpu_torch.render.pipeline import morton_pixel_order
from path_tracer_tpu_torch.utils import hashing
from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)
from tests.test_torch_render import ROUTES, _route

RES = tpt.Resolution(12, 18)


@pytest.fixture()
def finals(monkeypatch):
    """Every ``integrator.finalize`` output of the test's renders, in the
    order of the calls: the rows the image of each is made from."""
    got = []
    finalize = integrator.finalize

    def kept(*a, **k):
        out = finalize(*a, **k)
        got.append(out.clone())
        return out

    monkeypatch.setattr(integrator, "finalize", kept)
    return got


def _host_order(route, rows: torch.Tensor) -> np.ndarray:
    """``rows`` in pixel order as the host put them before: a lane route's
    through the inverse of the Morton permutation, the portal's as they
    are."""
    arr = rows.numpy()
    if route == "portal":
        return arr
    perm = morton_pixel_order(RES.width, RES.height)[0]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return arr[inv]


def _assert_hashed(image):
    assert not image.pixels.flags.writeable
    assert image.hash == hashing.hash_image(image.pixels)
    if native.native_available():
        assert image.hash == hashing.fnv1a(image.pixels.tobytes())


@pytest.mark.parametrize("route", list(ROUTES))
def test_final_image_is_the_host_gather_of_its_rows(repo_root, monkeypatch,
                                                    finals, route):
    scene, kw = _route(repo_root, route, monkeypatch)
    cfg = tpt.RenderConfig(samples_per_pixel=4, resolution=RES, seed=7, **kw)
    done = tpt.render(scene, cfg, device="cpu", out_dir=None, verbose=False)
    assert done.stats.extra["route"] == route and len(finals) == 1
    np.testing.assert_array_equal(done.image.pixels,
                                  _host_order(route, finals[0]))
    _assert_hashed(done.image)


@pytest.mark.parametrize("route", list(ROUTES))
def test_snapshots_and_checkpoint_keep_their_orders(repo_root, tmp_path,
                                                    monkeypatch, finals, route):
    """Cancelled after the first of two passes: every progress image made
    from finalized rows is their host gather, and the pass-boundary
    checkpoint keeps accum in the runner's row order, so that its rows,
    finalized, are the rows the snapshot and the final image came from."""
    scene, kw = _route(repo_root, route, monkeypatch)
    monkeypatch.setenv("PT_TPU_CKPT_SECS", "3600")  # no portal pass pauses
    ck = tmp_path / "ck.npz"
    updates, checked = [], []

    def progress(u):
        # an image made from finalized rows: a finalize ran since the last
        # update (the portal's poll snapshots come from the pass's buffers)
        if u.image is not None and len(finals) > sum(checked):
            np.testing.assert_array_equal(u.image.pixels,
                                          _host_order(route, finals[-1]))
            _assert_hashed(u.image)
        checked.append(len(finals) - sum(checked))
        updates.append(u)

    cfg = tpt.RenderConfig(samples_per_pixel=8, samples_per_pass=4,
                           resolution=RES, seed=3, **kw)
    done = tpt.render(scene, cfg, device="cpu", progress=progress,
                      progress_interval=0.0,
                      cancel=lambda: any(u.samples_done for u in updates),
                      checkpoint_path=str(ck), checkpoint_every=1,
                      out_dir=None, verbose=False)
    assert done.cancelled and done.stats.num_samples == 4 * RES.num_pixels
    snaps = [u for u in updates if u.image is not None and u.samples_done == 4]
    assert snaps
    with np.load(ck) as z:
        assert int(z["samples_done"]) == 4
        rows = integrator.finalize(
            torch.from_numpy(z["accum"][:RES.num_pixels]), 4)
    # every finalize after the first pass saw the rows the file holds
    assert len(finals) >= 2
    for got in finals:
        np.testing.assert_array_equal(got.numpy(), rows.numpy())
    np.testing.assert_array_equal(done.image.pixels, _host_order(route, rows))
    np.testing.assert_array_equal(snaps[-1].image.pixels, done.image.pixels)
    _assert_hashed(done.image)


def _slow_digest(monkeypatch):
    """hash_image held until the returned event is set."""
    gate = threading.Event()
    real = hashing.hash_image

    def held(px):
        assert gate.wait(30)
        return real(px)

    monkeypatch.setattr(hashing, "hash_image", held)
    return gate


def test_reading_the_hash_waits_for_its_digest(monkeypatch):
    px = np.random.default_rng(0).random((24, 3), dtype=np.float32)
    want = hashing.hash_image(px)
    gate = _slow_digest(monkeypatch)
    img = Image.new(px, tpt.Resolution(4, 6))
    assert not img.digest.done()
    timer = threading.Timer(0.2, gate.set)
    timer.start()
    t0 = time.perf_counter()
    got = img.hash
    waited = time.perf_counter() - t0
    timer.join(5)
    assert got == want == img.hash and waited >= 0.1
    # a read after the digest is done waits for nothing
    again = Image.new(px, tpt.Resolution(4, 6))
    again.digest.result(timeout=30)
    assert again.hash == want


def test_every_render_digests_its_image_unread(repo_root, monkeypatch):
    """Each render hands its image to the worker, and the digests run one
    at a time in the order the renders finished, though no ``hash`` is
    read."""
    scene, _ = _route(repo_root, "regen", monkeypatch)
    real = hashing.hash_image
    sizes, running, most = [], [0], [0]
    guard = threading.Lock()

    def counted(px):
        with guard:
            running[0] += 1
            most[0] = max(most[0], running[0])
        time.sleep(0.02)  # long enough for a second digest to overlap
        sizes.append(px.shape[0])
        with guard:
            running[0] -= 1
        return real(px)

    monkeypatch.setattr(hashing, "hash_image", counted)
    shapes = [(4, 6), (6, 8), (8, 10)]
    dones = [tpt.render(scene, tpt.RenderConfig(
                 samples_per_pixel=1, resolution=tpt.Resolution(*hw),
                 max_depth=2), device="cpu", out_dir=None, verbose=False)
             for hw in shapes]
    _, pending = concurrent.futures.wait([d.image.digest for d in dones],
                                         timeout=30)
    assert not pending
    assert sizes == [h * w for h, w in shapes] and most[0] == 1
    assert all(d.image.digest.result() == real(d.image.pixels) for d in dones)


def test_a_digest_that_raised_re_raises_on_read(repo_root, monkeypatch):
    scene, _ = _route(repo_root, "regen", monkeypatch)

    def broken(px):
        raise ValueError("digest failed")

    monkeypatch.setattr(hashing, "hash_image", broken)
    done = tpt.render(scene, tpt.RenderConfig(
        samples_per_pixel=1, resolution=tpt.Resolution(4, 6), max_depth=2),
        device="cpu", out_dir=None, verbose=False)
    for _ in range(2):
        with pytest.raises(ValueError, match="digest failed"):
            done.image.hash
