"""Image container and PPM output.

Parity with ``mod.rs:1031-1089`` (C14):

- output dir ``out/``, filename ``{timestamp}-scene-{id}-spp{n}-res{h}-.ppm``;
- ASCII P3 with two comment header lines (spp/res/scene, rendering seconds);
- pixels written in REVERSE index order, each as ``r g b `` (trailing space);
- gamma-2.2 quantization with +0.5 floor rounding;
- best-effort ``latest.ppm`` symlink.

The framebuffer is a flat [W*H, 3] float32 array indexed like the reference's
``pixels`` vec (pixel_index → y = H-1-idx/W, x = idx%W).

Counterpart of ``path_tracer_tpu.render.image``; the PPM bytes are equal.
"""

from __future__ import annotations

import os
from concurrent.futures import Future
from dataclasses import dataclass
from datetime import datetime

import numpy as np

from path_tracer_tpu_torch.ops.tonemap import quantize_np
from path_tracer_tpu_torch.utils.config import Resolution
from path_tracer_tpu_torch.utils.hashing import digest_later


@dataclass
class Image:
    pixels: np.ndarray  # [W*H, 3] float32 in [0,1], read-only: it is hashed
    resolution: Resolution
    digest: Future  # of hash_image(pixels), on the digest worker

    @staticmethod
    def new(pixels: np.ndarray, resolution: Resolution) -> "Image":
        """The image of ``pixels``, whose digest is handed to the worker
        (``hashing.digest_later``) and read through ``hash``."""
        pixels = np.asarray(pixels, np.float32).reshape(-1, 3)
        pixels.flags.writeable = False
        return Image(pixels, resolution, digest_later(pixels))

    @property
    def hash(self) -> int:
        """``hash_image(pixels)``: waits for the digest if it is still
        running, and re-raises what it raised."""
        return self.digest.result()

    def to_grid(self) -> np.ndarray:
        """[H, W, 3] in display orientation (row 0 = PPM row 0)."""
        h, w = self.resolution.height, self.resolution.width
        return self.pixels.reshape(h, w, 3)[::-1, ::-1, :]


def _encode_ascii_ints(v: np.ndarray) -> bytes:
    """``b"%d %d ... "`` for a flat array of ints in [0, 999]: digit-scatter
    into one preallocated byte buffer. ~50x faster than a Python join at
    framebuffer sizes (a 1024x768 frame is 2.4M values), and byte-identical."""
    v = v.astype(np.int32).ravel()
    lens = np.where(v >= 100, 4, np.where(v >= 10, 3, 2))  # digits + space
    starts = np.cumsum(lens) - lens
    out = np.full(int(starts[-1] + lens[-1]) if v.size else 0, 32, np.uint8)
    last = starts + lens - 2  # position of the ones digit
    out[last] = 48 + v % 10
    m = v >= 10
    out[last[m] - 1] = 48 + (v[m] // 10) % 10
    m = v >= 100
    out[starts[m]] = 48 + v[m] // 100
    return out.tobytes()


def ppm_body(pixels: np.ndarray, reverse: bool = True) -> bytes:
    """Gamma-quantized ``r g b `` triplets (reverse index order by default)."""
    q = quantize_np(np.asarray(pixels, np.float32).reshape(-1, 3))
    if reverse:
        q = q[::-1]
    return _encode_ascii_ints(q)


def write_ppm(
    image: Image,
    scene_id: str,
    spp: int,
    render_seconds: float,
    out_dir: str = "out",
    timestamp: datetime | None = None,
    make_symlink: bool = True,
) -> str:
    os.makedirs(out_dir, exist_ok=True)
    ts = (timestamp or datetime.now()).strftime("%Y-%m-%d_%H:%M:%S")
    res = image.resolution
    path = os.path.join(out_dir, f"{ts}-scene-{scene_id}-spp{spp}-res{res.height}-.ppm")
    header = (
        b"P3\n"
        + f"# samplesPerPixel: {spp}, resolution_y: {res.height}, scene_id: {scene_id}\n".encode()
        + f"# rendering time: {int(render_seconds)} s\n".encode()
        + f"{res.width} {res.height}\n255\n".encode()
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(ppm_body(image.pixels, reverse=True))

    if make_symlink:
        link = "latest.ppm"
        try:
            if os.path.lexists(link):
                os.remove(link)
            os.symlink(path, link)
        except OSError:
            print(f"Could not create symlink to latest image. You can find it at {path}")
    return path


def read_ppm(path: str) -> tuple[np.ndarray, int, int]:
    """Parse ASCII P3 → (int array [H*W, 3] in FILE order, width, height)."""
    with open(path, "rb") as f:
        tokens = []
        for line in f.read().split(b"\n"):
            line = line.split(b"#")[0]
            tokens.extend(line.split())
    if tokens[0] != b"P3":
        raise ValueError("not an ASCII P3 PPM")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int32)
    return vals.reshape(-1, 3), w, h
