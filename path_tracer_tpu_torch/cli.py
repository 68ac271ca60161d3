"""Headless render CLI.

Counterpart of ``path_tracer_tpu.cli`` with the interface
``spp res_y scene_id|scene_index`` and a ``\\r`` progress line with percent,
elapsed and estimated h:mm:ss. ``--device`` picks the device (default
``cuda``); without CUDA the CLI stops with an error instead of rendering on
the CPU.

Usage:
    python -m path_tracer_tpu_torch.cli [spp] [res_y] [scene] [options]
    python -m path_tracer_tpu_torch.cli 1000 768 cornell
    python -m path_tracer_tpu_torch.cli 8 24 cornell --device cpu
    python -m path_tracer_tpu_torch.cli 1024 768 mesh
    python -m path_tracer_tpu_torch.cli --list-scenes
"""

from __future__ import annotations

import argparse
import sys
import time

from path_tracer_tpu_torch.utils.profiling import format_eta

DEFAULT_SPP = 100
DEFAULT_RES_Y = 300
DEFAULT_SCENE = "cornell"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="path_tracer_tpu_torch",
        description="PyTorch/CUDA path tracer (headless CLI)",
    )
    p.add_argument("spp", nargs="?", type=int, default=DEFAULT_SPP,
                   help=f"samples per pixel (default {DEFAULT_SPP})")
    p.add_argument("res_y", nargs="?", type=int, default=DEFAULT_RES_Y,
                   help=f"vertical resolution; width = res_y*3/2 (default {DEFAULT_RES_Y})")
    p.add_argument("scene", nargs="?", default=DEFAULT_SCENE,
                   help="scene id or numeric index (default cornell)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernel) or cpu (its "
                        "plain torch version); default cuda")
    p.add_argument("--scene-dir", default="scenes")
    p.add_argument("--mesh-dir", default="meshes")
    p.add_argument("--out-dir", default="out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-depth", type=int, default=12)
    p.add_argument("--samples-per-pass", type=int, default=0,
                   help="samples per pixel in one pass (0 = min(spp, 256))")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for resumable renders")
    p.add_argument("--checkpoint-every", type=int, default=8,
                   help="passes between checkpoints (with --checkpoint)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard over N devices (not ported: ROADMAP.md Slice 4)")
    p.add_argument("--daemon", action="store_true",
                   help="resident render daemon (not ported: ROADMAP.md Slice 4)")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--no-validate", action="store_true",
                   help="skip the GUI-parity range checks on spp/res_y")
    p.add_argument("--quiet", action="store_true")
    return p


def resolve_scene(name: str, scene_dir: str, mesh_dir: str):
    from path_tracer_tpu_torch.models.scenes import load_scene, load_scene_ids

    ids = load_scene_ids(scene_dir, mesh_dir)
    if name.isdigit() and name not in ids:
        idx = int(name)
        if not 0 <= idx < len(ids):
            raise SystemExit(f"scene index {idx} out of range (have {len(ids)})")
        name = ids[idx]
    if name not in ids:
        raise SystemExit(f"unknown scene {name!r}; available: {', '.join(ids)}")
    return load_scene(name, scene_dir, mesh_dir)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.daemon:
        raise NotImplementedError("--daemon is ported in ROADMAP.md Slice 4")
    if args.devices:
        raise NotImplementedError("--devices is ported in ROADMAP.md Slice 4")

    from path_tracer_tpu_torch.models.scenes import load_scene_ids
    from path_tracer_tpu_torch.render.pipeline import render, resolve_device
    from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution

    if args.list_scenes:
        for i, sid in enumerate(load_scene_ids(args.scene_dir, args.mesh_dir)):
            print(f"{i}: {sid}")
        return 0

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"error: {e}") from None

    scene = resolve_scene(args.scene, args.scene_dir, args.mesh_dir)
    config = RenderConfig(
        samples_per_pixel=args.spp,
        resolution=Resolution.from_height(args.res_y),
        seed=args.seed,
        max_depth=args.max_depth,
        samples_per_pass=args.samples_per_pass,
        validate=not args.no_validate,
    )

    t0 = time.perf_counter()

    def progress(update):
        # parity with cmd_render.rs:54-80: \r percent + elapsed/eta h:mm:ss
        if args.quiet:
            return
        pct = update.progress * 100.0
        elapsed = time.perf_counter() - t0
        eta = elapsed / max(update.progress, 1e-9)
        sys.stderr.write(
            f"\rRendering... {pct:5.1f}%  elapsed {format_eta(elapsed)}"
            f" / estimated {format_eta(eta)}   "
        )
        sys.stderr.flush()

    done = render(
        scene,
        config,
        device=device,
        progress=progress,
        progress_snapshots=False,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        out_dir=args.out_dir,
        verbose=not args.quiet,
    )
    if not args.quiet:
        sys.stderr.write("\n")
        s = done.stats
        print(
            f"Done in {done.duration:.2f} s on {device} —"
            f" {s.msamples_per_sec:.1f} Msamples/s,"
            f" {s.mrays_per_sec:.1f} Mrays/s ({s.num_rays} rays,"
            f" {s.num_dispatches} dispatches)"
        )
        if done.ppm_path:
            print(f"Wrote {done.ppm_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
