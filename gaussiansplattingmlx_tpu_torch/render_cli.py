"""Inference renderer CLI (PyTorch + CUDA): loads a Gaussian PLY and renders
orbit cameras to PNGs.

    python -m gaussiansplattingmlx_tpu_torch.render_cli --ply scene.ply \\
        --orbit 4 --width 800 --height 800 [--bench-frames 16] [--device cuda]

Counterpart of the JAX package's ``render_cli.py``.  ``main(argv)`` returns a
``CliResult`` so that tests and scripts can check what was rendered.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import RasterizerConfig
from .data import ply as ply_mod
from .models.gaussians import activations, params_from_numpy
from .render import render, render_many, resolve_backend
from .utils.camera import Camera
from .utils.gif import write_gif
from .utils.png import write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ply", required=True)
    p.add_argument("--out", default="renders")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--focal", type=float, default=None,
                   help="focal length in pixels (default 1.2*width)")
    p.add_argument("--orbit", type=int, default=8,
                   help="number of orbit cameras around the scene")
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--elevation", type=float, default=0.2)
    p.add_argument("--white-background", action="store_true")
    p.add_argument("--backend", default=None,
                   help="rasterizer backend: auto | pallas (the port's kernels "
                        "on CUDA) | reference (the oracle rasterizer: "
                        "O(pixels x pairs), small renders only)")
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--tile", type=int, default=None)
    p.add_argument("--depth", action="store_true", help="also save depth maps")
    p.add_argument("--video", default=None,
                   help="write an animated turntable (GIF, fixed 252-colour "
                        "palette) to this path; --orbit sets the frame count")
    p.add_argument("--video-fps", type=int, default=30)
    p.add_argument("--no-auto-pairs", action="store_true",
                   help="disable the probe-based pair-budget sizing "
                        "(use the --max-pairs budget verbatim)")
    p.add_argument("--bench-frames", type=int, default=0,
                   help="after rendering, loop this many frames back-to-back "
                        "and report sustained rendered frames/s")
    p.add_argument("--bench-batch", type=int, default=8,
                   help="cameras per render_many call in the bench")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; a CUDA "
                        "device that is missing is an error)")
    return p.parse_args(argv)


def orbit_c2w(angle: float, radius: float, elevation: float) -> np.ndarray:
    pos = np.array([radius * np.sin(angle), elevation, -radius * np.cos(angle)])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, fwd, pos
    return c2w


@dataclasses.dataclass
class CliResult:
    device: str
    colors: list  # [H, W, 3] float32 numpy per orbit view
    num_pairs: list  # per orbit view
    overflow_pairs: list  # per orbit view
    max_pairs: int  # final pair budget
    bench_fps: float | None = None
    bench_frames: int = 0
    bench_overflow_pairs: int = 0


def _resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> CliResult:
    args = parse_args(argv)
    device = _resolve_device(args.device)
    if args.backend is not None:
        resolve_backend(args.backend)  # an unknown name raises before any work

    g = ply_mod.read_gaussian_ply(args.ply)
    n = g.xyz.shape[0]
    print(f"loaded {n} gaussians, SH rest {g.features_rest.shape[1]}", flush=True)
    params = params_from_numpy(g, device)
    sh_degree = params.sh_degree
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(params)

    focal = args.focal if args.focal else 1.2 * args.width
    cfg = RasterizerConfig()
    if args.max_pairs:
        cfg = dataclasses.replace(cfg, max_pairs=args.max_pairs)
    if args.tile:
        cfg = dataclasses.replace(cfg, tile_h=args.tile, tile_w=args.tile)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def cam_tensors(i, n_frames):
        cam = Camera.from_c2w(
            args.width, args.height, focal, focal,
            orbit_c2w(2 * np.pi * i / n_frames, args.radius, args.elevation),
        )
        t = cam.tensors()
        return tuple(
            torch.as_tensor(np.asarray(t[k])).to(device)
            for k in ("view", "proj", "camera_center", "fov_x", "fov_y",
                      "focal_x", "focal_y")
        )

    def render_view(cam):
        view, proj, center, fovx, fovy, fx, fy = cam
        return render(
            means, shs, opacity, scales, rots, view, proj, center,
            fovx, fovy, fx, fy, args.width, args.height, sh_degree,
            raster_cfg=cfg, white_background=args.white_background,
            inference=True, backend=args.backend,
        )

    def render_checked(cam):
        """A clipped pair budget doubles max_pairs and re-renders: never a
        truncated frame."""
        nonlocal cfg
        out, aux = render_view(cam)
        while int(aux.overflow_pairs) > 0 and cfg.max_pairs < cfg.max_pairs_limit:
            cfg = dataclasses.replace(
                cfg, max_pairs=min(cfg.max_pairs * 2, cfg.max_pairs_limit))
            print(f"pair-budget overflow: growing max_pairs to {cfg.max_pairs}",
                  flush=True)
            out, aux = render_view(cam)
        return out, aux

    if not args.no_auto_pairs:
        # Every staging stage pays for the full static budget, so size it to
        # the peak of a few probe views plus headroom, in 512-slot quanta
        # (the JAX package's merge block, kept so budgets match).
        n_frames = max(args.orbit, args.bench_frames, 1)
        probe_idx = sorted({int(i) for i in
                            np.linspace(0, n_frames - 1, min(4, n_frames))})
        peak = 0
        for i in probe_idx:
            _, aux = render_view(cam_tensors(i, n_frames))
            peak = max(peak, int(aux.num_pairs) + int(aux.overflow_pairs))
        quantum = max(512, cfg.chunk_size)
        snug = max(quantum, -(-int(peak * 1.25) // quantum) * quantum)
        snug = min(snug, cfg.max_pairs_limit)
        if snug != cfg.max_pairs:
            print(f"auto pair budget: peak {peak} pairs over {len(probe_idx)} "
                  f"probe views -> max_pairs {snug} (was {cfg.max_pairs})",
                  flush=True)
            cfg = dataclasses.replace(cfg, max_pairs=snug)

    result = CliResult(device=str(device), colors=[], num_pairs=[],
                       overflow_pairs=[], max_pairs=cfg.max_pairs)
    frames = []
    for i in range(args.orbit):
        out, aux = render_checked(cam_tensors(i, args.orbit))
        color = out.color.cpu().numpy()
        result.colors.append(color)
        result.num_pairs.append(int(aux.num_pairs))
        result.overflow_pairs.append(int(aux.overflow_pairs))
        img = np.clip(color * 255.0, 0, 255).astype(np.uint8)
        frames.append(img)
        write_png(out_dir / f"render_{i:03d}.png", img)
        if args.depth:
            d = out.depth.cpu().numpy()
            d = (d / max(float(d.max()), 1e-6) * 255.0).astype(np.uint8)
            write_png(out_dir / f"depth_{i:03d}.png", d)
        print(f"wrote render_{i:03d}.png ({result.num_pairs[-1]} pairs)", flush=True)
    result.max_pairs = cfg.max_pairs

    if args.video:
        write_gif(args.video, frames, max(1, round(1000 / args.video_fps)))
        print(f"wrote {args.video} ({len(frames)} frames @ {args.video_fps} fps)")

    if args.bench_frames > 0:
        B = max(1, min(args.bench_batch, args.bench_frames))
        n_frames = -(-args.bench_frames // B) * B  # round up to full batches

        def stacked_batch(b):
            cams = [cam_tensors(i, n_frames) for i in range(b * B, (b + 1) * B)]
            return tuple(torch.stack([c[k] for c in cams]) for k in range(7))

        batches = [stacked_batch(b) for b in range(n_frames // B)]
        for _ in range(2):
            def run(bt):
                view, proj, center, fovx, fovy, fx, fy = bt
                return render_many(
                    means, shs, opacity, scales, rots, view, proj, center,
                    fovx, fovy, fx, fy, args.width, args.height, sh_degree,
                    raster_cfg=cfg, white_background=args.white_background,
                    backend=args.backend,
                )

            run(batches[0])  # warm-up
            _sync(device)
            t0 = time.perf_counter()
            audits = [run(bt)[3] for bt in batches]
            _sync(device)
            dt = time.perf_counter() - t0
            # Overflow audit outside the timed region: a truncated frame must
            # never back a frames/s figure.  Grow once and re-run if clipped.
            clipped = int(sum(int(a.sum()) for a in audits))
            if clipped == 0 or cfg.max_pairs >= cfg.max_pairs_limit:
                break
            cfg = dataclasses.replace(
                cfg, max_pairs=min(cfg.max_pairs * 2, cfg.max_pairs_limit))
            print(f"bench overflow ({clipped} pairs clipped): growing max_pairs "
                  f"to {cfg.max_pairs}, re-running", flush=True)
        result.bench_fps = n_frames / dt
        result.bench_frames = n_frames
        result.bench_overflow_pairs = clipped
        result.max_pairs = cfg.max_pairs
        print(f"rendered {n_frames} frames at {args.width}x{args.height} on "
              f"{device}: {result.bench_fps:.2f} frames/s "
              f"({1e3 * dt / n_frames:.2f} ms/frame)", flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
