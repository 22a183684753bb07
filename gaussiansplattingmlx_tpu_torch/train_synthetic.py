"""End-to-end training on a procedural scene (PyTorch + CUDA), the
counterpart of the JAX package's ``scripts/train_synthetic_tpu.py``: the
small version of the flagship campaign (``train_flagship.py``).

Builds a ground-truth cloud of fittable blobs, renders a multi-view dataset
with the port's own renderer (``train_flagship.render_ground_truth``), then
trains from a noisy copy of its points and reports PSNR over iterations.

    python -m gaussiansplattingmlx_tpu_torch.train_synthetic --iters 1500 \\
        --views 24 --size 256 [--densify] [--device cuda]

The flags and their defaults are the JAX script's, plus ``--device``
(default cuda; a missing CUDA device is an error, ``cpu`` runs the kernels'
plain versions).  ``main(argv)`` returns a ``SyntheticRun``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List

import numpy as np
import torch

from .config import DensifyConfig, ModelConfig, RasterizerConfig, TrainConfig
from .data.dataset import TrainData
from .models import gaussians
from .render import resolve_backend
from .train.trainer import Trainer, resolve_device
from .train_flagship import render_ground_truth
from .utils.camera import Camera, orbit_c2w
from .utils.point_cloud import PointCloud


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--gaussians", type=int, default=1200)
    ap.add_argument("--sh-degree", type=int, default=2)
    ap.add_argument("--backend", default=None,
                    help="rasterizer backend: auto | pallas (the port's kernels "
                         "on CUDA, their plain versions on the CPU) | reference "
                         "(the oracle rasterizer, plain torch)")
    ap.add_argument("--densify", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; a CUDA device that is "
                         "missing is an error; cpu runs the plain versions)")
    return ap.parse_args(argv)


def ring_cameras(views: int, size: int) -> List[Camera]:
    """``views`` cameras on a radius-4 ring around the origin whose height
    swings by 0.35, focal 1.1 x ``size``."""
    angles = 2 * np.pi * np.arange(views) / views
    return [Camera.from_c2w(size, size, 1.1 * size, 1.1 * size,
                            orbit_c2w(ang, 4.0, 0.35 * np.sin(3 * ang))) for ang in angles]


@dataclasses.dataclass
class SyntheticRun:
    images: np.ndarray  # [V, H, W, 3] ground truth
    history: list  # every logged metrics dict
    final: dict
    trainer: Trainer


def main(argv=None) -> SyntheticRun:
    args = parse_args(argv)
    if args.backend is not None:
        resolve_backend(args.backend)
    device = resolve_device(args.device)
    W = H = args.size
    rng = np.random.default_rng(0)

    # Ground-truth scene: a cloud of visible, fittable blobs (sizes well
    # above a pixel, opacities in a recoverable range).
    n = args.gaussians
    centers = rng.normal(size=(8, 3)) * 0.6
    pts = (centers[rng.integers(0, 8, n)] + rng.normal(size=(n, 3)) * 0.15).astype(np.float32)
    cols = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    gt_params, _ = gaussians.create_from_points(pts, cols, sh_degree=args.sh_degree,
                                                capacity=n, device=device)
    with torch.no_grad():
        gt_params.scales.copy_(torch.as_tensor(
            np.log(rng.uniform(0.04, 0.12, size=(n, 3))).astype(np.float32)))
        gt_params.opacity.copy_(torch.as_tensor(
            rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)))

    raster = RasterizerConfig(max_pairs=2**17)
    cams = ring_cameras(args.views, W)

    print("rendering ground-truth views ...", flush=True)
    t0 = time.time()
    images, _, _ = render_ground_truth(gt_params, cams, W, H, args.sh_degree, raster,
                                       args.backend)
    print(f"rendered {args.views} views in {time.time()-t0:.1f}s "
          f"(mean {images.mean():.3f}, std {images.std():.3f})", flush=True)

    # Train from a perturbed cloud (noise well under the blob scale so the
    # problem is fittable).
    noisy = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.01
    pcd = PointCloud(coords=noisy, colors=cols * 255.0)
    densify_cfg = (
        DensifyConfig(interval=100, from_iter=300, until_iter=args.iters)
        if args.densify
        else DensifyConfig(from_iter=10**9)
    )
    cfg = TrainConfig(
        iterations=args.iters,
        init_points=n,
        log_interval=50,
        snapshot_interval=10**9 if not args.out else 500,
        checkpoint_interval=0,
        output_dir=args.out,
        early_stop_loss=1e-7,
        model=ModelConfig(sh_degree=args.sh_degree, initial_capacity=max(4096, n)),
        raster=raster,
        densify=densify_cfg,
    )
    trainer = Trainer(cfg, TrainData(cameras=cams, images=images), pcd, device=device,
                      backend=args.backend)

    t0 = time.time()
    history = []

    def on_metrics(m):
        history.append(m)
        print(f"iter {m['iteration']:5d} loss {m['loss']:.4f} psnr {m['psnr']:.2f} "
              f"n {m['num_active']} {m['iters_per_s']:.2f} it/s", flush=True)

    final = trainer.run(on_metrics=on_metrics)
    wall = time.time() - t0
    print(f"\ntrained {int(trainer.state.step)} iters in {wall:.1f}s "
          f"({int(trainer.state.step)/wall:.2f} it/s avg)")
    print(f"first psnr {history[0]['psnr']:.2f} -> final psnr {final['psnr']:.2f}")
    return SyntheticRun(images=images, history=history, final=final, trainer=trainer)


if __name__ == "__main__":
    main(sys.argv[1:])
