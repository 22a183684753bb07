"""Evaluation CLI (PyTorch + CUDA), the counterpart of the JAX package's
``eval.py``, with its flags plus ``--device``: render every dataset view
(or ``--views``) from a PLY snapshot and report PSNR / SSIM / L1.

    python -m gaussiansplattingmlx_tpu_torch.eval_cli --dataset colmap \\
        --root /path/to/scene --ply outputs/run/iteration_30000.ply \\
        --resize-factor 0.5 [--device cuda]

The cloud is centered and the cameras shifted as training does them; the
views render through the inference path (``render(..., inference=True)``)
at the configured pair budget, which is not resized here.  ``main(argv)``
returns an ``EvalResult`` that also carries each view's pair count and
overflow: an overflowing view is a truncated render.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .config import RasterizerConfig
from .data import ply as ply_mod
from .models.gaussians import activations, params_from_numpy
from .ops import losses, ssim
from .render import render, resolve_backend
from .train.trainer import resolve_device
from .train_cli import LOADERS
from .utils.png import write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["colmap", "blender", "nerfstudio"],
                   required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--ply", required=True)
    p.add_argument("--resize-factor", type=float, default=0.5)
    p.add_argument("--white-background", action="store_true")
    p.add_argument("--backend", default=None,
                   help="rasterizer backend: auto | pallas (the port's kernels "
                        "on CUDA) | reference (the oracle rasterizer)")
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--tile", type=int, default=None)
    p.add_argument("--save-renders", default=None)
    p.add_argument("--no-center", action="store_true")
    p.add_argument("--views", default=None,
                   help="comma-separated view indices to evaluate (e.g. the "
                        "held-out views of a train/test split); default: all")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; a CUDA "
                        "device that is missing is an error)")
    return p.parse_args(argv)


@dataclasses.dataclass
class EvalResult:
    metrics: dict  # the JSON line eval.py prints
    num_pairs: list  # per evaluated view
    overflow_pairs: list  # per evaluated view
    colors: list  # [H, W, 3] float32 numpy per evaluated view


def main(argv=None) -> EvalResult:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = RasterizerConfig()
    if args.max_pairs:
        cfg = dataclasses.replace(cfg, max_pairs=args.max_pairs)
    if args.tile:
        cfg = dataclasses.replace(cfg, tile_h=args.tile, tile_w=args.tile)
    if args.backend is not None:
        resolve_backend(args.backend)  # an unknown name raises before any work

    data, pcd = LOADERS[args.dataset](
        args.root, resize_factor=args.resize_factor, white_background=args.white_background)
    if not args.no_center:
        # Evaluation must see the camera shift used at training time.
        pcd, centroid = pcd.centering()
        data = data.shift_cameras(centroid)

    params = params_from_numpy(ply_mod.read_gaussian_ply(args.ply), device)
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(params)

    out_dir = Path(args.save_renders) if args.save_renders else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)

    view_ids = ([int(v) for v in args.views.split(",")] if args.views
                else list(range(len(data.cameras))))
    result = EvalResult(metrics={}, num_pairs=[], overflow_pairs=[], colors=[])
    psnrs, ssims, l1s = [], [], []
    for i in view_ids:
        t = data.cameras[i].tensors()
        cam = [torch.as_tensor(np.asarray(t[k])).to(device)
               for k in ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x",
                         "focal_y")]
        with torch.no_grad():
            out, aux = render(means, shs, opacity, scales, rots, *cam, data.width,
                              data.height, params.sh_degree, raster_cfg=cfg,
                              white_background=args.white_background, inference=True,
                              backend=args.backend)
            color = out.color
            target = torch.as_tensor(data.images[i]).to(device)
            psnrs.append(float(losses.psnr(color, target)))
            ssims.append(float(ssim.ssim(color, target)))
            l1s.append(float(losses.l1_loss(color, target)))
        color = color.cpu().numpy()
        result.colors.append(color)
        result.num_pairs.append(int(aux.num_pairs))
        result.overflow_pairs.append(int(aux.overflow_pairs))
        if out_dir:
            write_png(out_dir / f"eval_{i:03d}.png",
                      np.clip(color * 255.0, 0, 255).astype(np.uint8))
        print(f"view {i:3d}: psnr {psnrs[-1]:.2f} ssim {ssims[-1]:.4f}")

    result.metrics = {
        "psnr_mean": float(np.mean(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
        "l1_mean": float(np.mean(l1s)),
        "views": len(psnrs),
        "per_view_psnr": [round(p, 2) for p in psnrs],
        "view_ids": view_ids,
    }
    print(json.dumps(result.metrics))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
