"""Training CLI (PyTorch + CUDA), the counterpart of the JAX package's
``train.py``, with its flags and defaults plus ``--device``:

    python -m gaussiansplattingmlx_tpu_torch.train_cli --dataset colmap \\
        --root /path/to/scene --iterations 30000 --resize-factor 0.5 \\
        --output outputs/lego [--device cuda]

Dataset formats: colmap (sparse/0/*.bin + images/), blender (info.json),
nerfstudio (transforms.json).  Metrics stream to stdout and metrics.csv;
config.json, PLY snapshots, npz checkpoints, previews and loss_curve.png
land in --output.  ``main(argv)`` returns a ``TrainResult``.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

from .config import TrainConfig
from .data import blender, colmap, nerfstudio
from .train.trainer import Trainer
from .utils.camera import spatial_lr_scale_auto

LOADERS = {
    "colmap": colmap.load_colmap,
    "blender": blender.load_blender,
    "nerfstudio": nerfstudio.load_nerfstudio,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["colmap", "blender", "nerfstudio"],
                   required=True)
    p.add_argument("--root", required=True, help="dataset root directory")
    p.add_argument("--fetch-demo", choices=["lego", "chair"], default=None,
                   help="download this demo scene into --root first (needs "
                        "network access; not ported)")
    p.add_argument("--output", default="outputs/run", help="output directory")
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--resize-factor", type=float, default=0.5)
    p.add_argument("--init-points", type=int, default=16384)
    p.add_argument("--sh-degree", type=int, default=4)
    p.add_argument("--sh-warmup", type=int, default=0,
                   help="INRIA-style SH warmup: rest band d trains from iter "
                        "d*N (0 = reference behaviour, all bands from iter 0)")
    p.add_argument("--white-background", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default=None,
                   help="rasterizer backend: pallas | auto (the port's kernels "
                        "on CUDA, their plain versions on the CPU)")
    p.add_argument("--config", default=None, help="TrainConfig JSON file")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    p.add_argument("--max-gaussians", type=int, default=1_000_000)
    p.add_argument("--lambda-depth", type=float, default=None)
    p.add_argument("--no-center", action="store_true",
                   help="skip point-cloud centering")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="views per step across devices (not ported: 1 only)")
    p.add_argument("--tile-parallel", type=int, default=None,
                   help="pixel-row bands per view across devices (not "
                        "ported: 1 only)")
    p.add_argument("--opacity-reset-interval", type=int, default=None,
                   help="INRIA-style periodic opacity reset every N iters "
                        "(0 = off, the reference behaviour); recommended "
                        "3000 on large-extent / sky scenes")
    p.add_argument("--prune-world-scale", type=float, default=None,
                   help="prune gaussians larger than this many world units "
                        "at densify time (0 = off; INRIA uses 0.1 x extent)")
    p.add_argument("--spatial-lr-scale", default=None,
                   help="position-LR scene scaling: a float, or 'auto' for "
                        "1.1 x camera bounding-sphere radius (INRIA); "
                        "default 1.0 = reference behaviour")
    p.add_argument("--multihost", action="store_true",
                   help="train across hosts (not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; a CUDA "
                        "device that is missing is an error)")
    return p.parse_args(argv)


@dataclasses.dataclass
class TrainResult:
    output_dir: Path
    final: dict  # the last logged metrics, as printed after "final:"
    trainer: Trainer


def check_ported(args) -> None:
    """Flags whose code the port does not have raise at once, naming the
    ROADMAP.md item that holds it."""
    if args.fetch_demo:
        raise NotImplementedError(
            "--fetch-demo downloads over the network and is not ported "
            "(ROADMAP.md queue A.5)")
    if args.multihost:
        raise NotImplementedError("--multihost is not ported yet (ROADMAP.md queue A.6)")
    for flag, value in (("--data-parallel", args.data_parallel),
                        ("--tile-parallel", args.tile_parallel)):
        if value is not None and value != 1:
            raise NotImplementedError(
                f"{flag} {value}: data- and tile-parallel training is not ported "
                f"yet (ROADMAP.md queue A.6)")


def build_config(args) -> TrainConfig:
    """The JAX CLI's order: the --config file (or the defaults), then each
    flag that was given.  A --backend the port has not ported raises
    (RasterizerConfig)."""
    cfg = TrainConfig.from_json(Path(args.config).read_text()) if args.config else TrainConfig()
    loss_cfg = cfg.loss
    if args.lambda_depth is not None:
        loss_cfg = dataclasses.replace(loss_cfg, lambda_depth=args.lambda_depth)
    par_cfg = cfg.parallel
    if args.data_parallel is not None:
        par_cfg = dataclasses.replace(par_cfg, data_parallel=args.data_parallel)
    if args.tile_parallel is not None:
        par_cfg = dataclasses.replace(par_cfg, tile_parallel=args.tile_parallel)
    densify_cfg = cfg.densify
    if args.opacity_reset_interval is not None:
        densify_cfg = dataclasses.replace(
            densify_cfg, opacity_reset_interval=args.opacity_reset_interval)
    if args.prune_world_scale is not None:
        densify_cfg = dataclasses.replace(densify_cfg, prune_world_scale=args.prune_world_scale)
    raster_cfg = cfg.raster
    if args.backend is not None:
        raster_cfg = dataclasses.replace(raster_cfg, backend=args.backend)
    return dataclasses.replace(
        cfg,
        iterations=args.iterations,
        resize_factor=args.resize_factor,
        init_points=args.init_points,
        white_background=args.white_background,
        seed=args.seed,
        output_dir=args.output,
        loss=loss_cfg,
        parallel=par_cfg,
        densify=densify_cfg,
        raster=raster_cfg,
        model=dataclasses.replace(
            cfg.model, sh_degree=args.sh_degree, max_gaussians=args.max_gaussians,
            sh_warmup_interval=args.sh_warmup,
        ),
    )


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    check_ported(args)
    cfg = build_config(args)

    print(f"loading {args.dataset} dataset from {args.root} ...", flush=True)
    data, pcd = LOADERS[args.dataset](
        args.root, resize_factor=cfg.resize_factor, white_background=cfg.white_background)
    if not args.no_center:
        pcd, centroid = pcd.centering()
        data = data.shift_cameras(centroid)
        print(f"centered point cloud (centroid {centroid.round(3).tolist()})")

    if args.spatial_lr_scale is not None:
        if args.spatial_lr_scale == "auto":
            scale = spatial_lr_scale_auto(data.cameras)
            print(f"spatial_lr_scale auto: {scale:.3f}", flush=True)
        else:
            scale = float(args.spatial_lr_scale)
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                                  spatial_lr_scale=scale))

    print(f"{data.num_views} views {data.width}x{data.height}, "
          f"{pcd.size} init points -> sampling {cfg.init_points}", flush=True)

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "config.json").write_text(cfg.to_json())

    trainer = Trainer(cfg, data, pcd, device=args.device)
    if args.resume:
        trainer.restore_checkpoint(args.resume)
        print(f"resumed from {args.resume} at step {int(trainer.state.step)}")

    writer: Optional[csv.DictWriter] = None
    with open(out_dir / "metrics.csv", "a", newline="") as csv_file:
        def on_metrics(m):
            nonlocal writer
            if writer is None:
                writer = csv.DictWriter(csv_file, fieldnames=sorted(m.keys()))
                if csv_file.tell() == 0:
                    writer.writeheader()
            writer.writerow(m)
            csv_file.flush()
            print(f"iter {m['iteration']:6d}  loss {m['loss']:.5f}  "
                  f"psnr {m['psnr']:.2f}  n {m['num_active']}  "
                  f"{m['iters_per_s']:.2f} it/s", flush=True)

        final = trainer.run(on_metrics=on_metrics)
    trainer.save_loss_curve()
    trainer.save_snapshot(int(trainer.state.step))
    trainer.save_checkpoint(int(trainer.state.step))
    print("final:", json.dumps(final))
    return TrainResult(output_dir=out_dir, final=final, trainer=trainer)


if __name__ == "__main__":
    main(sys.argv[1:])
