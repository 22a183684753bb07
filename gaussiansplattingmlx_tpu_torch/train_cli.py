"""Training CLI (PyTorch + CUDA), the counterpart of the JAX package's
``train.py``, with its flags and defaults plus ``--device``:

    python -m gaussiansplattingmlx_tpu_torch.train_cli --dataset colmap \\
        --root /path/to/scene --iterations 30000 --resize-factor 0.5 \\
        --output outputs/lego [--device cuda]

Dataset formats: colmap (sparse/0/*.bin + images/), blender (info.json),
nerfstudio (transforms.json).  Metrics stream to stdout and metrics.csv;
config.json, PLY snapshots, npz checkpoints, previews and loss_curve.png
land in --output.  ``main(argv)`` returns a ``TrainResult``.

Several ranks on one host (``--data-parallel D --tile-parallel T``, D x T
ranks): ``main`` starts them itself, one process a rank, each on a card of
its own with ``--device cuda``, or all on one named device
(``--device cuda:0``, ``--device cpu``) over gloo.  Across hosts, torchrun
starts the ranks and each joins its group:

    torchrun --nnodes 2 --nproc-per-node 8 ... -m \
        gaussiansplattingmlx_tpu_torch.train_cli --multihost ...

Only rank 0 prints the log lines and writes files.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from .config import ParallelConfig, TrainConfig
from .data import blender, colmap, fetch, nerfstudio
from .parallel import launch, multihost, sharding
from .render import resolve_backend
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
                   help="download this demo scene into --root first, unless it "
                        "is there (needs network access)")
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
                   help="rasterizer backend: auto | pallas (the port's kernels "
                        "on CUDA, their plain versions on the CPU) | reference "
                        "(the oracle rasterizer, plain torch)")
    p.add_argument("--config", default=None, help="TrainConfig JSON file")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    p.add_argument("--max-gaussians", type=int, default=1_000_000)
    p.add_argument("--lambda-depth", type=float, default=None)
    p.add_argument("--no-center", action="store_true",
                   help="skip point-cloud centering")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="mesh 'data' axis size: one camera view per rank per "
                        "step, gradients averaged over the ranks (0 = all "
                        "remaining ranks: the group's, or one a card)")
    p.add_argument("--tile-parallel", type=int, default=None,
                   help="mesh 'tile' axis size: split each camera's pixel "
                        "rows into this many bands (exact seam handling)")
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
                   help="join the process group that torchrun started "
                        "(reads RANK / WORLD_SIZE / LOCAL_RANK / "
                        "LOCAL_WORLD_SIZE / MASTER_ADDR / MASTER_PORT); each "
                        "host keeps a host-local view store and only "
                        "gradients cross hosts")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda: each rank "
                        "on its own card, cuda:LOCAL_RANK; a named device, "
                        "such as cuda:0, is shared by all ranks over gloo; a "
                        "CUDA device that is missing is an error)")
    return p.parse_args(argv)


@dataclasses.dataclass
class TrainResult:
    output_dir: Path
    final: dict  # the last logged metrics, as printed after "final:"
    # The Trainer; None when the ranks ran in processes of their own.
    trainer: Optional[Trainer]
    history: list  # every logged metrics dict
    # Each rank's report when main started the ranks (launch.spawn): launch
    # counts, state digest, seconds, peak memory, collective time.
    ranks: list = dataclasses.field(default_factory=list)


def fetch_demo(args) -> None:
    """``--fetch-demo``: download the demo scene into ``--root`` unless it
    is there (the JAX CLI's check of the scene's format first)."""
    fmt, fetcher = fetch.DEMOS[args.fetch_demo]
    if fmt != args.dataset:
        raise ValueError(f"--fetch-demo {args.fetch_demo} is a {fmt} scene; "
                         f"pass --dataset {fmt}")
    print(f"fetching demo scene {args.fetch_demo!r} into {args.root} ...", flush=True)
    fetcher(args.root)


def build_config(args) -> TrainConfig:
    """The JAX CLI's order: the --config file (or the defaults), then each
    flag that was given.  ``--backend`` goes to the Trainer, as in the JAX
    CLI, and is also written into the config's ``raster.backend``, so that
    config.json and the checkpoints record the rasterizer the run used."""
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


def ranks_to_start(par: ParallelConfig, device) -> int:
    """How many ranks a run of ``par`` needs when no process group exists:
    data x tile, where ``data_parallel=0`` spans every card of a bare
    ``--device cuda``."""
    data = par.data_parallel
    if data <= 0:
        if launch.shares_device(device):
            raise ValueError(f"--data-parallel {data} spans every card of --device cuda; "
                             f"with --device {device} give the number of ranks")
        data = max(torch.cuda.device_count() // par.tile_parallel, 1)
    return data * par.tile_parallel


def main(argv=None) -> TrainResult:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.backend is not None:
        resolve_backend(args.backend)  # an unknown name raises before any work
    cfg = build_config(args)
    if args.fetch_demo and not dist.is_initialized():
        # Before any rank starts; under torchrun each process fetches, as
        # each process of the JAX CLI does.
        fetch_demo(args)
    if args.multihost or "WORLD_SIZE" in os.environ:
        # Under torchrun: join its group (a no-op without its variables, or
        # inside ranks this function started).
        multihost.initialize(launch.default_backend(args.device),
                             launch.rank_device(args.device))
    if not dist.is_initialized():
        world = ranks_to_start(cfg.parallel, args.device)
        if world > 1:
            launch.check_world(world, args.device)
            if launch.shares_device(args.device):
                print(f"{world} ranks share device {args.device} (process group over gloo)",
                      flush=True)
            result, reports = launch.spawn(_rank_main, world, args.device, args=(argv,))
            return dataclasses.replace(result, ranks=reports)
    return train(args, cfg)


def _rank_main(argv):
    """One rank of a run that ``main`` started: its TrainResult without the
    Trainer, and its report (state digest, steps, view store, collective
    time)."""
    res = main(argv)
    trainer = res.trainer
    mesh = trainer.mesh
    report = {"digest": sharding.state_digest(trainer.state).tolist(),
              "steps": int(trainer.state.step), "batched_views": trainer.batched_views,
              "collective_seconds": mesh.collective_seconds,
              "collective_calls": mesh.collective_calls}
    return dataclasses.replace(res, trainer=None), report


def train(args, cfg: TrainConfig) -> TrainResult:
    """The run of this process (every rank's, under a process group)."""
    ranked = dist.is_initialized()
    writer = not ranked or dist.get_rank() == 0
    say = print if writer else (lambda *a, **k: None)
    say(f"loading {args.dataset} dataset from {args.root} ...", flush=True)
    data, pcd = LOADERS[args.dataset](
        args.root, resize_factor=cfg.resize_factor, white_background=cfg.white_background)
    if not args.no_center:
        pcd, centroid = pcd.centering()
        data = data.shift_cameras(centroid)
        say(f"centered point cloud (centroid {centroid.round(3).tolist()})")

    if args.spatial_lr_scale is not None:
        if args.spatial_lr_scale == "auto":
            scale = spatial_lr_scale_auto(data.cameras)
            say(f"spatial_lr_scale auto: {scale:.3f}", flush=True)
        else:
            scale = float(args.spatial_lr_scale)
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                                  spatial_lr_scale=scale))

    say(f"{data.num_views} views {data.width}x{data.height}, "
        f"{pcd.size} init points -> sampling {cfg.init_points}", flush=True)

    out_dir = Path(args.output)
    if writer:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "config.json").write_text(cfg.to_json())

    device = launch.rank_device(args.device) if ranked else args.device
    trainer = Trainer(cfg, data, pcd, device=device, backend=args.backend)
    if trainer.mesh is not None:
        say(f"mesh {trainer.mesh.shape} over {len(trainer.mesh.ranks)} ranks, views "
            f"{'batched' if trainer.batched_views else 'replicated'}", flush=True)
    if args.resume:
        trainer.restore_checkpoint(args.resume)
        say(f"resumed from {args.resume} at step {int(trainer.state.step)}")

    csv_ctx = (open(out_dir / "metrics.csv", "a", newline="") if writer
               else contextlib.nullcontext())
    with csv_ctx as csv_file:
        writer_csv: Optional[csv.DictWriter] = None

        def on_metrics(m):
            nonlocal writer_csv
            if not writer:
                return
            if writer_csv is None:
                writer_csv = csv.DictWriter(csv_file, fieldnames=sorted(m.keys()))
                if csv_file.tell() == 0:
                    writer_csv.writeheader()
            writer_csv.writerow(m)
            csv_file.flush()
            print(f"iter {m['iteration']:6d}  loss {m['loss']:.5f}  "
                  f"psnr {m['psnr']:.2f}  n {m['num_active']}  "
                  f"{m['iters_per_s']:.2f} it/s", flush=True)

        final = trainer.run(on_metrics=on_metrics)
    trainer.save_loss_curve()
    trainer.save_snapshot(int(trainer.state.step))
    trainer.save_checkpoint(int(trainer.state.step))
    say("final:", json.dumps(final))
    return TrainResult(output_dir=out_dir, final=final, trainer=trainer,
                       history=list(trainer.history))


if __name__ == "__main__":
    main(sys.argv[1:])
