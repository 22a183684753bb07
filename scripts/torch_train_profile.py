#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python3 scripts/torch_train_profile.py [--steps 5] [--out profile.json]
        [--layout sorted aligned split]

Builds the training setup of ``chip_smoke.py`` (the bench scene, 4 orbit
targets at 800x800, a Trainer from its 100,000 points at SH3 with the
probed pair budget), then for each record layout (``sorted`` the default;
``aligned`` and ``split`` as ``config.LAYOUTS`` selects them, at the
same budget) runs 5 warm-up steps, times ``--steps`` steps on the host
clock (``torch.cuda.synchronize()`` at both ends), then profiles the same
number of steps with ``torch.profiler``.  Prints device time by kernel
(self device time of the device-side events, summed per name), device busy
time per step, wall time per step and the device's idle share
(1 - busy / wall); ``--out`` also writes them, with every kernel name, as
JSON (one object per layout).  In the sorted layout it also times K1 and
K3 on each view's buffer before and after those steps, with the
pixel-records each buffer makes them take (``replay_work``).  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None, help="write the result as JSON here")
    ap.add_argument("--layout", nargs="+", default=["sorted"],
                    choices=["sorted", "aligned", "split"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from gaussiansplattingmlx_tpu_torch import config

    device = torch.device("cuda:0")
    gpu = smoke.gpu_line()
    results = []
    with tempfile.TemporaryDirectory(prefix="train_profile_") as tmp:
        ply_path = Path(tmp) / "bench_scene.ply"
        smoke.bench_scene(ply_path)
        data = smoke.orbit_targets(ply_path, device)
        trainer, peak, _ = smoke.training_setup(ply_path, data, device)
        max_pairs = trainer.cfg.raster.max_pairs
        for layout in args.layout:
            if layout != "sorted":
                trainer = smoke.make_trainer(ply_path, data, device, **config.LAYOUTS[layout])
                trainer.set_max_pairs(max_pairs)
                results.append(profile(trainer, args.steps, layout, peak, gpu))
                continue
            before = replay_work(trainer, "initial parameters")
            results.append(profile(trainer, args.steps, layout, peak, gpu))
            results[-1]["replay_work"] = before + replay_work(
                trainer, f"after {int(trainer.state.step)} steps")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    return 0


def replay_work(trainer, when: str) -> list:
    """K1's and K3's work and device time on each view's buffer at the
    trainer's current parameters (the L1 + SSIM cotangent against the view's
    target): pixel-records taken (the same for both), pairs replayed,
    milliseconds (``device_ms``; K3's includes the wrapper's zero fill),
    and each kernel's bound."""
    import chip_smoke as smoke
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, staging

    tile = trainer.cfg.raster.tile_w
    grid = -(-smoke.WIDTH // tile)
    rows = []
    for view in range(trainer.views["target_rgb"].shape[0]):
        args, st = smoke.first_step_geometry(trainer, view)
        with torch.no_grad():
            sp, _ = staging._stage_train_impl(st, *args)
        block, _ = smoke.loss_cotangent_block(sp.records_cm, sp.tile_start, sp.tile_count,
                                              smoke.WIDTH, smoke.HEIGHT, tile,
                                              trainer.views["target_rgb"][view])
        fargs = (sp.records_cm, sp.tile_start, sp.tile_count, grid, grid, tile, tile)
        bargs = (*fargs[:3], block, *fargs[3:])
        k1_ms = smoke.device_ms(lambda: rasterize_cuda.raster_fwd(*fargs))
        ms = smoke.device_ms(lambda: rasterize_cuda.raster_bwd(*bargs))
        lim, taken, replayed = smoke.bwd_bound(block, sp.tile_count, sp.records_cm.numel())
        pairs = int(sp.num_pairs)
        out_numel = 6 * block.shape[0] * block.shape[1]  # K1 output [T, 6, TT]
        lim1 = smoke.bound(4.0 * (11 * pairs + 2 * sp.tile_count.numel() + out_numel),
                           smoke.K1_OPS * taken)
        rows.append({"when": when, "view": view, "pairs": pairs,
                     "pixel_records": taken, "replayed": replayed, "k1_ms": k1_ms,
                     "k1_bound_ms": lim1["bound_ms"], "k3_ms": ms, "bound_ms": lim["bound_ms"]})
        print(f"view {view}, {when}: {pairs} pairs, {taken:.0f} pixel-records; raster_fwd "
              f"{k1_ms:.4f} ms (bound {lim1['bound_ms']:.4f} ms); raster_bwd {replayed} "
              f"replayed, {ms:.4f} ms (bound {lim['bound_ms']:.4f} ms)", flush=True)
    return rows


def profile(trainer, steps, layout, peak, gpu) -> dict:
    trainer.run(5)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(5 + steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.run(5 + 2 * steps)
        torch.cuda.synchronize()
    # Device-side events only (kernels, memcpy, memset): the CPU-side ops
    # that launched them report the same device time again.
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": e.key, "calls": e.count // steps,
                         "ms_per_step": dev_us / 1e3 / steps})
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy_ms = sum(r["ms_per_step"] for r in rows)
    events = sum(r["calls"] for r in rows)
    result = {
        "layout": layout, "gpu": gpu, "steps": steps,
        "max_pairs": trainer.cfg.raster.max_pairs,
        "probe_peak_pairs": peak, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms, "device_events_per_step": events,
        "idle_share": (1.0 - busy_ms / wall_ms) if wall_ms > 0 else None,
        "kernels": rows,
    }
    print(f"layout {layout}:")
    for r in rows[:15]:
        print(f"{r['ms_per_step']:9.4f} ms/step  {r['calls']:5d} calls  {r['name'][:90]}")
    print(f"wall {wall_ms:.3f} ms/step (unprofiled), device busy {busy_ms:.3f} ms/step "
          f"over {events} device events, idle share {result['idle_share']:.3f} | {gpu}")
    print(json.dumps({k: v for k, v in result.items() if k != "kernels"}), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(main())
