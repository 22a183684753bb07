"""Headline benchmark of the port: pixels/s of one forward + backward
training render on one device, the counterpart of the JAX package's
``bench.py`` (its ``child``).  Prints one JSON line last.

    python -m gaussiansplattingmlx_tpu_torch.bench [--size 800] \\
        [--gaussians 100000] [--sh-degree 3] [--tile 32] [--chunk 128] \\
        [--max-pairs N] [--iters 10] [--repeats 5] [--seed 0] [--device cuda]

The workload is bench.py's: a seeded scene of ``--gaussians`` Gaussians
(points N(0, 0.6^2), colours U(0.05, 0.95), log-scales of U(0.004, 0.02),
opacity logits N(0, 2^2), zero higher SH bands, identity rotations), one
camera at z = -4 with focal 1111 at 800x800 (the same field of view at
other sizes), a U(0, 1) target, and one step: activations, ``render`` in
the default fused, sorted layout at ``RasterizerConfig(max_pairs,
chunk_size, tile_w=tile_h=tile)``, ``losses.total_loss`` (L1 + SSIM) and
the gradients of every raw parameter (no optimizer: bench.py has none).
The pair budget is the probed demand (the sum of tile footprints of the
projected Gaussians) x 1.03, rounded up to lcm(512, chunk) slots, unless
``--max-pairs`` gives it.

Timing: one warm-up step, then ``--repeats`` loops of ``--iters`` steps,
each loop on the host clock between device synchronisations and on CUDA
events for device time; nothing inside a loop waits for the device.  Every
step's loss must equal the warm-up step's bit for bit, or the bench fails.
Earlier lines give the kernel launches of the timed steps, the host syncs
one step makes (``torch.cuda.set_sync_debug_mode("warn")``) and the
device's busy time a step under ``torch.profiler`` (CUDA events around a
loop also count the device's idle gaps).  The
last line has bench.py's keys (``vs_baseline`` dropped: its anchor is a TPU
figure) plus the card, its power limit and the spread of the step times.

``--device cuda`` (the default) needs a CUDA device and raises without
one; ``--device cpu`` runs the kernels' plain versions and writes every
timing field as null.  ``main(argv)`` returns the printed dict.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .config import RasterizerConfig
from .models.gaussians import GaussianParams, activations, params_from_numpy
from .ops import _kernels, binning, losses, projection
from .render import render
from .train.trainer import resolve_device
from .utils import sh
from .utils.camera import Camera

# bench.py's camera: focal 1111 at 800 pixels, c2w translated to z = -4.
FOCAL = 1111.0
FOCAL_SIZE = 800
CAMERA_Z = -4.0
BUDGET_HEADROOM = 1.03
MERGE_BLOCK = 512
# Steps profiled after the timed loops for the device's busy time.
PROFILE_STEPS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=800, help="image width = height")
    p.add_argument("--gaussians", type=int, default=100_000)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--tile", type=int, default=32)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--max-pairs", type=int, default=None,
                   help="pair budget (default: probed demand x 1.03 in "
                        "lcm(512, chunk)-slot quanta)")
    p.add_argument("--iters", type=int, default=10, help="steps in a timed loop")
    p.add_argument("--repeats", type=int, default=5, help="timed loops")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; a CUDA device that is "
                        "missing is an error; cpu times nothing)")
    return p.parse_args(argv)


def metric_name(size: int, n: int, sh_degree: int) -> str:
    """bench.py's metric string at its workload, the run's sizes otherwise."""
    count = f"{n // 1000}k" if n % 1000 == 0 else str(n)
    return f"fwd+bwd pixels/s/chip ({size}x{size}, {count} gaussians, SH{sh_degree})"


def bench_scene(n: int, sh_degree: int, seed: int, device, size: int = 800):
    """bench.py's scene and target, drawn in its order from
    ``np.random.default_rng(seed)``: points, colours, log-scales, opacity
    logits, then the [size, size, 3] target.  The parameters equal the JAX
    package's ``create_from_points`` (capacity n) with the scales and
    opacity replaced, so its k-NN scales are never computed.
    Returns (GaussianParams on ``device``, target tensor on ``device``)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    cols = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    scales = np.log(rng.uniform(0.004, 0.02, size=(n, 3))).astype(np.float32)
    opacity = rng.normal(0.0, 2.0, size=(n, 1)).astype(np.float32)
    target = rng.uniform(size=(size, size, 3)).astype(np.float32)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    params = params_from_numpy({
        "xyz": pts,
        "features_dc": np.asarray(sh.rgb2sh(cols), np.float32)[:, None, :],
        "features_rest": np.zeros((n, sh.num_sh_coeffs(sh_degree) - 1, 3), np.float32),
        "scales": scales,
        "rotation": rot,
        "opacity": opacity,
    }, device)
    return params, torch.as_tensor(target).to(device)


def bench_camera(size: int) -> dict:
    """The camera tensors (numpy) of bench.py's view at ``size`` pixels."""
    c2w = np.eye(4)
    c2w[2, 3] = CAMERA_Z
    focal = FOCAL * size / FOCAL_SIZE
    return Camera.from_c2w(size, size, focal, focal, c2w).tensors()


def camera_args(t: dict, device) -> tuple:
    """``render``'s camera arguments from ``bench_camera``."""
    return (*(torch.as_tensor(t[k]).to(device) for k in ("view", "proj", "camera_center")),
            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"])


@torch.no_grad()
def pair_demand(params: GaussianParams, cam: tuple, size: int, sh_degree: int,
                tile: int) -> int:
    """bench.py's probe: the sum of the projected Gaussians' tile footprints
    (radii > 0) at ``tile`` x ``tile`` tiles."""
    means, shs, _, scales, rots = activations(params)
    p = projection.project_gaussians(means, scales, rots, shs, *cam, size, size, sh_degree)
    grid = -(-size // tile)
    tmin_x, tmin_y, tmax_x, tmax_y = binning._tile_bounds(
        p.rect_min, p.rect_max, float(tile), float(tile), grid, grid)
    foot = (torch.clamp_min(tmax_x - tmin_x, 0).long()
            * torch.clamp_min(tmax_y - tmin_y, 0).long())
    return int(torch.sum(torch.where(p.radii > 0, foot, 0)))


def pair_budget(demand: int, chunk: int) -> int:
    """bench.py's budget: demand x 1.03 rounded up to lcm(512, chunk)."""
    quantum = MERGE_BLOCK * chunk // math.gcd(MERGE_BLOCK, chunk)
    return -(-int(demand * BUDGET_HEADROOM) // quantum) * quantum


def train_like_step(params: GaussianParams, cam: tuple, target: torch.Tensor,
                    cfg: RasterizerConfig, size: int, sh_degree: int):
    """bench.py's step: render, L1 + SSIM against ``target`` (no depth
    term), the gradients of every raw parameter.  Returns (loss, (num_pairs,
    overflow_pairs, tile_depth_mean, tile_depth_max), grads), all tensors on
    the parameters' device, none read back here."""
    means, shs, opacity, scales, rots = activations(params)
    out, aux = render(means, shs, opacity, scales, rots, *cam, size, size, sh_degree,
                      raster_cfg=cfg)
    zeros = torch.zeros_like(out.depth)
    loss, _ = losses.total_loss(out.color, target, out.depth, zeros, zeros)
    grads = torch.autograd.grad(loss, list(params.tensors().values()))
    stats = (aux.num_pairs, aux.overflow_pairs, aux.tile_depth_mean, aux.tile_depth_max)
    return loss.detach(), stats, grads


def power_limit_w(device: torch.device):
    """The card's power limit in watts from nvidia-smi, else "not read"."""
    if device.type != "cuda":
        return "not read"
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
            check=True)
        return float(proc.stdout.strip().splitlines()[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return "not read"


def host_syncs(step) -> dict:
    """The synchronising CUDA operations one ``step()`` makes
    (``set_sync_debug_mode("warn")``), counted by the "file:line" of their
    Python callers (paths below the package's parent directory relative).
    The warning that switching the mode itself raises is left out."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    root = Path(__file__).resolve().parent.parent
    where = []
    for w in caught:
        path = Path(w.filename).resolve()
        if "synchroniz" in str(w.message) and path != Path(torch.cuda.__file__).resolve():
            name = path.relative_to(root).as_posix() if path.is_relative_to(root) else w.filename
            where.append(f"{name}:{w.lineno}")
    return dict(sorted(Counter(where).items()))


def device_busy_ms(step, steps: int = PROFILE_STEPS) -> tuple:
    """(device busy milliseconds a step, device events a step) over
    ``steps`` steps under ``torch.profiler``: the self device time of the
    device-side events (kernels, copies, fills), which CUDA events around a
    loop cannot separate from the device's idle gaps."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    busy_us, events = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        busy_us += dev_us
        events += e.count
    return busy_us / 1e3 / steps, events / steps


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    size, n, deg, tile = args.size, args.gaussians, args.sh_degree, args.tile

    params, target = bench_scene(n, deg, args.seed, device, size)
    cam = camera_args(bench_camera(size), device)
    if args.max_pairs:
        max_pairs = args.max_pairs
    else:
        demand = pair_demand(params, cam, size, deg, tile)
        max_pairs = pair_budget(demand, args.chunk)
        print(f"probe: {demand} pairs at tile {tile} -> max_pairs {max_pairs}", flush=True)
    cfg = RasterizerConfig(max_pairs=max_pairs, chunk_size=args.chunk, tile_w=tile,
                           tile_h=tile)

    def step():
        return train_like_step(params, cam, target, cfg, size, deg)

    loss, stats, _ = step()  # warm-up
    losses_seen = [loss]
    if on_card:
        torch.cuda.synchronize(device)
        syncs = host_syncs(step)
        print(f"host syncs in one step (set_sync_debug_mode): {sum(syncs.values())} "
              f"{json.dumps(syncs)}", flush=True)

    before = _kernels.launch_counts()
    step_s, device_ms = [], []
    for _ in range(args.repeats):
        if on_card:
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            loss, stats, _ = step()
            losses_seen.append(loss)
        if on_card:
            end.record()
            torch.cuda.synchronize(device)
            step_s.append((time.perf_counter() - t0) / args.iters)
            device_ms.append(start.elapsed_time(end) / args.iters)
    steps = args.repeats * args.iters
    median_s = float(np.median(step_s)) if step_s else None
    after = _kernels.launch_counts()
    total = {k: after[k] - before[k] for k in after}
    print("kernel launches: " + json.dumps(
        {"steps": steps, "total": total,
         "per_step": {k: v / steps for k, v in total.items()} if steps else None}),
        flush=True)

    if on_card and step_s:
        busy, events = device_busy_ms(step)
        print(f"device busy (torch.profiler, {PROFILE_STEPS} steps after the timed loops): "
              f"{busy:.4f} ms a step over {events:.0f} device events; idle share "
              f"{1.0 - busy / (median_s * 1e3):.4f} of the median step", flush=True)

    bits = torch.stack(losses_seen).view(torch.int32)
    if not bool((bits == bits[0]).all()):
        raise RuntimeError(f"losses differ over the repeats: "
                           f"{torch.stack(losses_seen).tolist()}")
    print(f"losses: {len(losses_seen)} steps bit-identical", flush=True)

    num_pairs, overflow, depth_mean, depth_max = (float(s) for s in stats)
    line = {
        "metric": metric_name(size, n, deg),
        "value": round(size * size / median_s) if step_s else None,
        "unit": "pixels/s",
        "num_pairs": round(num_pairs),
        "max_pairs": max_pairs,
        "tile": tile,
        "overflow_pairs": round(overflow),
        "tile_depth_mean": round(depth_mean, 1),
        "tile_depth_max": round(depth_max),
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "power_limit_w": power_limit_w(device),
        "repeats": args.repeats,
        "iters": args.iters,
        "step_ms": ({"median": median_s * 1e3, "min": min(step_s) * 1e3,
                     "max": max(step_s) * 1e3} if step_s else None),
        "device_ms_median": float(np.median(device_ms)) if device_ms else None,
        "loss": float(loss),
        "seed": args.seed,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
