#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gaussiansplattingmlx_tpu_torch/csrc``,
checks each kernel against its plain PyTorch version at the shapes of the
serving path, then drives that path once through its entry point
(``gaussiansplattingmlx_tpu_torch.render_cli.main``): the bench scene of
100,000 Gaussians at SH degree 3, rendered at 800x800 from 4 orbit views plus
a 16-frame throughput loop.  Every phase prints one line; any failure raises
and exits non-zero before the last line, which is the JSON device record.
Needs a CUDA device, the repository checkout beside this file, and nvcc.
Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_GAUSSIANS = 100_000
SH_DEGREE = 3
WIDTH = HEIGHT = 800
FOCAL = 1111.0
SEED = 0
# Tolerances of the JAX package's Pallas-vs-oracle checks
# (tests/test_rasterize_pallas.py): the kernel marches serially, the plain
# version uses a cumulative product, so transmittance rounds differently.
COLOR_RTOL, COLOR_ATOL = 1e-4, 1e-5
DEPTH_RTOL, DEPTH_ATOL = 1e-4, 1e-4
NCON_MISMATCH = 0.003


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA events
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bench_scene(path: Path) -> None:
    """The JAX package's bench scene (bench.py), drawn from numpy with seed
    SEED, written as a Gaussian PLY: points N(0, 0.6^2), colours U(0.05,
    0.95), identity rotations, scales U(0.004, 0.02), opacity logits N(0, 2^2);
    the higher SH bands small but nonzero so degree 3 does real work."""
    from gaussiansplattingmlx_tpu_torch.data import ply
    from gaussiansplattingmlx_tpu_torch.utils import sh

    rng = np.random.default_rng(SEED)
    n = N_GAUSSIANS
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    cols = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    rest = (rng.normal(size=(n, (SH_DEGREE + 1) ** 2 - 1, 3)) * 0.05).astype(np.float32)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    scales = np.log(rng.uniform(0.004, 0.02, size=(n, 3))).astype(np.float32)
    opacity = rng.normal(0.0, 2.0, size=(n, 1)).astype(np.float32)
    ply.write_gaussian_ply(path, pts, sh.rgb2sh(cols)[:, None, :], rest, opacity,
                           scales, rot)


def staged_inputs(ply_path: Path, device):
    """The serving path's real kernel inputs for the bench camera (z = -4):
    the merge-gather's cum/table and the compositing kernel's staged buffer,
    at the auto pair budget render_cli would pick."""
    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.data import ply
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.ops import projection, rasterize_ref, staging
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

    params = params_from_numpy(ply.read_gaussian_ply(ply_path), device)
    cfg = RasterizerConfig()
    c2w = np.eye(4)
    c2w[2, 3] = -4.0
    t = Camera.from_c2w(WIDTH, HEIGHT, FOCAL, FOCAL, c2w).tensors()
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(params)
        p = projection.project_gaussians(
            means, scales, rots, shs,
            *(torch.as_tensor(t[k]).to(device) for k in ("view", "proj", "camera_center")),
            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"], WIDTH, HEIGHT, SH_DEGREE,
        )
        packed = rasterize_ref.pack_gaussians(p.means2d, p.conic, p.colors, opacity, p.depths)
        args = (packed, p.rect_min, p.rect_max, p.radii, p.depths)

        def static(max_pairs):
            return staging.StagingStatic(WIDTH, HEIGHT, cfg.tile_w, cfg.tile_h,
                                         max_pairs, cfg.chunk_size)

        e, _ = staging.merge_table(static(cfg.max_pairs_limit), *args)
        total = int(e.num_pairs) + int(e.overflow_pairs)
        max_pairs = max(512, -(-int(total * 1.25) // 512) * 512)
        st = static(max_pairs)
        e, tbl = staging.merge_table(st, *args)
        staged = staging.stage_pairs_sorted(st, *args)
    return e, tbl, st, staged, total


def check_merge(e, tbl, max_pairs, device):
    from gaussiansplattingmlx_tpu_torch.ops import binning, merge_cuda

    def bit_equal(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    got = merge_cuda.merge_gather(e.cum_keep, tbl, max_pairs)
    want = merge_cuda.merge_gather_plain(e.cum_keep, tbl, max_pairs)
    torch.cuda.synchronize()
    require(bit_equal(got, want), "merge_gather kernel != plain on the slice inputs")
    ms = cuda_ms(lambda: merge_cuda.merge_gather(e.cum_keep, tbl, max_pairs))
    plain_ms = cuda_ms(lambda: merge_cuda.merge_gather_plain(e.cum_keep, tbl, max_pairs))

    # Synthetic cases: saturated cumsum entries and compacted-away pads under
    # a budget that overflows (no multiple of any block size), and a budget
    # past the last pair, whose slots have rank n and must be zero.
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    n = 50_000
    foot = torch.randint(1, 40, (n,), generator=gen)
    foot[n // 2] = 2**31 - 1  # saturates the cumsum from here on
    cum = binning._saturating_cumsum(foot)
    cum[-1000:] = binning._CUM_CLAMP + 1
    table = torch.randn((merge_cuda.TBL_ROWS, n), generator=gen)
    plain_total = int(binning._saturating_cumsum(foot[: n // 2])[-1])
    cases = [(cum, plain_total - 777),
             (binning._saturating_cumsum(foot[: n // 2]), plain_total + 1001)]
    for c, budget in cases:
        c, tb = c.to(device), table[:, : c.shape[0]].contiguous().to(device)
        got2 = merge_cuda.merge_gather(c, tb, budget)
        want2 = merge_cuda.merge_gather_plain(c, tb, budget)
        torch.cuda.synchronize()
        require(bit_equal(got2, want2), f"merge_gather kernel != plain ({budget} slots)")
    require(bool((got2[:, plain_total:] == 0).all()), "slots past the last pair must be zero")
    print(f"merge_gather: bit-exact vs plain on {tbl.shape[1]} gaussians x "
          f"{max_pairs} slots and on two synthetic budgets; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": float((got - want).abs().max()), "ms": ms, "plain_ms": plain_ms}


def check_raster(st, staged):
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda

    grid_w = -(-st.image_width // st.tile_w)
    grid_h = -(-st.image_height // st.tile_h)
    args = (staged.records_cm, staged.tile_start, staged.tile_count,
            grid_w, grid_h, st.tile_w, st.tile_h)
    got = rasterize_cuda.raster_fwd(*args)
    want = rasterize_cuda.raster_fwd_plain(*args)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "raster kernel output not finite")
    torch.testing.assert_close(got[:, 0:3], want[:, 0:3], rtol=COLOR_RTOL, atol=COLOR_ATOL)
    torch.testing.assert_close(got[:, 3], want[:, 3], rtol=DEPTH_RTOL, atol=DEPTH_ATOL)
    torch.testing.assert_close(got[:, 4], want[:, 4], rtol=COLOR_RTOL, atol=COLOR_ATOL)
    mismatch = float((got[:, 5] != want[:, 5]).float().mean())
    require(mismatch <= NCON_MISMATCH, f"n_contrib mismatch {mismatch}")
    err = float((got[:, :5] - want[:, :5]).abs().max())
    ms = cuda_ms(lambda: rasterize_cuda.raster_fwd(*args))
    plain_ms = cuda_ms(lambda: rasterize_cuda.raster_fwd_plain(*args), reps=3)
    print(f"raster_fwd: within tolerance of plain on {int(staged.num_pairs)} pairs "
          f"(max abs err {err:.3g}, n_contrib mismatch {mismatch:.2e}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_small_render(device):
    """End-to-end agreement on a small scene: render() on the card (both
    kernels) against render() on the CPU (both plain versions)."""
    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.render import render
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

    rng = np.random.default_rng(SEED + 1)
    n = 400
    raw = {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32) * 0.5,
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "scales": np.log(rng.uniform(0.02, 0.1, size=(n, 3))).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity": rng.normal(0.5, 1.0, size=(n, 1)).astype(np.float32),
    }
    c2w = np.eye(4)
    c2w[2, 3] = -4.0
    t = Camera.from_c2w(100, 72, 90.0, 90.0, c2w).tensors()
    cfg = RasterizerConfig(max_pairs=8192)
    outs = []
    for dev in ("cpu", device):
        params = params_from_numpy(raw, dev)
        with torch.no_grad():
            means, shs, opacity, scales, rots = activations(params)
        cam = [torch.as_tensor(np.asarray(t[k])).to(dev) for k in
               ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x", "focal_y")]
        out, aux = render(means, shs, opacity, scales, rots, *cam, 100, 72, 3,
                          raster_cfg=cfg, inference=True)
        outs.append((out, aux))
    (c_out, c_aux), (g_out, g_aux) = outs
    require(int(c_aux.num_pairs) == int(g_aux.num_pairs) > 0, "num_pairs differ")
    torch.testing.assert_close(g_out.color.cpu(), c_out.color, rtol=COLOR_RTOL, atol=COLOR_ATOL)
    torch.testing.assert_close(g_out.depth.cpu(), c_out.depth, rtol=DEPTH_RTOL, atol=DEPTH_ATOL)
    torch.testing.assert_close(g_out.alpha.cpu(), c_out.alpha, rtol=COLOR_RTOL, atol=COLOR_ATOL)
    print(f"small render: card == cpu plain path within tolerance "
          f"({int(g_aux.num_pairs)} pairs, 100x72, SH3)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "gaussiansplattingmlx_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the port's package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from gaussiansplattingmlx_tpu_torch import render_cli
    from gaussiansplattingmlx_tpu_torch.ops import _kernels, merge_cuda, rasterize_cuda

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    gpu = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {gpu} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _kernels.LIBRARY.cdll()
    built = _kernels.LIBRARY.build_seconds
    nvcc_s = "library already built" if built is None else f"nvcc {built:.2f} s"
    ptxas = [ln.strip() for ln in _kernels.LIBRARY.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"build: {_kernels.LIBRARY.path.name} in "
          f"{time.perf_counter() - t0:.2f} s ({nvcc_s})"
          f"; ptxas: {' | '.join(ptxas)}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ply_path = Path(tmp) / "bench_scene.ply"
        bench_scene(ply_path)

        # 3-4. kernel parity at the slice's shapes
        e, tbl, st, staged, total = staged_inputs(ply_path, device)
        require(int(staged.overflow_pairs) == 0 and int(staged.num_pairs) == total > 0,
                "staging at the auto budget must not overflow")
        merge = check_merge(e, tbl, st.max_pairs, device)
        raster = check_raster(st, staged)
        check_small_render(device)

        # 5. the serving path through its entry point
        merge_cuda.KERNEL.launches = 0
        rasterize_cuda.KERNEL.launches = 0
        res = render_cli.main([
            "--ply", str(ply_path), "--out", str(Path(tmp) / "renders"),
            "--orbit", "4", "--width", str(WIDTH), "--height", str(HEIGHT),
            "--focal", str(FOCAL), "--bench-frames", "16", "--device", "cuda",
        ])
        launches = {"merge_gather": merge_cuda.KERNEL.launches,
                    "raster_fwd": rasterize_cuda.KERNEL.launches}
        require(all(o == 0 for o in res.overflow_pairs) and res.bench_overflow_pairs == 0,
                f"overflow in the render: {res.overflow_pairs} / {res.bench_overflow_pairs}")
        require(all(npairs > 0 for npairs in res.num_pairs), "no pairs rendered")
        for c in res.colors:
            require(c.shape == (HEIGHT, WIDTH, 3), f"image shape {c.shape}")
            require(bool(np.isfinite(c).all()), "non-finite pixels")
            require(float(c.std()) > 1e-3 and float(c.max()) > 0.05, "blank image")
        require(all(v > 0 for v in launches.values()), f"kernel not launched: {launches}")
        print(f"render: {N_GAUSSIANS} gaussians SH{SH_DEGREE} {WIDTH}x{HEIGHT}, "
              f"num_pairs {res.num_pairs}, max_pairs {res.max_pairs}, "
              f"{res.bench_fps:.2f} frames/s over {res.bench_frames} frames, "
              f"launches {launches} | {gpu}", flush=True)

    kernels = [
        {"name": "merge_gather", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/merge_gather.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/merge_pallas.py:156",
         "launches": launches["merge_gather"], **merge},
        {"name": "raster_fwd", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/rasterize_pallas.py:210",
         "launches": launches["raster_fwd"], **raster},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
