#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gaussiansplattingmlx_tpu_torch/csrc``
and checks each against its plain PyTorch version at the shapes of its path:

* the densify noise stream (``utils/prng.py``: JAX's threefry2x32 key,
  split and ``jax.random.normal`` in plain torch): ``random_bits`` and
  ``normal`` at [2^20, 3] drawn on the card and on the CPU from one key,
  the bits bit-equal, the normals at least 99% bit-equal and none more
  than 4 ulp apart, each draw timed on the card;
* the port's bench through its entry point (``python -m
  gaussiansplattingmlx_tpu_torch.bench`` at its defaults, in a fresh
  process): the JAX package's bench.py workload (its seed-0 scene of
  100,000 Gaussians, SH3, one 800x800 view, tile 32, the probed budget),
  50 timed forward + backward steps with bit-identical losses, no overflow,
  K2, K1, K3 and K4 once a step; then K2, K1, K3 and K4 checked and timed
  on that workload's first-step buffers (``bench_*`` in the kernels line);
* K1 forward compositing and K2 merge-gather on the serving path's inputs,
  then the serving path through its entry point
  (``gaussiansplattingmlx_tpu_torch.render_cli.main``): a variant of
  bench.py's scene (``bench_scene``) of 100,000 Gaussians at SH degree 3,
  rendered at 800x800 from 4 orbit views plus a 16-frame throughput loop;
* K3 backward compositing and K4 per-Gaussian segment sum on the training
  buffers of the bench camera (the cotangent of the real L1 + SSIM loss;
  K4 with the buffer's segment profile and its feed, ``sort_by_gid``,
  timed beside it, wherever K4 is checked),
  K3 also at tile 32 on a small scene; K5 merge ranks (timed at the serving
  budget), K6 relayout and K7 aligned backward on the same camera's
  split-layout ranks and aligned buffers; then the training path through
  its entry point (``train.trainer.Trainer.run``): 20 steps at 800x800,
  SH3, tile 32, from a 100,000-point cloud of the bench scene, against
  targets rendered by the port from 4 orbit views, in the default sorted
  layout and again in each non-default layout (``train_staging="aligned"``:
  K6 and K7; ``staging="split"``: K5 and K7), each kernel first checked on
  that run's own first-step buffers (K1 on all three layouts' record
  buffers) and the layouts' losses held to the sorted run's; the kernels
  line times K1-K7 on those buffers, K1's and K2's serving and K4's tile-16
  numbers beside them;
* the golden image: tests/test_golden.py's scene (120 Gaussians, SH2,
  64x64) rendered by the kernels (K2, K1) and by the oracle, each held to
  the committed tests/golden_scene.npz at that test's bars;
* the split layout's serving path: ``render_many`` over 16 orbit frames of
  the bench scene with ``RasterizerConfig(staging="split")``;
* the staging route above 2^24 slots (K5's ranks in place of K2):
  ``render_cli.main`` with ``--max-pairs 33554432 --no-auto-pairs``; the
  training workload's initial Gaussians at tile 16 from the busiest
  800x800 orbit view (~14.4 M pairs) at 2^25 slots, bit-equal to the same
  frame through K2 at 2^24; then the first probed square view size past
  2^24 real pairs, rendered in the sorted layout and the split layout
  (compared bit for bit, else at the JAX image bars), K1 and K5 checked
  there against their plain versions, and one sorted training step (K5,
  K1, K3, K4 once each), K1, K3 and K4 first checked on its buffers;
* densify: from the sorted run's state after its 20 steps, the densify step
  (Adam reset) and the prune-only step on the card against the same steps
  on CPU copies with one draw of the trainer's own noise stream made on the
  card (stats, gather map, noise
  modes, parameters and moments bit-exact but the xyz and scales of the
  rows a round created), each timed on the card;
* the densified training run through ``Trainer.run``: 30 steps of the
  default layout with densify rounds at 10 and 20, a prune-only round at
  30, an opacity reset at 15, previews, a PLY snapshot and checkpoints at
  15 and 30 into a temporary directory; the capacity grows from 131,072 to
  262,144, and K2, K1, K3 and K4 are checked on the grown trainer's
  buffers;
* resume: a new Trainer restores the step-15 checkpoint and runs to 30,
  bit-identical to the uninterrupted run (parameters, moments, counters,
  logged losses);
* the command-line path: the COLMAP loader on the vendored scene
  (tests/fixtures/vendor_scene, 10 views 256x192) at factors 1.0 and 0.5
  without Pillow; ``train_cli.main`` on that scene at the default config
  (SH4, tile 16, densify from step 500) for 1,099 steps, ``eval_cli.main``
  on its step-100 and final PLYs (eval PSNR up by at least 1.5 dB, to at
  least 12 dB) and a resume from its step-500 checkpoint, whose final
  checkpoint equals the uninterrupted run's; then ``train_cli.main`` for 600
  steps and ``eval_cli.main`` on a full-width scene (12 views 800x800
  ray-traced by scripts/make_vendor_scene.py into a temporary directory,
  its 16,381-point surface sample) at the default config, and K2, K1, K3
  and K4 checked and timed on that run's last buffers;
* the flagship campaign (``train_flagship.run``, the JAX package's
  scripts/train_flagship_tpu.py): the self-fit form at full width (the
  procedural scene's 59,960 ground-truth Gaussians rendered from 32 orbit
  views at 800x800, each view's exact pairs equal to ``bench.pair_demand``,
  16,384 initial points, SH3) for 1,000 steps (densify rounds at 500-1,000),
  with no overflow, the JAX summary's keys and PSNR up by 1.5 dB; K2, K1, K3
  and K4 checked and timed on that run's last buffers (``flagship_*`` in
  the kernels line); then the independent form on the full-width scene, 2
  views held out, 300 steps, finite held-out PSNR / SSIM and their PNGs;
* the oracle (``backend="reference"``, plain torch on the card): one
  render and one training step's parameter gradients of a 400-Gaussian
  100x72 scene against the kernels' path (the JAX image and gradient
  bars), and ``eval_cli --backend reference`` on the vendored run's
  step-100 PLY at 64x48 against ``eval_cli`` on the kernels;
* the scatter reduction (``grad_reduce="scatter"``, no K4): on the sorted
  run's first-step buffers against ``sort_by_gid`` + K4 (K4's tolerance;
  two launches compared bit for bit; both timed), then ``Trainer.run``
  for 20 steps in the sorted layout and 10 in the aligned and split
  layouts, their losses held to the sorted segsum run's;
* the spans (``utils/profiler.py``): ``trace()`` of 3 default training
  steps, whose Chrome trace must name K1-K4's kernels and every span of
  ``SPANS`` once a step, and leave under 2% of the device time outside
  the spans (``benchmark/spans.py``);
* the native COLMAP parsers (built with the host C++ compiler) against
  the Python parsers on the vendored scene's ``sparse/``, bit for bit; and
  in a fresh process with no compiler (``CXX`` a missing file, an empty
  ``PATH``, an empty build directory), the vendored scene loaded through
  the Python parsers, equal to the library's load, with one stderr line;
* data- and tile-parallel training (``parallel/``), its ranks started by
  ``parallel/launch.py`` on this one card over gloo (so their times are no
  scaling result): ``render()`` of the bench scene at tile 16 over one
  orbit view and over 2 bands of 400 rows and 5 of 160 in each layout
  (the stitched bands equal the full image, their pairs add up to its);
  from the bench workload's initial state at tile 16, one step of D=2 on
  views (1, 4) against the mean of the two views' single-device gradients
  then Adam, of T=2 against the single-device step, and of D=2 x T=2
  against D=2 x T=1 (tests/test_sharding.py's bars), each mesh then
  trained 20 steps through ``Trainer.run`` (states bit-identical on every
  rank; steps/s, collective time, peak memory and K1-K4 launches per
  rank); K2, K1, K3 and K4 checked and timed on a 400-row band buffer;
  ``train_cli.main`` with ``--data-parallel 2 --device cuda:0`` on the
  vendored scene at the default config for 600 steps (one writer), a
  resume from its step-300 checkpoint (bit-identical), and the same run
  with ``--multihost`` in two ranks that each see a torchrun environment
  of a host of their own (batched views).

Each main path runs with every launch counter set to 0 just before it and
read just after.  Every phase prints one line; any failure raises and exits
non-zero before the kernels line, the card line and the last line (the JSON
device record).  Needs a CUDA device, the repository checkout beside this
file, and nvcc.  Imports no JAX.
"""

from __future__ import annotations

import csv
import dataclasses
import importlib.util
import json
import multiprocessing
import os
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
TRAIN_STEPS = 20
TRAIN_VIEWS = 4
# The training run composites 32x32 tiles, as the JAX package's bench does
# (bench.py:77): the 100,000-point initialisation's splats (scales from the
# 3-nearest-neighbour distances) need ~14.4 M pairs per view at tile 16,
# above the default pair limit of 2^23, and ~4.0 M at tile 32.
TRAIN_TILE = 32
# Tolerances of the JAX package's Pallas-vs-oracle checks
# (tests/test_rasterize_pallas.py): the kernel marches serially, the plain
# version uses a cumulative product, so transmittance rounds differently.
COLOR_RTOL, COLOR_ATOL = 1e-4, 1e-5
DEPTH_RTOL, DEPTH_ATOL = 1e-4, 1e-4
NCON_MISMATCH = 0.003
# Backward rows: the JAX package's Pallas-vs-oracle gradient tolerance
# (tests/test_rasterize_pallas.py:151), atol scaled by each row's largest
# magnitude because the rows differ by orders of magnitude in scale (a conic
# gradient is ~pixels^2 times a colour gradient).  K3 rebuilds transmittance
# from the stored alpha and sums over pixels in a tree; the plain version
# differentiates a cumulative product.
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
# Backward rows on a buffer whose pixels end near the transmittance floor:
# the JAX package's early-exit tolerance for the same kernel design
# (tests/test_rasterize_pallas.py:167, ROADMAP.md C).  K3 rebuilds T from
# T_final = 1 - alpha, which keeps a float32 ulp of alpha (~6e-8) on a T of
# ~1e-6; bench.py's scene (opacity logits N(0, 2^2), ~880 records a tile)
# has such pixels, and there one gradient of K3 left the bars above
# against the plain version (which agrees with a float64 evaluation to
# 0.2% of them).
EARLY_RTOL, EARLY_ATOL = 5e-3, 5e-4
# Segment sums: another summation order than index_add_'s; atol 1e-6 of the
# largest sum covers segments that cancel.
SEGSUM_RTOL, SEGSUM_ATOL = 1e-5, 1e-6
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per (pixel, record taken) for the compute bounds: K1 ~24 (offset
# 2, quadratic form 8, exp 1, opacity and clamp 2, weight 1, four
# multiply-adds 8, transmittance 2); K3 ~60 (alpha again 13, undo and weight
# 4, cotangent dot 7, dl/da 5, suffix sum 2, the ten gradient terms ~19, and
# one add per term into the pixel sum 10).  K4: one add per live row entry.
K1_OPS, K3_OPS = 24, 60
# The training runs' losses in the aligned and split layouts against the
# sorted run's (the CPU tests' step-parity tolerance).
LOSS_RTOL = 1e-4
SPLIT_FRAMES = 16
# The densified training run: the default layout at the bench workload,
# 30 steps with densify rounds at 10 and 20, a prune-only round at 30, an
# opacity reset at 15, previews every 10 steps, a PLY snapshot at 30 and
# checkpoints at 15 and 30.  GRAD_THRESHOLD makes the round at step 10
# split ~15-20% of the 100,000 Gaussians (the mean gradient's 80th and 85th
# percentiles there are ~6.8e-10 and ~1.0e-8: most Gaussians are seen from
# few of the 4 views), which passes 85% of the 131,072 slots, so the
# capacity grows to 262,144; DENSE_MAX_GAUSSIANS keeps it there.  The pair
# budget is the probe peak times DENSE_HEADROOM: the densified steps render
# more pairs.
# The truncated phase: view 0 of the training setup at this share of its
# pair demand (in 512-slot quanta), the budget also its limit, for this
# many steps of Trainer.run.
TRUNCATE_SHARE = 0.5
TRUNCATE_STEPS = 2
DENSE_STEPS = 30
GRAD_THRESHOLD = 2e-9
# The densify noise: the draw a round makes at the largest capacity of a
# default run (2^20 rows, max_gaussians 1,000,000), and the bar the CPU
# tests hold the draw to against JAX.
PRNG_SHAPE = (2 ** 20, 3)
NORMAL_EQUAL_SHARE = 0.99
NORMAL_MAX_ULP = 4
DENSE_MAX_GAUSSIANS = 262_144
DENSIFY = dict(from_iter=10, interval=10, until_iter=20, prune_until_iter=30,
               opacity_reset_interval=15, grad_threshold=GRAD_THRESHOLD)
DENSE_WRITES = dict(preview_interval=10, snapshot_interval=30, checkpoint_interval=15)
DENSE_HEADROOM = 3
# Quantiles of the live rows' mean gradient printed for each round.
AVG_GRAD_QUANTILES = [0.5, 0.7, 0.75, 0.8, 0.85, 0.88, 0.9, 0.95, 0.99]
# Rows a densify round created go through exp (the split noise scale) and
# the split children's log-scale shift: CUDA's expf is not the CPU's.
FRESH_RTOL, FRESH_ATOL = 1e-6, 1e-7
# The design of the backward replay K3 and K7 share (rasterize_bwd_tile.cuh),
# named in the kernels line.
BWD_DESIGN = ("replay: 2 pixels a thread at tile 16 (128 threads), 4 at tile 32 (256), "
              "transposed warp reduction over groups of 3 records")
# The design of the per-Gaussian segment sum K4 (segsum.cu), named in the
# kernels line.
SEGSUM_DESIGN = ("merge path over columns and segment ends: stretches of 224 steps, a warp each "
                 "(7 a lane, columns held in registers), persistent grid of 1,056 two-warp "
                 "blocks, a 256-entry sample of the ends for the search, a warp scan by segment; "
                 "a programmatic-dependent fix-up kernel adds the carries of segments that "
                 "cross stretches")
# The design of forward compositing K1 (rasterize_fwd.cu), named in the
# kernels line.
FWD_DESIGN = ("one pixel a thread in blocks of at most 128 pixels (whole rows: 2 blocks a tile at "
              "tile 16, 8 at tile 32), each stopping on its own pixels; cp.async double-buffered "
              "batches of 128 records as 3 x float4; 16-record groups between alive checks")

# The CLI phases.  The vendored COLMAP scene trains through train_cli at the
# default config (SH4, every point as the initial cloud, tile 16, densify
# every 100 steps from 500, budget auto-grow from 2^20) for VENDOR_STEPS
# steps, with checkpoints and snapshots at VENDOR_WRITES; eval_cli then
# scores the step-100 and the final PLY.  The bars are the JAX package's
# (tests/test_vendor_scene.py): +1.5 dB and at least 12 dB.  The run ends 99
# steps after its last densify round (at 1,000), as a default 30,000-step
# run ends long after its last (at 15,000): a run that ends on a round
# writes the round's untrained splits, Adam restarted, as its final PLY
# (17.915 dB at step 100, 14.458 dB after the round at 1,000 on the H100).
VENDOR = ROOT / "tests" / "fixtures" / "vendor_scene"
VENDOR_STEPS = 1099
VENDOR_WRITES = {"checkpoint_interval": 500, "snapshot_interval": 100}
VENDOR_RESUME = 500
PSNR_GAIN_DB, PSNR_FLOOR_DB = 1.5, 12.0
# The full-width scene (BASELINE.md's 800x800 flagship): the numpy ray
# tracer of scripts/make_vendor_scene.py with its rich spheres, FULL_VIEWS
# views of its camera ring (rendered by FULL_WORKERS processes) and its
# surface sample of FULL_POINTS (16,381 points), trained FULL_STEPS steps at
# the default config (densify
# rounds at 500 and 600).  The pair budget is the default unless
# FULL_HEADROOM times the initial demand, probed over every view, is larger:
# no step may overflow.
FULL_SIZE = 800
FULL_VIEWS = 12
FULL_POINTS = 16384
FULL_STEPS = 600
FULL_WORKERS = 4
FULL_HEADROOM = 3
# The flagship campaign (train_flagship.py, the JAX package's
# scripts/train_flagship_tpu.py): the self-fit form at its full width (the
# procedural scene's 59,960 Gaussians, 32 orbit views at 800x800, 16,384
# initial points, SH3, tile 16, budget from 2^21), cut to FLAGSHIP_STEPS
# steps (densify rounds at 500-1,000); then the independent form on the
# full-width scene with FLAGSHIP_HOLDOUT views held out, FLAGSHIP_HOLDOUT_STEPS
# steps, the INRIA switches of the JAX package's round-4 campaign.  The
# self-fit run must gain PSNR_GAIN_DB from its first logged row to its last.
FLAGSHIP_STEPS = 1000
FLAGSHIP_VIEWS = 32
FLAGSHIP_TILE = 16
FLAGSHIP_HOLDOUT = 2
FLAGSHIP_HOLDOUT_STEPS = 300
# The JAX script's summary keys (scripts/train_flagship_tpu.py:414-446).
FLAGSHIP_SUMMARY_KEYS = {
    "workload", "final_psnr", "final_loss", "first_psnr", "num_gaussians_final",
    "num_gaussians_peak", "gaussian_trajectory", "sustained_it_per_s", "mean_it_per_s",
    "wall_s_total", "segments", "capacity_recompiles", "pair_budget_recompiles",
    "final_max_pairs", "overflow_events"}
# The data- and tile-parallel phases.  Ranks start from parallel/launch.py
# and all compute on this one card over gloo (NCCL refuses two ranks on one
# card), so their times are not a scaling result.  Full width: the bench
# workload (100,000 points of the bench scene, SH3, 800x800) at tile 16, so
# a 400-row band (2 bands) is 25 tiles and a 160-row band (5) 10; PAR_VIEWS
# orbit views, the checked steps on views PAR_STEP_VIEWS (the JAX package's
# tests/test_sharding.py pair).  Each D x T run trains PAR_STEPS steps; its
# loss must fall from the mean of its first PAR_LOSS_WINDOW steps to that of
# its last (each step's views differ).  The CLI runs: train_cli on the vendored
# scene at the default config with --data-parallel 2 to CLI_PAR_STEPS
# (densify rounds at 500 and 600), checkpoints every 300, a resume from 300.
PAR_TILE = 16
PAR_BANDS = (2, 5)
PAR_VIEWS = 6
PAR_STEP_VIEWS = (1, 4)
PAR_STEPS = 20
PAR_LOSS_WINDOW = 5
PAR_DEVICE = "cuda:0"
# The parallel runs' pair budget cap: up to four ranks share the one card
# with this process, each holding buffers of its own.
PAR_MAX_PAIRS = 2 ** 24
CLI_PAR_STEPS = 600
CLI_PAR_WRITES = {"checkpoint_interval": 300, "snapshot_interval": 300}
CLI_PAR_RESUME = 300
# K1-K4, by C symbol (ranks report their counters by symbol).
PAR_KERNELS = {"gsplat_merge_gather": "merge_gather", "gsplat_raster_fwd": "raster_fwd",
               "gsplat_raster_bwd": "raster_bwd", "gsplat_segsum": "segsum"}


# The scatter reduction (grad_reduce="scatter") in place of K4: the sorted
# layout trains TRAIN_STEPS steps, the aligned and split layouts
# SCATTER_LAYOUT_STEPS (two log lines) of the same schedule, each at the
# sorted run's pair budget, their losses held to the sorted run's.
SCATTER_LAYOUT_STEPS = 10
# The oracle (backend="reference"), O(pixels x pairs): check_small_render's
# scene (400 Gaussians, SH3, 100x72, budget 8,192) against the kernels'
# path, one render and one training step's parameter gradients; and
# eval_cli --backend reference on the vendored run's step-100 PLY at a
# quarter of the images' size (64x48), against eval_cli on the kernels.
REF_WIDTH, REF_HEIGHT, REF_MAX_PAIRS = 100, 72, 8192
REF_EVAL_FACTOR, REF_EVAL_MAX_PAIRS = 0.25, 32768
# eval_cli metrics against each other (tests/test_torch_cli.py's bars).
PSNR_ATOL_DB, SSIM_ATOL, L1_ATOL = 0.01, 1e-4, 1e-5
# The profiler phase: PROFILE_STEPS training steps under trace(), whose
# file must name K1-K4's kernels and every span once a step, with under
# UNSPANNED_SHARE of the device time outside the spans.
PROFILE_STEPS = 3
UNSPANNED_SHARE = 0.02
# The staging route above 2^24 slots (ops/staging.py: K5's int32 ranks in
# place of K2's float32 slot values), on the training workload's initial
# Gaussians at tile 16: the busiest orbit view at 800x800 (~14.4 M pairs)
# under a 2^25-slot budget against the 2^24 one, then the first square view
# size (the focal scaled with it) whose pairs pass 2^24 by WIDE_MARGIN,
# rendered in the sorted and split layouts and trained one sorted step.
WIDE_TILE = 16
WIDE_BUDGET = 2 ** 25
WIDE_SIZES = (864, 896, 928, 960, 1024, 1088, 1152, 1280, 1600)
WIDE_MARGIN = 1.02
TRACE_KERNELS = {"merge_gather": "merge_gather_kernel", "raster_fwd": "raster_fwd_kernel",
                 "raster_bwd": "raster_bwd_kernel", "segsum": "segsum_kernel"}


# The port's bench (gaussiansplattingmlx_tpu_torch/bench.py) at its defaults,
# bench.py's workload: 100,000 Gaussians, SH3, 800x800, tile 32, chunk 128,
# the probed budget, 5 timed loops of 10 forward + backward steps.  Each step
# launches K2, K1, K3 and K4 once.
BENCH_TIMEOUT = 600
BENCH_KERNELS = ("merge_gather", "raster_fwd", "raster_bwd", "segsum")


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


def device_ms(fn, calls: int = 8, reps: int = 5) -> float:
    """Median device milliseconds of one fn() call: ``calls`` calls captured
    into one CUDA graph, replayed ``reps`` times between CUDA events after a
    warm-up replay, so the host's launch overhead (the Python wrapper, the
    ctypes call) stays off the device's timeline.  fn must not synchronise
    with the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def kernel_ms(fn) -> dict:
    """A kernel wrapper's times: ``ms`` its device time (``device_ms``),
    ``call_ms`` one call between CUDA events, the host's launch overhead
    included (``cuda_ms``, the method of PERF.md's earlier kernel times)."""
    return {"ms": device_ms(fn), "call_ms": cuda_ms(fn)}


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps runs, each a call between CUDA
    events after one warm-up run: the device's time plus whatever of the
    host's launch overhead it waits for."""
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


def timed_once(fn):
    """(fn(), its milliseconds on CUDA events) from one run: for plain
    versions too slow to repeat."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bench_scene(path: Path) -> None:
    """A variant of the JAX package's bench scene (bench.py:79-93), drawn
    from numpy with seed SEED, written as a Gaussian PLY: points N(0,
    0.6^2), colours U(0.05, 0.95), identity rotations, scales U(0.004,
    0.02), opacity logits N(0, 2^2), and, unlike bench.py's, the higher SH
    bands small but nonzero (N(0, 0.05^2), drawn before the scales and
    opacities, so those differ from bench.py's too) so degree 3 does real
    work.  bench.py's own scene is ``gaussiansplattingmlx_tpu_torch.bench
    .bench_scene`` (the bench phase); this one stays so that the kernel
    times of earlier runs stay comparable."""
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


def bench_camera(device):
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

    c2w = np.eye(4)
    c2w[2, 3] = -4.0
    t = Camera.from_c2w(WIDTH, HEIGHT, FOCAL, FOCAL, c2w).tensors()
    return [torch.as_tensor(np.asarray(t[k])).to(device) for k in
            ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x", "focal_y")]


def bench_geometry(ply_path: Path, device):
    """Projection of the bench scene through the bench camera (z = -4):
    (packed, rect_min, rect_max, radii, depths) and the auto pair budget
    render_cli would pick (probe peak x 1.25 in 512-slot quanta)."""
    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.data import ply
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.ops import projection, rasterize_ref, staging

    params = params_from_numpy(ply.read_gaussian_ply(ply_path), device)
    cfg = RasterizerConfig()
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(params)
        p = projection.project_gaussians(means, scales, rots, shs, *bench_camera(device),
                                         WIDTH, HEIGHT, SH_DEGREE)
        packed = rasterize_ref.pack_gaussians(p.means2d, p.conic, p.colors, opacity, p.depths)
        args = (packed, p.rect_min, p.rect_max, p.radii, p.depths)
        probe = staging.StagingStatic(WIDTH, HEIGHT, cfg.tile_w, cfg.tile_h,
                                      cfg.max_pairs_limit, cfg.chunk_size)
        e, _ = staging.merge_table(probe, *args)
    total = int(e.num_pairs) + int(e.overflow_pairs)
    max_pairs = max(512, -(-int(total * 1.25) // 512) * 512)
    return args, total, staging.StagingStatic(WIDTH, HEIGHT, cfg.tile_w, cfg.tile_h,
                                              max_pairs, cfg.chunk_size)


def merge_gather_entry(cum, tbl, max_pairs, what):
    """K2 bit-exact against its plain version on a cumsum, table and pair
    budget, timed there: the kernels line's entry."""
    from gaussiansplattingmlx_tpu_torch.ops import merge_cuda

    got = merge_cuda.merge_gather(cum, tbl, max_pairs)
    want = merge_cuda.merge_gather_plain(cum, tbl, max_pairs)
    torch.cuda.synchronize()
    require(bit_equal(got, want), f"merge_gather kernel != plain ({what})")
    times = kernel_ms(lambda: merge_cuda.merge_gather(cum, tbl, max_pairs))
    plain_ms = cuda_ms(lambda: merge_cuda.merge_gather_plain(cum, tbl, max_pairs))
    rows, n_tbl = tbl.shape
    # One binary search per slot is ~log2(n) integer compares: far below the
    # byte time, so the bound is the bytes (cum and table in, output out).
    lim = bound(4.0 * (n_tbl + rows * n_tbl + rows * max_pairs), 0.0)
    print(f"merge_gather: bit-exact vs plain on {n_tbl} gaussians x {max_pairs} slots "
          f"({what}); kernel {times['ms']:.4f} ms (a call {times['call_ms']:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({lim['bound_by']})",
          flush=True)
    return {"max_abs_err": 0.0, **times, "plain_ms": plain_ms, **lim, "library_ms": None}


def check_merge(args, st, device):
    from gaussiansplattingmlx_tpu_torch.ops import binning, merge_cuda, staging

    with torch.no_grad():
        e, tbl = staging.merge_table(st, *args)
    entry = merge_gather_entry(e.cum_keep, tbl, st.max_pairs, "serving, bench camera")

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
    print("merge_gather: bit-exact vs plain on two synthetic budgets", flush=True)
    return entry


def check_fwd(fargs, what, timed=True):
    """K1 against its plain version on a record buffer ``fargs`` (raster_fwd's
    arguments): within the image tolerances, two launches bit-identical.
    Returns the max abs err and the n_contrib mismatch; with ``timed``, the
    kernels line's entry, its bound from the pixel-records this buffer makes
    K1 take."""
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda

    got = rasterize_cuda.raster_fwd(*fargs)
    again = rasterize_cuda.raster_fwd(*fargs)
    want = rasterize_cuda.raster_fwd_plain(*fargs)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"raster_fwd output not finite ({what})")
    require(bit_equal(got, again), f"raster_fwd: two launches differ ({what})")
    torch.testing.assert_close(got[:, 0:3], want[:, 0:3], rtol=COLOR_RTOL, atol=COLOR_ATOL)
    torch.testing.assert_close(got[:, 3], want[:, 3], rtol=DEPTH_RTOL, atol=DEPTH_ATOL)
    torch.testing.assert_close(got[:, 4], want[:, 4], rtol=COLOR_RTOL, atol=COLOR_ATOL)
    mismatch = float((got[:, 5] != want[:, 5]).float().mean())
    require(mismatch <= NCON_MISMATCH, f"raster_fwd: n_contrib mismatch {mismatch} ({what})")
    err = float((got[:, :5] - want[:, :5]).abs().max())
    del again, want
    pairs = int(fargs[2].sum())
    line = (f"raster_fwd: within tolerance of plain on {pairs} pairs ({what}, tile "
            f"{fargs[5]}; max abs err {err:.3g}, n_contrib mismatch {mismatch:.2e}); "
            f"bit-identical repeats")
    if not timed:
        print(line, flush=True)
        return {"max_abs_err": err, "n_contrib_mismatch": mismatch}
    times = kernel_ms(lambda: rasterize_cuda.raster_fwd(*fargs))
    plain_ms = cuda_ms(lambda: rasterize_cuda.raster_fwd_plain(*fargs), reps=3)
    taken = float(got[:, 5].sum())
    # Bytes: the 11 record rows of every pair, tile ranges, the output.
    lim = bound(4.0 * (11 * pairs + 2 * fargs[2].numel() + got.numel()), K1_OPS * taken)
    print(f"{line}; kernel {times['ms']:.4f} ms (a call {times['call_ms']:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}, "
          f"{taken:.0f} pixel-records taken)", flush=True)
    return {"max_abs_err": err, "n_contrib_mismatch": mismatch, **times, "plain_ms": plain_ms,
            **lim, "library_ms": None, "pixel_records": taken}


def check_raster(args, st):
    """K1 on the serving path's buffer: the bench camera at the auto budget."""
    from gaussiansplattingmlx_tpu_torch.ops import staging

    with torch.no_grad():
        staged = staging.stage_pairs_sorted(st, *args)
    require(int(staged.overflow_pairs) == 0, "staging at the auto budget must not overflow")
    grid_w = -(-st.image_width // st.tile_w)
    grid_h = -(-st.image_height // st.tile_h)
    return check_fwd((staged.records_cm, staged.tile_start, staged.tile_count,
                      grid_w, grid_h, st.tile_w, st.tile_h), "serving, bench camera")


def check_small_render(device):
    """End-to-end agreement on a small scene: render() on the card (both
    kernels) against render() on the CPU (both plain versions)."""
    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.render import render
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

    raw = small_scene()
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


def small_scene(n=400):
    rng = np.random.default_rng(SEED + 1)
    return {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32) * 0.5,
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "scales": np.log(rng.uniform(0.02, 0.1, size=(n, 3))).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity": rng.normal(0.5, 1.0, size=(n, 1)).astype(np.float32),
    }


def assert_rows_close(got, want, what, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    for r in range(want.shape[0]):
        scale = max(float(want[r].abs().max()), 1e-30)
        try:
            torch.testing.assert_close(got[r], want[r], rtol=rtol, atol=atol * scale)
        except AssertionError as exc:
            raise SmokeFailure(f"{what}: row {r}: {exc}") from None


def beyond_grad_bars(got, want) -> tuple:
    """(entries of ``got`` outside the GRAD bars of ``want``, the largest
    ratio of an entry's difference to its bar), rows scaled as in
    ``assert_rows_close``."""
    count, worst = 0, 0.0
    for r in range(want.shape[0]):
        scale = max(float(want[r].abs().max()), 1e-30)
        ratio = (got[r] - want[r]).abs() / (GRAD_ATOL * scale + GRAD_RTOL * want[r].abs())
        count += int((ratio > 1).sum())
        worst = max(worst, float(ratio.max()))
    return count, worst


def loss_cotangent_block(records_cm, tile_start, tile_count, width, height, tile, target):
    """K1 forward of a training buffer, then the cotangent block of the real
    L1 + SSIM loss against ``target`` (the block K3 reads)."""
    from gaussiansplattingmlx_tpu_torch.ops import losses, rasterize_cuda

    grid_w, grid_h = -(-width // tile), -(-height // tile)
    out = rasterize_cuda.raster_fwd(records_cm, tile_start, tile_count, grid_w, grid_h,
                                    tile, tile)
    leaf = out.detach().requires_grad_()
    img = rasterize_cuda._untile(leaf, grid_w, grid_h, tile, tile, width, height)
    zeros = torch.zeros_like(img.depth)
    loss, _ = losses.total_loss(img.color, target, img.depth, zeros, zeros)
    (cot,) = torch.autograd.grad(loss, leaf)
    return rasterize_cuda.cotangent_block(cot, out[:, 4:6]), out


def bwd_bound(block, tile_count, out_numel):
    """K3's and K7's bound on a buffer: 11 record rows of every replayed pair,
    the cotangent block, tile ranges and the whole [16, P] output;
    K3_OPS per pixel-record taken.  Returns (bound entry, pixel-records
    taken, pairs replayed)."""
    ncon = block[:, :, 6]
    taken = float(ncon.sum())
    replayed = int(torch.minimum(ncon.max(dim=1).values.to(torch.int32), tile_count).sum())
    lim = bound(4.0 * (11 * replayed + block.numel() + 2 * tile_count.numel() + out_numel),
                K3_OPS * taken)
    return lim, taken, replayed


def check_raster_bwd(args, st, target, device):
    """K3 against its plain version on the bench camera's training buffer
    with the L1 + SSIM cotangent (tile 16), and on a small scene at tile 32
    whose size is no multiple of the tile; two launches must be
    bit-identical.  Returns (this check's times, the training buffer's gid
    and K3 rows for the K4 check)."""
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, staging

    with torch.no_grad():
        sp, gid = staging._stage_train_impl(st, *args)
    require(int(sp.overflow_pairs) == 0, "training staging must not overflow")
    tile = st.tile_w
    grid_w, grid_h = -(-WIDTH // tile), -(-HEIGHT // tile)
    block, out = loss_cotangent_block(sp.records_cm, sp.tile_start, sp.tile_count,
                                      WIDTH, HEIGHT, tile, target)
    bargs = (sp.records_cm, sp.tile_start, sp.tile_count, block, grid_w, grid_h, tile, tile)
    got = rasterize_cuda.raster_bwd(*bargs)
    again = rasterize_cuda.raster_bwd(*bargs)
    want = rasterize_cuda.raster_bwd_plain(*bargs)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "raster_bwd output not finite")
    require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
            "raster_bwd: two launches differ")
    assert_rows_close(got, want, "raster_bwd at tile 16")
    err = float((got - want).abs().max())
    times = kernel_ms(lambda: rasterize_cuda.raster_bwd(*bargs))
    plain_ms = cuda_ms(lambda: rasterize_cuda.raster_bwd_plain(*bargs), reps=3)

    # Tile 32 on a small scene, same checks.
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.ops import projection, rasterize_ref
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

    w32, h32 = 200, 144
    params = params_from_numpy(small_scene(), device)
    c2w = np.eye(4)
    c2w[2, 3] = -4.0
    t = Camera.from_c2w(w32, h32, 180.0, 180.0, c2w).tensors()
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(params)
        p = projection.project_gaussians(
            means, scales, rots, shs,
            *[torch.as_tensor(np.asarray(t[k])).to(device) for k in
              ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x", "focal_y")],
            w32, h32, 3)
        packed = rasterize_ref.pack_gaussians(p.means2d, p.conic, p.colors, opacity, p.depths)
        st32 = staging.StagingStatic(w32, h32, 32, 32, 16384, 128)
        sp32, _ = staging._stage_train_impl(st32, packed, p.rect_min, p.rect_max,
                                            p.radii, p.depths)
    require(int(sp32.overflow_pairs) == 0 and int(sp32.num_pairs) > 0, "tile-32 staging")
    target32 = torch.rand((h32, w32, 3), generator=torch.Generator().manual_seed(SEED)).to(device)
    block32, _ = loss_cotangent_block(sp32.records_cm, sp32.tile_start, sp32.tile_count,
                                      w32, h32, 32, target32)
    b32 = (sp32.records_cm, sp32.tile_start, sp32.tile_count, block32,
           -(-w32 // 32), -(-h32 // 32), 32, 32)
    g32, g32b = rasterize_cuda.raster_bwd(*b32), rasterize_cuda.raster_bwd(*b32)
    w32_plain = rasterize_cuda.raster_bwd_plain(*b32)
    torch.cuda.synchronize()
    require(torch.equal(g32.view(torch.int32), g32b.view(torch.int32)),
            "raster_bwd tile 32: two launches differ")
    assert_rows_close(g32, w32_plain, "raster_bwd at tile 32")

    lim, taken, replayed = bwd_bound(block, sp.tile_count, got.numel())
    print(f"raster_bwd (bench camera): within rtol {GRAD_RTOL} / scaled atol {GRAD_ATOL} of "
          f"plain on {int(sp.num_pairs)} pairs (L1+SSIM cotangent, tile 16; max abs err "
          f"{err:.3g}) and on {int(sp32.num_pairs)} pairs at tile 32 ({w32}x{h32}); "
          f"bit-identical repeats; kernel {times['ms']:.4f} ms (a call "
          f"{times['call_ms']:.4f} ms), plain {plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} "
          f"ms ({lim['bound_by']}, {taken:.0f} pixel-records, {replayed} pairs replayed)",
          flush=True)
    bench = {"bench_tile16_ms": times["ms"], "bench_tile16_call_ms": times["call_ms"],
             "bench_tile16_plain_ms": plain_ms,
             "bench_tile16_bound_ms": lim["bound_ms"], "bench_tile16_max_abs_err": err}
    return bench, gid, got


def segment_profile(offsets) -> dict:
    """The segment lengths K4 sums: rows, used pairs, empty segments, the
    longest segment and the 99th percentile of the non-empty ones."""
    lengths = (offsets[1:] - offsets[:-1]).long()
    used = lengths[lengths > 0].double()
    return {"rows": int(lengths.numel()), "pairs": int(offsets[-1]),
            "empty": int((lengths == 0).sum()), "longest": int(lengths.max()),
            "p99": float(torch.quantile(used, 0.99)) if used.numel() else 0.0}


def check_segsum(gid, rows, num_rec, what):
    """K4 against its plain version on a training buffer's gid and K3's rows;
    two launches bit-identical, column 4 = column 3, columns 11-15 zero;
    torch.segment_reduce as the yardstick.  Also prints the segment profile
    and times K4's feed, ``sort_by_gid`` (the gid sort and the live rows'
    gather), and that gather (two index ops) against one two-index gather.
    Returns the kernels line's entry, timed there."""
    from gaussiansplattingmlx_tpu_torch.ops import segsum_cuda

    rows_s, offsets = segsum_cuda.sort_by_gid(rows, gid, num_rec)
    profile = segment_profile(offsets)
    print(f"segsum segments ({what}): {json.dumps(profile)}", flush=True)
    got = segsum_cuda.segment_sum_sorted(rows_s, offsets)
    again = segsum_cuda.segment_sum_sorted(rows_s, offsets)
    want = segsum_cuda.segment_sum_sorted_plain(rows_s, offsets)
    torch.cuda.synchronize()
    require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
            "segsum: two launches differ")
    require(torch.equal(got[:, 4], got[:, 3]) and bool((got[:, 11:] == 0).all()),
            "segsum: column 4 differs from column 3 or columns 11-15 are not zero")
    torch.testing.assert_close(got, want, rtol=SEGSUM_RTOL,
                               atol=SEGSUM_ATOL * float(want.abs().max()))
    err = float((got - want).abs().max())
    times = kernel_ms(lambda: segsum_cuda.segment_sum_sorted(rows_s, offsets))
    plain_ms = cuda_ms(lambda: segsum_cuda.segment_sum_sorted_plain(rows_s, offsets))
    # K4's feed: the whole sort_by_gid, and its gather of the live rows
    # through the permutation (two gathers: the live rows, then their
    # columns) against one two-index gather, which must give the same bits.
    sort_ms = device_ms(lambda: segsum_cuda.sort_by_gid(rows, gid, num_rec))
    _, perm = torch.sort(torch.clamp(gid, max=num_rec), stable=True)
    live = segsum_cuda._live_index(rows.device)
    require(bit_equal(rows[live[:, None], perm], rows_s), "sort_by_gid: gathers differ")
    gather_ms = device_ms(lambda: rows[live][:, perm])
    gather_one_ms = device_ms(lambda: rows[live[:, None], perm])
    used = int(offsets[-1])
    lengths = (offsets[1:] - offsets[:-1]).long()
    data = rows_s[:, :used].T.contiguous()  # the library call's layout
    library = torch.segment_reduce(data, "sum", lengths=lengths)
    torch.testing.assert_close(library, got[:, list(segsum_cuda.LIVE_ROWS)],
                               rtol=SEGSUM_RTOL, atol=SEGSUM_ATOL * float(want.abs().max()))
    # unsafe=True skips the call's host-side checks of lengths (a device
    # sync, which a CUDA graph cannot hold); the call above made them.
    library_ms = device_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths,
                                                        unsafe=True))
    library_call_ms = cuda_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths))
    live = len(segsum_cuda.LIVE_ROWS)
    lim = bound(4.0 * (live * used + offsets.numel() + got.numel()), live * used)
    print(f"segsum: within rtol {SEGSUM_RTOL} of plain on {used} pairs into {num_rec} "
          f"gaussians ({what}); bit-identical repeats; kernel {times['ms']:.4f} ms (a call "
          f"{times['call_ms']:.4f} ms), plain {plain_ms:.4f} ms, torch.segment_reduce "
          f"{library_ms:.4f} ms (a call {library_call_ms:.4f} ms), bound "
          f"{lim['bound_ms']:.4f} ms ({lim['bound_by']}); sort_by_gid {sort_ms:.4f} ms, "
          f"its row gather {gather_ms:.4f} ms (one two-index gather {gather_one_ms:.4f} ms) over "
          f"{rows.shape[1]} columns", flush=True)
    return {"max_abs_err": err, **times, "plain_ms": plain_ms, **lim,
            "library_ms": library_ms, "library_call_ms": library_call_ms,
            "sort_ms": sort_ms, "gather_ms": gather_ms, "gather_one_ms": gather_one_ms,
            "segments": profile}


def bit_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_merge_ranks(cum, max_pairs, what):
    """K5 against its plain version and torch.searchsorted, bit for bit, on a
    compacted cumsum and pair budget; timed beside both.  Returns the times
    and the bound."""
    from gaussiansplattingmlx_tpu_torch.ops import merge_cuda

    got = merge_cuda.merge_ranks(cum, max_pairs)
    want = merge_cuda.merge_ranks_plain(cum, max_pairs)
    slots = torch.arange(max_pairs, dtype=torch.int32, device=cum.device)
    library = torch.searchsorted(cum, slots, right=True, out_int32=True)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"merge_ranks kernel != plain ({what})")
    require(torch.equal(got, library), f"merge_ranks kernel != torch.searchsorted ({what})")
    times = kernel_ms(lambda: merge_cuda.merge_ranks(cum, max_pairs))
    plain_ms = cuda_ms(lambda: merge_cuda.merge_ranks_plain(cum, max_pairs))
    library = kernel_ms(lambda: torch.searchsorted(cum, slots, right=True, out_int32=True))
    # A few integer compares per slot: the bytes bound it (cum read once,
    # the ranks written once).
    lim = bound(4.0 * (cum.numel() + max_pairs), 0.0)
    print(f"merge_ranks: bit-exact vs plain and torch.searchsorted on {cum.numel()} "
          f"gaussians x {max_pairs} slots ({what}); kernel {times['ms']:.4f} ms (a call "
          f"{times['call_ms']:.4f} ms), plain {plain_ms:.4f} ms, torch.searchsorted "
          f"{library['ms']:.4f} ms (a call {library['call_ms']:.4f} ms), bound "
          f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})", flush=True)
    return {"max_abs_err": 0.0, **times, "plain_ms": plain_ms, **lim,
            "library_ms": library["ms"], "library_call_ms": library["call_ms"]}


def serving_cumsum(args, st):
    """The compacted footprint cumsum of ``args`` at ``st``'s budget: K5's
    input (the bench camera's on the split serving path; the view past 2^24
    pairs on the route above 2^24 slots)."""
    from gaussiansplattingmlx_tpu_torch.ops import binning

    _, rect_min, rect_max, radii, _ = args
    with torch.no_grad():
        e = binning.expand_pairs(rect_min, rect_max, radii, st.image_width, st.image_height,
                                 st.tile_w, st.tile_h, st.max_pairs)
    return e.cum_keep


def relayout_inputs(args, st):
    """The aligned staging's inputs to K6: (sorted records + gid row [12,
    max_pairs], tile_start, tile_count, owner, rank0, num_aligned, pairs)."""
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, staging

    with torch.no_grad():
        rec_rows, gid, start, count, e = staging._sorted_pairs(st, *args)
    require(int(e.overflow_pairs) == 0, "aligned staging must not overflow")
    num_aligned = staging._num_aligned(st)
    _, owner, rank0 = rasterize_cuda.aligned_chunk_plan(count, st.chunk, num_aligned)
    sorted_cm = torch.cat([rec_rows, gid.to(torch.float32)[None]]).contiguous()
    return (sorted_cm, start, count, owner, rank0, st.chunk, num_aligned), int(e.num_pairs)


def check_relayout(args, st, what, timed=True):
    """K6 against its plain version, bit for bit (rows 0-11, row 11 the
    gaussian id as a float value, and the zero columns)."""
    from gaussiansplattingmlx_tpu_torch.ops import relayout_cuda

    rargs, pairs = relayout_inputs(args, st)
    got = relayout_cuda.relayout(*rargs)
    want = relayout_cuda.relayout_plain(*rargs)
    torch.cuda.synchronize()
    require(bit_equal(got, want), f"relayout kernel != plain ({what})")
    require(bool((got[12:] == 0).all()), f"relayout rows 12-15 not zero ({what})")
    num_aligned = rargs[-1]
    line = (f"relayout: bit-exact vs plain on {pairs} pairs into {num_aligned} aligned "
            f"columns ({what}, chunk {st.chunk})")
    if not timed:
        print(line, flush=True)
        return None
    times = kernel_ms(lambda: relayout_cuda.relayout(*rargs))
    plain_ms = cuda_ms(lambda: relayout_cuda.relayout_plain(*rargs))
    rows, nchunks, ntiles = rargs[0].shape[0], rargs[3].numel(), rargs[1].numel()
    # Bytes: the copied columns' rows read once, the [16, num_aligned]
    # output written once, the chunk plan and tile ranges read once.
    lim = bound(4.0 * (rows * pairs + 16 * num_aligned + 2 * nchunks + 2 * ntiles), 0.0)
    print(f"{line}; kernel {times['ms']:.4f} ms (a call {times['call_ms']:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({lim['bound_by']})", flush=True)
    return {"max_abs_err": 0.0, **times, "plain_ms": plain_ms, **lim, "library_ms": None}


def check_raster_bwd_aligned(records_cm, aligned_start, tile_count, tile, chunk, target,
                             what, timed=False):
    """K7 against its plain version on an aligned record buffer with the
    cotangent of L1 + SSIM against ``target``: within tolerance,
    bit-identical over two launches, and bit-equal to K3 run over the same
    buffer with the aligned starts (the two share their device code).  With
    ``timed``, returns the kernel line's entry, K3's time on the same buffer
    printed beside it."""
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda

    grid_w, grid_h = -(-WIDTH // tile), -(-HEIGHT // tile)
    block, _ = loss_cotangent_block(records_cm, aligned_start, tile_count, WIDTH, HEIGHT,
                                    tile, target)
    bargs = (records_cm, aligned_start, tile_count, block, grid_w, grid_h, tile, tile)
    got = rasterize_cuda.raster_bwd_aligned(*bargs, chunk)
    again = rasterize_cuda.raster_bwd_aligned(*bargs, chunk)
    k3 = rasterize_cuda.raster_bwd(*bargs)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"raster_bwd_aligned output not finite ({what})")
    require(bit_equal(got, again), f"raster_bwd_aligned: two launches differ ({what})")
    require(bit_equal(got, k3), f"raster_bwd_aligned != raster_bwd on the same buffer ({what})")
    del again, k3
    want, plain_ms = timed_once(lambda: rasterize_cuda.raster_bwd_plain(*bargs))
    assert_rows_close(got, want, f"raster_bwd_aligned ({what})")
    err = float((got - want).abs().max())
    del want
    line = (f"raster_bwd_aligned: within rtol {GRAD_RTOL} / scaled atol {GRAD_ATOL} of plain "
            f"on {int(tile_count.sum())} pairs in {got.shape[1]} aligned columns ({what}, "
            f"tile {tile}, chunk {chunk}, L1+SSIM cotangent; max abs err {err:.3g}); "
            f"bit-identical repeats; bit-equal to raster_bwd on the same buffer")
    if not timed:
        print(line, flush=True)
        return None
    times = kernel_ms(lambda: rasterize_cuda.raster_bwd_aligned(*bargs, chunk))
    k3_ms = device_ms(lambda: rasterize_cuda.raster_bwd(*bargs))
    lim, taken, replayed = bwd_bound(block, tile_count, got.numel())
    print(f"{line}; kernel {times['ms']:.4f} ms (a call {times['call_ms']:.4f} ms; "
          f"raster_bwd on the same buffer {k3_ms:.4f} ms), plain {plain_ms:.4f} ms (one "
          f"run), bound {lim['bound_ms']:.4f} ms "
          f"({lim['bound_by']}, {taken:.0f} pixel-records, {replayed} pairs replayed)",
          flush=True)
    return {"max_abs_err": err, **times, "plain_ms": plain_ms, **lim, "library_ms": None,
            "design": BWD_DESIGN}


def orbit_targets(ply_path: Path, device, n_views: int = TRAIN_VIEWS):
    """The training data: ``n_views`` orbit cameras (render_cli's orbit) and
    the port's own inference renders of the bench scene as targets."""
    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.data import ply
    from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.render import render
    from gaussiansplattingmlx_tpu_torch.utils.camera import orbit_c2w
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

    params = params_from_numpy(ply.read_gaussian_ply(ply_path), device)
    cfg = RasterizerConfig(max_pairs=RasterizerConfig().max_pairs_limit)
    cams, images = [], []
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(params)
        for i in range(n_views):
            cam = Camera.from_c2w(WIDTH, HEIGHT, FOCAL, FOCAL,
                                  orbit_c2w(2 * np.pi * i / n_views, 4.0, 0.2))
            t = cam.tensors()
            out, aux = render(means, shs, opacity, scales, rots,
                              *[torch.as_tensor(np.asarray(t[k])).to(device) for k in
                                ("view", "proj", "camera_center", "fov_x", "fov_y",
                                 "focal_x", "focal_y")],
                              WIDTH, HEIGHT, SH_DEGREE, raster_cfg=cfg, inference=True)
            require(int(aux.overflow_pairs) == 0, "target render overflowed")
            cams.append(cam)
            images.append(out.color.cpu().numpy())
    return TrainData(cameras=cams, images=np.stack(images).astype(np.float32))


def make_trainer(ply_path: Path, data, device, train=None, tile=TRAIN_TILE, **layout):
    """A Trainer at the bench workload (100,000 points of the bench scene,
    their colours, SH3, 800x800, tile ``tile``) in the record layout that
    ``layout`` selects (RasterizerConfig fields; none: the default).  Without
    ``train`` (TrainConfig fields) it runs TRAIN_STEPS steps with no densify
    and no files."""
    from gaussiansplattingmlx_tpu_torch import config
    from gaussiansplattingmlx_tpu_torch.data import ply
    from gaussiansplattingmlx_tpu_torch.train.trainer import Trainer
    from gaussiansplattingmlx_tpu_torch.utils import sh
    from gaussiansplattingmlx_tpu_torch.utils.point_cloud import PointCloud

    g = ply.read_gaussian_ply(ply_path)
    rgb = np.clip(g.features_dc[:, 0, :] * sh.C0 + 0.5, 0.0, 1.0)
    pc = PointCloud(coords=g.xyz, colors=(rgb * 255.0).astype(np.float32))
    fields = dict(
        iterations=TRAIN_STEPS, init_points=N_GAUSSIANS, log_interval=5,
        output_dir="", seed=SEED, model=config.ModelConfig(sh_degree=SH_DEGREE),
        raster=config.RasterizerConfig(tile_w=tile, tile_h=tile, **layout),
        densify=config.DensifyConfig(from_iter=10 ** 9),
    )
    fields.update(train or {})
    return Trainer(config.TrainConfig(**fields), data, pc, device=device)


def training_setup(ply_path: Path, data, device):
    """The default-layout Trainer, its pair budget set from a probe of every
    view at the initial parameters with 2x headroom: 20 Adam steps can grow
    the Gaussians' footprints, and no step may overflow."""
    from gaussiansplattingmlx_tpu_torch.models import gaussians
    from gaussiansplattingmlx_tpu_torch.ops import binning, projection
    from gaussiansplattingmlx_tpu_torch.render import render

    trainer = make_trainer(ply_path, data, device)
    state = trainer.state
    probe = dataclasses.replace(trainer.cfg.raster, max_pairs=trainer.cfg.raster.max_pairs_limit)
    peak = peak16 = 0
    with torch.no_grad():
        active = gaussians.active_mask(state.params.capacity, state.num_active)
        acts = gaussians.activations(state.params, active)
        for i in range(data.num_views):
            cam = [trainer.views[k][i] for k in ("view", "proj", "camera_center", "fov_x",
                                                 "fov_y", "focal_x", "focal_y")]
            _, aux = render(*acts, *cam, WIDTH, HEIGHT, SH_DEGREE, raster_cfg=probe,
                            active=active, inference=True)
            peak = max(peak, int(aux.num_pairs) + int(aux.overflow_pairs))
            # The same view's pair demand at tile 16, for the record.
            p = projection.project_gaussians(acts[0], acts[3], acts[4], acts[1], *cam,
                                             WIDTH, HEIGHT, SH_DEGREE, active=active)
            e = binning.expand_pairs(p.rect_min, p.rect_max, p.radii, WIDTH, HEIGHT,
                                     16, 16, 512)
            peak16 = max(peak16, int(e.num_pairs) + int(e.overflow_pairs))
    trainer.set_max_pairs(max(512, -(-2 * peak // 512) * 512))
    return trainer, peak, peak16


def first_step_geometry(trainer, view: int = 0, band=None):
    """The staging inputs of the training run's first step (the trainer's
    current parameters, initial before its run; view 0 unless ``view``
    says otherwise; with ``band`` = (rows, first row), that pixel band of
    the view, as render's band window places it) and the staging statics
    of its config."""
    from gaussiansplattingmlx_tpu_torch.models import gaussians
    from gaussiansplattingmlx_tpu_torch.ops import projection, rasterize_ref, staging
    from gaussiansplattingmlx_tpu_torch.render import band_window

    cfg, state, views = trainer.cfg.raster, trainer.state, trainer.views
    width, height = trainer.data.width, trainer.data.height
    rows, first = band if band is not None else (height, None)
    cam = [views[k][view] for k in ("view", "proj", "camera_center", "fov_x", "fov_y",
                                    "focal_x", "focal_y")]
    with torch.no_grad():
        active = gaussians.active_mask(state.params.capacity, state.num_active)
        means, shs, opacity, scales, rots = gaussians.activations(state.params, active)
        p = projection.project_gaussians(means, scales, rots, shs, *cam, width, height,
                                         trainer.cfg.model.sh_degree, active=active)
        means2d, rect_min, rect_max = band_window(p, rows, first)
        packed = rasterize_ref.pack_gaussians(means2d, p.conic, p.colors, opacity, p.depths)
    st = staging.StagingStatic(width, rows, cfg.tile_w, cfg.tile_h, cfg.max_pairs,
                               cfg.chunk_size, cfg.grad_reduce)
    return (packed, rect_min, rect_max, p.radii, p.depths), st


def check_layout_buffers(trainer, layout):
    """The first step's buffers of a non-default layout's training run
    (tile 32, its pair budget, view 0, the L1 + SSIM cotangent against its
    target): K6 (aligned) or K5 (split) bit-exact vs plain, then K1 and K7 on
    the aligned record buffer the layout builds.  Returns the kernel line's
    entries for K6 and K7 (aligned) or K5 (split), timed at the shapes
    their path gives them."""
    from gaussiansplattingmlx_tpu_torch.ops import binning, rasterize_cuda, staging

    args, st = first_step_geometry(trainer)
    what = f"train {layout}, first step"
    grid = (-(-WIDTH // st.tile_w), -(-HEIGHT // st.tile_h))
    if layout == "aligned":
        relayout = check_relayout(args, st, f"training buffers, tile {st.tile_w}")
        with torch.no_grad():
            sp, _ = staging._stage_impl(st, *args)
        require(int(sp.overflow_pairs) == 0, "aligned training buffers overflow")
        check_fwd((sp.records_cm, sp.aligned_start, sp.tile_count, *grid, st.tile_w,
                   st.tile_h), what, timed=False)
        aligned = check_raster_bwd_aligned(sp.records_cm, sp.aligned_start, sp.tile_count,
                                           st.tile_w, st.chunk, trainer.views["target_rgb"][0],
                                           what, timed=True)
        return {"relayout": relayout, "raster_bwd_aligned": aligned}
    packed, rect_min, rect_max, radii, depths = args
    with torch.no_grad():
        e = binning.expand_pairs(rect_min, rect_max, radii, WIDTH, HEIGHT, st.tile_w,
                                 st.tile_h, st.max_pairs)
        ranks = check_merge_ranks(e.cum_keep, st.max_pairs,
                                  f"{what}, tile {st.tile_w}, {int(e.num_pairs)} pairs")
        del e
        b = binning.bin_gaussians(rect_min, rect_max, radii, depths, WIDTH, HEIGHT,
                                  st.tile_w, st.tile_h, st.max_pairs)
        require(int(b.overflow_pairs) == 0, "split training buffers overflow")
        num_tiles = b.tile_count.numel()
        records_cm, aligned_start = rasterize_cuda.split_records(
            packed, b.sorted_gauss_idx, b.tile_start, b.tile_count, num_tiles, st.chunk)
    check_fwd((records_cm, aligned_start, b.tile_count, *grid, st.tile_w, st.tile_h), what,
              timed=False)
    check_raster_bwd_aligned(records_cm, aligned_start, b.tile_count, st.tile_w, st.chunk,
                             trainer.views["target_rgb"][0], what)
    return {"merge_ranks": ranks}


def check_training_buffers(trainer, device, label="training buffers, first step", view=0,
                           band=None, truncated=False):
    """K2, K1, K3 and K4 on the buffers of the trainer's next step
    (``check_step_buffers``): its tile, pair budget and capacity, its
    current parameters (the initial ones before its run), view ``view``
    (with ``band``, one pixel band of it: ``first_step_geometry``) and its
    target."""
    cfg = trainer.cfg.raster
    args, st = first_step_geometry(trainer, view, band)
    target = trainer.views["target_rgb"][view]
    if band is not None:
        target = target[band[1]:band[1] + band[0]]
    return check_step_buffers(args, st, target, trainer.state.params.capacity,
                              f"{label}, max_pairs {cfg.max_pairs}", truncated=truncated)


def check_step_buffers(args, st, target, capacity, what, early_exit=False, truncated=False):
    """K2, K1, K3 and K4 against their plain versions on one training step's
    buffers: the staging inputs ``args`` at the statics ``st`` (tile, pair
    budget), ``capacity`` rows and the L1 + SSIM cotangent against
    ``target``; K1 and K3 also bit-identical over two launches.  K3 is held
    to the GRAD bars, or, with ``early_exit`` (pixels that end near the
    transmittance floor), to the EARLY bars, its entries beyond the GRAD
    bars counted.  Returns the kernels line's entries for K2, K1, K3 and
    K4, timed on these buffers (the shapes their path gives them).  Above ``staging.K2_MAX_SLOTS`` the
    path merges through K5, not K2: K2 is left out (its entry None), and K5
    is checked by ``check_merge_ranks``.  The buffers must not overflow
    unless ``truncated``, and then must fill the budget and drop pairs."""
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, staging

    with torch.no_grad():
        merge = None
        if st.max_pairs <= staging.K2_MAX_SLOTS:
            e, tbl = staging.merge_table(st, *args)
            merge = merge_gather_entry(e.cum_keep, tbl, st.max_pairs, what)
            del e, tbl
        sp, gid = staging._stage_train_impl(st, *args)
    if truncated:
        require(int(sp.overflow_pairs) > 0 and int(sp.num_pairs) == st.max_pairs,
                f"training buffers must fill the budget and drop pairs ({what})")
    else:
        require(int(sp.overflow_pairs) == 0, "training buffers overflow")
    tile = st.tile_w
    grid = (-(-st.image_width // tile), -(-st.image_height // tile))
    fwd = check_fwd((sp.records_cm, sp.tile_start, sp.tile_count, *grid, tile, tile), what)
    block, _ = loss_cotangent_block(sp.records_cm, sp.tile_start, sp.tile_count,
                                    st.image_width, st.image_height, tile, target)
    bargs = (sp.records_cm, sp.tile_start, sp.tile_count, block, *grid, tile, tile)
    got3 = rasterize_cuda.raster_bwd(*bargs)
    again = rasterize_cuda.raster_bwd(*bargs)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got3).all()), "raster_bwd output not finite (training buffers)")
    require(bit_equal(got3, again), "raster_bwd: two launches differ (training buffers)")
    del again
    want3, plain3_ms = timed_once(lambda: rasterize_cuda.raster_bwd_plain(*bargs))
    rtol, atol = (EARLY_RTOL, EARLY_ATOL) if early_exit else (GRAD_RTOL, GRAD_ATOL)
    assert_rows_close(got3, want3, f"raster_bwd on the training buffers (tile {tile})", rtol,
                      atol)
    beyond, worst = beyond_grad_bars(got3, want3)
    err3 = float((got3 - want3).abs().max())
    del want3
    t3 = kernel_ms(lambda: rasterize_cuda.raster_bwd(*bargs))
    lim3, taken3, replayed3 = bwd_bound(block, sp.tile_count, got3.numel())
    print(f"raster_bwd: within rtol {rtol} / scaled atol {atol} of plain on "
          f"{int(sp.num_pairs)} pairs ({what}, tile {tile}; {beyond} entries beyond rtol "
          f"{GRAD_RTOL} / scaled atol {GRAD_ATOL}, worst at {worst:.3f} of it); bit-identical "
          f"repeats, max abs err {err3:.3g}, kernel "
          f"{t3['ms']:.4f} ms (a call {t3['call_ms']:.4f} ms), plain {plain3_ms:.4f} ms "
          f"(one run), bound {lim3['bound_ms']:.4f} ms ({lim3['bound_by']}, {taken3:.0f} "
          f"pixel-records, {replayed3} pairs replayed)", flush=True)
    segsum = check_segsum(gid, got3, capacity, f"{what}, K3's rows")
    bwd = {"max_abs_err": err3, **t3, "plain_ms": plain3_ms, **lim3, "library_ms": None,
           "design": BWD_DESIGN, "rtol": rtol, "beyond_grad_bars": beyond,
           "worst_of_grad_bar": worst}
    return {"merge_gather": merge, "raster_fwd": fwd, "raster_bwd": bwd, "segsum": segsum}


def run_bench(device, counters, gpu) -> dict:
    """The port's bench through its entry point (``python -m
    gaussiansplattingmlx_tpu_torch.bench`` at its defaults) in a fresh
    process: exit code 0, no overflow, a finite loss (the bench fails unless
    every step's loss is bit-identical), K2, K1, K3 and K4 once a timed step
    and no other kernel.  Then K2, K1, K3 and K4 against their plain
    versions on that workload's first-step buffers, built here by the bench
    module's own scene, camera and budget, and timed there.  Returns the
    bench's last line, its launches by kernel and the kernel entries."""
    from gaussiansplattingmlx_tpu_torch import bench as port_bench
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations
    from gaussiansplattingmlx_tpu_torch.ops import projection, rasterize_ref, staging

    proc = subprocess.run([sys.executable, "-m", "gaussiansplattingmlx_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    require(proc.returncode == 0, f"bench exited {proc.returncode}:\n{proc.stdout[-4000:]}"
                                  f"\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(f"bench: {ln}", flush=True)
    line = json.loads(lines[-1])
    launched = json.loads(next(ln for ln in lines if ln.startswith("kernel launches: "))
                          .split(": ", 1)[1])
    steps = line["repeats"] * line["iters"]
    by_name = {name: launched["total"][k.symbol] for name, k in counters.items()}
    require(launched["steps"] == steps and by_name == {
        name: steps if name in BENCH_KERNELS else 0 for name in counters},
        f"bench launches {by_name} over {steps} steps")
    require(line["overflow_pairs"] == 0, f"bench overflow: {line}")
    require(np.isfinite(line["loss"]) and line["num_pairs"] > 0, f"bench line: {line}")
    require(line["device"] == torch.cuda.get_device_name(0), f"bench device: {line}")
    print(f"bench line: {lines[-1]} | {gpu}", flush=True)

    d = port_bench.parse_args([])
    size, deg, tile = d.size, d.sh_degree, d.tile
    params, target = port_bench.bench_scene(d.gaussians, deg, d.seed, device, size)
    cam = port_bench.camera_args(port_bench.bench_camera(size), device)
    demand = port_bench.pair_demand(params, cam, size, deg, tile)
    max_pairs = port_bench.pair_budget(demand, d.chunk)
    require(max_pairs == line["max_pairs"] and line["tile"] == tile,
            f"the bench's budget {line['max_pairs']} != {max_pairs} here")
    with torch.no_grad():
        means, shs, opacity, scales, rots = activations(params)
        p = projection.project_gaussians(means, scales, rots, shs, *cam, size, size, deg)
        packed = rasterize_ref.pack_gaussians(p.means2d, p.conic, p.colors, opacity, p.depths)
    st = staging.StagingStatic(size, size, tile, tile, max_pairs, d.chunk)
    entries = check_step_buffers((packed, p.rect_min, p.rect_max, p.radii, p.depths), st,
                                 target, d.gaussians,
                                 f"bench.py's workload, first step, {demand} pairs probed, "
                                 f"max_pairs {max_pairs}", early_exit=True)
    return {"line": line, "launches": by_name, "entries": entries}


def run_training(trainer, counters, steps=TRAIN_STEPS):
    """The training path through its entry point, ``steps`` steps, counters
    zeroed just before and read just after."""
    for k in counters.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = trainer.run(steps, on_metrics=log.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    return log, final, seconds, launches


def check_train_run(trainer, log, final, launches, expected, seconds, peak_mem, what,
                    extra="", steps=TRAIN_STEPS):
    """The checks of a training run of ``steps`` steps: finite, falling
    losses, gradients that reach the Gaussians, no overflow, every step
    run, and the expected launch count of every kernel."""
    gpu = gpu_line()
    require(len(log) >= 2 and all(np.isfinite(m["loss"]) for m in log),
            f"{what}: non-finite or missing losses: {[m['loss'] for m in log]}")
    require(log[-1]["loss"] < log[0]["loss"],
            f"{what}: loss did not fall: {log[0]['loss']} -> {log[-1]['loss']}")
    require(final["grad_coverage"] > 0, f"{what}: no gaussian received a gradient")
    require(final["overflow_pairs_acc"] == 0, f"{what}: a training step overflowed the budget")
    require(int(trainer.state.step) == steps, f"{what}: not every step ran")
    require(launches == expected, f"{what}: launches {launches}, expected {expected}")
    window = sum(5 / m["iters_per_s"] for m in log[1:])
    print(f"{what}: {steps} steps of {int(final['num_active'])} gaussians "
          f"SH{SH_DEGREE} {WIDTH}x{HEIGHT} tile {TRAIN_TILE} over {TRAIN_VIEWS} views, "
          f"max_pairs {trainer.cfg.raster.max_pairs}{extra}, num_pairs "
          f"{int(final['num_pairs'])}; loss {log[0]['loss']:.5f} -> {log[-1]['loss']:.5f}, "
          f"psnr {log[0]['psnr']:.3f} -> {log[-1]['psnr']:.3f} dB, grad_coverage "
          f"{final['grad_coverage']:.4f}; {steps / seconds:.2f} steps/s over all "
          f"{steps} steps, {5 * (len(log) - 1) / window:.2f} steps/s over steps "
          f"6-{steps}; peak memory {peak_mem / 2**30:.3f} GiB; launches "
          f"{launches} | {gpu}", flush=True)


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def require_states_match(got: dict, want: dict, fresh, what: str) -> None:
    """Two states as ``state_to_numpy`` gives them: bit for bit, except the
    xyz and scales of the rows a densify round created (``fresh``, a row
    mask or None), which are held to FRESH_RTOL / FRESH_ATOL."""
    require(set(got) == set(want), f"{what}: keys {sorted(set(got) ^ set(want))}")
    for k, w in want.items():
        g = got[k]
        require(g.dtype == w.dtype and g.shape == w.shape, f"{what}: {k} {g.shape} {w.shape}")
        if fresh is not None and k in ("param_xyz", "param_scales"):
            require(np.array_equal(bits(g[~fresh]), bits(w[~fresh])), f"{what}: {k} differs")
            require(np.allclose(g[fresh], w[fresh], rtol=FRESH_RTOL, atol=FRESH_ATOL),
                    f"{what}: {k} of fresh rows beyond rtol {FRESH_RTOL} / atol {FRESH_ATOL}")
        else:
            require(np.array_equal(bits(g), bits(w)), f"{what}: {k} differs")


def check_prng(device, gpu: str) -> None:
    """The densify noise stream drawn on the card and on the CPU from seed
    SEED's first densify key at the largest draw a round makes: the bits
    bit-equal, the normals within the CPU tests' bar against JAX (at least
    99% of entries bit-equal, none more than 4 ulp apart); each draw timed
    on the card."""
    from gaussiansplattingmlx_tpu_torch.utils import prng

    key = prng.split(prng.prng_key(SEED))[1]
    bits = prng.random_bits(key, PRNG_SHAPE, device)
    require(torch.equal(bits.cpu(), prng.random_bits(key, PRNG_SHAPE)),
            "prng: the bits drawn on the card differ from the CPU's")
    normal = prng.normal(key, PRNG_SHAPE, device)
    require(bool(torch.isfinite(normal).all()), "prng: non-finite normals")
    ulp = prng.ulp_distance(normal.cpu(), prng.normal(key, PRNG_SHAPE))
    equal, worst = int((ulp == 0).sum()), int(ulp.max())
    require(equal >= NORMAL_EQUAL_SHARE * ulp.numel() and worst <= NORMAL_MAX_ULP,
            f"prng: {equal} of {ulp.numel()} normals bit-equal to the CPU's, max {worst} ulp")
    bits_ms = cuda_ms(lambda: prng.random_bits(key, PRNG_SHAPE, device))
    normal_ms = cuda_ms(lambda: prng.normal(key, PRNG_SHAPE, device))
    print(f"prng: {list(PRNG_SHAPE)} from key {key.tolist()} (seed {SEED}'s first densify "
          f"key): bits card == cpu, {bits.numel()} of {bits.numel()} bit-equal; normal "
          f"{equal} of {ulp.numel()} bit-equal, max {worst} ulp (bars "
          f"{NORMAL_EQUAL_SHARE:.0%}, {NORMAL_MAX_ULP} ulp), mean {float(normal.mean()):.5f} "
          f"std {float(normal.std()):.5f}; bits {bits_ms:.4f} ms, normal {normal_ms:.4f} ms "
          f"(one call between CUDA events) | {gpu}", flush=True)


def stats_dict(stats) -> dict:
    return {k: int(v) for k, v in stats._asdict().items()}


def densify_ms(step, state, noise) -> float:
    """Device milliseconds of one densify step on a copy of ``state``
    (CUDA events around one call, after a warm-up call on another copy)."""
    from gaussiansplattingmlx_tpu_torch.train import trainer as trainer_mod

    host = trainer_mod.state_to_numpy(state)
    step(trainer_mod.state_from_numpy(host, noise.device), noise)
    copy = trainer_mod.state_from_numpy(host, noise.device)
    torch.cuda.synchronize()
    _, ms = timed_once(lambda: step(copy, noise))
    return ms


def check_densify(trainer, device) -> None:
    """The densify step (Adam reset) and the prune-only step on the card
    against the same steps on CPU copies, from the sorted run's state after
    its steps (gradient statistic of TRAIN_STEPS views), with one draw of the
    trainer's noise stream made on the card and copied to the CPU: equal
    stats, a bit-exact gather map
    and noise modes, bit-exact parameters and moments but for the fresh
    rows' xyz and scales; each step timed on the card."""
    from gaussiansplattingmlx_tpu_torch import config
    from gaussiansplattingmlx_tpu_torch.train import densify
    from gaussiansplattingmlx_tpu_torch.train import trainer as trainer_mod

    cfg = dataclasses.replace(trainer.cfg, densify=config.DensifyConfig(**DENSIFY))
    host = trainer_mod.state_to_numpy(trainer.state)
    cap = trainer.state.params.capacity
    noise = trainer.densify_noise(cap)
    for kind, allow in (("densify", True), ("prune-only", False)):
        step = trainer_mod.make_densify_step(cfg, allow_densify=allow)
        runs = {}
        for where, dev, nz in (("card", device, noise), ("cpu", "cpu", noise.cpu())):
            s = trainer_mod.state_from_numpy(host, dev)
            _, stats, idx, mode = densify.split_and_prune(
                s.params, s.num_active, s.grad_accum, s.grad_denom, nz, allow_densify=allow,
                **trainer_mod.densify_options(cfg))
            s, step_stats = step(s, nz)
            runs[where] = (stats_dict(stats), idx.cpu().numpy(), mode.cpu().numpy(),
                           trainer_mod.state_to_numpy(s), stats_dict(step_stats))
        (gs, gi, gm, gstate, gss), (cs, ci, cm, cstate, css) = runs["card"], runs["cpu"]
        require(gs == cs and gss == css == gs, f"{kind}: stats card {gs} / {gss}, cpu {cs} / {css}")
        require(np.array_equal(gi, ci) and np.array_equal(gm, cm),
                f"{kind}: gather map or noise modes differ")
        fresh = cm != 0
        require(fresh.any() == allow and fresh.sum() == 2 * (cs["n_split"] + cs["n_clone"]),
                f"{kind}: {int(fresh.sum())} fresh rows for {cs}")
        require_states_match(gstate, cstate, fresh, f"{kind} card vs cpu")
        err = float(np.abs(gstate["param_xyz"] - cstate["param_xyz"]).max(initial=0.0))
        ms = densify_ms(step, trainer.state, noise)
        print(f"densify ({kind}, card == cpu): stats {gs} from {int(host['num_active'])} of "
              f"{cap} slots after {TRAIN_STEPS} steps (grad_threshold {GRAD_THRESHOLD}); "
              f"gather map and noise modes bit-exact, parameters and moments bit-exact but "
              f"{int(fresh.sum())} fresh rows' xyz/scales (max abs err {err:.3g}); "
              f"{ms:.4f} ms device time (one call, CUDA events)", flush=True)


def run_truncated(ply_path: Path, data, device, counters, expect, gpu: str):
    """The training setup on view 0 with its pair budget, and the budget's
    limit, cut to TRUNCATE_SHARE of that view's demand, as the flagship's
    runs train hundreds of steps at their limit: K2, K1, K3 and K4 against
    their plain versions on the first step's own buffers (two launches
    bit-identical); then TRUNCATE_STEPS steps through Trainer.run, counters
    zeroed just before, each of the four kernels launched once a step, the
    first step's overflow counts equal to the plain expansion's on CPU
    copies of its inputs, and the at-limit branch taken: a warning each
    logged step and no growth.  Returns (the kernels line's entries for K2,
    K1, K3 and K4, the run's launches)."""
    import contextlib
    import io

    from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
    from gaussiansplattingmlx_tpu_torch.ops import binning

    view0 = TrainData(cameras=data.cameras[:1], images=data.images[:1])
    trainer = make_trainer(ply_path, view0, device,
                           train={"iterations": TRUNCATE_STEPS, "log_interval": 1})
    (_, rect_min, rect_max, radii, _), st = first_step_geometry(trainer)
    with torch.no_grad():
        plain = binning.expand_pairs(rect_min.cpu(), rect_max.cpu(), radii.cpu(), WIDTH, HEIGHT,
                                     st.tile_w, st.tile_h, 2 ** 30)
    demand = int(plain.num_pairs)
    budget = int(demand * TRUNCATE_SHARE) // 512 * 512
    with torch.no_grad():
        plain = binning.expand_pairs(rect_min.cpu(), rect_max.cpu(), radii.cpu(), WIDTH, HEIGHT,
                                     st.tile_w, st.tile_h, budget)
    want = [int(plain.num_pairs), int(plain.overflow_pairs), int(plain.overflow_gaussians)]
    require(want[0] == budget and want[1] == demand - budget and want[2] > 0,
            f"truncated: plain expansion {want} at budget {budget} of demand {demand}")
    trainer.cfg = dataclasses.replace(trainer.cfg, raster=dataclasses.replace(
        trainer.cfg.raster, max_pairs_limit=budget))
    trainer.set_max_pairs(budget)
    what = (f"truncated step, view 0 at {budget} of its {demand} pairs, {want[2]} gaussians "
            f"losing pairs")
    entries = check_training_buffers(trainer, device, what, truncated=True)

    for k in counters.values():
        k.launches = 0
    log, err = [], io.StringIO()
    with contextlib.redirect_stderr(err):
        trainer.run(on_metrics=log.append)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    sys.stderr.write(err.getvalue())
    steps = TRUNCATE_STEPS
    require(launches == expect(merge_gather=steps, raster_fwd=steps, raster_bwd=steps,
                               segsum=steps), f"truncated: launches {launches}")
    got = [int(log[0][k]) for k in ("num_pairs", "overflow_pairs", "overflow_gaussians")]
    require(got == want, f"truncated: the step's counts {got}, the plain expansion's {want}")
    require(all(np.isfinite(m["loss"]) and m["overflow_pairs"] > 0 for m in log),
            f"truncated: {log}")
    warned = err.getvalue().count(f"but max_pairs_limit reached (max_pairs={budget})")
    require(warned == steps and "growing max_pairs" not in err.getvalue()
            and trainer.cfg.raster.max_pairs == budget,
            f"truncated: {warned} limit warnings, max_pairs {trainer.cfg.raster.max_pairs}")
    print(f"truncated: {steps} sorted steps of {N_GAUSSIANS} gaussians on view 0 at "
          f"max_pairs = max_pairs_limit = {budget} ({TRUNCATE_SHARE} of its {demand} pairs); "
          f"first step num_pairs / overflow pairs / overflow gaussians {got} = the plain "
          f"expansion's; the limit warning on each of {steps} logged steps, no growth; loss "
          f"{[round(m['loss'], 5) for m in log]}; launches {launches} | {gpu}", flush=True)
    return entries, launches


def dense_config(out_dir) -> dict:
    """TrainConfig fields of the densified run, writing into ``out_dir``
    (none: no files)."""
    from gaussiansplattingmlx_tpu_torch import config

    return dict(iterations=DENSE_STEPS, output_dir=str(out_dir or ""),
                model=config.ModelConfig(sh_degree=SH_DEGREE,
                                         max_gaussians=DENSE_MAX_GAUSSIANS),
                raster=config.RasterizerConfig(tile_w=TRAIN_TILE, tile_h=TRAIN_TILE,
                                               max_pairs_limit=2 ** 24),
                densify=config.DensifyConfig(**DENSIFY), **DENSE_WRITES)


def run_densified(ply_path: Path, data, device, budget, out_dir: Path, counters):
    """The densified training run through ``Trainer.run``, counters zeroed
    just before and read just after; each round's stats recorded.  Returns
    (trainer, log, seconds, launches, rounds, peak memory)."""
    trainer = make_trainer(ply_path, data, device, train=dense_config(out_dir))
    trainer.set_max_pairs(budget)
    rounds = []

    def recorded(fn, kind):
        def step(state, noise):
            cap, n = state.params.capacity, int(state.num_active)
            avg = state.grad_accum[:n] / state.grad_denom
            q = torch.quantile(avg, torch.tensor(AVG_GRAD_QUANTILES, device=avg.device))
            state, stats = fn(state, noise)
            rounds.append({"step": int(state.step), "kind": kind, "capacity": cap,
                           **stats_dict(stats),
                           "avg_grad_quantiles": [float(f"{v:.4g}") for v in q.tolist()]})
            return state, stats
        return step

    trainer.densify_step = recorded(trainer.densify_step, "densify")
    trainer.prune_step = recorded(trainer.prune_step, "prune-only")
    for k in counters.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(on_metrics=log.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    return trainer, log, seconds, launches, rounds, torch.cuda.max_memory_allocated()


def check_densified(trainer, log, launches, expected, rounds, out_dir: Path):
    """The densified run's checks: its rounds, a split or clone and a prune,
    the capacity growth, no overflow, finite losses, every step, the
    expected launches and the files it writes.  Returns the files."""
    require([(r["step"], r["kind"]) for r in rounds]
            == [(10, "densify"), (20, "densify"), (30, "prune-only")], f"rounds {rounds}")
    require(sum(r["n_split"] + r["n_clone"] for r in rounds) > 0, "no split or clone")
    require(sum(r["n_prune"] for r in rounds) > 0, "no prune")
    require(trainer.state.params.capacity == 2 * rounds[0]["capacity"],
            f"capacity {rounds[0]['capacity']} -> {trainer.state.params.capacity}: no growth")
    require(all(np.isfinite(m["loss"]) for m in log), f"losses {[m['loss'] for m in log]}")
    require(log[-1]["overflow_pairs_acc"] == 0, "a densified step overflowed the budget")
    require(int(trainer.state.step) == DENSE_STEPS, "not every densified step ran")
    require(launches == expected, f"densified launches {launches}, expected {expected}")
    files = sorted(p.relative_to(out_dir).as_posix() for p in out_dir.rglob("*") if p.is_file())
    want = ["ckpt_15.npz", "ckpt_30.npz", "iteration_30.ply"]
    require(all(f in files for f in want), f"files {files}")
    pngs = [f for f in files if f.startswith("previews/") and f.endswith(".png")]
    require(sorted(int(f.split("_")[1]) for f in pngs) == [10, 20, 30], f"previews {pngs}")
    return files


def check_resume(ply_path: Path, data, device, budget, ckpt: Path, full_state: dict,
                 full_log: list, counters):
    """A new Trainer restores the densified run's step-15 checkpoint and runs
    to its end: parameters, moments, counters and logged losses bit-identical
    to the uninterrupted run's."""
    from gaussiansplattingmlx_tpu_torch.train import trainer as trainer_mod

    trainer = make_trainer(ply_path, data, device, train=dense_config(None))
    trainer.set_max_pairs(budget)
    trainer.restore_checkpoint(ckpt)
    start = int(trainer.state.step)
    for k in counters.values():
        k.launches = 0
    log = []
    trainer.run(on_metrics=log.append)
    launches = {name: k.launches for name, k in counters.items()}
    got = trainer_mod.state_to_numpy(trainer.state)
    require_states_match(got, full_state, None, "resumed vs uninterrupted")
    tail = [(m["iteration"], m["loss"]) for m in full_log if m["iteration"] > start]
    mine = [(m["iteration"], m["loss"]) for m in log]
    require(mine == tail, f"resumed losses {mine} != uninterrupted {tail}")
    return start, mine, launches


def run_split_serving(ply_path: Path, device, max_pairs, fused_colors, counters):
    """The split layout's serving path: render_many over SPLIT_FRAMES orbit
    frames of the bench scene at the serving run's pair budget, counters
    zeroed just before and read just after.  Frames 0, 4, 8, 12 are the
    serving run's four orbit views and must match its images."""
    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.data import ply
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.render import render_many
    from gaussiansplattingmlx_tpu_torch.utils.camera import orbit_c2w
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

    params = params_from_numpy(ply.read_gaussian_ply(ply_path), device)
    cfg = RasterizerConfig(staging="split", max_pairs=max_pairs)
    keys = ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x", "focal_y")
    ts = [Camera.from_c2w(WIDTH, HEIGHT, FOCAL, FOCAL,
                          orbit_c2w(2 * np.pi * i / SPLIT_FRAMES, 4.0, 0.2)).tensors()
          for i in range(SPLIT_FRAMES)]
    cams = [torch.as_tensor(np.stack([np.asarray(t[k], np.float32) for t in ts])).to(device)
            for k in keys]
    with torch.no_grad():
        acts = activations(params)

        def run():
            return render_many(*acts, *cams, WIDTH, HEIGHT, SH_DEGREE, raster_cfg=cfg)

        run()  # warm-up
        for k in counters.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        colors, _, npairs, overflow = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    require(int(overflow.sum()) == 0, f"split serving overflowed: {overflow.tolist()}")
    require(bool(torch.isfinite(colors).all()), "split serving: non-finite pixels")
    same = []
    for j, want in enumerate(fused_colors):
        got = colors[j * SPLIT_FRAMES // len(fused_colors)].cpu()
        want = torch.as_tensor(want)
        torch.testing.assert_close(got, want, rtol=COLOR_RTOL, atol=COLOR_ATOL)
        same.append(bool(torch.equal(got, want)))
    return launches, seconds, npairs, peak_mem, same


def zero_counters(counters) -> None:
    for k in counters.values():
        k.launches = 0


def cli_run(cli, argv, counters):
    """``cli.main(argv)`` with every launch counter set to 0 just before and
    read just after.  Returns (result, seconds, launches, peak memory)."""
    zero_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    return res, seconds, launches, torch.cuda.max_memory_allocated()


def steps_per_s(history, after: int = 0) -> float:
    """Steps per second over the logged windows that start at or after step
    ``after`` (each log line's iters_per_s covers the steps since the one
    before)."""
    its = [0] + [m["iteration"] for m in history]
    spans = [(b - a, (b - a) / m["iters_per_s"])
             for a, b, m in zip(its, its[1:], history) if a >= after]
    return sum(n for n, _ in spans) / sum(t for _, t in spans)


def check_cli_training(res, what: str) -> list:
    """A train_cli run's checks: every step run, finite losses, no step over
    the pair budget (the run's total, so unlogged steps count too).
    Returns its logged metrics."""
    history = res.trainer.history
    require(len(history) >= 2 and all(np.isfinite(m["loss"]) for m in history),
            f"{what}: non-finite or missing losses {[m['loss'] for m in history]}")
    require(all(m["overflow_pairs"] == 0 for m in history)
            and res.final["overflow_pairs_acc"] == 0,
            f"{what}: a step overflowed the pair budget "
            f"({[m['overflow_pairs'] for m in history]}, total {res.final['overflow_pairs_acc']})")
    return history


def check_cli_eval(ev, launches, views: int, expect, what: str) -> None:
    require(launches == expect(merge_gather=views, raster_fwd=views),
            f"{what}: launches {launches}")
    require(ev.metrics["views"] == views and all(o == 0 for o in ev.overflow_pairs),
            f"{what}: overflow {ev.overflow_pairs}")
    require(all(np.isfinite(c).all() for c in ev.colors)
            and np.isfinite(ev.metrics["psnr_mean"]), f"{what}: non-finite render or PSNR")


def require_checkpoints_equal(a: Path, b: Path, what: str) -> None:
    """Two checkpoint files bit for bit, but for the output directory in
    their saved configs."""
    with np.load(a) as za, np.load(b) as zb:
        require(sorted(za.files) == sorted(zb.files), f"{what}: keys differ")
        for k in za.files:
            if k == "config_json":
                ca, cb = (json.loads(bytes(z[k]).decode("utf-8")) for z in (za, zb))
                ca.pop("output_dir"), cb.pop("output_dir")
                require(ca == cb, f"{what}: saved configs differ")
            else:
                require(za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape
                        and za[k].tobytes() == zb[k].tobytes(), f"{what}: {k} differs")


def check_loader() -> None:
    """The port's COLMAP loader on the vendored scene at factors 1.0 and 0.5,
    its PNGs decoded and resized without Pillow."""
    from gaussiansplattingmlx_tpu_torch.data import colmap

    seconds = {}
    for factor, size in ((1.0, (256, 192)), (0.5, (128, 96))):
        t0 = time.perf_counter()
        data, pcd = colmap.load_colmap(VENDOR, resize_factor=factor)
        seconds[factor] = time.perf_counter() - t0
        require(data.num_views == 10 and (data.width, data.height) == size
                and pcd.size == 4000, f"vendored scene at {factor}: {data.num_views} views "
                f"{data.width}x{data.height}, {pcd.size} points")
        require(bool(np.isfinite(data.images).all()) and 0.1 < float(data.images.mean()) < 0.9,
                f"vendored scene at {factor}: implausible pixels")
    require("PIL" not in sys.modules, "the loader imported Pillow")
    print(f"loader: load_colmap(tests/fixtures/vendor_scene): 10 views, 4000 points; "
          f"256x192 in {seconds[1.0]:.3f} s at factor 1.0, 128x96 in {seconds[0.5]:.3f} s "
          f"at 0.5; Pillow installed: {importlib.util.find_spec('PIL') is not None}, "
          f"imported: no", flush=True)


def run_vendor(tmp: Path, counters, expect, gpu: str) -> dict:
    """The vendored scene through train_cli at the default config, eval_cli
    on the step-100 and the final PLY, and a resume from the step-500
    checkpoint into a fresh directory whose final checkpoint must equal the
    uninterrupted run's.  Returns the launches of each run."""
    from gaussiansplattingmlx_tpu_torch import eval_cli, train_cli

    cfg_path = tmp / "vendor_config.json"
    cfg_path.write_text(json.dumps(VENDOR_WRITES))
    argv = ["--dataset", "colmap", "--root", str(VENDOR), "--resize-factor", "1.0",
            "--iterations", str(VENDOR_STEPS), "--config", str(cfg_path), "--device", "cuda"]
    out = tmp / "vendor"
    res, seconds, launches, peak = cli_run(train_cli, argv + ["--output", str(out)], counters)
    steps = VENDOR_STEPS
    require(launches == expect(merge_gather=steps, raster_fwd=steps, raster_bwd=steps,
                               segsum=steps), f"vendored training launches {launches}")
    history = check_cli_training(res, "vendored training")
    trainer = res.trainer
    budget = trainer.cfg.raster.max_pairs
    evals, eval_launches = {}, {}
    for step in (100, steps):
        ev, _, ev_launches, _ = cli_run(eval_cli, [
            "--dataset", "colmap", "--root", str(VENDOR), "--ply",
            str(out / f"iteration_{step}.ply"), "--resize-factor", "1.0",
            "--max-pairs", str(budget), "--device", "cuda"], counters)
        check_cli_eval(ev, ev_launches, 10, expect, f"vendored eval at step {step}")
        evals[step], eval_launches[step] = ev, ev_launches
    early, late = evals[100].metrics, evals[steps].metrics
    require(late["psnr_mean"] >= early["psnr_mean"] + PSNR_GAIN_DB
            and late["psnr_mean"] >= PSNR_FLOOR_DB,
            f"vendored scene did not converge: eval PSNR {early['psnr_mean']:.3f} at step 100, "
            f"{late['psnr_mean']:.3f} at step {steps}")
    print(f"train_cli vendored: tests/fixtures/vendor_scene 10 views 256x192, default config "
          f"(SH{trainer.cfg.model.sh_degree}, tile {trainer.cfg.raster.tile_w}, densify from "
          f"{trainer.cfg.densify.from_iter} every {trainer.cfg.densify.interval}), {steps} steps: "
          f"gaussians 4000 -> {int(trainer.state.num_active)}, capacity "
          f"{trainer.state.params.capacity}, max_pairs {budget}, overflow 0; loss "
          f"{history[0]['loss']:.5f} -> {history[-1]['loss']:.5f}; eval PSNR "
          f"{early['psnr_mean']:.3f} dB (step 100) -> {late['psnr_mean']:.3f} dB, SSIM "
          f"{early['ssim_mean']:.4f} -> {late['ssim_mean']:.4f}; pairs a view at the end "
          f"{evals[steps].num_pairs}; {steps / seconds:.2f} steps/s over the whole CLI call "
          f"({seconds:.2f} s), {steps_per_s(history):.2f} over the {steps} steps, "
          f"{steps_per_s(history, 100):.2f} over steps 101-{steps}; peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches} | {gpu}", flush=True)
    del res, trainer
    # The oracle through eval_cli on the step-100 PLY, at a quarter size.
    eval_ref_launches = check_eval_reference(out / "iteration_100.ply", counters, expect)

    resumed, _, resume_launches, _ = cli_run(
        train_cli, argv + ["--output", str(tmp / "vendor_resumed"), "--resume",
                           str(out / f"ckpt_{VENDOR_RESUME}.npz")], counters)
    left = steps - VENDOR_RESUME
    require(resume_launches == expect(merge_gather=left, raster_fwd=left, raster_bwd=left,
                                      segsum=left), f"resumed launches {resume_launches}")
    require_checkpoints_equal(out / f"ckpt_{steps}.npz",
                              tmp / "vendor_resumed" / f"ckpt_{steps}.npz", "resumed CLI run")
    print(f"train_cli resume: --resume ckpt_{VENDOR_RESUME}.npz into a fresh directory, steps "
          f"{VENDOR_RESUME + 1}-{steps}: ckpt_{steps}.npz bit-identical to the uninterrupted "
          f"run's (output_dir aside); launches {resume_launches} | {gpu}", flush=True)
    del resumed
    return {"vendor": launches, "vendor_eval": eval_launches[steps],
            "vendor_eval_reference": eval_ref_launches, "vendor_resumed": resume_launches}


def vendor_module():
    """scripts/make_vendor_scene.py as a module, its globals set as its main()
    sets them for an 800x800 scene with --rich (main() itself, which needs
    Pillow, is not called)."""
    spec = importlib.util.spec_from_file_location(
        "make_vendor_scene", ROOT / "scripts" / "make_vendor_scene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.W = mod.H = FULL_SIZE
    mod.FOCAL = 290.0 * FULL_SIZE / 256.0
    mod.N_VIEWS = FULL_VIEWS
    mod.SPHERES = mod.SPHERES + mod.RICH_SPHERES
    return mod


def ring_c2w(mod, i: int) -> np.ndarray:
    """View i of make_vendor_scene's camera ring."""
    ang = 2 * np.pi * i / FULL_VIEWS
    pos = np.array([2.6 * np.sin(ang), 1.3 + 0.25 * np.sin(2 * ang), -2.6 * np.cos(ang)])
    return mod.look_at_c2w(pos, np.array([0.0, 0.35, 0.0]))


def full_view(i: int) -> np.ndarray:
    """One ray-traced 800x800 view as uint8 (a worker process's task)."""
    mod = vendor_module()
    with np.errstate(invalid="ignore"):  # rays that miss the floor
        img = mod.render_view(ring_c2w(mod, i))
    return (img * 255 + 0.5).astype(np.uint8)


def write_full_scene(dest: Path) -> float:
    """The full-width COLMAP scene written into ``dest``; returns its
    seconds."""
    from gaussiansplattingmlx_tpu_torch.utils.png import write_png

    t0 = time.perf_counter()
    mod = vendor_module()
    (dest / "images").mkdir(parents=True)
    workers = min(FULL_WORKERS, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        images = pool.map(full_view, range(FULL_VIEWS))
    for i, img in enumerate(images):
        write_png(dest / "images" / f"frame_{i:03d}.png", img)
    pts, cols = mod.surface_points(np.random.default_rng(7), n=FULL_POINTS)
    mod.write_colmap(dest, [ring_c2w(mod, i) for i in range(FULL_VIEWS)], pts, cols)
    return time.perf_counter() - t0


def full_budget(argv) -> tuple:
    """(pair budget, initial peak): the trainer train_cli builds from
    ``argv``, every view's pairs at tile 16 at its initial parameters; the
    budget is the default unless FULL_HEADROOM times the peak is larger."""
    from gaussiansplattingmlx_tpu_torch import train_cli
    from gaussiansplattingmlx_tpu_torch.models import gaussians
    from gaussiansplattingmlx_tpu_torch.ops import binning, projection

    from gaussiansplattingmlx_tpu_torch.train.trainer import Trainer

    args = train_cli.parse_args(argv)
    cfg = dataclasses.replace(train_cli.build_config(args), output_dir="")
    data, pcd = train_cli.LOADERS[args.dataset](args.root, resize_factor=cfg.resize_factor)
    pcd, centroid = pcd.centering()
    data = data.shift_cameras(centroid)
    trainer = Trainer(cfg, data, pcd, device=args.device)
    state, r = trainer.state, cfg.raster
    peak = 0
    with torch.no_grad():
        active = gaussians.active_mask(state.params.capacity, state.num_active)
        acts = gaussians.activations(state.params, active)
        for i in range(data.num_views):
            cam = [trainer.views[k][i] for k in ("view", "proj", "camera_center", "fov_x",
                                                 "fov_y", "focal_x", "focal_y")]
            p = projection.project_gaussians(acts[0], acts[3], acts[4], acts[1], *cam,
                                             data.width, data.height, cfg.model.sh_degree,
                                             active=active)
            e = binning.expand_pairs(p.rect_min, p.rect_max, p.radii, data.width, data.height,
                                     r.tile_w, r.tile_h, 512)
            peak = max(peak, int(e.num_pairs) + int(e.overflow_pairs))
    return max(r.max_pairs, -(-FULL_HEADROOM * peak // 512) * 512), peak


def run_full(tmp: Path, counters, expect, gpu: str):
    """The full-width scene through train_cli and eval_cli.  Returns (the
    run's trainer, the launches of each run)."""
    from gaussiansplattingmlx_tpu_torch import eval_cli, train_cli
    from gaussiansplattingmlx_tpu_torch.data import colmap

    scene = tmp / "full_scene"
    scene_s = write_full_scene(scene)
    t0 = time.perf_counter()
    data, _ = colmap.load_colmap(scene, resize_factor=0.5)
    load_half_s = time.perf_counter() - t0
    half = FULL_SIZE // 2
    require((data.num_views, data.width, data.height) == (FULL_VIEWS, half, half),
            f"full scene at 0.5: {data.num_views} views {data.width}x{data.height}")
    del data
    argv = ["--dataset", "colmap", "--root", str(scene), "--resize-factor", "1.0",
            "--iterations", str(FULL_STEPS), "--device", "cuda"]
    budget, peak = full_budget(argv)
    limit = max(budget, 2 ** 23)
    cfg_path = tmp / "full_config.json"
    cfg_path.write_text(json.dumps({"raster": {"max_pairs": budget, "max_pairs_limit": limit}}))
    out = tmp / "full"
    res, seconds, launches, peak_mem = cli_run(
        train_cli, argv + ["--output", str(out), "--config", str(cfg_path)], counters)
    steps = FULL_STEPS
    require(launches == expect(merge_gather=steps, raster_fwd=steps, raster_bwd=steps,
                               segsum=steps), f"full-width training launches {launches}")
    history = check_cli_training(res, "full-width training")
    require(history[-1]["loss"] < history[0]["loss"],
            f"full-width loss did not fall: {history[0]['loss']} -> {history[-1]['loss']}")
    trainer = res.trainer
    ev, _, eval_launches, _ = cli_run(eval_cli, [
        "--dataset", "colmap", "--root", str(scene), "--ply", str(out / f"iteration_{steps}.ply"),
        "--resize-factor", "1.0", "--max-pairs", str(trainer.cfg.raster.max_pairs),
        "--device", "cuda"], counters)
    check_cli_eval(ev, eval_launches, FULL_VIEWS, expect, "full-width eval")
    print(f"train_cli full width: {FULL_VIEWS} ray-traced views {FULL_SIZE}x{FULL_SIZE} "
          f"(written in {scene_s:.1f} s), default config (SH{trainer.cfg.model.sh_degree}, "
          f"tile {trainer.cfg.raster.tile_w}, densify "
          f"at 500 and 600), {steps} steps: gaussians {int(history[0]['num_active'])} -> "
          f"{int(trainer.state.num_active)}, "
          f"capacity {trainer.state.params.capacity}; initial pair demand {peak} a view -> "
          f"max_pairs {budget} (limit {limit}), at the end {trainer.cfg.raster.max_pairs}; "
          f"num_pairs {int(history[0]['num_pairs'])} (step {history[0]['iteration']}) -> "
          f"{int(history[-1]['num_pairs'])} (step {steps}), overflow 0; loss "
          f"{history[0]['loss']:.5f} -> {history[-1]['loss']:.5f}; eval PSNR "
          f"{ev.metrics['psnr_mean']:.3f} dB, SSIM {ev.metrics['ssim_mean']:.4f}, pairs a view "
          f"{ev.num_pairs}; {steps_per_s(history):.2f} steps/s over all {steps} steps, "
          f"{steps_per_s(history, 100):.2f} over steps 101-{steps} ({seconds:.2f} s for the CLI "
          f"call); peak memory {peak_mem / 2**30:.3f} GiB; loader {load_half_s:.3f} s at "
          f"--resize-factor 0.5; launches {launches} | {gpu}", flush=True)
    return trainer, {"full": launches, "full_eval": eval_launches}


def run_flagship(tmp: Path, device, counters, expect, gpu: str):
    """The flagship campaign through ``train_flagship.run``: the self-fit
    form at full width (each ground-truth view's exact pairs equal to
    ``bench.pair_demand`` on the ground truth's parameters, no overflow,
    the JAX summary's keys, PSNR up by PSNR_GAIN_DB, K2 and K1 once a
    ground-truth view and K2, K1, K3 and K4 once a step), then the
    independent form on ``run_full``'s scene (no overflow in the run or in
    the held-out renders, finite held-out PSNR / SSIM that a second render
    reproduces, the held-out PNGs; K2 and K1 also once a held-out view).  Returns (the
    self-fit run's trainer, the launches of each run)."""
    from types import SimpleNamespace

    from gaussiansplattingmlx_tpu_torch import bench as port_bench, train_flagship
    from gaussiansplattingmlx_tpu_torch.data import colmap
    from gaussiansplattingmlx_tpu_torch.models import gaussians
    from gaussiansplattingmlx_tpu_torch.ops import losses
    from gaussiansplattingmlx_tpu_torch.utils.camera import camera_args

    entry = SimpleNamespace(main=train_flagship.run)
    out = tmp / "flagship"
    res, seconds, launches, peak_mem = cli_run(
        entry, ["--iters", str(FLAGSHIP_STEPS), "--views", str(FLAGSHIP_VIEWS), "--size",
                str(FULL_SIZE), "--out", str(out), "--device", str(device)], counters)
    steps, views = FLAGSHIP_STEPS, FLAGSHIP_VIEWS
    require(launches == expect(merge_gather=steps + views, raster_fwd=steps + views,
                               raster_bwd=steps, segsum=steps),
            f"flagship launches {launches}")
    summary, trainer = res.summary, res.trainer
    require(set(summary) == FLAGSHIP_SUMMARY_KEYS,
            f"flagship summary keys {sorted(summary)}")
    cams = train_flagship.orbit_cameras(views, FULL_SIZE)
    demand = [port_bench.pair_demand(res.gt_params,
                                     camera_args(c.tensors(), device), FULL_SIZE,
                                     SH_DEGREE, FLAGSHIP_TILE) for c in cams]
    require(res.gt_pairs == demand, f"ground-truth pairs {res.gt_pairs} differ from the "
                                    f"probe's {demand}")
    rows, _ = train_flagship.merge_metric_segments(out / "metrics.jsonl")
    require(len(rows) == steps // 50 and all(np.isfinite(r["loss"]) for r in rows),
            f"flagship rows {[r['iteration'] for r in rows]}")
    require(summary["overflow_events"] == 0 and rows[-1]["overflow_pairs_acc"] == 0,
            f"flagship overflow: {summary['overflow_events']} events")
    require(summary["final_psnr"] >= summary["first_psnr"] + PSNR_GAIN_DB,
            f"flagship PSNR {summary['first_psnr']:.3f} -> {summary['final_psnr']:.3f} dB")
    require((out / "gt_view0.png").is_file() and (out / "summary.json").is_file()
            and (out / f"iteration_{steps}.ply").is_file(), "flagship files missing")
    print(f"train_flagship self-fit: {len(res.gt_params.xyz)} ground-truth gaussians, {views} "
          f"views {FULL_SIZE}x{FULL_SIZE} SH{SH_DEGREE}, exact pairs a view "
          f"{min(demand)}-{max(demand)} (= bench.pair_demand at tile {FLAGSHIP_TILE}); "
          f"{steps} steps: gaussians {rows[0]['num_active']} -> "
          f"{summary['num_gaussians_final']} (peak {summary['num_gaussians_peak']}), capacity "
          f"{rows[0]['capacity']} -> {rows[-1]['capacity']}, max_pairs {rows[0]['max_pairs']} "
          f"-> {summary['final_max_pairs']} ({summary['pair_budget_recompiles']} changes), "
          f"num_pairs {int(rows[0]['num_pairs'])} -> {int(rows[-1]['num_pairs'])}, overflow "
          f"events 0; PSNR {summary['first_psnr']:.3f} -> {summary['final_psnr']:.3f} dB; "
          f"{summary['sustained_it_per_s']:.2f} it/s sustained, {summary['mean_it_per_s']:.2f} "
          f"mean ({seconds:.2f} s for the call); peak memory {peak_mem / 2**30:.3f} GiB; "
          f"launches {launches} | {gpu}", flush=True)

    hold_out = tmp / "flagship_holdout"
    hres, hseconds, hlaunches, hpeak = cli_run(entry, [
        "--dataset-root", str(tmp / "full_scene"), "--holdout", str(FLAGSHIP_HOLDOUT),
        "--iters", str(FLAGSHIP_HOLDOUT_STEPS), "--spatial-lr-scale", "auto",
        "--prune-world-scale", "2.0", "--out", str(hold_out), "--device", str(device)],
        counters)
    hsteps, held = FLAGSHIP_HOLDOUT_STEPS, FLAGSHIP_HOLDOUT
    require(hlaunches == expect(merge_gather=hsteps + held, raster_fwd=hsteps + held,
                                raster_bwd=hsteps, segsum=hsteps),
            f"flagship held-out launches {hlaunches}")
    hsum = hres.summary
    hold = hsum.get("holdout", {})
    ids = hold.get("views", [])
    require(set(hsum) == FLAGSHIP_SUMMARY_KEYS | {"holdout"} and len(ids) == held
            and hsum["workload"]["views"] == FULL_VIEWS - held,
            f"flagship held-out summary {sorted(hsum)}, views {ids}")
    require(all(np.isfinite(v) for v in hold["psnr_per_view"] + hold["ssim_per_view"]),
            f"flagship held-out metrics {hold}")
    require(all((hold_out / "holdout" / f"holdout_{i:03d}.png").is_file() for i in ids),
            "flagship held-out PNGs missing")
    hrows, _ = train_flagship.merge_metric_segments(hold_out / "metrics.jsonl")
    require(hsum["overflow_events"] == 0 and hrows[-1]["overflow_pairs_acc"] == 0,
            f"flagship held-out run overflow: {hsum['overflow_events']} events, "
            f"{hrows[-1]['overflow_pairs_acc']} pairs in the run")
    # The summary's held-out scores come from renders whose overflow it
    # drops: render the held-out views again at the final budget, require
    # that nothing was clipped and that they score as the summary says.
    data, pcd = colmap.load_colmap(tmp / "full_scene", resize_factor=1.0)
    data = data.shift_cameras(pcd.centering()[1])
    htrainer = hres.trainer
    active = gaussians.active_mask(htrainer.state.params.capacity, htrainer.state.num_active)
    with torch.no_grad():
        acts = gaussians.activations(htrainer.state.params, active)
    colors, _, hoverflow = train_flagship.render_views(
        acts, [data.cameras[i] for i in ids], FULL_SIZE, FULL_SIZE, htrainer.cfg.model.sh_degree,
        htrainer.cfg.raster, white_background=htrainer.cfg.white_background,
        active=active)
    require(not any(hoverflow), f"flagship held-out renders clipped: {hoverflow} pairs a view")
    rescored = [float(losses.psnr(c, torch.as_tensor(data.images[i]).to(c.device)))
                for c, i in zip(colors, ids)]
    require(np.allclose(rescored, hold["psnr_per_view"], rtol=0, atol=1e-4),
            f"flagship held-out PSNR {hold['psnr_per_view']}, rendered again {rescored}")
    print(f"train_flagship independent: {FULL_VIEWS} ray-traced views {FULL_SIZE}x{FULL_SIZE}, "
          f"views {ids} held out, {hsteps} steps (spatial_lr_scale auto, prune_world_scale "
          f"2.0): train PSNR {hsum['first_psnr']:.3f} -> {hsum['final_psnr']:.3f} dB, held-out "
          f"PSNR {[round(v, 3) for v in hold['psnr_per_view']]} SSIM "
          f"{[round(v, 4) for v in hold['ssim_per_view']]} at max_pairs "
          f"{hsum['final_max_pairs']}; {hsum['mean_it_per_s']:.2f} it/s mean ({hseconds:.2f} s "
          f"for the call); peak memory {hpeak / 2**30:.3f} GiB; launches {hlaunches} | {gpu}",
          flush=True)
    del hres
    return trainer, {"self_fit": launches, "holdout": hlaunches}


def check_band_render(ply_path: Path, data, device) -> None:
    """render() of the bench scene's Gaussians at tile PAR_TILE over one
    orbit view's full image, then over 2 bands of 400 rows and 5 of 160,
    in each record layout (the training render, without gradients): the
    stitched bands are the full image within the JAX package's band
    bars, and the bands' pairs add up to the full image's."""
    from gaussiansplattingmlx_tpu_torch import config
    from gaussiansplattingmlx_tpu_torch.data import ply
    from gaussiansplattingmlx_tpu_torch.models.gaussians import activations, params_from_numpy
    from gaussiansplattingmlx_tpu_torch.render import render

    params = params_from_numpy(ply.read_gaussian_ply(ply_path), device)
    view = PAR_STEP_VIEWS[0]
    cam = [torch.as_tensor(np.asarray(data.cameras[view].tensors()[k])).to(device)
           for k in ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x", "focal_y")]
    parts = []
    with torch.no_grad():
        acts = activations(params)
        for layout, selector in config.LAYOUTS.items():
            cfg = config.RasterizerConfig(tile_w=PAR_TILE, tile_h=PAR_TILE, **selector)
            cfg = dataclasses.replace(cfg, max_pairs=cfg.max_pairs_limit)
            full, aux = render(*acts, *cam, WIDTH, HEIGHT, SH_DEGREE, raster_cfg=cfg)
            require(int(aux.overflow_pairs) == 0, f"band render ({layout}): full image overflows")
            counts = {}
            for n_bands in PAR_BANDS:
                rows = HEIGHT // n_bands
                color, alpha, pairs = [], [], []
                for b in range(n_bands):
                    out, baux = render(*acts, *cam, WIDTH, rows, SH_DEGREE, raster_cfg=cfg,
                                       pixel_y_offset=b * rows, full_image_height=HEIGHT)
                    require(int(baux.overflow_pairs) == 0,
                            f"band render ({layout}): band {b} of {n_bands} overflows")
                    color.append(out.color)
                    alpha.append(out.alpha)
                    pairs.append(int(baux.num_pairs))
                torch.testing.assert_close(torch.cat(color), full.color, rtol=COLOR_RTOL,
                                           atol=COLOR_ATOL)
                torch.testing.assert_close(torch.cat(alpha), full.alpha, rtol=COLOR_RTOL,
                                           atol=COLOR_ATOL)
                require(sum(pairs) == int(aux.num_pairs),
                        f"band render ({layout}): {n_bands} bands' pairs {pairs} sum to "
                        f"{sum(pairs)}, the full image has {int(aux.num_pairs)}")
                counts[n_bands] = pairs
            parts.append(f"{layout}: full {int(aux.num_pairs)} pairs, "
                         + ", ".join(f"{n} x {HEIGHT // n} rows {c} (sum {sum(c)})"
                                     for n, c in counts.items()))
    print(f"band render: bench scene {N_GAUSSIANS} gaussians SH{SH_DEGREE} {WIDTH}x{HEIGHT} "
          f"tile {PAR_TILE}, orbit view {view}; stitched bands == full image within rtol "
          f"{COLOR_RTOL} / atol {COLOR_ATOL} (color, alpha), overflow 0; " + "; ".join(parts),
          flush=True)


def parallel_trainer(spec, device, parallel=None):
    """The Trainer of the parallel phases: the bench workload at tile
    PAR_TILE on the PAR_VIEWS orbit views, its pair budget ``spec["budget"]``;
    ``parallel`` (data, tile) sets config.parallel."""
    from gaussiansplattingmlx_tpu_torch import config

    train = dict(iterations=spec["steps"], log_interval=1)
    if parallel is not None:
        train["parallel"] = config.ParallelConfig(data_parallel=parallel[0],
                                                  tile_parallel=parallel[1])
    trainer = make_trainer(Path(spec["ply"]), spec["data"], device, train=train, tile=PAR_TILE)
    trainer.set_max_pairs(spec["budget"])
    return trainer


def parallel_ranks(spec, tasks):
    """A rank of the parallel phases (every rank on cuda:0, over gloo).  For
    each (name, data, tile, steps) task: a Trainer with that
    config.parallel; one step of its train step on views PAR_STEP_VIEWS
    from a copy of its initial state, the results for the single-device
    checks; then ``Trainer.run(steps)``, the main path, with every launch
    counter set to 0 just before and read just after.  Returns (rank 0's
    results, this rank's report)."""
    from gaussiansplattingmlx_tpu_torch.ops import _kernels
    from gaussiansplattingmlx_tpu_torch.parallel import launch, sharding
    from gaussiansplattingmlx_tpu_torch.train import trainer as trainer_mod

    device = launch.rank_device(PAR_DEVICE)
    results, report = {}, {}
    for name, d, t, steps in tasks:
        trainer = parallel_trainer({**spec, "steps": steps}, device, (d, t))
        mesh = trainer.mesh
        digest0 = sharding.state_digest(trainer.state).tolist()
        state = trainer_mod.state_from_numpy(trainer_mod.state_to_numpy(trainer.state), device)
        state, metrics, _ = trainer.train_step(
            state, trainer.views, sharding.shard_view_idx(PAR_STEP_VIEWS, mesh))
        sharding.assert_replicated(state, mesh, "after the checked step")
        out = trainer_mod.state_to_numpy(state)
        results[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: out[k] for k in ("param_xyz", "param_scales", "param_opacity",
                                          "param_features_dc", "grad_accum")}}
        del state, out
        for k in _kernels.KERNELS:
            k.launches = 0
        mesh.collective_seconds, mesh.collective_calls = 0.0, 0
        torch.cuda.reset_peak_memory_stats(device)
        log = []
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        trainer.run(steps, on_metrics=log.append)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        report[name] = {
            "digest0": digest0, "digest": sharding.state_digest(trainer.state).tolist(),
            "launches": _kernels.launch_counts(), "seconds": seconds, "steps": steps,
            "collective_seconds": mesh.collective_seconds,
            "peak_memory": torch.cuda.max_memory_allocated(device)}
        results[name]["log"] = log
        del trainer
        torch.cuda.empty_cache()
    return results, report


def one_device_reference(trainer, view_ids):
    """The single-device computation on the card from the trainer's
    initial state: each view's gradient, their mean, Adam.  Returns (state
    as numpy, mean loss, mean SSIM, mean per-view |d xyz|)."""
    from gaussiansplattingmlx_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussiansplattingmlx_tpu_torch.train import trainer as trainer_mod

    cfg, views = trainer.cfg, trainer.views
    state = trainer_mod.state_from_numpy(trainer_mod.state_to_numpy(trainer.state),
                                         trainer.device)
    losses, ssims, grads = [], [], []
    for i in view_ids:
        def take(k):
            return views[k][i]

        leaves, _, out, aux = trainer_mod.render_view(cfg, state, take, WIDTH, HEIGHT,
                                                      SH_DEGREE)
        require(int(aux.overflow_pairs) == 0, f"reference render of view {i} overflows")
        loss, parts = trainer_mod.view_loss(cfg, out.color, out.depth, take)
        grads.append(trainer_mod.param_grads(loss, leaves))
        losses.append(float(loss.detach()))
        ssims.append(float(parts["ssim"].detach()))
    n = len(grads)
    mean = {k: sum(g[k] for g in grads) / n for k in PARAM_NAMES}
    norm = sum(torch.sqrt(torch.sum(g["xyz"] * g["xyz"], dim=1)) for g in grads) / n
    trainer_mod.adam_step(cfg, state, state.params.tensors(), mean, cfg.iterations)
    out = trainer_mod.state_to_numpy(state)
    out["grad_accum"] = norm.cpu().numpy()
    return out, float(np.mean(losses)), float(np.mean(ssims))


def require_close(got, want, rtol, atol, what):
    """``got`` within rtol / atol of ``want`` (numpy), or fail naming how
    many entries are off and by how much."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(got - want) > atol + rtol * np.abs(want)
    require(not off.any(), f"{what}: {int(off.sum())} of {off.size} entries beyond rtol {rtol} / "
                           f"atol {atol}, max abs diff {float(np.abs(got - want).max()):.3g}")


def parallel_line(name, desc, reports, log, gpu) -> list:
    """The line of a D x T run (steps/s, the collective ms a step, peak
    memory and K1-K4 launches per rank) after its checks.  Returns the K1-K4
    launches per rank."""
    runs = [r[name] for r in reports]
    steps = runs[0]["steps"]
    require(all(r["digest"] == runs[0]["digest"] for r in runs),
            f"{name}: the ranks' states differ after {steps} steps")
    require(len(log) == steps and all(np.isfinite(m["loss"]) for m in log),
            f"{name}: non-finite or missing losses")
    # Each step's loss is of other views: compare the first and the last
    # PAR_LOSS_WINDOW steps' means.
    first = float(np.mean([m["loss"] for m in log[:PAR_LOSS_WINDOW]]))
    last = float(np.mean([m["loss"] for m in log[-PAR_LOSS_WINDOW:]]))
    require(last < first, f"{name}: loss did not fall: mean {first} over the first "
                          f"{PAR_LOSS_WINDOW} steps, {last} over the last")
    require(all(m["overflow_pairs"] == 0 for m in log) and log[-1]["overflow_pairs_acc"] == 0,
            f"{name}: a step overflowed the pair budget")
    per_rank = [{PAR_KERNELS[s]: n for s, n in r["launches"].items() if s in PAR_KERNELS}
                for r in runs]
    others = [{s: n for s, n in r["launches"].items() if s not in PAR_KERNELS and n}
              for r in runs]
    require(all(all(n == steps for n in k.values()) for k in per_rank) and not any(others),
            f"{name}: launches {[r['launches'] for r in runs]}, expected {steps} of K1-K4 "
            "a rank and no other kernel")
    rate = [round(steps / r["seconds"], 2) for r in runs]
    collective = [round(1e3 * r["collective_seconds"] / steps, 3) for r in runs]
    peak = [round(r["peak_memory"] / 2**30, 3) for r in runs]
    print(f"{name}: {desc}; {len(runs)} ranks on one card (cuda:0, gloo) share it, so these "
          f"numbers are not a scaling result; {steps} steps of Trainer.run, loss "
          f"{log[0]['loss']:.5f} -> {log[-1]['loss']:.5f} (means of {PAR_LOSS_WINDOW} steps "
          f"{first:.5f} -> {last:.5f}), num_pairs a view "
          f"{int(log[-1]['num_pairs'])}, overflow 0, states bit-identical on every rank; "
          f"steps/s per rank {rate}; collective ms a step per rank (host clock around the "
          f"all-reduces and gathers) {collective}; peak memory per rank {peak} GiB; K1-K4 "
          f"launches per rank {per_rank} | {gpu}", flush=True)
    return per_rank


def run_parallel(ply_path: Path, tmp: Path, device, gpu: str) -> dict:
    """The data- and tile-parallel steps and runs at full width: D=2 against
    the mean of single-device views, T=2 against the single-device step,
    D=2 x T=2 against D=2 x T=1, each then trained through Trainer.run;
    K1-K4 on a 400-row band buffer of the T=2 run.  Returns the kernels
    line's entries."""
    from gaussiansplattingmlx_tpu_torch.ops import binning
    from gaussiansplattingmlx_tpu_torch.parallel import launch, sharding

    data = orbit_targets(ply_path, device, PAR_VIEWS)
    check_band_render(ply_path, data, device)
    # The pair budget: twice the initial demand of the busiest view (the
    # steps may grow the footprints), capped at PAR_MAX_PAIRS to hold down
    # the memory of ranks that share one card; no step may overflow.
    probe = parallel_trainer({"ply": str(ply_path), "data": data, "steps": 1,
                              "budget": 2 ** 26}, device)
    peak = 0
    for v in range(PAR_VIEWS):
        args, _ = first_step_geometry(probe, v)
        with torch.no_grad():
            e = binning.expand_pairs(args[1], args[2], args[3], WIDTH, HEIGHT, PAR_TILE,
                                     PAR_TILE, 512)
        peak = max(peak, int(e.num_pairs) + int(e.overflow_pairs))
        del args, e
    budget = min(max(512, -(-2 * peak // 512) * 512), PAR_MAX_PAIRS)
    del probe
    spec = {"ply": str(ply_path), "data": data, "budget": budget}
    reference = parallel_trainer({**spec, "steps": PAR_STEPS}, device)
    ref_digest = sharding.state_digest(reference.state).tolist()
    mean_ref, mean_loss, _ = one_device_reference(reference, PAR_STEP_VIEWS)
    single_ref, single_loss, single_ssim = one_device_reference(reference, PAR_STEP_VIEWS[:1])

    t0 = time.perf_counter()
    two, reports2 = launch.spawn(parallel_ranks, 2, PAR_DEVICE, args=(
        spec, [("d2", 2, 1, PAR_STEPS), ("t2", 1, 2, PAR_STEPS)]), timeout=900)
    four, reports4 = launch.spawn(parallel_ranks, 4, PAR_DEVICE, args=(
        spec, [("d2t2", 2, 2, PAR_STEPS)]), timeout=900)
    spawn_s = time.perf_counter() - t0
    for name, reports in (("d2", reports2), ("t2", reports2), ("d2t2", reports4)):
        require(all(r[name]["digest0"] == ref_digest for r in reports),
                f"{name}: a rank's initial state differs from the single-device trainer's")

    # D=2 against the mean of the two views' single-device gradients
    # (tests/test_sharding.py::test_dp_matches_mean_of_single_steps's bars).
    d2 = two["d2"]
    require_close(d2["metrics"]["loss"], mean_loss, 1e-5, 0.0, "d2 loss vs the views' mean")
    require_close(d2["state"]["grad_accum"], mean_ref["grad_accum"], 1e-4, 1e-9,
                  "d2 grad_accum vs the mean of the per-view |d xyz|")
    require_close(d2["state"]["param_xyz"], mean_ref["param_xyz"], 1e-4, 1e-6,
                  "d2 xyz vs Adam on the mean gradient")
    # T=2 against the single-device step (test_tile_parallel_matches_single_device).
    t2 = two["t2"]
    require_close(t2["metrics"]["loss"], single_loss, 1e-6, 0.0, "t2 loss vs one device")
    require_close(t2["metrics"]["ssim"], single_ssim, 1e-6, 0.0, "t2 ssim vs one device")
    for n in ("xyz", "scales", "opacity", "features_dc"):
        require_close(t2["state"][f"param_{n}"], single_ref[f"param_{n}"], 1e-5, 1e-7,
                      f"t2 {n} vs one device")
    require_close(t2["state"]["grad_accum"], single_ref["grad_accum"], 1e-4, 1e-9,
                  "t2 grad_accum vs one device")
    # D=2 x T=2 against D=2 x T=1 (test_data_x_tile_mesh).
    d22 = four["d2t2"]
    require_close(d22["metrics"]["loss"], d2["metrics"]["loss"], 1e-6, 0.0, "d2t2 loss vs d2")
    for n in ("xyz", "scales", "opacity"):
        require_close(d22["state"][f"param_{n}"], d2["state"][f"param_{n}"], 1e-5, 1e-7,
                      f"d2t2 {n} vs d2")
    require_close(d22["state"]["grad_accum"], d2["state"]["grad_accum"], 1e-4, 1e-9,
                  "d2t2 grad_accum vs d2")
    print(f"parallel steps: bench workload {N_GAUSSIANS} points SH{SH_DEGREE} {WIDTH}x{HEIGHT} "
          f"tile {PAR_TILE}, {PAR_VIEWS} orbit views, max_pairs {budget} (2 x the initial "
          f"peak {peak}, at most 2^24); one step from the initial state (identical on every rank): d2 on "
          f"views {PAR_STEP_VIEWS} == the single-device mean of the two views (loss "
          f"{d2['metrics']['loss']:.7f} vs {mean_loss:.7f}; grad_accum, xyz), t2 (bands of "
          f"{HEIGHT // 2} rows of view {PAR_STEP_VIEWS[0]}) == the single-device step (loss "
          f"{t2['metrics']['loss']:.7f} vs {single_loss:.7f}, ssim {t2['metrics']['ssim']:.7f} "
          f"vs {single_ssim:.7f}; xyz, scales, opacity, features_dc, grad_accum), d2t2 == d2 "
          f"(loss {d22['metrics']['loss']:.7f}), within tests/test_sharding.py's bars; pairs a "
          f"view d2 {d2['metrics']['num_pairs']:.0f}, t2 {t2['metrics']['num_pairs']:.0f}; "
          f"the ranks' calls {spawn_s:.1f} s | {gpu}", flush=True)
    entries = {
        "d2": parallel_line("d2", "data_parallel 2, views drawn from the seeded stream",
                            reports2, two["d2"]["log"], gpu),
        "t2": parallel_line("t2", f"tile_parallel 2, bands of {HEIGHT // 2} rows", reports2,
                            two["t2"]["log"], gpu),
        "d2t2": parallel_line("d2t2", "data_parallel 2 x tile_parallel 2", reports4,
                              four["d2t2"]["log"], gpu)}
    del mean_ref, single_ref
    # K2, K1, K3 and K4 on a 400-row band buffer of the T=2 run's first step
    # (band 0 of its view), timed there.
    band_entries = check_training_buffers(
        reference, device, f"T=2 run's band 0 ({HEIGHT // 2} rows) of view {PAR_STEP_VIEWS[0]}",
        view=PAR_STEP_VIEWS[0], band=(HEIGHT // 2, 0))
    del reference
    return {"runs": entries, "band": band_entries}


def cli_parallel_check(res, reports, out: Path, what: str) -> dict:
    """A train_cli run of two ranks: finite, falling losses, no overflow,
    the ranks' states bit-identical, K1-K4 once a step on every rank, and
    one writer: each metrics row and each preview once, no file of a
    second rank."""
    history = res.history
    require(len(history) >= 2 and all(np.isfinite(m["loss"]) for m in history),
            f"{what}: non-finite or missing losses")
    require(history[-1]["loss"] < history[0]["loss"],
            f"{what}: loss did not fall: {history[0]['loss']} -> {history[-1]['loss']}")
    require(all(m["overflow_pairs"] == 0 for m in history)
            and res.final["overflow_pairs_acc"] == 0, f"{what}: a step overflowed the budget")
    require(all(r["digest"] == reports[0]["digest"] for r in reports),
            f"{what}: the ranks' final states differ")
    per_rank = [{PAR_KERNELS[s]: n for s, n in r["launches"].items() if s in PAR_KERNELS}
                for r in reports]
    with open(out / "metrics.csv", newline="") as fh:
        rows = [int(r["iteration"]) for r in csv.DictReader(fh)]
    require(rows == [m["iteration"] for m in history],
            f"{what}: metrics.csv rows {rows[:5]}... are not the logged steps once each")
    previews = sorted(p.name for p in (out / "previews").iterdir())
    preview_steps = [int(n.split("_")[1]) for n in previews]
    require(len(preview_steps) == len(set(preview_steps)),
            f"{what}: a preview step written twice: {previews}")
    return {"launches": per_rank,
            "collective_ms_per_step": [1e3 * r["collective_seconds"] / r["steps"]
                                       for r in reports],
            "peak_memory_gib": [r["peak_memory"] / 2**30 for r in reports]}


def run_cli_parallel(tmp: Path, gpu: str) -> dict:
    """train_cli on the vendored scene with --data-parallel 2 --device
    cuda:0 (two ranks sharing the card) at the default config to step
    CLI_PAR_STEPS, a resume from ckpt_CLI_PAR_RESUME whose final checkpoint
    must equal the uninterrupted run's, and the same run with --multihost in
    two ranks that each see a torchrun environment of their own host
    (batched views).  Returns the kernels line's entries."""
    from gaussiansplattingmlx_tpu_torch import train_cli
    from gaussiansplattingmlx_tpu_torch.parallel import launch

    cfg_path = tmp / "cli_parallel_config.json"
    cfg_path.write_text(json.dumps(CLI_PAR_WRITES))
    argv = ["--dataset", "colmap", "--root", str(VENDOR), "--resize-factor", "1.0",
            "--iterations", str(CLI_PAR_STEPS), "--config", str(cfg_path),
            "--device", PAR_DEVICE]
    out = tmp / "cli_d2"
    t0 = time.perf_counter()
    res = train_cli.main(argv + ["--output", str(out), "--data-parallel", "2"])
    seconds = time.perf_counter() - t0
    entry = {"cli_d2": cli_parallel_check(res, res.ranks, out, "train_cli --data-parallel 2")}
    history = res.history
    require(all(r == {k: CLI_PAR_STEPS for k in r} for r in entry["cli_d2"]["launches"]),
            f"train_cli --data-parallel 2 launches {entry['cli_d2']['launches']}")
    print(f"train_cli --data-parallel 2 --device {PAR_DEVICE}: tests/fixtures/vendor_scene, "
          f"default config, {CLI_PAR_STEPS} steps (densify at 500 and 600, checkpoints every "
          f"{CLI_PAR_WRITES['checkpoint_interval']}); 2 ranks share one card over gloo (not a "
          f"scaling result); gaussians {int(history[0]['num_active'])} -> "
          f"{int(history[-1]['num_active'])}, loss {history[0]['loss']:.5f} -> "
          f"{history[-1]['loss']:.5f}, psnr {history[-1]['psnr']:.2f} dB, overflow 0, final "
          f"states bit-identical, one writer; {steps_per_s(history):.2f} steps/s over the "
          f"{CLI_PAR_STEPS} steps ({seconds:.2f} s for the CLI call, ranks' start included); "
          f"collective ms a step per rank "
          f"{[round(x, 3) for x in entry['cli_d2']['collective_ms_per_step']]}; peak memory "
          f"per rank {[round(x, 3) for x in entry['cli_d2']['peak_memory_gib']]} GiB; K1-K4 "
          f"launches per rank {entry['cli_d2']['launches']} | {gpu}", flush=True)

    resumed = tmp / "cli_d2_resumed"
    res2 = train_cli.main(argv + ["--output", str(resumed), "--data-parallel", "2",
                                  "--resume", str(out / f"ckpt_{CLI_PAR_RESUME}.npz")])
    left = CLI_PAR_STEPS - CLI_PAR_RESUME
    launches2 = [{PAR_KERNELS[s]: n for s, n in r["launches"].items() if s in PAR_KERNELS}
                 for r in res2.ranks]
    require(all(r == {k: left for k in r} for r in launches2),
            f"resumed --data-parallel 2 launches {launches2}")
    require_checkpoints_equal(out / f"ckpt_{CLI_PAR_STEPS}.npz",
                              resumed / f"ckpt_{CLI_PAR_STEPS}.npz", "resumed --data-parallel 2")
    entry["cli_d2_resumed"] = {"launches": launches2}
    print(f"train_cli --data-parallel 2 resume: --resume ckpt_{CLI_PAR_RESUME}.npz into a fresh "
          f"directory, steps {CLI_PAR_RESUME + 1}-{CLI_PAR_STEPS}: ckpt_{CLI_PAR_STEPS}.npz "
          f"bit-identical to the uninterrupted run's (output_dir aside); K1-K4 launches per "
          f"rank {launches2} | {gpu}", flush=True)

    mh = tmp / "cli_multihost"
    t0 = time.perf_counter()
    res3, reports3 = launch.spawn(
        train_cli._rank_main, 2, PAR_DEVICE, init_group=False,
        env={"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, timeout=900,
        args=(argv + ["--output", str(mh), "--multihost"],))
    seconds3 = time.perf_counter() - t0
    entry["cli_multihost"] = cli_parallel_check(res3, reports3, mh, "train_cli --multihost")
    require(all(r["batched_views"] for r in reports3), "--multihost ranks did not batch views")
    require(all(r == {k: CLI_PAR_STEPS for k in r} for r in entry["cli_multihost"]["launches"]),
            f"train_cli --multihost launches {entry['cli_multihost']['launches']}")
    h3 = res3.history
    print(f"train_cli --multihost: the same run in 2 ranks, each told by torchrun's variables "
          f"(RANK, WORLD_SIZE, LOCAL_RANK 0, LOCAL_WORLD_SIZE 1, MASTER_ADDR, MASTER_PORT) "
          f"that it is one host of two, joined by multihost.initialize; each keeps a batched "
          f"store of its own data shard's views; loss {h3[0]['loss']:.5f} -> "
          f"{h3[-1]['loss']:.5f}, psnr {h3[-1]['psnr']:.2f} dB, gaussians "
          f"{int(h3[-1]['num_active'])}, overflow 0, final states bit-identical, one writer; "
          f"{steps_per_s(h3):.2f} steps/s over the {CLI_PAR_STEPS} steps ({seconds3:.2f} s "
          f"with the ranks' start); K1-K4 launches per rank "
          f"{entry['cli_multihost']['launches']} | {gpu}", flush=True)
    return entry


def check_scatter_buffers(trainer):
    """The scatter reduction on the first-step buffers of a scatter training
    run (view 0, K3's rows of the L1 + SSIM cotangent): against the K4 path
    (``sort_by_gid`` + K4) at K4's tolerance, two launches compared bit for
    bit (held to K4's tolerance where they differ), timed beside the K4
    path's parts and ``index_add_`` (float atomics) on the same rows.
    Returns the kernels line's entry fields."""
    from gaussiansplattingmlx_tpu_torch.ops import rasterize_cuda, segsum_cuda, staging

    args, st = first_step_geometry(trainer)
    num_rec = trainer.state.params.capacity
    with torch.no_grad():
        sp, gid = staging._stage_train_impl(st, *args)
    require(int(sp.overflow_pairs) == 0, "scatter training buffers overflow")
    tile = st.tile_w
    grid = (-(-st.image_width // tile), -(-st.image_height // tile))
    block, _ = loss_cotangent_block(sp.records_cm, sp.tile_start, sp.tile_count,
                                    st.image_width, st.image_height, tile,
                                    trainer.views["target_rgb"][0])
    rows = rasterize_cuda.raster_bwd(sp.records_cm, sp.tile_start, sp.tile_count, block,
                                     *grid, tile, tile)
    pairs = int(sp.num_pairs)
    del sp, block
    got = rasterize_cuda.scatter_reduce(rows, gid, num_rec)
    again = rasterize_cuda.scatter_reduce(rows, gid, num_rec)
    k4 = segsum_cuda.segment_reduce(rows, gid, num_rec)
    torch.cuda.synchronize()
    scale = float(k4.abs().max())
    torch.testing.assert_close(got, k4, rtol=SEGSUM_RTOL, atol=SEGSUM_ATOL * scale)
    stable = bit_equal(got, again)
    if not stable:
        torch.testing.assert_close(again, got, rtol=SEGSUM_RTOL, atol=SEGSUM_ATOL * scale)
    repeat_err = float((again - got).abs().max())
    err = float((got - k4).abs().max())
    # d packed, the staging backward's result, from both reductions.
    d_scatter = rasterize_cuda.reduce_record_cotangent(rows, gid, num_rec, "scatter")
    d_segsum = rasterize_cuda.reduce_record_cotangent(rows, gid, num_rec, "segsum")
    torch.testing.assert_close(d_scatter, d_segsum, rtol=SEGSUM_RTOL,
                               atol=SEGSUM_ATOL * float(d_segsum.abs().max()))
    del got, again, k4, d_scatter, d_segsum
    scatter = kernel_ms(lambda: rasterize_cuda.scatter_reduce(rows, gid, num_rec))
    k4_path = kernel_ms(lambda: segsum_cuda.segment_reduce(rows, gid, num_rec))
    sort_ms = device_ms(lambda: segsum_cuda.sort_by_gid(rows, gid, num_rec))
    rows_s, offsets = segsum_cuda.sort_by_gid(rows, gid, num_rec)
    k4_ms = device_ms(lambda: segsum_cuda.segment_sum_sorted(rows_s, offsets))
    del rows_s, offsets
    valid = gid < num_rec
    idx = torch.where(valid, gid, 0).long()
    masked = torch.where(valid[:, None], rows.T, 0.0)
    out = torch.zeros((num_rec, rows.shape[0]), dtype=torch.float32, device=rows.device)
    index_add_ms = device_ms(lambda: out.zero_().index_add_(0, idx, masked))
    print(f"scatter: the scatter-add reduction on {pairs} pairs of {rows.shape[1]} columns "
          f"into {num_rec} rows (train scatter, first step, tile {tile}) within rtol "
          f"{SEGSUM_RTOL} of sort_by_gid + K4 (max abs err {err:.3g}; d packed too); two "
          f"launches bit-identical: {stable} (max abs difference {repeat_err:.3g}); device "
          f"{scatter['ms']:.4f} ms (a call {scatter['call_ms']:.4f} ms) against sort_by_gid + "
          f"K4 {k4_path['ms']:.4f} ms (a call {k4_path['call_ms']:.4f} ms: sort_by_gid "
          f"{sort_ms:.4f}, K4 {k4_ms:.4f}); index_add_ (float atomics) {index_add_ms:.4f} ms "
          f"| {gpu_line()}", flush=True)
    return {"scatter_ms": scatter["ms"], "scatter_call_ms": scatter["call_ms"],
            "scatter_bit_stable": stable, "scatter_repeat_max_abs_diff": repeat_err,
            "scatter_max_abs_err_vs_k4": err, "scatter_k4_path_ms": k4_path["ms"],
            "scatter_k4_path_call_ms": k4_path["call_ms"], "scatter_sort_ms": sort_ms,
            "scatter_k4_ms": k4_ms, "scatter_index_add_ms": index_add_ms}


def run_scatter(ply_path: Path, data, device, max_pairs: int, sorted_log, counters,
                expect) -> tuple:
    """grad_reduce="scatter" through Trainer.run: the sorted layout for
    TRAIN_STEPS steps (its first-step buffers checked by
    ``check_scatter_buffers``), then the aligned and split layouts for
    SCATTER_LAYOUT_STEPS; each at the sorted segsum run's budget, its logged
    losses within LOSS_RTOL of that run's, launching no K4.  Returns (the
    buffer check's fields, each run's launches)."""
    from gaussiansplattingmlx_tpu_torch import config

    sorted_losses = np.array([m["loss"] for m in sorted_log])
    entry, runs = {}, {}
    for layout, steps, launched in (
            ("sorted", TRAIN_STEPS, dict(merge_gather=1, raster_bwd=1)),
            ("aligned", SCATTER_LAYOUT_STEPS, dict(merge_gather=1, relayout=1,
                                                   raster_bwd_aligned=1)),
            ("split", SCATTER_LAYOUT_STEPS, dict(merge_ranks=1, raster_bwd_aligned=1))):
        trainer = make_trainer(ply_path, data, device, grad_reduce="scatter",
                               **config.LAYOUTS[layout])
        trainer.set_max_pairs(max_pairs)
        if layout == "sorted":
            entry = check_scatter_buffers(trainer)
        log, final, seconds, launches = run_training(trainer, counters, steps)
        losses = np.array([m["loss"] for m in log])
        want = sorted_losses[:len(losses)]
        rel = float(np.max(np.abs(losses - want) / want))
        require(rel <= LOSS_RTOL, f"train scatter {layout}: losses {losses.tolist()} differ "
                                  f"from the sorted segsum run's {want.tolist()}")
        check_train_run(trainer, log, final, launches,
                        expect(raster_fwd=steps, **{k: v * steps for k, v in launched.items()}),
                        seconds, torch.cuda.max_memory_allocated(), f"train scatter {layout}",
                        f" (grad_reduce='scatter'; logged losses within {rel:.2e} of the "
                        f"sorted segsum run's)", steps=steps)
        runs[layout] = launches
        del trainer
    return entry, runs


def small_trainer(device, **raster):
    """A Trainer of check_small_render's scene (400 points, SH3) on one
    100x72 camera whose target is a seeded uniform random image, which is
    what makes the gradients non-zero."""
    from gaussiansplattingmlx_tpu_torch import config
    from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
    from gaussiansplattingmlx_tpu_torch.train.trainer import Trainer
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera
    from gaussiansplattingmlx_tpu_torch.utils.point_cloud import PointCloud

    raw = small_scene()
    c2w = np.eye(4)
    c2w[2, 3] = -4.0
    cam = Camera.from_c2w(REF_WIDTH, REF_HEIGHT, 90.0, 90.0, c2w)
    target = np.random.default_rng(SEED + 2).uniform(
        size=(1, REF_HEIGHT, REF_WIDTH, 3)).astype(np.float32)
    pc = PointCloud(coords=raw["xyz"], colors=np.full((400, 3), 128.0, np.float32))
    cfg = config.TrainConfig(
        iterations=10, init_points=400, output_dir="", seed=SEED,
        model=config.ModelConfig(sh_degree=SH_DEGREE, initial_capacity=512),
        raster=config.RasterizerConfig(max_pairs=REF_MAX_PAIRS, **raster),
        densify=config.DensifyConfig(from_iter=10 ** 9))
    return Trainer(cfg, TrainData(cameras=[cam], images=target), pc, device=device)


def check_reference(device, counters, expect) -> dict:
    """The oracle on the card: render(backend="reference") of a small
    trainer's scene against the kernels' training render at the JAX image
    bars, and one training step's parameter gradients (L1 + SSIM against
    the target) at the JAX gradient bars; the oracle launches only K5 (its
    binning).  Returns its launches."""
    from gaussiansplattingmlx_tpu_torch.train import trainer as trainer_mod

    trainer = small_trainer(device)
    state, views = trainer.state, trainer.views

    def take(k):
        return views[k][0]

    def step(backend):
        leaves, _, out, aux = trainer_mod.render_view(trainer.cfg, state, take, REF_WIDTH,
                                                      REF_HEIGHT, SH_DEGREE, backend)
        loss, _ = trainer_mod.view_loss(trainer.cfg, out.color, out.depth, take)
        return out, aux, trainer_mod.param_grads(loss, leaves), loss

    results = {}
    for backend in ("auto", "reference"):
        step(backend)  # the first call's set-up stays out of the time
        zero_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux, grads, loss = step(backend)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: k.launches for name, k in counters.items()}
        require(int(aux.overflow_pairs) == 0 and int(aux.num_pairs) > 0,
                f"reference phase ({backend}): pairs {int(aux.num_pairs)}, overflow "
                f"{int(aux.overflow_pairs)}")
        results[backend] = (out, aux, grads, launches, seconds, float(loss.detach()))
    k_out, k_aux, k_grads, k_launches, k_s, k_loss = results["auto"]
    r_out, r_aux, r_grads, r_launches, r_s, r_loss = results["reference"]
    require(k_launches == expect(merge_gather=1, raster_fwd=1, raster_bwd=1, segsum=1),
            f"reference phase: the kernels' step launched {k_launches}")
    require(r_launches == expect(merge_ranks=1),
            f"reference phase: the oracle's step launched {r_launches}")
    require(int(r_aux.num_pairs) == int(k_aux.num_pairs)
            and int(r_aux.tile_depth_max) == int(k_aux.tile_depth_max),
            "reference phase: pair counts differ")
    torch.testing.assert_close(r_out.color, k_out.color, rtol=COLOR_RTOL, atol=COLOR_ATOL)
    torch.testing.assert_close(r_out.depth, k_out.depth, rtol=DEPTH_RTOL, atol=DEPTH_ATOL)
    torch.testing.assert_close(r_out.alpha, k_out.alpha, rtol=COLOR_RTOL, atol=COLOR_ATOL)
    mismatch = float((r_out.n_contrib != k_out.n_contrib).float().mean())
    require(mismatch <= NCON_MISMATCH, f"reference phase: n_contrib mismatch {mismatch}")
    for name, want in r_grads.items():
        scale = max(float(want.abs().max()), 1e-30)
        torch.testing.assert_close(k_grads[name], want, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   msg=lambda m, n=name: f"reference phase, d {n}: {m}")
    require(any(float(g.abs().max()) > 0 for g in r_grads.values()),
            "reference phase: zero gradients")
    print(f"reference: render(backend='reference') on the card, {int(r_aux.num_pairs)} pairs "
          f"of 400 gaussians SH{SH_DEGREE} {REF_WIDTH}x{REF_HEIGHT}, budget {REF_MAX_PAIRS}: "
          f"image within rtol {COLOR_RTOL} / atol {COLOR_ATOL} of the kernels' path, n_contrib "
          f"mismatch {mismatch:.5f}; loss {r_loss:.6f} (kernels {k_loss:.6f}); the six "
          f"parameter gradients within rtol {GRAD_RTOL} / atol {GRAD_ATOL} x their largest; "
          f"render + loss + backward {1e3 * r_s:.2f} ms (kernels {1e3 * k_s:.2f} ms; host "
          f"clock, second calls); launches {r_launches} | {gpu_line()}", flush=True)
    return r_launches


def check_eval_reference(ply_path: Path, counters, expect) -> dict:
    """eval_cli --backend reference on the vendored scene at REF_EVAL_FACTOR
    against eval_cli on the kernels, same budget: the JAX CLI bars on the
    metrics and the JAX image bars on every view.  Returns its launches."""
    from gaussiansplattingmlx_tpu_torch import eval_cli

    argv = ["--dataset", "colmap", "--root", str(VENDOR), "--ply", str(ply_path),
            "--resize-factor", str(REF_EVAL_FACTOR), "--max-pairs", str(REF_EVAL_MAX_PAIRS),
            "--device", "cuda"]
    ker, ker_s, ker_launches, _ = cli_run(eval_cli, argv, counters)
    ref, ref_s, ref_launches, ref_mem = cli_run(eval_cli, argv + ["--backend", "reference"],
                                                counters)
    views = ref.metrics["views"]
    require(views == 10 and ref_launches == expect(merge_ranks=views),
            f"eval_cli --backend reference: {views} views, launches {ref_launches}")
    require(ker_launches == expect(merge_gather=views, raster_fwd=views),
            f"eval_cli (kernels): launches {ker_launches}")
    require(ref.overflow_pairs == ker.overflow_pairs == [0] * views
            and ref.num_pairs == ker.num_pairs, f"eval_cli reference: pairs {ref.num_pairs} / "
            f"{ker.num_pairs}, overflow {ref.overflow_pairs} / {ker.overflow_pairs}")
    for a, b in zip(ref.colors, ker.colors):
        np.testing.assert_allclose(a, b, rtol=COLOR_RTOL, atol=COLOR_ATOL)
    got, want = ref.metrics, ker.metrics
    require(abs(got["psnr_mean"] - want["psnr_mean"]) <= PSNR_ATOL_DB
            and abs(got["ssim_mean"] - want["ssim_mean"]) <= SSIM_ATOL
            and abs(got["l1_mean"] - want["l1_mean"]) <= L1_ATOL,
            f"eval_cli reference metrics {got} against the kernels' {want}")
    h, w = ref.colors[0].shape[:2]
    print(f"eval_cli --backend reference: {ply_path.name} of the vendored run, {views} views "
          f"{w}x{h}, budget {REF_EVAL_MAX_PAIRS}, pairs {min(ref.num_pairs)}-"
          f"{max(ref.num_pairs)}: PSNR {got['psnr_mean']:.4f} dB against {want['psnr_mean']:.4f} "
          f"on the kernels, SSIM {got['ssim_mean']:.5f} / {want['ssim_mean']:.5f}, every view "
          f"within the image bars; {ref_s:.2f} s (kernels {ker_s:.2f} s, host clock); peak "
          f"memory {ref_mem / 2**30:.3f} GiB; launches {ref_launches} | {gpu_line()}",
          flush=True)
    return ref_launches


def check_profiler(ply_path: Path, data, device, max_pairs: int, tmp: Path) -> None:
    """The spans on the default training step: trace() of PROFILE_STEPS
    steps writes a Chrome trace that names K1-K4's kernels and every span of
    ``SPANS`` at least once a step, and leaves under UNSPANNED_SHARE of the
    device time outside the spans (``benchmark/spans.py``)."""
    from benchmark import spans
    from gaussiansplattingmlx_tpu_torch.utils.profiler import SPANS, trace

    trainer = make_trainer(ply_path, data, device)
    trainer.set_max_pairs(max_pairs)
    state = trainer.state
    state, metrics, _ = trainer.train_step(state, trainer.views, 0)
    torch.cuda.synchronize()
    out = tmp / "trace"
    with trace(str(out)):
        for i in range(PROFILE_STEPS):
            state, metrics, _ = trainer.train_step(state, trainer.views, i % data.num_views)
        torch.cuda.synchronize()
    require(np.isfinite(float(metrics["loss"])), "profiler: a non-finite loss")
    files = sorted(out.glob("trace_*.json"))
    require(len(files) == 1, f"profiler: trace files {files}")
    events = spans.read_events(str(files[0]))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = " ".join(e.get("name", "") for e in kernels)
    missing = [k for k, v in TRACE_KERNELS.items() if v not in names]
    require(not missing, f"profiler: the trace names no kernel of {missing}")
    seen = {n: sum(1 for e in events if e.get("cat") == "user_annotation" and e["name"] == n)
            for n in SPANS}
    require(all(c >= PROFILE_STEPS for c in seen.values()),
            f"profiler: spans recorded over {PROFILE_STEPS} steps: {seen}")
    split = spans.attribute(events)
    device_ms = 1e3 * sum(split.device_s.values())
    unspanned = 1e3 * split.device_s.get(spans.UNSPANNED, 0.0)
    require(unspanned < UNSPANNED_SHARE * device_ms,
            f"profiler: {unspanned:.3f} of {device_ms:.3f} device ms outside the spans")
    by_span = ", ".join(f"{k} {v * 1e3 / PROFILE_STEPS:.3f}"
                        for k, v in sorted(split.device_s.items(), key=lambda kv: -kv[1]))
    print(f"profiler: trace() of {PROFILE_STEPS} default training steps wrote {files[0].name} "
          f"({files[0].stat().st_size} bytes, {len(kernels)} kernel events), naming "
          f"{sorted(TRACE_KERNELS.values())} and every span ({seen}); device ms a step by span "
          f"(benchmark/spans.py): {by_span}; unspanned {unspanned:.3f} of {device_ms:.3f} ms | "
          f"{gpu_line()}", flush=True)


def check_golden(device, counters, expect) -> dict:
    """The golden scene (tests/golden_scene.npz: the JAX oracle's image of
    tests/test_golden.py's scene, 120 Gaussians, SH2, 64x64) rendered on the
    card by the kernels (K2 then K1, serving) and by the oracle, each held
    to the file at tests/test_golden.py's bars.  Returns the launches."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_golden_scene import GOLDEN, golden_errors, render_golden

    want = np.load(GOLDEN)
    launches, parts = {}, []
    for name, backend, inference, launched in (
            ("kernels", "auto", True, dict(merge_gather=1, raster_fwd=1)),
            ("reference", "reference", False, dict(merge_ranks=1))):
        zero_counters(counters)
        got = render_golden(device, backend, inference)
        torch.cuda.synchronize()
        launches[name] = {n: k.launches for n, k in counters.items()}
        require(launches[name] == expect(**launched),
                f"golden {name}: launches {launches[name]}")
        err = golden_errors(got, want)
        worst = max(err[f"{k}_excess"] for k in ("color", "depth", "alpha"))
        require(worst <= 0 and err["ncon_mismatch"] < 0.002,
                f"golden {name}: outside tests/test_golden.py's bars: {err}")
        require(float(got["color"].std()) > 0.05, f"golden {name}: blank image")
        parts.append(f"{name} (backend={backend!r}, inference={inference}): max abs err "
                     f"color {err['color_max_abs_err']:.3e}, depth "
                     f"{err['depth_max_abs_err']:.3e}, alpha {err['alpha_max_abs_err']:.3e}, "
                     f"n_contrib mismatch {err['ncon_mismatch']:.4%}, launches "
                     f"{ {k: v for k, v in launches[name].items() if v} }")
    print(f"golden: tests/golden_scene.npz (120 gaussians SH2 64x64) within "
          f"tests/test_golden.py's bars (color rtol 1e-4 / atol 1e-5, depth rtol 1e-4 / "
          f"atol 1e-4, alpha rtol 1e-4 / atol 1e-5, n_contrib mismatch < 0.2%): "
          + "; ".join(parts) + f" | {gpu_line()}", flush=True)
    return launches


def wide_view(size: int, view: int):
    """Orbit view ``view`` of TRAIN_VIEWS at ``size`` x ``size`` pixels, the
    bench focal scaled with it (the field of view of the 800x800 views)."""
    from gaussiansplattingmlx_tpu_torch.utils.camera import orbit_c2w
    from gaussiansplattingmlx_tpu_torch.utils.camera import Camera

    focal = FOCAL * size / WIDTH
    return Camera.from_c2w(size, size, focal, focal,
                           orbit_c2w(2 * np.pi * view / TRAIN_VIEWS, 4.0, 0.2))


def cam_args(cam, device):
    t = cam.tensors()
    return [torch.as_tensor(np.asarray(t[k])).to(device)
            for k in ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x",
                      "focal_y")]


def wide_geometry(acts, active, cam, device, size, max_pairs):
    """The staging inputs of ``cam`` and their statics at tile WIDE_TILE
    (``active``: the live rows, as the training step culls them)."""
    from gaussiansplattingmlx_tpu_torch.ops import projection, rasterize_ref, staging

    means, shs, opacity, scales, rots = acts
    with torch.no_grad():
        p = projection.project_gaussians(means, scales, rots, shs, *cam_args(cam, device),
                                         size, size, SH_DEGREE, active=active)
        packed = rasterize_ref.pack_gaussians(p.means2d, p.conic, p.colors, opacity,
                                              p.depths)
    st = staging.StagingStatic(size, size, WIDE_TILE, WIDE_TILE, max_pairs, 128)
    return (packed, p.rect_min, p.rect_max, p.radii, p.depths), st


def pair_demand(args, st) -> int:
    from gaussiansplattingmlx_tpu_torch.ops import binning

    with torch.no_grad():
        e = binning.expand_pairs(args[1], args[2], args[3], st.image_width, st.image_height,
                                 st.tile_w, st.tile_h, 512)
    return int(e.num_pairs) + int(e.overflow_pairs)


def wide_render(acts, active, cam, device, size, counters, expect, launched, **raster):
    """One inference render at tile WIDE_TILE, counters set to 0 just before
    and read just after: (outputs as numpy, aux, ms on CUDA events)."""
    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.render import render

    cfg = RasterizerConfig(tile_w=WIDE_TILE, tile_h=WIDE_TILE, **raster)
    zero_counters(counters)
    with torch.no_grad():
        (out, aux), ms = timed_once(lambda: render(*acts, *cam_args(cam, device), size, size,
                                                   SH_DEGREE, raster_cfg=cfg, active=active,
                                                   inference=True))
    launches = {n: k.launches for n, k in counters.items()}
    require(launches == expect(**launched), f"wide render {raster}: launches {launches}")
    require(int(aux.overflow_pairs) == 0, f"wide render {raster}: overflow")
    return ({k: getattr(out, k).cpu().numpy() for k in ("color", "depth", "alpha", "n_contrib")},
            aux, ms)


def same_image(a: dict, b: dict) -> bool:
    return all(bits(a[k]).tobytes() == bits(b[k]).tobytes()
               for k in ("color", "depth", "alpha", "n_contrib"))


def run_wide(ply_path: Path, data, device, counters, expect, tmp: Path, gpu: str) -> dict:
    """The staging route above 2^24 slots.  (1) Serving at a 2^25-slot
    budget: render_cli --max-pairs 2^25 --no-auto-pairs on the bench PLY,
    then the training workload's initial Gaussians at the busiest 800x800
    orbit view, bit-equal to the same frame through K2 at 2^24; the route's
    ms beside K2's.  (2) More than 2^24 real pairs: the first probed view
    size past 2^24 pairs, rendered in the sorted layout (K5 route) and the
    split layout (K5 + integer gathers), compared; K1 and K5 checked
    against their plain versions there; one sorted training step (K5, K1,
    K3, K4), K1, K3 and K4 checked against their plain versions and timed
    on its buffers first.  Returns the kernels line's entries."""
    from gaussiansplattingmlx_tpu_torch import render_cli
    from gaussiansplattingmlx_tpu_torch.config import RasterizerConfig
    from gaussiansplattingmlx_tpu_torch.data.dataset import TrainData
    from gaussiansplattingmlx_tpu_torch.models import gaussians
    from gaussiansplattingmlx_tpu_torch.ops import staging

    launches = {}
    # (1a) the user's entry point at a budget above 2^24
    res, seconds, launches["render_cli_2e25"], mem = cli_run(render_cli, [
        "--ply", str(ply_path), "--out", str(tmp / "wide_renders"), "--orbit", "1",
        "--width", str(WIDTH), "--height", str(HEIGHT), "--focal", str(FOCAL),
        "--max-pairs", str(WIDE_BUDGET), "--no-auto-pairs", "--device", device.type], counters)
    require(res.max_pairs == WIDE_BUDGET and res.overflow_pairs == [0],
            f"render_cli at 2^25: max_pairs {res.max_pairs}, overflow {res.overflow_pairs}")
    require(launches["render_cli_2e25"] == expect(merge_ranks=1, raster_fwd=1),
            f"render_cli at 2^25: launches {launches['render_cli_2e25']}")
    c = res.colors[0]
    require(bool(np.isfinite(c).all()) and float(c.std()) > 1e-3, "render_cli at 2^25: image")
    print(f"wide render_cli: --max-pairs {WIDE_BUDGET} --no-auto-pairs, bench PLY "
          f"{WIDTH}x{HEIGHT} tile 16, {res.num_pairs[0]} pairs, {seconds:.3f} s, peak memory "
          f"{mem / 2**30:.3f} GiB, launches {launches['render_cli_2e25']} | {gpu}", flush=True)

    # (1b) the same frame at 2^24 (K2) and 2^25 (K5 route) slots
    trainer = make_trainer(ply_path, data, device, tile=WIDE_TILE)
    state = trainer.state
    with torch.no_grad():
        active = gaussians.active_mask(state.params.capacity, state.num_active)
        acts = [a.detach() for a in gaussians.activations(state.params, active)]
    del trainer, state
    demand = [pair_demand(*wide_geometry(acts, active, data.cameras[v], device, WIDTH, 512))
              for v in range(TRAIN_VIEWS)]
    view = int(np.argmax(demand))
    cam = data.cameras[view]
    k2, aux24, render24_ms = wide_render(acts, active, cam, device, WIDTH, counters, expect,
                                         dict(merge_gather=1, raster_fwd=1),
                                         max_pairs=staging.K2_MAX_SLOTS)
    torch.cuda.reset_peak_memory_stats()
    ranked, aux25, render25_ms = wide_render(acts, active, cam, device, WIDTH, counters, expect,
                                             dict(merge_ranks=1, raster_fwd=1),
                                             max_pairs=WIDE_BUDGET)
    mem25 = torch.cuda.max_memory_allocated()
    launches["serving_2e25"] = {n: k.launches for n, k in counters.items()}
    npairs = int(aux25.num_pairs)
    require(npairs == int(aux24.num_pairs) == demand[view], "2^24 / 2^25 pair counts differ")
    require(same_image(ranked, k2), "the 2^25-slot frame differs from the 2^24-slot (K2) frame")
    args, st25 = wide_geometry(acts, active, cam, device, WIDTH, WIDE_BUDGET)
    st24 = st25._replace(max_pairs=staging.K2_MAX_SLOTS)
    with torch.no_grad():
        # The two routes at the same 2^24 budget: the same outputs, and
        # their times side by side.
        k2_out = staging._sorted_pairs(st24, *args)
        ranked_out = staging._ranked_pairs(st24, *args)
        require(all(bit_equal(a, b) for a, b in zip(ranked_out[:4], k2_out[:4])),
                "the K5 route differs from the K2 route at 2^24 slots")
        del k2_out, ranked_out
        route25 = cuda_ms(lambda: staging._sorted_pairs(st25, *args))
        route24 = cuda_ms(lambda: staging._sorted_pairs(st24, *args))
        ranked24 = cuda_ms(lambda: staging._ranked_pairs(st24, *args))
    del args
    print(f"wide serving: training workload's initial {N_GAUSSIANS} gaussians SH{SH_DEGREE} "
          f"{WIDTH}x{HEIGHT} tile {WIDE_TILE}, orbit view {view} ({npairs} pairs): the "
          f"{WIDE_BUDGET}-slot frame (K5 route) bit-equal to the 2^24-slot frame (K2) in "
          f"color, depth, alpha and n_contrib; _sorted_pairs {route25:.4f} ms at 2^25 (K5 "
          f"route) vs {route24:.4f} ms at 2^24 (K2); at 2^24 the K5 route alone "
          f"(_ranked_pairs) {ranked24:.4f} ms, its outputs bit-equal to K2's (CUDA events, "
          f"median of 5); render "
          f"{render25_ms:.3f} / {render24_ms:.3f} ms (one call); peak memory "
          f"{mem25 / 2**30:.3f} GiB | {gpu}", flush=True)

    # (2) a view with more than 2^24 real pairs
    size = pairs = None
    for s in WIDE_SIZES:
        d = pair_demand(*wide_geometry(acts, active, wide_view(s, view), device, s, 512))
        if d > WIDE_MARGIN * staging.K2_MAX_SLOTS:
            size, pairs = s, d
            break
    require(size is not None, f"no probed view size passes 2^24 pairs: {WIDE_SIZES}")
    budget = -(-pairs // 512) * 512 + 512
    cam = wide_view(size, view)
    torch.cuda.reset_peak_memory_stats()
    sorted_img, aux_s, sorted_ms = wide_render(acts, active, cam, device, size, counters, expect,
                                               dict(merge_ranks=1, raster_fwd=1),
                                               max_pairs=budget)
    launches["sorted_over_2e24"] = {n: k.launches for n, k in counters.items()}
    split_img, aux_p, split_ms = wide_render(acts, active, cam, device, size, counters, expect,
                                             dict(merge_ranks=1, raster_fwd=1),
                                             max_pairs=budget, staging="split")
    launches["split_over_2e24"] = {n: k.launches for n, k in counters.items()}
    mem_render = torch.cuda.max_memory_allocated()
    require(int(aux_s.num_pairs) == int(aux_p.num_pairs) == pairs > staging.K2_MAX_SLOTS,
            f"over-2^24 pair counts {int(aux_s.num_pairs)} / {int(aux_p.num_pairs)} / {pairs}")
    same = same_image(sorted_img, split_img)
    if not same:
        np.testing.assert_allclose(sorted_img["color"], split_img["color"], rtol=1e-4,
                                   atol=1e-5)
        mism = float(np.mean(sorted_img["n_contrib"] != split_img["n_contrib"]))
        require(mism <= NCON_MISMATCH, f"over-2^24 n_contrib mismatch {mism}")
    require(float(sorted_img["color"].std()) > 1e-3, "over-2^24 render: blank image")
    args, st = wide_geometry(acts, active, cam, device, size, budget)
    with torch.no_grad():
        route_ms = cuda_ms(lambda: staging._sorted_pairs(st, *args))
        sp = staging.stage_pairs_sorted(st, *args)
    # K1 against its plain version on the serving buffer of this frame (the
    # K5 route's records), and K5 on its cumsum.
    grid = (-(-size // WIDE_TILE),) * 2
    fwd_serving = check_fwd((sp.records_cm, sp.tile_start, sp.tile_count, *grid, WIDE_TILE,
                             WIDE_TILE), f"{size}x{size} serving, over 2^24 pairs",
                            timed=False)
    del sp
    cum = serving_cumsum(args, st)
    ranks = check_merge_ranks(cum, budget, f"{size}x{size}, over 2^24 pairs")
    del args, cum

    # one sorted training step there, its target the bench PLY's own render
    from gaussiansplattingmlx_tpu_torch.data import ply
    ply_params = gaussians.params_from_numpy(ply.read_gaussian_ply(ply_path), device)
    with torch.no_grad():
        ply_acts = [a.detach() for a in gaussians.activations(ply_params)]
    target, _, _ = wide_render(ply_acts, None, cam, device, size, counters, expect,
                               dict(merge_gather=1, raster_fwd=1),
                               max_pairs=RasterizerConfig().max_pairs_limit)
    del ply_params, ply_acts, acts, active
    wide = TrainData(cameras=[cam], images=target["color"][None].astype(np.float32))
    trainer = make_trainer(ply_path, wide, device, tile=WIDE_TILE,
                           train=dict(iterations=1, log_interval=1))
    trainer.set_max_pairs(budget)
    # K1, K3 and K4 against their plain versions on the step's own buffers
    # (no K2 above 2^24 slots); timed there.
    train_entries = check_training_buffers(trainer, device,
                                           f"{size}x{size} trainer's buffers, first step")
    torch.cuda.reset_peak_memory_stats()
    log, final, seconds, launches["train_over_2e24"] = run_training(trainer, counters, steps=1)
    mem_train = torch.cuda.max_memory_allocated()
    require(len(log) == 1 and all(np.isfinite([log[0]["loss"], log[0]["l1"], log[0]["ssim"]])),
            f"over-2^24 step: losses {log}")
    require(int(final["num_pairs"]) == pairs and final["overflow_pairs_acc"] == 0,
            f"over-2^24 step: pairs {final['num_pairs']}, overflow {final['overflow_pairs_acc']}")
    require(final["grad_coverage"] > 0, "over-2^24 step: no gaussian received a gradient")
    require(launches["train_over_2e24"] == expect(merge_ranks=1, raster_fwd=1, raster_bwd=1,
                                                  segsum=1),
            f"over-2^24 step: launches {launches['train_over_2e24']}")
    del trainer
    print(f"wide pairs: orbit view {view} at {size}x{size} (focal {FOCAL * size / WIDTH:.1f}), "
          f"tile {WIDE_TILE}: {pairs} pairs (> 2^24 = {staging.K2_MAX_SLOTS}), max_pairs "
          f"{budget}; sorted layout (K5 route) vs staging='split' (K5 + integer gathers): "
          f"bit-equal {same}; render {sorted_ms:.3f} / {split_ms:.3f} ms (one call), "
          f"_sorted_pairs {route_ms:.4f} ms (CUDA events, median of 5); peak memory "
          f"{mem_render / 2**30:.3f} GiB over the renders; one sorted training step: loss "
          f"{log[0]['loss']:.6f} (l1 {log[0]['l1']:.6f}, ssim {log[0]['ssim']:.6f}), "
          f"grad_coverage {final['grad_coverage']:.4f}, {seconds:.3f} s, peak memory "
          f"{mem_train / 2**30:.3f} GiB, launches {launches['train_over_2e24']} | {gpu}",
          flush=True)
    return {"launches": launches, "ranks": ranks, "fwd_serving": fwd_serving,
            **{k: train_entries[k] for k in ("raster_fwd", "raster_bwd", "segsum")},
            "numbers": {"serving_pairs": npairs, "serving_route_ms": route25,
                        "serving_k2_route_ms": route24,
                        "serving_k5_route_at_2e24_ms": ranked24, "wide_size": size,
                        "wide_pairs": pairs, "wide_budget": budget,
                        "wide_route_ms": route_ms, "wide_split_bit_equal": same,
                        "wide_render_peak_gib": mem_render / 2**30,
                        "wide_train_peak_gib": mem_train / 2**30}}


def colmap_scene() -> dict:
    """The vendored scene as ``load_colmap`` and ``read_points3d_bin``
    give it (cameras as their tensors)."""
    from gaussiansplattingmlx_tpu_torch.data import colmap

    sparse = VENDOR / "sparse" / "0"
    data, pcd = colmap.load_colmap(VENDOR)
    return {"images": data.images, "alphas": data.alphas,
            "cameras": [c.tensors() for c in data.cameras], "coords": pcd.coords,
            "colors": pcd.colors,
            "points": colmap.read_points3d_bin(sparse / "points3D.bin")}


def check_no_compiler(tmp: Path) -> None:
    """COLMAP loading where the native parser cannot be built: a fresh
    process with CXX naming a missing file, a PATH that holds no compiler and
    an empty build directory loads the vendored scene through the Python
    parsers, equal to this process's load through the library, and says so
    in exactly one stderr line."""
    import pickle

    from gaussiansplattingmlx_tpu_torch.data import native_io

    require(native_io.library() is not None, "the native parser did not build here")
    want = colmap_scene()
    empty = tmp / "no_compiler_bin"
    empty.mkdir()
    out = tmp / "no_compiler.pkl"
    code = "\n".join([
        "import pickle, sys",
        "from pathlib import Path",
        f"sys.path.insert(0, {str(ROOT)!r})",
        "import chip_smoke",
        "from gaussiansplattingmlx_tpu_torch.data import native_io",
        f"native_io.BUILD_DIR = Path({str(tmp / 'no_compiler_build')!r})",
        "got = chip_smoke.colmap_scene()",
        "got['library'] = native_io.library()",
        f"Path({str(out)!r}).write_bytes(pickle.dumps(got))",
    ])
    env = {**os.environ, "CXX": str(tmp / "missing" / "c++"), "PATH": str(empty)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"no-compiler load failed:\n{proc.stdout}{proc.stderr}")
    got = pickle.loads(out.read_bytes())
    require(got.pop("library") is None, "the library loaded without a compiler")
    require(same_value(got, want), "the Python parsers' scene differs from the library's")
    lines = proc.stderr.splitlines()
    require(len(lines) == 1 and lines[0].startswith("native COLMAP parser unavailable: no C++ "
                                                    "compiler"),
            f"no-compiler stderr: {proc.stderr!r}")
    print(f"no compiler: CXX={env['CXX']} (missing), PATH={empty} (empty), a fresh build "
          f"directory: load_colmap(tests/fixtures/vendor_scene) and read_points3d_bin equal "
          f"the library's load bit for bit; stderr, one line: {lines[0]!r}; {seconds:.2f} s "
          f"for the process | {gpu_line()}", flush=True)


def check_native() -> None:
    """The native COLMAP parsers, built here with the host C++ compiler
    (the first use in this run), against the Python parsers on the
    vendored scene's sparse/: equal bit for bit; both times printed."""
    from gaussiansplattingmlx_tpu_torch.data import colmap, native_io

    t0 = time.perf_counter()
    require(native_io.library() is not None, "the native COLMAP parser did not build")
    build_s = time.perf_counter() - t0
    sparse = VENDOR / "sparse" / "0"
    times = {}
    for name, native, plain in (
            ("cameras.bin", colmap.read_cameras_bin, colmap.read_cameras_bin_plain),
            ("images.bin", colmap.read_images_bin, colmap.read_images_bin_plain),
            ("points3D.bin", colmap.read_points3d_bin, colmap.read_points3d_bin_plain)):
        got, want = {}, {}
        for fn, into in ((native, got), (plain, want)):
            t0 = time.perf_counter()
            into["value"] = fn(sparse / name)
            into["ms"] = 1e3 * (time.perf_counter() - t0)
        require(same_value(got["value"], want["value"]),
                f"native parser: {name} differs from the Python parser's")
        times[name] = (got["ms"], want["ms"])
    print(f"native: the COLMAP parsers built in {build_s:.2f} s and equal to the Python "
          f"parsers bit for bit on tests/fixtures/vendor_scene/sparse/0; ms native / Python: "
          + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in times.items())
          + f" (host clock, one call) | {gpu_line()}", flush=True)


def same_value(a, b) -> bool:
    """Nested dicts, lists and arrays equal in type, dtype, shape and bits."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_value(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "gaussiansplattingmlx_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the port's package is not beside this script", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def elapsed(phase: str) -> None:
        print(f"elapsed: {time.perf_counter() - t_start:.1f} s after the {phase} phase",
              flush=True)

    sys.path.insert(0, str(ROOT))
    from gaussiansplattingmlx_tpu_torch import config, render_cli
    from gaussiansplattingmlx_tpu_torch.ops import (
        _kernels, merge_cuda, rasterize_cuda, relayout_cuda, segsum_cuda, staging,
    )
    from gaussiansplattingmlx_tpu_torch.train import trainer as trainer_mod

    # Every kernel's launch counter; each main path names what it must launch.
    counters = {"merge_gather": merge_cuda.KERNEL,
                "raster_fwd": rasterize_cuda.KERNEL,
                "raster_bwd": rasterize_cuda.BWD_KERNEL,
                "segsum": segsum_cuda.KERNEL,
                "merge_ranks": merge_cuda.RANKS_KERNEL,
                "relayout": relayout_cuda.KERNEL,
                "raster_bwd_aligned": rasterize_cuda.BWD_ALIGNED_KERNEL}

    def expect(**launched):
        return {name: launched.get(name, 0) for name in counters}

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    gpu = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {gpu} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build (one nvcc per source, in parallel, then a link)
    t0 = time.perf_counter()
    _kernels.LIBRARY.cdll()
    built = _kernels.LIBRARY.build_seconds
    nvcc_s = "library already built" if built is None else f"nvcc {built:.2f} s"
    ptxas = [ln.strip() for ln in _kernels.LIBRARY.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"build: {_kernels.LIBRARY.path.name} in "
          f"{time.perf_counter() - t0:.2f} s ({nvcc_s})"
          f"; ptxas: {' | '.join(ptxas)}", flush=True)

    # 2a. the densify noise stream, card against CPU
    check_prng(device, gpu)

    # 2b. the port's bench (bench.py's workload) through its entry point in a
    # fresh process, then K2, K1, K3 and K4 on its first-step buffers
    bench = run_bench(device, counters, gpu)
    elapsed("bench")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ply_path = Path(tmp) / "bench_scene.ply"
        bench_scene(ply_path)

        # 3. serving kernels at the serving path's shapes
        args, total, st = bench_geometry(ply_path, device)
        require(total > 0, "no pairs in the bench view")
        merge_serving = check_merge(args, st, device)
        fwd_serving = check_raster(args, st)
        check_small_render(device)
        # 3b. the oracle (backend="reference") against the kernels' path
        ref_launches = check_reference(device, counters, expect)
        elapsed("reference")
        # 3c. the golden image (tests/golden_scene.npz) through the kernels
        # and the oracle
        golden_launches = check_golden(device, counters, expect)

        # 4. the serving path through its entry point
        for k in counters.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = render_cli.main([
            "--ply", str(ply_path), "--out", str(Path(tmp) / "renders"),
            "--orbit", "4", "--width", str(WIDTH), "--height", str(HEIGHT),
            "--focal", str(FOCAL), "--bench-frames", "16", "--device", "cuda",
        ])
        serve_launches = {name: k.launches for name, k in counters.items()}
        serve_mem = torch.cuda.max_memory_allocated()
        require(all(o == 0 for o in res.overflow_pairs) and res.bench_overflow_pairs == 0,
                f"overflow in the render: {res.overflow_pairs} / {res.bench_overflow_pairs}")
        require(all(npairs > 0 for npairs in res.num_pairs), "no pairs rendered")
        for c in res.colors:
            require(c.shape == (HEIGHT, WIDTH, 3), f"image shape {c.shape}")
            require(bool(np.isfinite(c).all()), "non-finite pixels")
            require(float(c.std()) > 1e-3 and float(c.max()) > 0.05, "blank image")
        frames = serve_launches["raster_fwd"]
        require(frames > 0 and serve_launches == expect(merge_gather=frames, raster_fwd=frames),
                f"serving launches {serve_launches}")
        print(f"render: {N_GAUSSIANS} gaussians SH{SH_DEGREE} {WIDTH}x{HEIGHT}, "
              f"num_pairs {res.num_pairs}, max_pairs {res.max_pairs}, "
              f"{res.bench_fps:.2f} frames/s over {res.bench_frames} frames, peak memory "
              f"{serve_mem / 2**30:.3f} GiB, launches {serve_launches} | {gpu}", flush=True)

        # 5. training kernels on the bench camera's training buffers
        data = orbit_targets(ply_path, device)
        target = torch.as_tensor(data.images[0]).to(device)
        bwd_bench, gid, rows = check_raster_bwd(args, st, target, device)
        segsum_bench = check_segsum(gid, rows, N_GAUSSIANS, "bench camera, tile 16")
        del gid, rows
        ranks_serving = check_merge_ranks(serving_cumsum(args, st), st.max_pairs,
                                          "bench camera, serving budget")
        check_relayout(args, st, "bench camera, tile 16", timed=False)
        with torch.no_grad():
            sp16, _ = staging._stage_impl(st, *args)
        require(int(sp16.overflow_pairs) == 0, "aligned staging must not overflow")
        check_raster_bwd_aligned(sp16.records_cm, sp16.aligned_start, sp16.tile_count,
                                 st.tile_w, st.chunk, target, "bench camera")
        del sp16

        # 6. the training path through its entry point (the default layout)
        trainer, peak, peak16 = training_setup(ply_path, data, device)
        train_entries = check_training_buffers(trainer, device)
        raster_bwd = {**train_entries["raster_bwd"], **bwd_bench}
        steps = TRAIN_STEPS
        log, final, seconds, train_launches = run_training(trainer, counters)
        check_train_run(trainer, log, final, train_launches,
                        expect(merge_gather=steps, raster_fwd=steps, raster_bwd=steps,
                               segsum=steps),
                        seconds, torch.cuda.max_memory_allocated(), "train",
                        f" (probe peak {peak}; {peak16} at tile 16)")
        max_pairs = trainer.cfg.raster.max_pairs
        sorted_log = log
        sorted_losses = np.array([m["loss"] for m in log])
        # 6b. densify on the card against densify on the CPU, from this
        # run's state
        check_densify(trainer, device)
        del trainer
        # 6c. one sorted step at half of view 0's pair demand, the budget at
        # its limit: K2, K1, K3 and K4 on its buffers, its overflow counts,
        # the Trainer's at-limit branch
        truncated, trunc_launches = run_truncated(ply_path, data, device, counters, expect, gpu)
        elapsed("truncated")

        # 7. the non-default layouts' training runs, at the same pair budget;
        # K1 checked and K6 and K7 checked and timed on the aligned run's own
        # buffers, K1, K5 and K7 on the split run's
        layout_launches, layout_entries = {}, {}
        for layout, launched in (
                ("aligned", dict(merge_gather=steps, relayout=steps)),
                ("split", dict(merge_ranks=steps))):
            selector = config.LAYOUTS[layout]
            trainer = make_trainer(ply_path, data, device, **selector)
            trainer.set_max_pairs(max_pairs)
            layout_entries.update(check_layout_buffers(trainer, layout))
            log, final, seconds, launches = run_training(trainer, counters)
            losses = np.array([m["loss"] for m in log])
            rel = float(np.max(np.abs(losses - sorted_losses) / sorted_losses))
            require(rel <= LOSS_RTOL, f"train {layout}: losses {losses.tolist()} differ from "
                                      f"the sorted run's {sorted_losses.tolist()}")
            check_train_run(trainer, log, final, launches,
                            expect(raster_fwd=steps, raster_bwd_aligned=steps, segsum=steps,
                                   **launched),
                            seconds, torch.cuda.max_memory_allocated(), f"train {layout}",
                            f" ({', '.join(f'{k}={v!r}' for k, v in selector.items())}; "
                            f"logged losses within {rel:.2e} of the sorted run's)")
            layout_launches[layout] = launches
            del trainer
        relayout = layout_entries["relayout"]
        raster_bwd_aligned = layout_entries["raster_bwd_aligned"]
        # 7b. grad_reduce="scatter" in the three layouts (no K4), and the
        # profiler on the default layout's step
        scatter_entry, scatter_runs = run_scatter(ply_path, data, device, max_pairs,
                                                  sorted_log, counters, expect)
        elapsed("scatter")
        check_profiler(ply_path, data, device, max_pairs, Path(tmp))
        elapsed("profiler")
        # K5 at the split training run's budget, with the split serving
        # budget's numbers beside them.
        merge_ranks = {**layout_entries["merge_ranks"],
                       **{f"serving_{k}": ranks_serving[k]
                          for k in ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
                                    "library_call_ms")}}

        # 8. the split layout's serving path
        split_launches, seconds, npairs, split_mem, same = run_split_serving(
            ply_path, device, res.max_pairs, res.colors, counters)
        require(split_launches == expect(merge_ranks=SPLIT_FRAMES, raster_fwd=SPLIT_FRAMES),
                f"split serving launches {split_launches}")
        print(f"render split: {SPLIT_FRAMES} orbit frames through render_many, "
              f"staging='split', max_pairs {res.max_pairs}, num_pairs "
              f"{int(npairs.min())}-{int(npairs.max())}, {SPLIT_FRAMES / seconds:.2f} "
              f"frames/s; the 4 serving views within tolerance of the fused render "
              f"(bit-equal: {same}); peak memory {split_mem / 2**30:.3f} GiB; launches "
              f"{split_launches} | {gpu}", flush=True)
        # 8b. the staging route above 2^24 slots: a 2^25 budget, then more
        # than 2^24 real pairs (sorted vs split, one training step)
        wide = run_wide(ply_path, data, device, counters, expect, Path(tmp), gpu)
        elapsed("wide")

        # 9. the densified training run (default layout) through Trainer.run
        dense_dir = Path(tmp) / "densified"
        budget = max(512, -(-DENSE_HEADROOM * peak // 512) * 512)
        trainer, dense_log, seconds, dense_launches, rounds, dense_mem = run_densified(
            ply_path, data, device, budget, dense_dir, counters)
        for r in rounds:
            print(f"densified round: {json.dumps(r)}", flush=True)
        files = check_densified(trainer, dense_log, dense_launches,
                                expect(merge_gather=DENSE_STEPS, raster_fwd=DENSE_STEPS,
                                       raster_bwd=DENSE_STEPS, segsum=DENSE_STEPS),
                                rounds, dense_dir)
        window = sum(5 / m["iters_per_s"] for m in dense_log[1:])
        print(f"train densified: {DENSE_STEPS} steps, {N_GAUSSIANS} -> "
              f"{int(trainer.state.num_active)} gaussians, capacity {rounds[0]['capacity']} -> "
              f"{trainer.state.params.capacity}, SH{SH_DEGREE} {WIDTH}x{HEIGHT} tile "
              f"{TRAIN_TILE}, max_pairs {trainer.cfg.raster.max_pairs} ({DENSE_HEADROOM} x probe "
              f"peak {peak}), num_pairs {[int(m['num_pairs']) for m in dense_log]}, overflow 0; "
              f"loss {[round(m['loss'], 5) for m in dense_log]}; "
              f"{DENSE_STEPS / seconds:.2f} steps/s over all {DENSE_STEPS} steps, "
              f"{5 * (len(dense_log) - 1) / window:.2f} steps/s over steps 6-{DENSE_STEPS}; "
              f"peak memory {dense_mem / 2**30:.3f} GiB; launches {dense_launches}; files "
              f"{files} | {gpu}", flush=True)
        # K2, K1, K3 and K4 on the grown trainer's buffers (262,144 rows),
        # and the densify step's time at that capacity.
        grown = check_training_buffers(
            trainer, device, f"densified run's buffers after step {DENSE_STEPS}")
        noise = trainer.densify_noise(trainer.state.params.capacity)
        densify_grown = densify_ms(trainer_mod.make_densify_step(trainer.cfg), trainer.state,
                                   noise)
        print(f"densify (densify): {densify_grown:.4f} ms device time at "
              f"{trainer.state.params.capacity} slots (one call, CUDA events) | {gpu}", flush=True)
        full_state = trainer_mod.state_to_numpy(trainer.state)
        del trainer, noise

        # 10. resume from the densified run's step-15 checkpoint
        start, resumed, resume_launches = check_resume(
            ply_path, data, device, budget, dense_dir / "ckpt_15.npz", full_state, dense_log,
            counters)
        require(resume_launches == expect(merge_gather=DENSE_STEPS - start,
                                          raster_fwd=DENSE_STEPS - start,
                                          raster_bwd=DENSE_STEPS - start,
                                          segsum=DENSE_STEPS - start),
                f"resume launches {resume_launches}")
        print(f"resume: ckpt_15.npz restored into a new Trainer, steps {start + 1}-{DENSE_STEPS} "
              f"(a densify round at 20, prune-only at 30): parameters, Adam moments, "
              f"num_active {int(full_state['num_active'])} and logged losses {resumed} "
              f"bit-identical to the uninterrupted run; launches {resume_launches} | {gpu}",
              flush=True)
        del full_state

        # 11. the native COLMAP parsers (built here), then the loader
        # without Pillow
        check_native()
        check_loader()
        # 11b. the loader where the native parser cannot be built
        check_no_compiler(Path(tmp))
        # 12. the vendored scene through train_cli and eval_cli at the
        # default config, and a resume through train_cli
        cli_launches = run_vendor(Path(tmp), counters, expect, gpu)
        elapsed("vendored CLI")
        # 13. the full-width scene through train_cli and eval_cli
        trainer, full_launches = run_full(Path(tmp), counters, expect, gpu)
        cli_launches.update(full_launches)
        elapsed("full-width CLI")
        # 14. K2, K1, K3 and K4 on the buffers of the full-width run's last
        # step (SH4, tile 16, densified)
        cli = check_training_buffers(trainer, device,
                                     f"800x800 CLI run's buffers after step {FULL_STEPS}")
        del trainer
        # 14b. the flagship campaign (train_flagship): the self-fit form at
        # full width, the independent form on the full-width scene; K2, K1,
        # K3 and K4 on the self-fit run's last buffers
        trainer, flagship_launches = run_flagship(Path(tmp), device, counters, expect, gpu)
        flagship = check_training_buffers(
            trainer, device, f"flagship self-fit run's buffers after step {FLAGSHIP_STEPS}")
        del trainer
        elapsed("flagship")
        # 15. the band render, the data-, tile- and data x tile-parallel
        # steps against one device and their runs through Trainer.run; K1-K4
        # on a 400-row band buffer
        par = run_parallel(ply_path, Path(tmp), device, gpu)
        elapsed("parallel")
        # 16. train_cli --data-parallel 2, its resume and --multihost
        cli_par = run_cli_parallel(Path(tmp), gpu)

    # K1, K2 and K4 at the sorted training run's shapes, their serving (K1,
    # K2) or tile-16 bench buffer (K4) numbers beside them.
    timed = ("ms", "call_ms", "plain_ms", "bound_ms", "max_abs_err")
    merge_gather = {**train_entries["merge_gather"],
                    **{f"serving_{k}": merge_serving[k] for k in timed},
                    "serving_launches": serve_launches["merge_gather"]}
    fwd_paths = {"serving": serve_launches["raster_fwd"],
                 "train_sorted": train_launches["raster_fwd"],
                 **{f"train_{k}": v["raster_fwd"] for k, v in layout_launches.items()},
                 "serving_split": split_launches["raster_fwd"]}
    raster_fwd = {**train_entries["raster_fwd"],
                  **{f"serving_{k}": fwd_serving[k] for k in (*timed, "pixel_records")},
                  "serving_launches": serve_launches["raster_fwd"],
                  "launches_by_path": fwd_paths, "design": FWD_DESIGN}
    # K4 also carries its feed's times and its segment profile at each shape.
    segsum_keys = (*timed, "library_ms", "sort_ms", "gather_ms", "gather_one_ms", "segments")
    segsum = {**train_entries["segsum"],
              **{f"bench_tile16_{k}": segsum_bench[k] for k in segsum_keys},
              "design": SEGSUM_DESIGN, **scatter_entry}
    # K1-K4 on the densified run's grown buffers (262,144 rows).
    merge_gather.update({f"grown_{k}": grown["merge_gather"][k] for k in timed})
    raster_fwd.update({f"grown_{k}": grown["raster_fwd"][k] for k in (*timed, "pixel_records")})
    raster_bwd.update({f"grown_{k}": grown["raster_bwd"][k] for k in timed})
    segsum.update({f"grown_{k}": grown["segsum"][k] for k in segsum_keys})
    # K1-K4 on the full-width CLI run's buffers (SH4, tile 16, densified),
    # and their launches in the CLI runs.
    merge_gather.update({f"cli_{k}": cli["merge_gather"][k] for k in timed})
    raster_fwd.update({f"cli_{k}": cli["raster_fwd"][k] for k in (*timed, "pixel_records")})
    raster_bwd.update({f"cli_{k}": cli["raster_bwd"][k] for k in timed})
    segsum.update({f"cli_{k}": cli["segsum"][k] for k in segsum_keys})
    # K1-K4 on the flagship self-fit run's last buffers (SH3, tile 16,
    # densified), and their launches in the flagship runs.
    merge_gather.update({f"flagship_{k}": flagship["merge_gather"][k] for k in timed})
    raster_fwd.update({f"flagship_{k}": flagship["raster_fwd"][k]
                       for k in (*timed, "pixel_records")})
    raster_bwd.update({f"flagship_{k}": flagship["raster_bwd"][k] for k in timed})
    segsum.update({f"flagship_{k}": flagship["segsum"][k] for k in segsum_keys})
    for name, entry in (("merge_gather", merge_gather), ("raster_fwd", raster_fwd),
                        ("raster_bwd", raster_bwd), ("segsum", segsum)):
        entry["launches_flagship"] = {run: launched[name]
                                      for run, launched in flagship_launches.items()}
    # Every kernel's launches in the scatter runs (K4 none) and in the
    # oracle's render and eval_cli run (K5 only, its binning).
    for name, entry in (("merge_gather", merge_gather), ("raster_fwd", raster_fwd),
                        ("raster_bwd", raster_bwd), ("segsum", segsum),
                        ("merge_ranks", merge_ranks), ("relayout", relayout),
                        ("raster_bwd_aligned", raster_bwd_aligned)):
        entry["launches_scatter"] = {layout: launched[name]
                                     for layout, launched in scatter_runs.items()}
        entry["launches_reference"] = {"render": ref_launches[name],
                                       "eval_cli": cli_launches["vendor_eval_reference"][name]}
    # K5 at the shape of the view with more than 2^24 pairs (its new launch
    # site: the sorted staging above 2^24 slots), and every kernel's
    # launches in the wide and golden phases.
    merge_ranks.update({f"wide_{k}": wide["ranks"][k]
                        for k in ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
                                  "library_call_ms")})
    merge_ranks.update(wide["numbers"])
    # K1, K3 and K4 on the over-2^24 trainer's buffers (K1 also on that
    # frame's serving buffer).
    raster_fwd.update({f"wide_{k}": wide["raster_fwd"][k]
                       for k in (*timed, "n_contrib_mismatch", "pixel_records")})
    raster_fwd.update({f"wide_serving_{k}": v for k, v in wide["fwd_serving"].items()})
    raster_bwd.update({f"wide_{k}": wide["raster_bwd"][k] for k in timed})
    segsum.update({f"wide_{k}": wide["segsum"][k] for k in segsum_keys})
    for name, entry in (("merge_gather", merge_gather), ("raster_fwd", raster_fwd),
                        ("raster_bwd", raster_bwd), ("segsum", segsum),
                        ("merge_ranks", merge_ranks), ("relayout", relayout),
                        ("raster_bwd_aligned", raster_bwd_aligned)):
        entry["launches_wide"] = {run: launched[name]
                                  for run, launched in wide["launches"].items()}
        entry["launches_golden"] = {run: launched[name]
                                    for run, launched in golden_launches.items()}
    for name, entry in (("merge_gather", merge_gather), ("raster_fwd", raster_fwd),
                        ("raster_bwd", raster_bwd), ("segsum", segsum)):
        entry["launches_densified"] = dense_launches[name]
        entry["launches_resumed"] = resume_launches[name]
        entry["launches_cli"] = {run: launched[name] for run, launched in cli_launches.items()}
        # K1-K4 on the T=2 run's 400-row band buffer, and their launches
        # per rank in each D x T run (ranks sharing one card).
        entry.update({f"band400_{k}": par["band"][name][k]
                      for k in (segsum_keys if name == "segsum" else timed)})
        entry["launches_parallel"] = {
            **{run: [r[name] for r in launched] for run, launched in par["runs"].items()},
            **{run: [r[name] for r in e["launches"]] for run, e in cli_par.items()}}

    # K2, K1, K3 and K4 on the truncated step's buffers (tile 32, half of
    # view 0's demand), and their launches in its run.
    for name, entry in (("merge_gather", merge_gather), ("raster_fwd", raster_fwd),
                        ("raster_bwd", raster_bwd), ("segsum", segsum)):
        keys = (*timed, "bound_by", "library_ms")
        if name == "segsum":
            keys += ("segments",)
        entry.update({f"truncated_{k}": truncated[name][k] for k in keys})
        entry["truncated_launches"] = trunc_launches[name]
    raster_fwd["truncated_pixel_records"] = truncated["raster_fwd"]["pixel_records"]

    # K2, K1, K3 and K4 on the bench workload's first-step buffers (tile 32,
    # its probed budget), and their launches in the bench's timed steps.
    for name, entry in (("merge_gather", merge_gather), ("raster_fwd", raster_fwd),
                        ("raster_bwd", raster_bwd), ("segsum", segsum)):
        keys = (*timed, "bound_by", "library_ms")
        if name == "segsum":
            keys += ("library_call_ms", "sort_ms", "segments")
        if name == "raster_bwd":
            keys += ("rtol", "beyond_grad_bars", "worst_of_grad_bar")
        entry.update({f"bench_{k}": bench["entries"][name][k] for k in keys})
        entry["bench_launches"] = bench["launches"][name]
    raster_fwd["bench_pixel_records"] = bench["entries"]["raster_fwd"]["pixel_records"]

    kernels = [
        {"name": "merge_gather", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/merge_gather.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/merge_pallas.py:156",
         "launches": train_launches["merge_gather"], **merge_gather},
        {"name": "raster_fwd", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/rasterize_pallas.py:210",
         "launches": train_launches["raster_fwd"], **raster_fwd},
        {"name": "raster_bwd", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/rasterize_bwd.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/rasterize_pallas.py:473",
         "launches": train_launches["raster_bwd"], **raster_bwd},
        {"name": "segsum", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/segsum.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/rasterize_pallas.py:726",
         "launches": train_launches["segsum"], **segsum},
        {"name": "merge_ranks", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/merge_ranks.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/merge_pallas.py:45",
         "launches": layout_launches["split"]["merge_ranks"], **merge_ranks},
        {"name": "relayout", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/relayout.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/staging.py:246",
         "launches": layout_launches["aligned"]["relayout"], **relayout},
        {"name": "raster_bwd_aligned", "route": "cuda",
         "source": "gaussiansplattingmlx_tpu_torch/csrc/rasterize_bwd_aligned.cu",
         "replaces": "gaussiansplattingmlx_tpu/ops/rasterize_pallas.py:302",
         "launches": layout_launches["aligned"]["raster_bwd_aligned"], **raster_bwd_aligned},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
