"""The benchmark's yardstick arithmetic: the card's peaks, the pair budget,
each kernel's bytes and operations, the operations of a whole step, host
syncs and the card's power limit.  Frozen here so that it cannot move with
the program.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet): HBM 3.35 TB/s; 67 TFLOP/s
in float32 outside the tensor cores (the program uses no tensor core).

Operations a (pixel, record) taken: K1 24 (offset 2, quadratic form 8,
exp 1, opacity and clamp 2, weight 1, four multiply-adds 8, transmittance
2); K3 60 (alpha again 13, undo and weight 4, cotangent dot 7, dl/da 5,
suffix sum 2, ten gradient terms ~19, one add a term into the pixel's sum
10).  K4: one add a live row entry.
"""

from __future__ import annotations

import math
import subprocess
import warnings
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS, K3_OPS = 24, 60
# K4's live gradient rows a record (rows 3 and 4 of the 16 carry one value).
K4_ROWS = 10
# Rows a record carries in the record buffer, rows the compositing reads.
REC_ROWS, READ_ROWS = 16, 11
# Operations a Gaussian: the projection's forward (view and clip transforms
# 56, quaternion to rotation 40, covariance 63, Jacobian and 2D covariance
# 104, determinant and conic 10, radius and rect 27) and the SH colour by
# degree (basis and 3-channel multiply-adds); a backward counts twice its
# forward.
PROJ_OPS = 300
SH_OPS = {0: 6, 1: 30, 2: 80, 3: 140}
# Operations a pixel and channel of L1 + SSIM's forward: |x - y| and its sum
# 3; SSIM's five maps 3, two 11-tap blurs of five maps 220, the map 22.
LOSS_OPS = 248
# Adam a parameter: two moment updates 7, sqrt, add, divide, scale and
# subtract 5.
ADAM_OPS = 12
# Operations a pixel and channel of the background and the 8-bit frame.
FRAME_OPS = 4
BUDGET_QUANTUM = 512


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def pair_budget(demand: int, chunk: int, headroom: float) -> int:
    """The pair budget: ``demand`` x ``headroom`` rounded up to lcm(512,
    chunk) slots."""
    quantum = BUDGET_QUANTUM * chunk // math.gcd(BUDGET_QUANTUM, chunk)
    return -(-int(demand * headroom) // quantum) * quantum


def tiles(cfg: dict) -> int:
    t = cfg["tile"]
    return -(-cfg["image_width"] // t) * -(-cfg["image_height"] // t)


def k1_bound_s(cfg: dict, work) -> float:
    """K1 on one view: the 11 record rows of every record a tile replays
    until its last pixel stops (a tile stops reading there, so most of a
    deep tile's pairs are never read), each tile's range, the [T, 6, TT]
    output; 24 operations a pixel-record taken."""
    t, tt = tiles(cfg), cfg["tile"] ** 2
    nbytes = 4.0 * (READ_ROWS * work.replayed + 2 * t + 6 * t * tt)
    return bound_s(nbytes, K1_OPS * work.pixel_records)


def k3_bound_s(cfg: dict, work) -> float:
    """K3 on one view: the 11 record rows of every replayed record, the
    [T, TT, 8] cotangent block, each tile's range, a 16-row gradient column
    a replayed record; 60 operations a pixel-record taken."""
    t, tt = tiles(cfg), cfg["tile"] ** 2
    nbytes = 4.0 * (READ_ROWS * work.replayed + 8 * t * tt + 2 * t + REC_ROWS * work.replayed)
    return bound_s(nbytes, K3_OPS * work.pixel_records)


def k4_bound_s(gaussians: int, work) -> float:
    """K4 on one view: the live rows of every pair and the segment offsets
    read, the [N, 16] sums written; one add a live entry."""
    nbytes = 4.0 * (K4_ROWS * work.pairs + gaussians + 1 + REC_ROWS * gaussians)
    return bound_s(nbytes, K4_ROWS * work.pairs)


def train_step_ops(cfg: dict, work) -> float:
    """Operations of one training step on one view: projection and SH
    forward and backward, K1, K3, K4, L1 + SSIM forward and backward, Adam."""
    n = cfg["scene"]["gaussians"]
    deg = cfg["sh_degree"]
    params = 3 + 3 * (deg + 1) ** 2 + 3 + 4 + 1
    pixels = cfg["image_width"] * cfg["image_height"]
    return (3.0 * n * (PROJ_OPS + SH_OPS[deg]) + (K1_OPS + K3_OPS) * work.pixel_records
            + K4_ROWS * work.pairs + 3.0 * LOSS_OPS * 3 * pixels + ADAM_OPS * params * n)


def frame_ops(cfg: dict, work) -> float:
    """Operations of one served frame: projection and SH, K1, background and
    8-bit conversion."""
    n = cfg["scene"]["gaussians"]
    pixels = cfg["image_width"] * cfg["image_height"]
    return (n * (PROJ_OPS + SH_OPS[cfg["sh_degree"]]) + K1_OPS * work.pixel_records
            + FRAME_OPS * 3 * pixels)


def host_syncs(step, device):
    """The synchronising CUDA operations one ``step()`` makes, counted from
    the warnings of ``torch.cuda.set_sync_debug_mode("warn")`` (the warning
    that switching the mode raises is not one); None off the card."""
    if torch.device(device).type != "cuda":
        step()
        return None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    switch = Path(torch.cuda.__file__).resolve()
    return sum(1 for w in caught
               if "synchroniz" in str(w.message) and Path(w.filename).resolve() != switch)


def power_limit_w(index: int = 0):
    """The card's power limit in watts from nvidia-smi, else None."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60,
            check=True)
        return float(proc.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None
