"""Exact (gaussian, tile) pair expansion onto a static pair axis (torch
counterpart of the JAX package's ``ops/binning.py``, the parts the sorted
inference staging uses).

Per-Gaussian tile footprints from the screen rect, an inclusive saturating
cumsum giving each gaussian a contiguous block of pair slots in
gaussian-major order, and the compaction of positive-footprint gaussians that
makes the cumsum strictly increasing for the merge (``ops/merge_cuda.py``).
Index machinery only: torch ops, bit-exact against the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Cumulative pair counts saturate at this value (2^30 - 1 keeps every partial
# sum inside int32 in the JAX package's clamped-add scan).
_CUM_CLAMP = 2**30 - 1
# Float -> int32 conversion guard: tile bounds are clipped to the grid right
# after, so clamping the float first changes no in-range value and keeps the
# cast defined for far off-screen rects.
_INT_GUARD = float(2**30)


def _saturating_cumsum(footprint: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of nonneg int32 saturating at _CUM_CLAMP.

    An int64 cumsum cannot wrap, and min(true_sum, C) is exactly what the
    JAX package's clamped-add associative scan computes for nonnegative
    inputs."""
    cum = torch.cumsum(footprint.to(torch.int64), dim=0)
    return torch.clamp(cum, max=_CUM_CLAMP).to(torch.int32)


def _floor_div_i32(x: torch.Tensor, tile: float) -> torch.Tensor:
    q = torch.floor(x / tile)
    return torch.clamp(q, -_INT_GUARD, _INT_GUARD).to(torch.int32)


def _tile_bounds(rect_min, rect_max, tile_w, tile_h, grid_w, grid_h):
    """Tile index bounds: floor(min/tile) .. floor(max/tile)+1, clipped."""
    tmin_x = torch.clamp(_floor_div_i32(rect_min[:, 0], tile_w), 0, grid_w)
    tmin_y = torch.clamp(_floor_div_i32(rect_min[:, 1], tile_h), 0, grid_h)
    tmax_x = torch.clamp(_floor_div_i32(rect_max[:, 0], tile_w) + 1, 0, grid_w)
    tmax_y = torch.clamp(_floor_div_i32(rect_max[:, 1], tile_h) + 1, 0, grid_h)
    return tmin_x, tmin_y, tmax_x, tmax_y


class PairExpansion(NamedTuple):
    cum_keep: torch.Tensor  # [n] int32 compacted inclusive cumsum (pad: clamp+1)
    keep_idx: torch.Tensor  # [n] int64 compaction permutation (actives first)
    tmin_x: torch.Tensor  # [n] int32
    tmin_y: torch.Tensor  # [n] int32
    rw: torch.Tensor  # [n] int32 rect width in tiles (>=1)
    block_start: torch.Tensor  # [n] int32 first pair slot of each gaussian's block
    num_pairs: torch.Tensor  # [] int32
    overflow_gaussians: torch.Tensor  # [] int32
    overflow_pairs: torch.Tensor  # [] int32


def expand_pairs(
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    radii: torch.Tensor,
    image_width: int,
    image_height: int,
    tile_w: int,
    tile_h: int,
    max_pairs: int,
) -> PairExpansion:
    """Footprints, saturating cumsum and compaction.  The pair-slot -> owner
    merge is fused downstream (``merge_cuda.merge_gather`` on ``cum_keep``),
    so no [max_pairs] rank is built here."""
    n = rect_min.shape[0]
    dev = rect_min.device
    grid_w = -(-image_width // tile_w)
    grid_h = -(-image_height // tile_h)

    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bounds(
        rect_min.detach(), rect_max.detach(), float(tile_w), float(tile_h),
        grid_w, grid_h,
    )
    active = radii.detach() > 0.0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    rw = torch.where(active, tmax_x - tmin_x, zero)
    rh = torch.where(active, tmax_y - tmin_y, zero)
    footprint = rw * rh  # exact tile count per gaussian

    cum = _saturating_cumsum(footprint)
    total = cum[-1] if n > 0 else zero
    num_pairs = torch.clamp(total, max=max_pairs)
    overflow_pairs = torch.clamp(total - max_pairs, min=0)
    overflow_gaussians = torch.sum(
        torch.logical_and(cum > max_pairs, footprint > 0)
    ).to(torch.int32)

    # Compaction: positive-footprint gaussians first, in gaussian order
    # (stable), so the compacted cumsum is strictly increasing.
    active_key = (footprint <= 0).to(torch.int32)
    sort_key, keep_idx = torch.sort(active_key, stable=True)
    cum_keep = torch.where(
        sort_key == 0, cum[keep_idx],
        torch.full((), _CUM_CLAMP + 1, dtype=torch.int32, device=dev),
    )
    return PairExpansion(
        cum_keep=cum_keep.contiguous(),
        keep_idx=keep_idx,
        tmin_x=tmin_x,
        tmin_y=tmin_y,
        rw=torch.clamp(rw, min=1),
        block_start=cum - footprint,
        num_pairs=num_pairs.to(torch.int32),
        overflow_gaussians=overflow_gaussians,
        overflow_pairs=overflow_pairs.to(torch.int32),
    )


def enumerate_tiles(g_block_start, g_rw, g_tmin_x, g_tmin_y, grid_w):
    """Per-pair tile ids from the gathered per-gaussian columns: the pair's
    offset inside its block enumerates the rect row-major.  Exact integer
    division (the JAX package's float-division form gives the same values)."""
    p = torch.arange(g_block_start.shape[0], dtype=torch.int32,
                     device=g_block_start.device)
    local = p - g_block_start
    q = torch.div(local, g_rw, rounding_mode="floor")
    ty = g_tmin_y + q
    tx = g_tmin_x + (local - q * g_rw)
    return ty * grid_w + tx
