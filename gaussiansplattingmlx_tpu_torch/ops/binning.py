"""Exact (gaussian, tile) pair expansion onto a static pair axis, and the
split pipeline's tile binning (torch counterpart of the JAX package's
``ops/binning.py``).

Per-Gaussian tile footprints from the screen rect, an inclusive saturating
cumsum giving each gaussian a contiguous block of pair slots in
gaussian-major order, and the compaction of positive-footprint gaussians that
makes the cumsum strictly increasing for the merge (``ops/merge_cuda.py``:
K2 fuses the merge with the staging's table gather, K5 gives the ranks
alone).  ``bin_gaussians`` is the split layout's binning: ranks, one table
row gather, and the (tile, depth) sort with the gaussian id as payload.
Index machinery only: torch ops, bit-exact against the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import merge_cuda

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
    merge runs downstream on ``cum_keep``: fused with the staging's table
    gather (``merge_cuda.merge_gather``) or alone in ``bin_gaussians``
    (``merge_cuda.merge_ranks``)."""
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


def sort_pairs(tile_ids: torch.Tensor, depth_keys: torch.Tensor) -> torch.Tensor:
    """The permutation of one stable (tile, depth) sort: ``torch.sort`` of the
    int64 key ``tile << 32 | f32_bits(depth)``.  It is exactly the JAX
    package's two-key stable ``lax.sort``: visible depths are >= z_cull > 0,
    the bits of a positive float32 sort in the order of its value, and
    invalid slots carry (num_tiles, +inf)."""
    key = (tile_ids.to(torch.int64) << 32) | depth_keys.view(torch.int32).to(torch.int64)
    return torch.sort(key, stable=True).indices


def tile_ranges(sorted_tile: torch.Tensor, num_tiles: int):
    """(tile_start, tile_count) [num_tiles] int32 of the sorted tile ids."""
    tile_iota = torch.arange(num_tiles, dtype=torch.int32, device=sorted_tile.device)
    start = torch.searchsorted(sorted_tile, tile_iota, side="left").to(torch.int32)
    end = torch.searchsorted(sorted_tile, tile_iota, side="right").to(torch.int32)
    return start, end - start


class TileBinning(NamedTuple):
    sorted_gauss_idx: torch.Tensor  # [max_pairs] int32 gaussian per pair (pad: 0)
    sorted_tile_id: torch.Tensor  # [max_pairs] int32 tile per pair (pad: num_tiles)
    tile_start: torch.Tensor  # [num_tiles] int32 first pair of each tile
    tile_count: torch.Tensor  # [num_tiles] int32 pairs per tile
    num_pairs: torch.Tensor  # [] int32
    overflow_gaussians: torch.Tensor  # [] int32
    overflow_pairs: torch.Tensor  # [] int32
    pair_valid: torch.Tensor  # [max_pairs] bool


class RankedSort(NamedTuple):
    expansion: PairExpansion
    sorted_rank: torch.Tensor  # [max_pairs] int32 compacted owner per pair (pad: n)
    valid: torch.Tensor  # [max_pairs] bool, slot < num_pairs (the same in sorted order)
    sorted_tile: torch.Tensor  # [max_pairs] int32 (pad: num_tiles)
    sorted_depth: torch.Tensor  # [max_pairs] f32 (pad: +inf)


def ranked_sort(rect_min, rect_max, radii, depths, image_width: int, image_height: int,
                tile_w: int, tile_h: int, max_pairs: int) -> RankedSort:
    """Pair expansion, owner ranks (K5), the tile rect and block start
    gathered as int32 by rank, per-pair tiles, and the stable (tile, depth)
    sort: the index part of ``bin_gaussians`` and of the sorted staging
    above 2^24 slots (``staging._ranked_pairs``), which differ only in the
    payload they carry through the sort.  Invalid slots sort to the tail,
    so ``valid`` holds in slot and in sorted order alike."""
    dev = rect_min.device
    i32 = torch.int32
    grid_w = -(-image_width // tile_w)
    num_tiles = grid_w * -(-image_height // tile_h)
    e = expand_pairs(rect_min, rect_max, radii, image_width, image_height,
                     tile_w, tile_h, max_pairs)
    rank = merge_cuda.merge_ranks(e.cum_keep, max_pairs)  # [max_pairs] in [0, n]
    rank_c = torch.clamp(rank, max=rect_min.shape[0] - 1)
    keep = e.keep_idx
    # One gather per column: a row gather of the columns stacked as [n, 4]
    # runs torch's vectorized row-gather kernel, and made the staging route
    # above 2^24 slots 2.5x slower on an H100 (PERF.md).
    g_tmin_x, g_tmin_y, g_rw, g_block = (col[keep][rank_c] for col in
                                         (e.tmin_x, e.tmin_y, e.rw, e.block_start))
    valid = torch.arange(max_pairs, dtype=i32, device=dev) < e.num_pairs
    tiles = enumerate_tiles(g_block, g_rw, g_tmin_x, g_tmin_y, grid_w)
    del g_tmin_x, g_tmin_y, g_rw, g_block
    tile_ids = torch.where(valid, tiles, torch.full((), num_tiles, dtype=i32, device=dev))
    depth_keys = torch.where(valid, depths.detach().to(torch.float32)[keep][rank_c],
                             torch.full((), float("inf"), dtype=torch.float32, device=dev))
    del tiles, rank_c
    perm = sort_pairs(tile_ids, depth_keys)
    return RankedSort(expansion=e, sorted_rank=rank[perm], valid=valid,
                      sorted_tile=tile_ids[perm], sorted_depth=depth_keys[perm])


def sorted_gauss_ids(r: RankedSort, n: int, fill: int) -> torch.Tensor:
    """[max_pairs] int32 gaussian id of every sorted pair, ``fill`` on the
    slots past the last pair."""
    keep = r.expansion.keep_idx.to(torch.int32)
    return torch.where(r.valid, keep[torch.clamp(r.sorted_rank, max=n - 1)],
                       torch.full((), fill, dtype=torch.int32, device=keep.device))


def bin_gaussians(
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    radii: torch.Tensor,
    depths: torch.Tensor,
    image_width: int,
    image_height: int,
    tile_w: int,
    tile_h: int,
    max_pairs: int,
) -> TileBinning:
    """The split layout's binning: ``ranked_sort`` with the gaussian id as
    payload.  The depth rides as a float (the JAX package bit-casts it
    through its int table and back: the same values)."""
    num_tiles = -(-image_width // tile_w) * -(-image_height // tile_h)
    r = ranked_sort(rect_min, rect_max, radii, depths, image_width, image_height,
                    tile_w, tile_h, max_pairs)
    tile_start, tile_count = tile_ranges(r.sorted_tile, num_tiles)
    e = r.expansion
    return TileBinning(
        sorted_gauss_idx=sorted_gauss_ids(r, rect_min.shape[0], 0),
        sorted_tile_id=r.sorted_tile,
        tile_start=tile_start,
        tile_count=tile_count,
        num_pairs=e.num_pairs,
        overflow_gaussians=e.overflow_gaussians,
        overflow_pairs=e.overflow_pairs,
        pair_valid=r.sorted_tile < num_tiles,
    )
