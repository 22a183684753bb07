"""Sorted-order pair staging for the inference renderer (torch counterpart of
the JAX package's ``ops/staging.py``: ``StagingStatic``, ``SortedPairs``,
``_sorted_pairs`` and ``stage_pairs_sorted``).

Payload carriage, as the JAX package runs by default:

    1. The per-gaussian table (tile rect, block start, depth, gaussian id and
       the 11 kernel-layout record floats, as real f32 values) is gathered to
       the pair axis by the fused merge-gather kernel (``merge_cuda``).
    2. ONE stable sort on (tile, depth) orders the pairs; the record rows are
       carried through it by the sort's permutation.
    3. Per-tile ranges by searchsorted.  No chunk-aligned relayout: the
       compositing kernel reads unaligned tile starts.

The (tile, depth) sort is one ``torch.sort(stable=True)`` of the int64 key
``tile << 32 | f32_bits(depth)``.  It gives exactly the permutation of the
JAX package's two-key stable ``lax.sort``: visible depths are >= z_cull > 0,
the bits of a positive float32 sort in the order of its value, and invalid
slots carry (num_tiles, +inf).  Index machinery only: bit-exact against the
JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import binning as binning_mod
from . import merge_cuda
from .rasterize_cuda import REC_DIM

# packed [N, 11] reference layout -> kernel record layout (depth/op swapped).
_PERM = (0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 9)


class StagingStatic(NamedTuple):
    """Static staging configuration."""

    image_width: int
    image_height: int
    tile_w: int
    tile_h: int
    max_pairs: int
    chunk: int  # trailing zero columns of the record buffer


class SortedPairs(NamedTuple):
    records_cm: torch.Tensor  # [16, max_pairs + chunk] sorted-order records
    tile_start: torch.Tensor  # [num_tiles] int32 raw (unaligned) starts
    tile_count: torch.Tensor  # [num_tiles] int32
    num_pairs: torch.Tensor  # [] int32
    overflow_gaussians: torch.Tensor  # [] int32
    overflow_pairs: torch.Tensor  # [] int32


def merge_table(st: StagingStatic, packed, rect_min, rect_max, radii, depths):
    """Pair expansion and the per-gaussian merge table: (PairExpansion,
    table [24, N] f32 in compacted order) -- the inputs of merge-gather.

    Table rows: tile rect x/y min, rect width in tiles, block start, depth,
    gaussian id, the 11 kernel-layout record floats, 7 zero rows.  Small
    integers (<= 2^24) are exact f32 values; no bit casting."""
    dev = packed.device
    n = packed.shape[0]
    if n >= 2 ** 24:
        raise ValueError("gaussian ids ride as f32 values: num_rec < 2^24")
    e = binning_mod.expand_pairs(
        rect_min, rect_max, radii,
        st.image_width, st.image_height, st.tile_w, st.tile_h, st.max_pairs,
    )
    keep = e.keep_idx
    f32 = torch.float32
    rec_kernel = packed.detach()[:, list(_PERM)].to(f32)  # [N, 11]
    tbl = torch.cat(
        [
            torch.stack(
                [
                    e.tmin_x[keep].to(f32),
                    e.tmin_y[keep].to(f32),
                    e.rw[keep].to(f32),
                    e.block_start[keep].to(f32),
                    depths.detach().to(f32)[keep],
                    keep.to(f32),
                ],
                dim=0,
            ),
            rec_kernel[keep].T,
            torch.zeros((merge_cuda.TBL_ROWS - 17, n), dtype=f32, device=dev),
        ],
        dim=0,
    ).contiguous()
    return e, tbl


def _sorted_pairs(st: StagingStatic, packed, rect_min, rect_max, radii, depths):
    """Merge-gather + (tile, depth) sort.  Returns (the 11 kernel-layout
    record rows in sorted order [11, max_pairs], tile_start, tile_count,
    expansion)."""
    dev = packed.device
    f32 = torch.float32
    grid_w = -(-st.image_width // st.tile_w)
    num_tiles = grid_w * -(-st.image_height // st.tile_h)
    e, tbl = merge_table(st, packed, rect_min, rect_max, radii, depths)
    g = merge_cuda.merge_gather(e.cum_keep, tbl, st.max_pairs)  # [24, max_pairs]

    i32 = torch.int32
    p = torch.arange(st.max_pairs, dtype=i32, device=dev)
    valid = p < e.num_pairs
    tiles = binning_mod.enumerate_tiles(
        g[3].to(i32), torch.clamp(g[2].to(i32), min=1), g[0].to(i32),
        g[1].to(i32), grid_w,
    )
    tile_ids = torch.where(valid, tiles, torch.full((), num_tiles, dtype=i32, device=dev))
    depth_keys = torch.where(valid, g[4], torch.full((), float("inf"), dtype=f32, device=dev))

    # --- 2. ONE stable sort on (tile, depth) --------------------------------
    key = (tile_ids.to(torch.int64) << 32) | depth_keys.view(i32).to(torch.int64)
    perm = torch.sort(key, stable=True).indices
    sorted_tile = tile_ids[perm]
    sorted_depth = depth_keys[perm]
    rec_rows = g[6:17][:, perm]  # [11, max_pairs] kernel-layout records
    # Record row 9 (depth) equals the depth key on valid lanes; invalid lanes
    # (key +inf, stably at the tail) get exact zeros.
    rec_rows[9] = torch.where(valid, sorted_depth, torch.zeros((), dtype=f32, device=dev))

    # --- 3. tile ranges -----------------------------------------------------
    tile_iota = torch.arange(num_tiles, dtype=i32, device=dev)
    tile_start = torch.searchsorted(sorted_tile, tile_iota, side="left").to(i32)
    tile_end = torch.searchsorted(sorted_tile, tile_iota, side="right").to(i32)
    return rec_rows, tile_start, tile_end - tile_start, e


def stage_pairs_sorted(st: StagingStatic, packed, rect_min, rect_max, radii,
                       depths) -> SortedPairs:
    """Inference staging: records in sorted pair order, no aligned relayout.

    ``packed`` [N, 11] in the reference layout; the returned buffer is
    [16, max_pairs + chunk] in kernel layout (rows 11-15 and the trailing
    ``chunk`` columns zero), the JAX package's exact layout.  Forward only.
    """
    rec_rows, tile_start, tile_count, e = _sorted_pairs(
        st, packed, rect_min, rect_max, radii, depths
    )
    records_cm = torch.zeros(
        (REC_DIM, st.max_pairs + st.chunk), dtype=torch.float32, device=packed.device
    )
    records_cm[:11, :st.max_pairs] = rec_rows
    return SortedPairs(
        records_cm=records_cm,
        tile_start=tile_start,
        tile_count=tile_count,
        num_pairs=e.num_pairs,
        overflow_gaussians=e.overflow_gaussians,
        overflow_pairs=e.overflow_pairs,
    )
