"""Pair staging (torch counterpart of the JAX package's ``ops/staging.py``:
``StagingStatic``, ``SortedPairs``, ``_sorted_pairs``, ``stage_pairs_sorted``
for inference, ``stage_pairs_train`` for training in sorted order, and
``StagedPairs`` / ``stage_pairs`` for training in the chunk-aligned
layout).

Payload carriage, as the JAX package runs by default:

    1. The per-gaussian table (tile rect, block start, depth, gaussian id and
       the 11 kernel-layout record floats, as real f32 values) is gathered to
       the pair axis by the fused merge-gather kernel (``merge_cuda``).
       Budgets above ``K2_MAX_SLOTS`` (where f32 slot values stop being
       exact) take the ranks alone (K5) instead: the tile rect, block start
       and gaussian id are gathered as int32, the depth as f32, and the 11
       record rows once, by the ranks in sorted order.
    2. ONE stable sort on (tile, depth) orders the pairs; the record rows are
       carried through it by the sort's permutation.
    3. Per-tile ranges by searchsorted.  The sorted layouts stop here: the
       compositing kernels read unaligned tile starts.  The aligned layout
       copies each tile's records to whole chunks of its own (the relayout,
       kernel K6, ``relayout_cuda``).

Training staging is a ``torch.autograd.Function`` around the same index
machinery: the forward also keeps the gaussian id of every record column,
and the backward is the per-Gaussian reduction of the record cotangent
(``rasterize_cuda.reduce_record_cotangent``: kernel K4, or the scatter-add
with ``grad_reduce="scatter"``); the sort is never differentiated.

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

from ..utils.profiler import span
from . import binning as binning_mod
from . import merge_cuda, rasterize_cuda, relayout_cuda
from .rasterize_cuda import REC_DIM

# Largest budget the fused merge-gather (K2) takes: it carries slot indices as
# f32 values, exact up to 2^24.  Larger budgets merge through K5's int32 ranks.
K2_MAX_SLOTS = merge_cuda.F32_EXACT


class StagingStatic(NamedTuple):
    """Static staging configuration."""

    image_width: int
    image_height: int
    tile_w: int
    tile_h: int
    max_pairs: int
    chunk: int  # aligned layout's ownership quantum; sorted buffers' zero tail
    # The training stagings' backward: "segsum" (gid sort + K4) or "scatter".
    grad_reduce: str = "segsum"


class SortedPairs(NamedTuple):
    # [16, max_pairs + pad] sorted-order records: pad is ``chunk`` for
    # inference staging and ``_train_pad`` for training staging.
    records_cm: torch.Tensor
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
    rec_kernel = packed.detach()[:, list(rasterize_cuda.PERM)].to(f32)  # [N, 11]
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
    record rows in sorted order [11, max_pairs], the sorted gaussian id
    [max_pairs] int32 with ``num_rec`` on slots past the last pair,
    tile_start, tile_count, expansion).  Budgets above ``K2_MAX_SLOTS``
    take ``_ranked_pairs``: the same outputs bit for bit."""
    if st.max_pairs > K2_MAX_SLOTS:
        return _ranked_pairs(st, packed, rect_min, rect_max, radii, depths)
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
    perm = binning_mod.sort_pairs(tile_ids, depth_keys)
    sorted_tile = tile_ids[perm]
    sorted_depth = depth_keys[perm]
    rec_rows = g[6:17][:, perm]  # [11, max_pairs] kernel-layout records
    # Record row 9 (depth) equals the depth key on valid lanes; invalid lanes
    # (key +inf, stably at the tail) get exact zeros.
    rec_rows[9] = torch.where(valid, sorted_depth, torch.zeros((), dtype=f32, device=dev))
    gid = torch.where(valid, g[5][perm].to(i32),
                      torch.full((), packed.shape[0], dtype=i32, device=dev))

    # --- 3. tile ranges -----------------------------------------------------
    tile_start, tile_count = binning_mod.tile_ranges(sorted_tile, num_tiles)
    return rec_rows, gid, tile_start, tile_count, e


def _ranked_pairs(st: StagingStatic, packed, rect_min, rect_max, radii, depths):
    """``_sorted_pairs`` for budgets above ``K2_MAX_SLOTS``: the split
    layout's index part (``binning.ranked_sort``: K5 ranks, the tile rect
    and block start gathered as int32, the sort), then ONE gather of the 11
    record rows by the ranks in sorted order.  Bit-equal to the K2 route: a
    slot of rank n (past the last pair) selects a zero column of records, as
    K2 does.  The JAX package's fallback instead clamps the rank to n - 1
    and gathers the block start through f32, so it agrees with this route
    only on valid slots and only while the pair count is at most 2^24."""
    n = packed.shape[0]
    if n >= 2 ** 24:
        raise ValueError("the aligned layout carries gaussian ids as f32 values: "
                         "num_rec < 2^24")
    f32 = torch.float32
    dev = packed.device
    r = binning_mod.ranked_sort(rect_min, rect_max, radii, depths, st.image_width,
                                st.image_height, st.tile_w, st.tile_h, st.max_pairs)
    # [11, n + 1]: the kernel-layout records in compacted order, then the
    # zero column that slots of rank n select.
    rec_tbl = torch.cat(
        [packed.detach()[:, list(rasterize_cuda.PERM)].to(f32)[r.expansion.keep_idx].T,
         torch.zeros((11, 1), dtype=f32, device=dev)], dim=1)
    rec_rows = rec_tbl[:, r.sorted_rank]  # [11, max_pairs]
    rec_rows[9] = torch.where(r.valid, r.sorted_depth, torch.zeros((), dtype=f32, device=dev))
    num_tiles = -(-st.image_width // st.tile_w) * -(-st.image_height // st.tile_h)
    tile_start, tile_count = binning_mod.tile_ranges(r.sorted_tile, num_tiles)
    return (rec_rows, binning_mod.sorted_gauss_ids(r, n, n), tile_start, tile_count,
            r.expansion)


def stage_pairs_sorted(st: StagingStatic, packed, rect_min, rect_max, radii,
                       depths) -> SortedPairs:
    """Inference staging: records in sorted pair order, no aligned relayout.

    ``packed`` [N, 11] in the reference layout; the returned buffer is
    [16, max_pairs + chunk] in kernel layout (rows 11-15 and the trailing
    ``chunk`` columns zero), the JAX package's exact layout.  Forward only.
    """
    rec_rows, _, tile_start, tile_count, e = _sorted_pairs(
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


def _train_pad(st: StagingStatic) -> int:
    """Zero columns after ``max_pairs`` in the training buffer: at least
    ``chunk``, with the total rounded up to a multiple of 512 (the JAX
    package's layout, kept so that the two buffers compare column for
    column)."""
    base = st.max_pairs + st.chunk
    return -(-base // 512) * 512 - st.max_pairs


def _stage_train_impl(st: StagingStatic, packed, rect_min, rect_max, radii,
                      depths):
    """Sorted training staging without autograd: (SortedPairs with the
    [16, max_pairs + _train_pad] buffer, gid_full [max_pairs + _train_pad]
    int32 with ``num_rec`` on columns of no gaussian)."""
    rec_rows, gid, tile_start, tile_count, e = _sorted_pairs(
        st, packed, rect_min, rect_max, radii, depths
    )
    dev = packed.device
    pad = _train_pad(st)
    records_cm = torch.zeros((REC_DIM, st.max_pairs + pad), dtype=torch.float32, device=dev)
    records_cm[:11, :st.max_pairs] = rec_rows
    gid_full = torch.cat(
        [gid, torch.full((pad,), packed.shape[0], dtype=torch.int32, device=dev)])
    staged = SortedPairs(
        records_cm=records_cm,
        tile_start=tile_start,
        tile_count=tile_count,
        num_pairs=e.num_pairs,
        overflow_gaussians=e.overflow_gaussians,
        overflow_pairs=e.overflow_pairs,
    )
    return staged, gid_full


class StagedPairs(NamedTuple):
    records_cm: torch.Tensor  # [16, _num_aligned(st)] chunk-aligned records
    aligned_start: torch.Tensor  # [num_tiles] int32 chunk-aligned column starts
    tile_count: torch.Tensor  # [num_tiles] int32 real pairs per tile
    num_pairs: torch.Tensor  # [] int32
    overflow_gaussians: torch.Tensor  # [] int32
    overflow_pairs: torch.Tensor  # [] int32


def _num_aligned(st: StagingStatic) -> int:
    """Columns of the chunk-aligned buffer: each tile pads its pairs to whole
    chunks, at most ``chunk`` columns more than it has."""
    num_tiles = -(-st.image_width // st.tile_w) * -(-st.image_height // st.tile_h)
    return st.max_pairs + num_tiles * st.chunk


def _stage_impl(st: StagingStatic, packed, rect_min, rect_max, radii, depths):
    """Aligned training staging without autograd: the sorted records, the
    chunk plan, the relayout (K6) of the 11 record rows and the gaussian id
    (row 11, an exact float value) into the [16, _num_aligned] buffer.
    Returns (StagedPairs, gid_aligned [_num_aligned] int32 with ``num_rec``
    on columns of no gaussian)."""
    rec_rows, gid, tile_start, tile_count, e = _sorted_pairs(
        st, packed, rect_min, rect_max, radii, depths
    )
    num_aligned = _num_aligned(st)
    C = st.chunk
    aligned_start, owner, rank0 = rasterize_cuda.aligned_chunk_plan(tile_count, C, num_aligned)
    sorted_cm = torch.cat([rec_rows, gid.to(torch.float32)[None]], dim=0).contiguous()
    records_cm = relayout_cuda.relayout(sorted_cm, tile_start, tile_count, owner, rank0, C,
                                        num_aligned)
    _, within = rasterize_cuda.aligned_slots(tile_start, tile_count, owner, rank0, C)
    gid_aligned = torch.where(within, records_cm[11].to(torch.int32),
                              torch.full((), packed.shape[0], dtype=torch.int32,
                                         device=packed.device))
    staged = StagedPairs(
        records_cm=records_cm,
        aligned_start=aligned_start,
        tile_count=tile_count,
        num_pairs=e.num_pairs,
        overflow_gaussians=e.overflow_gaussians,
        overflow_pairs=e.overflow_pairs,
    )
    return staged, gid_aligned


class _Stage(torch.autograd.Function):
    """Training staging, sorted (``_stage_train_impl``) or aligned
    (``_stage_impl``).  Forward: the staging; backward:
    ``rasterize_cuda.reduce_record_cotangent`` (``st.grad_reduce``) over the
    per-column gaussian ids.  Only ``packed`` is differentiable: rects,
    radii and depths are staging machinery."""

    @staticmethod
    def forward(ctx, impl, st, packed, rect_min, rect_max, radii, depths):
        staged, gid = impl(st, packed.detach(), rect_min, rect_max, radii, depths)
        ctx.save_for_backward(gid)
        ctx.num_rec, ctx.grad_reduce = packed.shape[0], st.grad_reduce
        ctx.mark_non_differentiable(*staged[1:])
        return tuple(staged)

    @staticmethod
    def backward(ctx, g_records, *_):
        with span("stage.bwd"):
            (gid,) = ctx.saved_tensors
            d_packed = rasterize_cuda.reduce_record_cotangent(g_records.contiguous(), gid,
                                                              ctx.num_rec, ctx.grad_reduce)
        return None, None, d_packed, None, None, None, None


def stage_pairs_train(st: StagingStatic, packed, rect_min, rect_max, radii,
                      depths) -> SortedPairs:
    """Training staging: records in sorted pair order, no aligned relayout,
    differentiable with respect to ``packed`` [N, 11] (reference layout).
    The buffer is [16, max_pairs + _train_pad(st)] in kernel layout, the JAX
    package's ``stage_pairs_train`` layout."""
    return SortedPairs(*_Stage.apply(_stage_train_impl, st, packed, rect_min, rect_max,
                                     radii, depths))


def stage_pairs(st: StagingStatic, packed, rect_min, rect_max, radii,
                depths) -> StagedPairs:
    """Aligned training staging (the JAX package's ``stage_pairs``):
    chunk-aligned records [16, _num_aligned(st)], differentiable with
    respect to ``packed`` [N, 11] (reference layout)."""
    return StagedPairs(*_Stage.apply(_stage_impl, st, packed, rect_min, rect_max,
                                     radii, depths))
