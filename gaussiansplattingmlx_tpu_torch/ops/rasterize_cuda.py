"""Tile rasterizer over a staged record buffer: forward compositing (kernel
K1), backward compositing over sorted records (K3) and over chunk-aligned
records (K7), a ``torch.autograd.Function`` over them, the chunk-aligned
layout's index math, and the split layout's rasterizer.

Counterpart of the JAX package's ``ops/rasterize_pallas.py``
(``rasterize_staged``, ``_raster_core``, Pallas ``_fwd_kernel``,
``_bwd_kernel_sorted`` and ``_bwd_kernel``, ``aligned_chunk_plan``,
``aligned_relayout``, ``_gather_records``, ``rasterize_pallas``,
``_untile``).

Record buffer ``records_cm`` [16, P] f32, component-major, rows:
0 mean_x, 1 mean_y, 2 c00, 3 c01, 4 c10, 5 c11, 6-8 rgb, 9 depth,
10 opacity, 11-15 not read.  Tile t composites the columns
[tile_start[t], tile_start[t] + tile_count[t]) in order.  In the sorted
layout starts need not be aligned; in the chunk-aligned layout tile t owns
the whole chunks [aligned_start[t], aligned_start[t] + ceil(count / C) * C),
zeros after its records.  The per-tile output [num_tiles, 6, tile_h *
tile_w] holds rgb, depth, alpha (= 1 - T) and n_contrib; the background is
applied outside.  The backward writes one gradient row per record column,
[16, P] (rows 3 and 4 both hold d_cs; rows 11-15 and columns no tile
replays are zero).

``raster_fwd``, ``raster_bwd`` and ``raster_bwd_aligned`` dispatch on the
device of their inputs: CPU tensors take the ``*_plain`` versions; CUDA
tensors launch ``csrc/rasterize_fwd.cu`` / ``csrc/rasterize_bwd.cu`` /
``csrc/rasterize_bwd_aligned.cu`` or raise.  K1 splits a tile into blocks
of 128 consecutive pixels, one a thread, each walking the tile's whole
record list until its own pixels stop; K3 and K7 replay a tile in one block
with 1, 2 or 4 pixels a thread (``csrc/rasterize_bwd_tile.cuh``).  K1's
per-pixel arithmetic is the replay's, so the alpha K1 stores is the one K3
and K7 rebuild transmittance from.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiler import span
from . import _kernels, segsum_cuda
from .rasterize_ref import RenderOutputs

REC_DIM = 16
OUT_CHANNELS = 6
COT_COLS = 8  # cotR, cotG, cotB, cotDepth, cotAlpha, alpha_fwd, ncon_fwd, 0
_REC_ROWS = 11  # rows the compositing reads
# Pixels of a tile: K3 and K7 run a block a tile with at most 4 pixels a
# thread in 256 threads; K1 runs blocks of 128 pixels, one a thread.
_MAX_BLOCK = 1024
# The scatter reduction's most columns of no gaussian per scratch row.
_SCATTER_SPAN = 1024

KERNEL = _kernels.Kernel(
    "gsplat_raster_fwd",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
     ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p],
)
BWD_KERNEL = _kernels.Kernel(
    "gsplat_raster_bwd",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
     ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
     ctypes.c_void_p],
)
BWD_ALIGNED_KERNEL = _kernels.Kernel(
    "gsplat_raster_bwd_aligned",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
     ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_void_p],
)
# packed [N, 11] reference layout -> kernel record layout (depth/op swapped);
# an involution, so it also maps kernel-layout gradients back.
PERM = (0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 9)


def _check(records_cm, tile_start, tile_count, grid_w, grid_h, tile_w, tile_h):
    check = _kernels.check
    check(records_cm.dim() == 2 and records_cm.shape[0] >= _REC_ROWS
          and records_cm.dtype == torch.float32,
          f"records must be f32 [>= {_REC_ROWS}, P], got "
          f"{records_cm.dtype} {tuple(records_cm.shape)}")
    num_tiles = grid_w * grid_h
    for name, x in (("tile_start", tile_start), ("tile_count", tile_count)):
        check(x.dtype == torch.int32 and tuple(x.shape) == (num_tiles,),
              f"{name} must be int32 [{num_tiles}], got {x.dtype} {tuple(x.shape)}")
        check(x.device == records_cm.device, f"{name} on another device")
        check(x.is_contiguous(), f"{name} must be contiguous")
    check(records_cm.is_contiguous(), "records must be contiguous")
    check(0 < tile_w * tile_h <= _MAX_BLOCK,
          f"tile {tile_w}x{tile_h} exceeds {_MAX_BLOCK} pixels")


def _composite(r, valid, ts, grid_w, tile_w, tile_h, alpha_clamp, transmittance_eps,
               ncon=None):
    """Forward compositing of a batch of tiles ``ts`` [B] from their record
    windows ``r`` [11, B, L] (``valid`` [B, L] marks real records), by the
    per-pixel vector identity

        Tu_i = exclusive_cumprod(1 - a)_i ;  m_i = Tu_i >= eps
        out = sum_i Tu_i a_i m_i attr_i ;  T = prod_i (1 - a_i m_i)

    or, given the forward's n_contrib ``ncon`` [B, TT], with the include mask
    m_i = i < ncon.  Returns [B, 6, TT]; differentiable with respect to
    ``r``."""
    f32 = torch.float32
    pix = torch.arange(tile_w * tile_h, device=r.device)
    lx, ly = pix % tile_w, pix // tile_w
    px = ((ts % grid_w) * tile_w)[:, None] + lx[None, :]  # [B, TT]
    py = ((ts // grid_w) * tile_h)[:, None] + ly[None, :]
    dx = px.to(f32)[:, :, None] - r[0][:, None, :]  # [B, TT, L]
    dy = py.to(f32)[:, :, None] - r[1][:, None, :]
    e = -0.5 * (dx * dx * r[2][:, None, :] + dy * dy * r[5][:, None, :]
                + dx * dy * (r[3] + r[4])[:, None, :])
    a = torch.clamp(torch.exp(e) * r[10][:, None, :], max=alpha_clamp)
    a = torch.where(valid[:, None, :], a, 0.0)
    om = 1.0 - a
    tu = torch.cat(
        [torch.ones_like(om[..., :1]), torch.cumprod(om, dim=-1)[..., :-1]],
        dim=-1,
    )
    if ncon is None:
        m = tu >= transmittance_eps
    else:
        rank = torch.arange(r.shape[2], device=r.device)
        m = rank[None, None, :] < ncon[:, :, None]
    m = torch.logical_and(m, valid[:, None, :])
    w = torch.where(m, tu * a, 0.0)
    chans = [torch.sum(w * r[row][:, None, :], dim=-1) for row in (6, 7, 8, 9)]
    chans.append(1.0 - torch.prod(torch.where(m, om, 1.0), dim=-1))
    chans.append(torch.sum(m, dim=-1).to(f32))
    return torch.stack(chans, dim=1)


def _tile_batches(records_cm, tile_start, tile_count, tt, max_elems):
    """Yield (tile ids [B], record columns [B, L], valid [B, L]) over the
    tiles that hold records (an empty tile's outputs and gradients are
    zeros), each tile's window padded to the longest tile, at most
    ``max_elems`` (pixel, record) entries a batch."""
    dev = records_cm.device
    tiles = torch.nonzero(tile_count > 0).reshape(-1)
    if tiles.numel() == 0:
        return
    longest = int(tile_count.max())
    j = torch.arange(longest, device=dev)
    batch = max(1, max_elems // (tt * longest))
    for t0 in range(0, tiles.numel(), batch):
        ts = tiles[t0:t0 + batch]
        start = tile_start[ts].long()
        valid = j[None, :] < tile_count[ts].long()[:, None]  # [B, L]
        idx = torch.where(valid, start[:, None] + j[None, :], 0)
        yield ts, idx, valid


def raster_fwd_plain(records_cm, tile_start, tile_count, grid_w, grid_h,
                     tile_w, tile_h, *, alpha_clamp=0.99, transmittance_eps=1e-4,
                     max_elems=2 ** 24):
    """Plain torch version of K1 (``_composite`` over batches of tiles)."""
    _check(records_cm, tile_start, tile_count, grid_w, grid_h, tile_w, tile_h)
    tt = tile_w * tile_h
    out = torch.zeros((grid_w * grid_h, OUT_CHANNELS, tt), dtype=torch.float32,
                      device=records_cm.device)
    rec = records_cm[:_REC_ROWS].detach()
    for ts, idx, valid in _tile_batches(records_cm, tile_start, tile_count, tt, max_elems):
        out[ts] = _composite(rec[:, idx], valid, ts, grid_w, tile_w, tile_h,
                             alpha_clamp, transmittance_eps)
    return out


def raster_bwd_plain(records_cm, tile_start, tile_count, cot_block, grid_w, grid_h,
                     tile_w, tile_h, *, alpha_clamp=0.99, transmittance_eps=1e-4,
                     undo_denom_floor=1e-6, max_elems=2 ** 22):
    """Plain torch version of K3: ``torch.autograd.grad`` of the plain
    forward with respect to the records, a batch of tiles at a time (each
    column belongs to one tile, so the batches do not overlap).  The
    cotangent block ``cot_block`` [T, TT, 8] carries the output cotangents in
    columns 0-4 and the forward's n_contrib in column 6; as in K3 and the
    JAX kernel, the recomputed forward takes the records of rank < n_contrib
    (a recomputed transmittance test could round the other way at the
    1e-4 threshold).  ``undo_denom_floor`` is not read (1 - a >=
    1 - alpha_clamp is far above it).  As in K3 and the JAX kernel, records
    with opacity <= 1e-37 get a zero opacity gradient."""
    del undo_denom_floor
    _check(records_cm, tile_start, tile_count, grid_w, grid_h, tile_w, tile_h)
    tt = tile_w * tile_h
    grad = torch.zeros_like(records_cm, dtype=torch.float32)
    rec = records_cm[:_REC_ROWS].detach()
    for ts, idx, valid in _tile_batches(records_cm, tile_start, tile_count, tt, max_elems):
        r = rec[:, idx].requires_grad_()
        with torch.enable_grad():
            block = cot_block[ts]
            out = _composite(r, valid, ts, grid_w, tile_w, tile_h, alpha_clamp,
                             transmittance_eps, ncon=block[:, :, 6])
            cot = block[:, :, 0:5].transpose(1, 2)
            (g,) = torch.autograd.grad(out[:, 0:5], r, grad_outputs=cot)
        grad[:_REC_ROWS, idx[valid]] = g[:, valid]
    grad[10] = torch.where(rec[10] > 1e-37, grad[10], 0.0)
    return grad


def raster_fwd(records_cm, tile_start, tile_count, grid_w, grid_h, tile_w,
               tile_h, *, alpha_clamp=0.99, transmittance_eps=1e-4):
    """Per-tile forward compositing -> [num_tiles, 6, tile_h * tile_w]."""
    if records_cm.device.type == "cpu":
        return raster_fwd_plain(
            records_cm, tile_start, tile_count, grid_w, grid_h, tile_w, tile_h,
            alpha_clamp=alpha_clamp, transmittance_eps=transmittance_eps,
        )
    if records_cm.device.type != "cuda":
        raise ValueError(f"raster_fwd: unsupported device {records_cm.device}")
    _check(records_cm, tile_start, tile_count, grid_w, grid_h, tile_w, tile_h)
    num_tiles = grid_w * grid_h
    out = torch.empty((num_tiles, OUT_CHANNELS, tile_w * tile_h),
                      dtype=torch.float32, device=records_cm.device)
    with torch.cuda.device(records_cm.device):
        KERNEL.launch(
            records_cm.data_ptr(), records_cm.shape[1], tile_start.data_ptr(),
            tile_count.data_ptr(), num_tiles, grid_w, tile_w, tile_h,
            alpha_clamp, transmittance_eps, out.data_ptr(),
            _kernels.stream_of(records_cm),
        )
    return out


def _check_bwd(records_cm, cot_block, num_tiles, tile_w, tile_h):
    tt = tile_w * tile_h
    _kernels.check(tt % 32 == 0, f"tile {tile_w}x{tile_h}: the backward needs whole warps")
    _kernels.check(cot_block.dtype == torch.float32 and cot_block.is_contiguous()
                   and tuple(cot_block.shape) == (num_tiles, tt, COT_COLS)
                   and cot_block.device == records_cm.device,
                   f"cotangent block must be contiguous f32 [{num_tiles}, {tt}, "
                   f"{COT_COLS}] on {records_cm.device}")
    # The kernels read each pixel's 8 columns as two float4 loads.
    _kernels.check(cot_block.data_ptr() % 16 == 0, "cotangent block must be 16-byte aligned")


def raster_bwd(records_cm, tile_start, tile_count, cot_block, grid_w, grid_h,
               tile_w, tile_h, *, alpha_clamp=0.99, transmittance_eps=1e-4,
               undo_denom_floor=1e-6):
    """Per-column gradient rows [16, P] (zero where no tile replays the
    column) from the cotangent block [num_tiles, TT, 8]."""
    if records_cm.device.type == "cpu":
        return raster_bwd_plain(
            records_cm, tile_start, tile_count, cot_block, grid_w, grid_h,
            tile_w, tile_h, alpha_clamp=alpha_clamp,
            transmittance_eps=transmittance_eps, undo_denom_floor=undo_denom_floor,
        )
    if records_cm.device.type != "cuda":
        raise ValueError(f"raster_bwd: unsupported device {records_cm.device}")
    _check(records_cm, tile_start, tile_count, grid_w, grid_h, tile_w, tile_h)
    num_tiles = grid_w * grid_h
    _check_bwd(records_cm, cot_block, num_tiles, tile_w, tile_h)
    grad = torch.zeros((REC_DIM, records_cm.shape[1]), dtype=torch.float32,
                       device=records_cm.device)
    with torch.cuda.device(records_cm.device):
        BWD_KERNEL.launch(
            records_cm.data_ptr(), records_cm.shape[1], tile_start.data_ptr(),
            tile_count.data_ptr(), cot_block.data_ptr(), num_tiles, grid_w,
            tile_w, tile_h, alpha_clamp, undo_denom_floor, grad.data_ptr(),
            _kernels.stream_of(records_cm),
        )
    return grad


def raster_bwd_aligned(records_cm, aligned_start, tile_count, cot_block, grid_w, grid_h,
                       tile_w, tile_h, chunk, *, alpha_clamp=0.99, transmittance_eps=1e-4,
                       undo_denom_floor=1e-6):
    """Backward over a chunk-aligned record buffer (``aligned_start`` the
    exclusive cumsum of ceil(tile_count / chunk) * chunk): per-column
    gradient rows [16, P] with every column written, so the output needs no
    clearing.  Its plain version is ``raster_bwd_plain`` over the aligned
    ranges: the replayed columns' rows and zeros in every other column (the
    dead tail and pad lanes each tile owns, and the columns no tile owns),
    so ``chunk`` changes nothing there."""
    if records_cm.device.type == "cpu":
        return raster_bwd_plain(
            records_cm, aligned_start, tile_count, cot_block, grid_w, grid_h,
            tile_w, tile_h, alpha_clamp=alpha_clamp,
            transmittance_eps=transmittance_eps, undo_denom_floor=undo_denom_floor,
        )
    if records_cm.device.type != "cuda":
        raise ValueError(f"raster_bwd_aligned: unsupported device {records_cm.device}")
    _check(records_cm, aligned_start, tile_count, grid_w, grid_h, tile_w, tile_h)
    num_tiles = grid_w * grid_h
    _check_bwd(records_cm, cot_block, num_tiles, tile_w, tile_h)
    _kernels.check(chunk > 0, f"chunk must be positive, got {chunk}")
    grad = torch.empty((REC_DIM, records_cm.shape[1]), dtype=torch.float32,
                       device=records_cm.device)
    with torch.cuda.device(records_cm.device):
        BWD_ALIGNED_KERNEL.launch(
            records_cm.data_ptr(), records_cm.shape[1], aligned_start.data_ptr(),
            tile_count.data_ptr(), cot_block.data_ptr(), num_tiles, grid_w,
            tile_w, tile_h, chunk, alpha_clamp, undo_denom_floor, grad.data_ptr(),
            _kernels.stream_of(records_cm),
        )
    return grad


def cotangent_block(cot_out, alpha_ncon):
    """[T, 6, TT] output cotangent + the forward's [T, 2, TT] alpha and
    n_contrib -> the [T, TT, 8] block K3 reads."""
    pad = torch.zeros_like(alpha_ncon[:, :1])
    return torch.cat([cot_out[:, 0:5], alpha_ncon, pad], dim=1).transpose(1, 2).contiguous()


class _RasterCore(torch.autograd.Function):
    """K1 forward; backward from the saved records, tile ranges and the
    forward's alpha and n_contrib: K3 over sorted-order records
    (``sorted_mode``), K7 over chunk-aligned ones.  The caller names the
    layout.  Only the records are differentiable."""

    @staticmethod
    def forward(ctx, records_cm, tile_start, tile_count, geom, consts, sorted_mode, chunk):
        out = raster_fwd(records_cm, tile_start, tile_count, *geom,
                         alpha_clamp=consts[0], transmittance_eps=consts[1])
        ctx.save_for_backward(records_cm, tile_start, tile_count,
                              out[:, 4:6].contiguous())
        ctx.geom, ctx.consts = geom, consts
        ctx.sorted_mode, ctx.chunk = sorted_mode, chunk
        return out

    @staticmethod
    def backward(ctx, cot_out):
        with span("composite.bwd"):
            records_cm, tile_start, tile_count, alpha_ncon = ctx.saved_tensors
            alpha_clamp, eps, floor = ctx.consts
            block = cotangent_block(cot_out, alpha_ncon)
            consts = dict(alpha_clamp=alpha_clamp, transmittance_eps=eps,
                          undo_denom_floor=floor)
            if ctx.sorted_mode:
                grad = raster_bwd(records_cm, tile_start, tile_count, block, *ctx.geom,
                                  **consts)
            else:
                grad = raster_bwd_aligned(records_cm, tile_start, tile_count, block,
                                          *ctx.geom, ctx.chunk, **consts)
        return grad, None, None, None, None, None, None


def _untile(out, grid_w, grid_h, tile_w, tile_h, image_width, image_height):
    """[num_tiles, 6, TT] -> RenderOutputs cropped to the image."""
    x = out.reshape(grid_h, grid_w, OUT_CHANNELS, tile_h, tile_w)
    x = x.permute(2, 0, 3, 1, 4).reshape(
        OUT_CHANNELS, grid_h * tile_h, grid_w * tile_w
    )
    x = x[:, :image_height, :image_width]
    return RenderOutputs(
        color=x[0:3].permute(1, 2, 0),
        depth=x[3],
        alpha=x[4],
        n_contrib=x[5].to(torch.int32),
    )


def rasterize_staged(records_cm, tile_start, tile_count, image_width,
                     image_height, tile_w, tile_h, *, chunk_size=128, alpha_clamp=0.99,
                     transmittance_eps=1e-4, undo_denom_floor=1e-6,
                     sorted_mode=True) -> RenderOutputs:
    """Rasterize a staged record buffer; differentiable with respect to
    ``records_cm`` when it requires grad (K1 forward; K3 backward over
    sorted-order records with raw ``tile_start``s, ``sorted_mode=True``, or
    K7 over chunk-aligned records with the aligned starts,
    ``sorted_mode=False``)."""
    grid_w = -(-image_width // tile_w)
    grid_h = -(-image_height // tile_h)
    geom = (grid_w, grid_h, tile_w, tile_h)
    if records_cm.requires_grad and torch.is_grad_enabled():
        out = _RasterCore.apply(records_cm, tile_start, tile_count, geom,
                                (alpha_clamp, transmittance_eps, undo_denom_floor),
                                sorted_mode, chunk_size)
    else:
        out = raster_fwd(records_cm, tile_start, tile_count, *geom,
                         alpha_clamp=alpha_clamp, transmittance_eps=transmittance_eps)
    return _untile(out, grid_w, grid_h, tile_w, tile_h, image_width, image_height)


# --- the chunk-aligned layout ---------------------------------------------------


def aligned_chunk_plan(tile_count, chunk: int, num_aligned: int):
    """Per-chunk plan of the chunk-aligned layout, shared by the split
    rasterizer, the aligned staging and K6 so that they cannot diverge.

    Tile t owns the ceil(count / chunk) chunks from ``aligned_start[t]`` (the
    exclusive cumsum of the owned sizes).  Returns (aligned_start
    [num_tiles], owner [num_aligned / chunk], rank0 [num_aligned / chunk]),
    int32: chunk c holds its owner's sorted pairs from within-tile rank
    rank0[c] (ranks past tile_count are padding; chunks past the last
    tile's are owned by the last tile, past its count)."""
    dev = tile_count.device
    sizes = (tile_count.to(torch.int64) + chunk - 1) // chunk * chunk
    aligned_start = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
    first_slot = torch.arange(num_aligned // chunk, dtype=torch.int32, device=dev) * chunk
    owner = torch.searchsorted(aligned_start, first_slot, right=True).to(torch.int32) - 1
    owner = torch.clamp(owner, 0, tile_count.shape[0] - 1)
    rank0 = first_slot - aligned_start[owner.long()]
    return aligned_start, owner, rank0


def aligned_slots(tile_start, tile_count, owner, rank0, chunk: int):
    """Per-slot view of the plan: (src [num_aligned] int64, within
    [num_aligned] bool), slot c * chunk + j taking sorted position
    tile_start[o] + rank0[c] + j of its owner o while that rank is below
    tile_count[o]."""
    o = owner.long()
    rank = rank0.long()[:, None] + torch.arange(chunk, device=tile_count.device)
    within = (rank < tile_count[o].long()[:, None]).reshape(-1)
    src = torch.where(within, (tile_start[o].long()[:, None] + rank).reshape(-1), 0)
    return src, within


def aligned_relayout(tile_start, tile_count, chunk: int, num_aligned: int):
    """(aligned_start [num_tiles], src, within) of ``aligned_chunk_plan`` and
    ``aligned_slots``: tile t's pairs sit at aligned columns
    [aligned_start[t], aligned_start[t] + tile_count[t])."""
    aligned_start, owner, rank0 = aligned_chunk_plan(tile_count, chunk, num_aligned)
    return (aligned_start, *aligned_slots(tile_start, tile_count, owner, rank0, chunk))


def scatter_reduce(g_cm: torch.Tensor, gid: torch.Tensor, num_rec: int) -> torch.Tensor:
    """[16, P] per-column gradient rows + [P] int32 gaussian ids ->
    [num_rec, 16] per-Gaussian sums: each column added into row ``gid[j]``
    where ``gid[j] < num_rec`` (the JAX package's ``.at[idx].add(rows)``).
    All 16 rows are summed as they are: the compositing backward writes
    d_cs into rows 3 and 4 both, so no row is copied.

    No kernel: ``index_put_(accumulate=True)``, which adds each row's
    columns in order on every device (on CUDA it sorts the indices and walks
    each row in one warp instead of adding with float atomics;
    ``chip_smoke.py`` compares two launches bit for bit).
    Columns of no gaussian go to scratch rows past ``num_rec``, at most
    ``_SCATTER_SPAN`` a row, so that no walk is long: a budget's unused
    columns would otherwise all land on one row."""
    _kernels.check(g_cm.dim() == 2 and g_cm.shape[0] == REC_DIM
                   and gid.shape == (g_cm.shape[1],) and gid.dtype == torch.int32,
                   f"need rows [16, P] and int32 gid [P], got {tuple(g_cm.shape)} "
                   f"and {gid.dtype} {tuple(gid.shape)}")
    cols = g_cm.shape[1]
    scratch = max(1, -(-cols // _SCATTER_SPAN))
    col = torch.arange(cols, device=g_cm.device)
    idx = torch.where(gid < num_rec, gid.long(), num_rec + col % scratch)
    out = torch.zeros((num_rec + scratch, REC_DIM), dtype=torch.float32, device=g_cm.device)
    out.index_put_((idx,), g_cm.T, accumulate=True)
    return out[:num_rec]


def reduce_record_cotangent(g_cm: torch.Tensor, gid: torch.Tensor, num_rec: int,
                            grad_reduce: str = "segsum") -> torch.Tensor:
    """d packed [num_rec, 11] from the record-buffer cotangent [16, P] and the
    per-column gaussian id [P] (``num_rec`` = no gaussian): the per-Gaussian
    reduction ``grad_reduce`` names, then kernel layout -> packed layout.
    "segsum": the gid sort and the segment sum (K4, which also copies row 3
    into row 4: both conic off-diagonals get d_cs); "scatter":
    ``scatter_reduce``.  The one backward of every staging and of the split
    layout's record gather."""
    if grad_reduce == "segsum":
        grad_rec = segsum_cuda.segment_reduce(g_cm, gid, num_rec)  # [N, 16]
    elif grad_reduce == "scatter":
        grad_rec = scatter_reduce(g_cm, gid, num_rec)
    else:
        raise ValueError(f"unknown grad_reduce {grad_reduce!r}")
    return grad_rec[:, list(PERM)]


class _GatherRecords(torch.autograd.Function):
    """The split layout's record gather.  Forward: the chunk-aligned record
    buffer [16, num_aligned], column j = kernel-layout row of gaussian
    ``aligned_idx[j]`` where ``aligned_valid[j]``, else zeros.  Backward:
    ``reduce_record_cotangent`` on gid = aligned_idx where valid, else N.
    No segment-sum width constraint applies (the JAX package falls back to
    the scatter where no segment-sum chunk divides the aligned width; K4
    takes any width)."""

    @staticmethod
    def forward(ctx, packed, aligned_idx, aligned_valid, grad_reduce):
        n = packed.shape[0]
        rec = torch.zeros((n, REC_DIM), dtype=torch.float32, device=packed.device)
        rec[:, :_REC_ROWS] = packed.detach()[:, list(PERM)]
        gathered = torch.where(aligned_valid[:, None], rec[aligned_idx], 0.0)
        gid = torch.where(aligned_valid, aligned_idx, n).to(torch.int32)
        ctx.save_for_backward(gid)
        ctx.num_rec, ctx.grad_reduce = n, grad_reduce
        return gathered.T.contiguous()

    @staticmethod
    def backward(ctx, g_cm):
        with span("stage.bwd"):
            (gid,) = ctx.saved_tensors
            d_packed = reduce_record_cotangent(g_cm.contiguous(), gid, ctx.num_rec,
                                               ctx.grad_reduce)
        return d_packed, None, None, None


def split_records(packed, sorted_gauss_idx, tile_start, tile_count, num_tiles: int,
                  chunk: int, grad_reduce: str = "segsum"):
    """The split layout's chunk-aligned record buffer: (records_cm [16,
    max_pairs + num_tiles * chunk], aligned_start [num_tiles]) from packed
    [N, 11] (reference layout) and the binning's sorted gaussian ids and
    tile ranges; differentiable with respect to ``packed`` (its backward
    the ``grad_reduce`` reduction)."""
    num_aligned = sorted_gauss_idx.shape[0] + num_tiles * chunk
    aligned_start, src, within = aligned_relayout(tile_start, tile_count, chunk, num_aligned)
    aligned_idx = torch.where(within, sorted_gauss_idx[src].long(), 0)
    return _GatherRecords.apply(packed, aligned_idx, within, grad_reduce), aligned_start


def rasterize_split(packed, sorted_gauss_idx, tile_start, tile_count, image_width,
                    image_height, tile_w, tile_h, *, chunk_size=128, alpha_clamp=0.99,
                    transmittance_eps=1e-4, undo_denom_floor=1e-6,
                    grad_reduce="segsum") -> RenderOutputs:
    """The split layout's rasterizer (the JAX package's
    ``rasterize_pallas``): packed [N, 11] (reference layout) and the binning
    -> image outputs.  The sorted pairs are laid out chunk-aligned
    (``num_aligned = max_pairs + num_tiles * chunk`` columns), the records
    gathered there (``_GatherRecords``, whose backward is the
    ``grad_reduce`` reduction), then K1 forward and, when ``packed``
    requires grad, K7 backward."""
    num_tiles = -(-image_width // tile_w) * -(-image_height // tile_h)
    records_cm, aligned_start = split_records(packed, sorted_gauss_idx, tile_start,
                                              tile_count, num_tiles, chunk_size, grad_reduce)
    return rasterize_staged(records_cm, aligned_start, tile_count, image_width,
                            image_height, tile_w, tile_h, chunk_size=chunk_size,
                            alpha_clamp=alpha_clamp, transmittance_eps=transmittance_eps,
                            undo_denom_floor=undo_denom_floor, sorted_mode=False)
