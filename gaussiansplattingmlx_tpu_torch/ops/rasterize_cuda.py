"""Tile rasterizer forward over a staged record buffer (kernel K1).

Counterpart of the JAX package's ``ops/rasterize_pallas.py``
(``rasterize_staged`` forward, Pallas ``_fwd_kernel``, ``_untile``).

Record buffer ``records_cm`` [16, P] f32, component-major, rows:
0 mean_x, 1 mean_y, 2 c00, 3 c01, 4 c10, 5 c11, 6-8 rgb, 9 depth,
10 opacity, 11-15 zero.  Tile t composites the columns
[tile_start[t], tile_start[t] + tile_count[t]) in order; starts need not be
aligned.  The per-tile output [num_tiles, 6, tile_h * tile_w] holds rgb,
depth, alpha (= 1 - T) and n_contrib; the background is applied outside.

``raster_fwd`` dispatches on the device of its inputs: CPU tensors take
``raster_fwd_plain``; CUDA tensors launch ``csrc/rasterize_fwd.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from .rasterize_ref import RenderOutputs

REC_DIM = 16
OUT_CHANNELS = 6
_REC_ROWS = 11  # rows the compositing reads
_MAX_BLOCK = 1024  # one thread per pixel of a tile

KERNEL = _kernels.Kernel(
    "gsplat_raster_fwd",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
     ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p],
)


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


def raster_fwd_plain(records_cm, tile_start, tile_count, grid_w, grid_h,
                     tile_w, tile_h, *, alpha_clamp=0.99, transmittance_eps=1e-4,
                     max_elems=2 ** 24):
    """Plain torch version: the per-pixel vector identity

        Tu_i = exclusive_cumprod(1 - a)_i ;  m_i = Tu_i >= eps
        out = sum_i Tu_i a_i m_i attr_i ;  T = prod_i (1 - a_i m_i)

    over each tile's record window padded to the longest tile, in batches of
    tiles holding at most ``max_elems`` (pixel, record) entries."""
    _check(records_cm, tile_start, tile_count, grid_w, grid_h, tile_w, tile_h)
    dev = records_cm.device
    f32 = torch.float32
    num_tiles = grid_w * grid_h
    tt = tile_w * tile_h
    out = torch.zeros((num_tiles, OUT_CHANNELS, tt), dtype=f32, device=dev)
    longest = int(tile_count.max()) if num_tiles else 0
    if longest == 0:
        return out
    rec = records_cm[:_REC_ROWS]
    pix = torch.arange(tt, device=dev)
    lx, ly = pix % tile_w, pix // tile_w
    j = torch.arange(longest, device=dev)
    batch = max(1, max_elems // (tt * longest))
    for t0 in range(0, num_tiles, batch):
        ts = torch.arange(t0, min(t0 + batch, num_tiles), device=dev)
        start = tile_start[ts].long()
        valid = j[None, :] < tile_count[ts].long()[:, None]  # [B, L]
        idx = torch.where(valid, start[:, None] + j[None, :], 0)
        r = rec[:, idx]  # [11, B, L]
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
        m = torch.logical_and(tu >= transmittance_eps, valid[:, None, :])
        w = torch.where(m, tu * a, 0.0)
        for c, row in enumerate((6, 7, 8, 9)):
            out[ts, c] = torch.sum(w * r[row][:, None, :], dim=-1)
        out[ts, 4] = 1.0 - torch.prod(torch.where(m, om, 1.0), dim=-1)
        out[ts, 5] = torch.sum(m, dim=-1).to(f32)
    return out


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
                     image_height, tile_w, tile_h, *, alpha_clamp=0.99,
                     transmittance_eps=1e-4) -> RenderOutputs:
    """Rasterize a staged sorted-order record buffer (forward only)."""
    grid_w = -(-image_width // tile_w)
    grid_h = -(-image_height // tile_h)
    out = raster_fwd(
        records_cm, tile_start, tile_count, grid_w, grid_h, tile_w, tile_h,
        alpha_clamp=alpha_clamp, transmittance_eps=transmittance_eps,
    )
    return _untile(out, grid_w, grid_h, tile_w, tile_h, image_width, image_height)
