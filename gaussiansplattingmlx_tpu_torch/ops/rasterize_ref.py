"""Packed record layout, render outputs and the oracle rasterizer (torch
counterpart of the JAX package's ``ops/rasterize_ref.py``).

Compositing semantics shared by every rasterizer of the port: per-pixel
front-to-back alpha compositing over the pixel's tile list in depth order,

    contrib_i = T_i * alpha_i ;  T_{i+1} = T_i * (1 - alpha_i) ;
    record i is taken while T_i >= 1e-4 (transmittance BEFORE it)

with alpha_i = min(exp(-0.5 d^T conic d) * opacity_i, 0.99), d = (px - mx,
py - my) at integer pixel coordinates (no +0.5), and no alpha < 1/255 skip.

``rasterize_reference`` is the oracle (``RasterizerConfig.backend=
"reference"``): plain torch on the device of its inputs, differentiable by
autograd, with no kernel.  It evaluates every pixel against the whole sorted
pair list by the vector identity

    Tu_i = exclusive_cumprod(1 - alpha)_i          (transmittance before i)
    m_i  = Tu_i >= 1e-4                            (include mask, monotone)
    w_i  = Tu_i * alpha_i * m_i                    (per-sample weight)
    out  = sum_i w_i * attr_i ;  T_final = prod_i (1 - alpha_i * m_i)

which equals the serial march: factors after the crossing only shrink Tu,
so the mask taken from the *unmasked* product agrees with the serial break.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils import checkpoint

# Packed per-Gaussian render record layout:
#   [0:2] mean2d, [2:6] conic (c00, c01, c10, c11), [6:9] color,
#   [9] opacity, [10] depth
PACKED_DIM = 11


def pack_gaussians(means2d, conic, colors, opacity, depths) -> torch.Tensor:
    """[N,2],[N,4],[N,3],[N,1],[N] -> [N,11]."""
    return torch.cat(
        [means2d, conic, colors, opacity.reshape(-1, 1), depths.reshape(-1, 1)],
        dim=-1,
    )


def unpack_gradients(grad_packed):
    """[N, 11] cotangent -> per-leaf cotangents (means2d, conic, colors,
    opacity [N, 1], depths [N])."""
    return (
        grad_packed[:, 0:2],
        grad_packed[:, 2:6],
        grad_packed[:, 6:9],
        grad_packed[:, 9:10],
        grad_packed[:, 10],
    )


class RenderOutputs(NamedTuple):
    color: torch.Tensor  # [H, W, 3] accumulated color (background NOT applied)
    depth: torch.Tensor  # [H, W]
    alpha: torch.Tensor  # [H, W] = 1 - final transmittance
    n_contrib: torch.Tensor  # [H, W] int32 samples composited per pixel


def apply_background(color, alpha, white_background: bool):
    """White background adds the final transmittance to every channel."""
    if white_background:
        return color + (1.0 - alpha)[..., None]
    return color


def sample_alpha(px, py, mean_x, mean_y, c00, c01, c10, c11, opacity, alpha_clamp=0.99):
    """Gaussian falloff alpha, clamped at ``alpha_clamp``: the gradient is
    zero above the clamp (and halved at a tie, as ``jnp.minimum``'s)."""
    dx = px - mean_x
    dy = py - mean_y
    e = -0.5 * (dx * dx * c00 + dy * dy * c11 + dx * dy * (c01 + c10))
    raw = torch.exp(e) * opacity
    return torch.minimum(raw, torch.tensor(alpha_clamp, dtype=raw.dtype, device=raw.device))


def _composite_rows(records, sorted_tile_id, ys, xs, grid_w, tile_w, tile_h, alpha_clamp,
                    transmittance_eps):
    """Every pixel of rows ``ys`` [R] x columns ``xs`` [W] against the whole
    sorted pair list: (color [R, W, 3], depth, alpha, n_contrib [R, W])."""
    py = ys.to(torch.float32)[:, None, None]
    px = xs.to(torch.float32)[None, :, None]
    tile = (ys // tile_h)[:, None] * grid_w + (xs // tile_w)[None, :]  # [R, W]
    in_tile = sorted_tile_id[None, None, :] == tile[:, :, None]  # [R, W, P]
    r = records.T  # [11, P]
    a = sample_alpha(px, py, r[0], r[1], r[2], r[3], r[4], r[5], r[9],
                     alpha_clamp=alpha_clamp)
    a = torch.where(in_tile, a, 0.0)
    one_minus = 1.0 - a
    tu = torch.cat([torch.ones_like(one_minus[..., :1]),
                    torch.cumprod(one_minus, dim=-1)[..., :-1]], dim=-1)
    m = (tu >= transmittance_eps) & in_tile
    mf = m.to(a.dtype)
    w = tu * a * mf
    color = w @ records[:, 6:9]
    depth = torch.sum(w * r[10], dim=-1)
    t_final = torch.prod(1.0 - a * mf, dim=-1)
    return color, depth, 1.0 - t_final, torch.sum(m, dim=-1, dtype=torch.int32)


def rasterize_reference(
    packed: torch.Tensor,
    sorted_gauss_idx: torch.Tensor,
    sorted_tile_id: torch.Tensor,
    image_width: int,
    image_height: int,
    tile_w: int,
    tile_h: int,
    *,
    alpha_clamp: float = 0.99,
    transmittance_eps: float = 1e-4,
    row_chunk: int = 8,
) -> RenderOutputs:
    """Rasterize by the vector identity over the full sorted pair list, each
    pixel masking the pairs of its own tile: O(H * W * max_pairs) work, for
    oracle-scale scenes.  ``packed`` [N, 11] (reference layout); the pair
    list is the binning's (``sorted_tile_id`` = num_tiles on unused slots).

    Rows are composited ``row_chunk`` at a time; under autograd each chunk
    is recomputed in the backward (``torch.utils.checkpoint``), so memory
    stays O(row_chunk * W * max_pairs) in both passes."""
    grid_w = -(-image_width // tile_w)
    dev = packed.device
    records = packed[sorted_gauss_idx.long()]  # [P, 11]
    tiles = sorted_tile_id.to(torch.int64)
    xs = torch.arange(image_width, device=dev)
    consts = (grid_w, tile_w, tile_h, alpha_clamp, transmittance_eps)
    grad = torch.is_grad_enabled() and records.requires_grad
    parts = []
    for y0 in range(0, image_height, row_chunk):
        ys = torch.arange(y0, min(y0 + row_chunk, image_height), device=dev)
        if grad:
            parts.append(checkpoint.checkpoint(_composite_rows, records, tiles, ys, xs,
                                               *consts, use_reentrant=False))
        else:
            parts.append(_composite_rows(records, tiles, ys, xs, *consts))
    color, depth, alpha, n_contrib = (torch.cat(p, dim=0) for p in zip(*parts))
    return RenderOutputs(color=color, depth=depth, alpha=alpha, n_contrib=n_contrib)
