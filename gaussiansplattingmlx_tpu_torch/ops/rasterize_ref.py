"""Packed record layout and render outputs (torch counterpart of the JAX
package's ``ops/rasterize_ref.py``).

Compositing semantics shared by every rasterizer of the port: per-pixel
front-to-back alpha compositing over the pixel's tile list in depth order,

    contrib_i = T_i * alpha_i ;  T_{i+1} = T_i * (1 - alpha_i) ;
    record i is taken while T_i >= 1e-4 (transmittance BEFORE it)

with alpha_i = min(exp(-0.5 d^T conic d) * opacity_i, 0.99), d = (px - mx,
py - my) at integer pixel coordinates (no +0.5), and no alpha < 1/255 skip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
