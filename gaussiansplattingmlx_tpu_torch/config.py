"""Rasterizer configuration: the port's copy of the JAX package's
``RasterizerConfig`` (same fields, same defaults; a test pins the two).

The port keeps its own copy so that it never imports the JAX package.  The
inference path does not read the training fields (``auto_grow``,
``auto_shrink``, ``grad_reduce``, ``undo_denom_floor``) or the JAX layout
selectors (``backend``, ``staging``, ``train_staging``): the port always
runs the payload-carriage, merge-gather, sorted-order path.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Static-shape rasterizer / tile-binning configuration."""

    # Pixel tile size (the CUDA compositing kernel runs one thread per pixel,
    # so tile_h * tile_w <= 1024).
    tile_h: int = 16
    tile_w: int = 16
    # Global (gaussian, tile) pair budget: the one truncating capacity.
    # Binning reports overflow_pairs when the exact pair total exceeds it.
    max_pairs: int = 2 ** 20
    auto_grow: bool = True
    max_pairs_limit: int = 2 ** 23
    auto_shrink: bool = True
    # Trailing zero columns of the staged record buffer (and the budget
    # quantum of render_cli's auto pair budget).
    chunk_size: int = 128
    grad_reduce: str = "segsum"
    # Compositing constants.
    alpha_clamp: float = 0.99
    transmittance_eps: float = 1e-4
    undo_denom_floor: float = 1e-6
    # Projection constants.
    ndc_w_eps: float = 1e-6
    z_cull: float = 0.2
    cov2d_dilation: float = 0.3
    tanfov_clip: float = 1.3
    radius_eigen_eps: float = 1e-5
    quat_norm_eps: float = 1e-8
    backend: str = "auto"
    staging: str = "fused"
    train_staging: str = "sorted"
