"""Render: projection -> pair staging -> compositing (torch counterpart of
the JAX package's ``render.py``).

``RasterizerConfig`` names the record layout, as in the JAX package:

* ``staging="fused"`` (the default), ``inference=True``, the serving path:
  sorted-order staging with the merge-gather kernel (K2), then forward
  compositing (K1) over unaligned tile ranges, without gradients.
* ``staging="fused"``, training, ``train_staging="sorted"`` (the default):
  the same staging as a differentiable ``autograd.Function`` whose backward
  is the per-Gaussian segment sum (K4), and the rasterizer's
  ``autograd.Function`` (K1 forward, K3 backward).
  ``train_staging="aligned"``: the staging also relays the records out into
  whole chunks per tile (K6), and the backward is K7.
* ``staging="split"``, serving and training: ``binning.bin_gaussians``
  (owner ranks by K5, one (tile, depth) sort of the gaussian ids), the
  chunk-aligned record gather whose backward is K4, K1 forward and K7
  backward (``rasterize_cuda.rasterize_split``).

``grad_reduce="scatter"`` replaces K4 in the backward of every layout by a
scatter-add (``rasterize_cuda.scatter_reduce``).  ``backend="reference"``
(whatever the layout, and with ``inference`` or without) bins with
``binning.bin_gaussians`` and composites with the oracle
(``rasterize_ref.rasterize_reference``), differentiable by autograd.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .config import SELECTORS, RasterizerConfig
from .ops import binning as binning_mod
from .ops import projection, rasterize_cuda, rasterize_ref
from .ops import staging as staging_mod
from .utils.profiler import span


class RenderAux(NamedTuple):
    radii: torch.Tensor  # [N] screen radii (0 = culled)
    num_pairs: torch.Tensor  # [] pairs binned
    overflow_gaussians: torch.Tensor  # [] gaussians losing pairs to the budget
    overflow_pairs: torch.Tensor  # [] pairs dropped by the budget
    means2d: torch.Tensor  # [N, 2] the projection's (full-image) screen means
    tile_depth_mean: torch.Tensor  # [] mean pairs a tile
    tile_depth_max: torch.Tensor  # [] most pairs in a tile


def resolve_backend(backend: str) -> str:
    """"reference" (the oracle) or "kernels" (the port's kernels on CUDA
    tensors, their plain versions on CPU tensors: "auto", "pallas" and
    "pallas_interpret").  The JAX package's "auto" means the oracle off a
    TPU; the port's never does, because off the card the kernels' plain
    versions run (the oracle is chosen by name).  Unknown names raise
    ``ValueError``."""
    if backend not in SELECTORS["backend"]:
        raise ValueError(f"unknown rasterizer backend {backend!r}: expected one of "
                         f"{SELECTORS['backend']}")
    return "reference" if backend == "reference" else "kernels"


def band_window(p: projection.ProjectionOutputs, image_height: int, pixel_y_offset=None):
    """(means2d, rect_min, rect_max) of a projection in the pixels of the
    band of ``image_height`` rows that starts at full-image row
    ``pixel_y_offset`` (None: the projection's own, full image).  The shift
    carries the gradient; the y rects are clipped again to the band, the x
    rects keep the full image's clamps."""
    if pixel_y_offset is None:
        return p.means2d, p.rect_min, p.rect_max
    offs = torch.as_tensor(pixel_y_offset, dtype=p.means2d.dtype, device=p.means2d.device)
    means2d = p.means2d - torch.stack([torch.zeros_like(offs), offs])
    y_band = means2d[:, 1].detach()
    rect_min = torch.stack([p.rect_min[:, 0], torch.clamp_min(y_band - p.radii, 0.0)], dim=-1)
    rect_max = torch.stack(
        [p.rect_max[:, 0], torch.clamp_max(y_band + p.radii, image_height - 1.0)], dim=-1)
    return means2d, rect_min, rect_max


def render(
    means3d: torch.Tensor,
    shs: torch.Tensor,
    opacity: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    view: torch.Tensor,
    proj: torch.Tensor,
    camera_center: torch.Tensor,
    fov_x,
    fov_y,
    focal_x,
    focal_y,
    image_width: int,
    image_height: int,
    sh_degree: int,
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    white_background: bool = False,
    pixel_y_offset=None,
    full_image_height: int | None = None,
    active: torch.Tensor | None = None,
    inference: bool = False,
    backend: str | None = None,
):
    """Render one view on the device of ``means3d``.  ``active`` [N]
    (optional) culls rows with active <= 0 in the projection; ``backend``
    (None: ``raster_cfg.backend``) names the rasterizer.

    For the pixel-band split (``parallel/sharding.py``), ``image_height`` is
    the band's height, ``full_image_height`` the camera's full image height
    and ``pixel_y_offset`` the band's first row: the projection uses the
    full image, while staging and compositing run in band-local pixels.

    Returns (RenderOutputs with the background applied to color, RenderAux).
    """
    cfg = raster_cfg
    backend = resolve_backend(backend if backend is not None else cfg.backend)
    proj_height = full_image_height if full_image_height is not None else image_height
    grad_ctx = torch.no_grad() if inference else contextlib.nullcontext()
    with grad_ctx:
        with span("project"):
            p = projection.project_gaussians(
                means3d, scales, rotations, shs, view, proj, camera_center,
                fov_x, fov_y, focal_x, focal_y, image_width, proj_height, sh_degree,
                z_cull=cfg.z_cull,
                ndc_w_eps=cfg.ndc_w_eps,
                tanfov_clip=cfg.tanfov_clip,
                cov2d_dilation=cfg.cov2d_dilation,
                radius_eigen_eps=cfg.radius_eigen_eps,
                quat_norm_eps=cfg.quat_norm_eps,
                active=active,
            )
            means2d, rect_min, rect_max = band_window(p, image_height, pixel_y_offset)
            packed = rasterize_ref.pack_gaussians(
                means2d, p.conic, p.colors, opacity, p.depths
            )
        common = dict(chunk_size=cfg.chunk_size, alpha_clamp=cfg.alpha_clamp,
                      transmittance_eps=cfg.transmittance_eps,
                      undo_denom_floor=cfg.undo_denom_floor)
        binned = backend == "reference" or cfg.staging == "split"
        with span("stage"):
            if binned:
                staged = binning_mod.bin_gaussians(
                    rect_min, rect_max, p.radii, p.depths, image_width, image_height,
                    cfg.tile_w, cfg.tile_h, cfg.max_pairs,
                )
            else:
                sst = staging_mod.StagingStatic(
                    image_width=image_width,
                    image_height=image_height,
                    tile_w=cfg.tile_w,
                    tile_h=cfg.tile_h,
                    max_pairs=cfg.max_pairs,
                    chunk=cfg.chunk_size,
                    grad_reduce=cfg.grad_reduce,
                )
                geom = (sst, packed, rect_min, rect_max, p.radii, p.depths)
                if inference:
                    staged = staging_mod.stage_pairs_sorted(*geom)
                    starts, sorted_mode = staged.tile_start, True
                elif cfg.train_staging == "sorted":
                    staged = staging_mod.stage_pairs_train(*geom)
                    starts, sorted_mode = staged.tile_start, True
                else:
                    staged = staging_mod.stage_pairs(*geom)
                    starts, sorted_mode = staged.aligned_start, False
        with span("composite"):
            if backend == "reference":
                out = rasterize_ref.rasterize_reference(
                    packed, staged.sorted_gauss_idx, staged.sorted_tile_id,
                    image_width, image_height, cfg.tile_w, cfg.tile_h,
                    alpha_clamp=cfg.alpha_clamp, transmittance_eps=cfg.transmittance_eps,
                )
            elif binned:
                out = rasterize_cuda.rasterize_split(
                    packed, staged.sorted_gauss_idx, staged.tile_start, staged.tile_count,
                    image_width, image_height, cfg.tile_w, cfg.tile_h,
                    grad_reduce=cfg.grad_reduce, **common,
                )
            else:
                out = rasterize_cuda.rasterize_staged(
                    staged.records_cm, starts, staged.tile_count,
                    image_width, image_height, cfg.tile_w, cfg.tile_h,
                    sorted_mode=sorted_mode, **common,
                )
            out = out._replace(color=rasterize_ref.apply_background(
                out.color, out.alpha, white_background))
            aux = RenderAux(
                radii=p.radii,
                num_pairs=staged.num_pairs,
                overflow_gaussians=staged.overflow_gaussians,
                overflow_pairs=staged.overflow_pairs,
                means2d=p.means2d,
                tile_depth_mean=torch.mean(staged.tile_count.to(torch.float32)),
                tile_depth_max=torch.max(staged.tile_count),
            )
    return out, aux


def render_many(
    means3d, shs, opacity, scales, rotations,
    views: torch.Tensor,  # [B, 4, 4]
    projs: torch.Tensor,  # [B, 4, 4]
    camera_centers: torch.Tensor,  # [B, 3]
    fov_xs, fov_ys, focal_xs, focal_ys,  # [B] each
    image_width: int,
    image_height: int,
    sh_degree: int,
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    white_background: bool = False,
    inference: bool = True,
    backend: str | None = None,
):
    """Render a batch of cameras of one model, one after another
    (``backend`` as ``render``'s).

    Returns (colors [B,H,W,3], depths [B,H,W], num_pairs [B],
    overflow_pairs [B])."""
    colors, depths, npairs, ovfl = [], [], [], []
    for b in range(views.shape[0]):
        out, aux = render(
            means3d, shs, opacity, scales, rotations,
            views[b], projs[b], camera_centers[b],
            fov_xs[b], fov_ys[b], focal_xs[b], focal_ys[b],
            image_width, image_height, sh_degree,
            raster_cfg=raster_cfg, white_background=white_background,
            inference=inference, backend=backend,
        )
        colors.append(out.color)
        depths.append(out.depth)
        npairs.append(aux.num_pairs)
        ovfl.append(aux.overflow_pairs)
    return (torch.stack(colors), torch.stack(depths), torch.stack(npairs),
            torch.stack(ovfl))
