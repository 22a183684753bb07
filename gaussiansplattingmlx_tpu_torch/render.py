"""Render: projection -> pair staging -> forward compositing (torch counterpart
of the JAX package's ``render.py``, inference path).

``render(..., inference=True)`` is the serving path: sorted-order staging
with the merge-gather kernel, then the forward compositing kernel over
unaligned tile ranges.  Training (``inference=False``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import RasterizerConfig
from .ops import projection, rasterize_cuda, rasterize_ref
from .ops import staging as staging_mod


class RenderAux(NamedTuple):
    radii: torch.Tensor  # [N] screen radii (0 = culled)
    num_pairs: torch.Tensor  # [] pairs binned
    overflow_gaussians: torch.Tensor  # [] gaussians losing pairs to the budget
    overflow_pairs: torch.Tensor  # [] pairs dropped by the budget


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
    inference: bool = False,
):
    """Render one view on the device of ``means3d``.

    Returns (RenderOutputs with the background applied to color, RenderAux).
    """
    if not inference:
        raise NotImplementedError(
            "training render (inference=False) is not ported yet: see ROADMAP.md "
            "queue A, 'projection backward and staging autograd.Function'"
        )
    cfg = raster_cfg
    with torch.no_grad():
        p = projection.project_gaussians(
            means3d, scales, rotations, shs, view, proj, camera_center,
            fov_x, fov_y, focal_x, focal_y, image_width, image_height, sh_degree,
            z_cull=cfg.z_cull,
            ndc_w_eps=cfg.ndc_w_eps,
            tanfov_clip=cfg.tanfov_clip,
            cov2d_dilation=cfg.cov2d_dilation,
            radius_eigen_eps=cfg.radius_eigen_eps,
            quat_norm_eps=cfg.quat_norm_eps,
        )
        packed = rasterize_ref.pack_gaussians(
            p.means2d, p.conic, p.colors, opacity, p.depths
        )
        sst = staging_mod.StagingStatic(
            image_width=image_width,
            image_height=image_height,
            tile_w=cfg.tile_w,
            tile_h=cfg.tile_h,
            max_pairs=cfg.max_pairs,
            chunk=cfg.chunk_size,
        )
        staged = staging_mod.stage_pairs_sorted(
            sst, packed, p.rect_min, p.rect_max, p.radii, p.depths
        )
        out = rasterize_cuda.rasterize_staged(
            staged.records_cm, staged.tile_start, staged.tile_count,
            image_width, image_height, cfg.tile_w, cfg.tile_h,
            alpha_clamp=cfg.alpha_clamp,
            transmittance_eps=cfg.transmittance_eps,
        )
        out = out._replace(color=rasterize_ref.apply_background(
            out.color, out.alpha, white_background))
    aux = RenderAux(
        radii=p.radii,
        num_pairs=staged.num_pairs,
        overflow_gaussians=staged.overflow_gaussians,
        overflow_pairs=staged.overflow_pairs,
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
):
    """Render a batch of cameras of one model, one after another.

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
            inference=inference,
        )
        colors.append(out.color)
        depths.append(out.depth)
        npairs.append(aux.num_pairs)
        ovfl.append(aux.overflow_pairs)
    return (torch.stack(colors), torch.stack(depths), torch.stack(npairs),
            torch.stack(ovfl))
