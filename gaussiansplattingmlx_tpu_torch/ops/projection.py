"""Gaussian projection: world -> view -> NDC -> screen, EWA cov2d, SH color.

Torch counterpart of the JAX package's ``ops/projection.py``.
``project_gaussians`` dispatches on the device of ``means3d``: CPU tensors
take ``project_gaussians_plain``, vectorized torch differentiable by plain
autograd (radii and rects are detached, as the JAX package stop-grads
them); CUDA tensors take the kernels of ``projection_cuda`` (the projection,
then the SH colour in span ``sh``), which compute the same values, or raise.

Semantics replicated exactly, including the reference's quirks:
  * the +1e-6 guard on clip-space w;
  * visibility cull at view z >= 0.2;
  * the EWA ``t`` clamp written as clamp(t_z, +-1.3*tan_fov);
  * +0.3 low-pass on the cov2d diagonal;
  * SH evaluated on the *unnormalized* view direction;
  * radius = 3*ceil(sqrt(lambda_max)), lambda_max = mid + sqrt(max(mid^2-det, 1e-5));
  * rect min clamped at 0, rect max clamped at W-1/H-1 only from above;
  * NaN-safe culled rows: culled gaussians get safe denominators (w, t_z,
    det), so their rows stay finite.

Float32 throughout.  The small contractions are written as explicit
products and sums instead of matmuls, so TF32 settings of the card cannot
lower their precision (the JAX package pins these matmuls to HIGHEST).
Where the JAX package uses ``maximum``/``minimum``/``clip`` this uses
``torch.maximum``/``torch.minimum``: at a tie they split the gradient in
half as JAX does, where ``torch.clamp`` would pass all of it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import sh as sh_utils
from ..utils import transforms
from ..utils.profiler import span
from . import projection_cuda


class ProjectionOutputs(NamedTuple):
    means2d: torch.Tensor  # [N, 2] pixel coordinates
    depths: torch.Tensor  # [N] view-space z
    colors: torch.Tensor  # [N, 3] SH-evaluated RGB (clamped at 0)
    cov2d: torch.Tensor  # [N, 4] (c00, c01, c10, c11)
    conic: torch.Tensor  # [N, 4] inverse cov2d, same layout
    radii: torch.Tensor  # [N] screen-space radius (0 when culled)
    rect_min: torch.Tensor  # [N, 2]
    rect_max: torch.Tensor  # [N, 2]


def _rowvec_mm(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[N, K] @ [K, J] as a left-to-right sum of K products, in full f32."""
    out = a[:, 0:1] * m[0]
    for k in range(1, m.shape[0]):
        out = out + a[:, k:k + 1] * m[k]
    return out


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    shs: torch.Tensor,
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
    *,
    z_cull: float = 0.2,
    ndc_w_eps: float = 1e-6,
    tanfov_clip: float = 1.3,
    cov2d_dilation: float = 0.3,
    radius_eigen_eps: float = 1e-5,
    quat_norm_eps: float = 1e-8,
    active: torch.Tensor | None = None,
) -> ProjectionOutputs:
    """Project N Gaussians through one camera on the device of ``means3d``
    (arguments and outputs as ``project_gaussians_plain``'s)."""
    constants = dict(z_cull=z_cull, ndc_w_eps=ndc_w_eps, tanfov_clip=tanfov_clip,
                     cov2d_dilation=cov2d_dilation, radius_eigen_eps=radius_eigen_eps,
                     quat_norm_eps=quat_norm_eps)
    if means3d.device.type == "cpu":
        return project_gaussians_plain(
            means3d, scales, quats, shs, view, proj, camera_center, fov_x, fov_y, focal_x,
            focal_y, image_width, image_height, sh_degree, active=active, **constants)
    if means3d.device.type != "cuda":
        raise ValueError(f"project_gaussians: unsupported device {means3d.device}")
    cam = projection_cuda.Camera(view, proj, camera_center, fov_x, fov_y, focal_x, focal_y,
                                 image_width, image_height, device=means3d.device, **constants)
    means2d, depths, cov2d, conic, radii, rect_min, rect_max = projection_cuda.project(
        means3d, scales, quats, active, cam)
    with span("sh"):
        colors = projection_cuda.sh_color(sh_degree, shs, means3d, cam)
    return ProjectionOutputs(means2d=means2d, depths=depths, colors=colors, cov2d=cov2d,
                             conic=conic, radii=radii, rect_min=rect_min, rect_max=rect_max)


def project_gaussians_plain(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    shs: torch.Tensor,
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
    *,
    z_cull: float = 0.2,
    ndc_w_eps: float = 1e-6,
    tanfov_clip: float = 1.3,
    cov2d_dilation: float = 0.3,
    radius_eigen_eps: float = 1e-5,
    quat_norm_eps: float = 1e-8,
    active: torch.Tensor | None = None,
) -> ProjectionOutputs:
    """Project N Gaussians through one camera, in plain torch on any device.

    means3d [N, 3]; scales [N, 3] activated; quats [N, 4] raw w-first;
    shs [N, K, 3]; view/proj [4, 4] row-vector transforms; camera_center [3];
    fov/focal scalars (python floats or 0-d tensors); ``active`` [N]
    (optional): rows with active <= 0 are culled like behind-camera rows.
    """
    w = float(image_width)
    h = float(image_height)
    dev = means3d.device
    f32 = torch.float32

    def scalar(v):
        return torch.as_tensor(v, dtype=f32, device=dev)

    # --- NDC projection (row-vector convention) -----------------------------
    p_hom = transforms.homogeneous(means3d)  # [N, 4]
    p_view = _rowvec_mm(p_hom, view)  # [N, 4]
    p_clip = _rowvec_mm(p_view, proj)  # [N, 4]
    depths = p_view[:, 2]
    visible = depths >= z_cull
    if active is not None:
        visible = torch.logical_and(visible, active > 0)
    one = torch.ones((), dtype=f32, device=dev)
    w_den = torch.where(visible, p_clip[:, 3] + ndc_w_eps, one)
    w_inv = 1.0 / w_den
    ndc = p_clip * w_inv[:, None]

    mean_x = ((ndc[:, 0] + 1.0) * w - 1.0) * 0.5
    mean_y = ((ndc[:, 1] + 1.0) * h - 1.0) * 0.5
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    # --- cov3d from scale/rotation ------------------------------------------
    cov3d = transforms.build_cov3d(scales, quats, quat_norm_eps)  # [N, 3, 3]

    # --- EWA cov2d ----------------------------------------------------------
    a = view[:3, :3]
    t = _rowvec_mm(means3d, a) + view[3, :3]  # [N, 3]
    t0, t1 = t[:, 0], t[:, 1]
    t2 = torch.where(visible, t[:, 2], one)

    tan_fov_x = torch.tan(scalar(fov_x) * 0.5)
    tan_fov_y = torch.tan(scalar(fov_y) * 0.5)
    lim_x = tan_fov_x * tanfov_clip
    lim_y = tan_fov_y * tanfov_clip
    clip_x = torch.minimum(torch.maximum(t2, -lim_x), lim_x)
    clip_y = torch.minimum(torch.maximum(t2, -lim_y), lim_y)
    tx = t0 / clip_x * t2
    ty = t1 / clip_y * t2
    tz = t2

    fx = scalar(focal_x)
    fy = scalar(focal_y)
    j00 = fx / tz
    j02 = -tx * fx / (tz * tz)
    j11 = fy / tz
    j12 = -ty * fy / (tz * tz)

    W = a.T
    b0 = j00[:, None] * W[0][None, :] + j02[:, None] * W[2][None, :]  # [N, 3]
    b1 = j11[:, None] * W[1][None, :] + j12[:, None] * W[2][None, :]

    c3b0 = torch.sum(cov3d * b0[:, None, :], dim=-1)
    c3b1 = torch.sum(cov3d * b1[:, None, :], dim=-1)
    c00 = torch.sum(b0 * c3b0, dim=-1) + cov2d_dilation
    c01 = torch.sum(b0 * c3b1, dim=-1)
    c10 = torch.sum(b1 * c3b0, dim=-1)
    c11 = torch.sum(b1 * c3b1, dim=-1) + cov2d_dilation
    cov2d = torch.stack([c00, c01, c10, c11], dim=-1)

    det = c00 * c11 - c01 * c10
    det = torch.where(torch.logical_and(visible, det > 1e-12), det, one)
    conic = torch.stack([c11 / det, -c01 / det, -c10 / det, c00 / det], dim=-1)

    # --- SH color -----------------------------------------------------------
    with span("sh"):
        dirs = means3d - camera_center[None, :]  # unnormalized, by design
        colors = sh_utils.sh_to_color(sh_degree, shs, dirs)

    # --- radius and screen rect ---------------------------------------------
    mid = 0.5 * (c00 + c11)
    lambda_max = mid + torch.sqrt(torch.maximum(mid * mid - det, scalar(radius_eigen_eps)))
    radius = 3.0 * torch.ceil(torch.sqrt(lambda_max))
    zero = torch.zeros((), dtype=f32, device=dev)
    radii = torch.where(visible, radius, zero)

    min_x = torch.maximum(mean_x - radii, zero)
    min_y = torch.maximum(mean_y - radii, zero)
    max_x = torch.minimum(mean_x + radii, scalar(w - 1.0))
    max_y = torch.minimum(mean_y + radii, scalar(h - 1.0))

    return ProjectionOutputs(
        means2d=means2d,
        depths=depths,
        colors=colors,
        cov2d=cov2d,
        conic=conic,
        radii=radii.detach(),
        rect_min=torch.stack([min_x, min_y], dim=-1).detach(),
        rect_max=torch.stack([max_x, max_y], dim=-1).detach(),
    )
