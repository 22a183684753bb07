"""Gaussian parameter store (torch counterpart of the JAX package's
``models/gaussians.py``).

Parameter semantics (identical to the JAX package):
  xyz           [C, 3]    world positions (identity activation)
  features_dc   [C, 1, 3] SH degree-0 coefficients
  features_rest [C, K-1, 3] higher-order SH coefficients
  scales        [C, 3]    log-space; activation exp
  rotation      [C, 4]    unnormalized w-first quaternion; activation row-norm
  opacity       [C, 1]    logit; activation sigmoid

Parameters live in fixed-capacity buffers with a separate active count;
inactive slots carry opacity logit ``INACTIVE_OPACITY`` and identity
quaternions, and the projection culls them.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..data.ply import GaussianPly
from ..utils import sh as sh_utils
from ..utils import transforms

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scales", "rotation", "opacity")

# Opacity logit assigned to inactive capacity slots: sigmoid(-30) ~ 1e-13.
INACTIVE_OPACITY = -30.0


class GaussianParams(nn.Module):
    """One ``nn.Parameter`` per name in ``PARAM_NAMES``."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        missing = set(PARAM_NAMES) - set(tensors)
        if missing:
            raise ValueError(f"missing parameters: {sorted(missing)}")
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(tensors[name]))

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        return math.isqrt(self.features_rest.shape[1] + 1) - 1

    def tensors(self) -> dict:
        """The parameters as a dict keyed by ``PARAM_NAMES``."""
        return {n: getattr(self, n) for n in PARAM_NAMES}

    def to_numpy(self) -> dict:
        return {n: getattr(self, n).detach().cpu().numpy() for n in PARAM_NAMES}


def params_from_numpy(src, device) -> GaussianParams:
    """Carry parameters given as numpy arrays (a dict keyed by
    ``PARAM_NAMES``, or a ``GaussianPly``) into the port as float32 tensors
    on ``device``.  The tensors are copies: training updates them in place."""
    if isinstance(src, GaussianPly):
        src = {n: getattr(src, n) for n in PARAM_NAMES}
    return GaussianParams(
        **{
            n: torch.tensor(np.asarray(src[n], np.float32), device=device)
            for n in PARAM_NAMES
        }
    )


def activations(params, active_mask=None):
    """Raw params (a ``GaussianParams`` or a dict keyed by ``PARAM_NAMES``)
    -> render-space quantities.  ``active_mask`` [C] additionally multiplies
    the opacity of each slot.

    Returns (means3d, shs [C, K, 3], opacity [C, 1], scales, rotations).
    """
    p = params if isinstance(params, Mapping) else params.tensors()
    means3d = p["xyz"]
    opacity = torch.sigmoid(p["opacity"])
    if active_mask is not None:
        opacity = opacity * active_mask[:, None].to(opacity.dtype)
    scales = torch.exp(p["scales"])
    rotations = p["rotation"]  # normalized inside the projection math
    shs = torch.cat([p["features_dc"], p["features_rest"]], dim=1)
    return means3d, shs, opacity, scales, rotations


def knn_mean_sq_dist(points: np.ndarray, k: int = 3, chunk: int = 2048,
                     device="cuda") -> np.ndarray:
    """Mean squared distance to the k nearest neighbours (excluding self).

    Runs on ``device`` in blocks of ``chunk`` rows: distances by the gemm
    expansion |a-b|^2 = |a|^2 + |b|^2 - 2 a.b (a full-f32 ``torch.mm``:
    ``torch.backends.cuda.matmul.allow_tf32`` is False by default), the k
    smallest by ``topk``, summed in ascending order like the JAX package's
    repeated min passes (duplicates count once each)."""
    pts = torch.as_tensor(np.asarray(points, np.float32)).to(device)
    n = pts.shape[0]
    kk = min(k, n - 1)
    sq = torch.sum(pts * pts, dim=1)
    out = []
    for start in range(0, n, chunk):
        block = pts[start:start + chunk]
        rows = torch.arange(start, start + block.shape[0], device=pts.device)
        d2 = sq[start:start + chunk, None] + sq[None, :] - 2.0 * (block @ pts.T)
        d2[torch.arange(block.shape[0], device=pts.device), rows] = float("inf")
        d2 = torch.clamp_min(d2, 0.0)
        smallest = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values
        total = torch.zeros((block.shape[0],), dtype=torch.float32, device=pts.device)
        for j in range(kk):
            total = total + smallest[:, j]
        out.append(total / kk)
    return torch.cat(out).cpu().numpy()


def create_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    sh_degree: int = 4,
    capacity: int | None = None,
    init_opacity: float = 0.1,
    dist2_floor: float = 1e-7,
    knn_k: int = 3,
    device="cuda",
) -> tuple[GaussianParams, int]:
    """Initialize from a point cloud ([N, 3] points, [N, 3] colours in
    [0, 1]).  Returns (params padded to ``capacity`` on ``device``,
    num_active).  Inactive slots get opacity ``INACTIVE_OPACITY`` and
    identity quaternions: a zero quaternion would put 0/0 = NaN into the
    normalize backward even at zero cotangent."""
    points = np.asarray(points, dtype=np.float32)
    colors = np.asarray(colors, dtype=np.float32)
    n = points.shape[0]
    k_coeffs = sh_utils.num_sh_coeffs(sh_degree)
    capacity = n if capacity is None else capacity

    dc = np.asarray(sh_utils.rgb2sh(colors), dtype=np.float32)[:, None, :]
    rest = np.zeros((n, k_coeffs - 1, 3), dtype=np.float32)
    dist2 = np.maximum(knn_mean_sq_dist(points, k=knn_k, device=device), dist2_floor)
    scales = np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1).astype(np.float32)
    rots = np.zeros((n, 4), dtype=np.float32)
    rots[:, 0] = 1.0
    opacity = np.full((n, 1), float(np.log(init_opacity / (1.0 - init_opacity))),
                      dtype=np.float32)

    def pad(x, fill=0.0):
        shape = (capacity - n,) + x.shape[1:]
        return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)

    quat_pad = np.zeros((capacity - n, 4), np.float32)
    quat_pad[:, 0] = 1.0
    src = {
        "xyz": pad(points),
        "features_dc": pad(dc),
        "features_rest": pad(rest),
        "scales": pad(scales),
        "rotation": np.concatenate([rots, quat_pad], axis=0),
        "opacity": pad(opacity, INACTIVE_OPACITY),
    }
    return params_from_numpy(src, device), n


def active_mask(capacity: int, num_active: torch.Tensor) -> torch.Tensor:
    """[capacity] float mask of live slots (``num_active`` a 0-d tensor)."""
    idx = torch.arange(capacity, device=num_active.device)
    return (idx < num_active).to(torch.float32)


def apply_sh_warmup(params: dict, step: torch.Tensor, warmup: int,
                    sh_degree: int) -> dict:
    """SH-degree warmup as a band mask computed from the 0-d ``step`` tensor:
    rest-band row k holds SH index k+1 of degree floor(sqrt(k+1)); bands
    above step // warmup contribute zero and receive zero gradient.
    ``warmup <= 0`` returns ``params`` unchanged."""
    if warmup <= 0:
        return params
    n_rest = sh_utils.num_sh_coeffs(sh_degree) - 1
    rest = params["features_rest"]
    row_degree = torch.as_tensor(
        np.floor(np.sqrt(np.arange(1, n_rest + 1))).astype(np.float32)
    ).to(rest.device)
    active_deg = torch.div(step, warmup, rounding_mode="floor").to(torch.float32)
    band = (row_degree <= active_deg).to(rest.dtype)
    return {**params, "features_rest": rest * band[None, :, None]}


def learning_rates(
    step: torch.Tensor,
    total: int,
    lr_xyz: float = 1.6e-4,
    lr_features_dc: float = 2.5e-3,
    lr_features_rest: float = 2.5e-3 / 20.0,
    lr_scales: float = 5e-3,
    lr_rotation: float = 1e-3,
    lr_opacity: float = 2.5e-2,
    xyz_lr_floor: float = 0.01,
) -> dict:
    """Per-parameter learning rates as 0-d float32 tensors on the device of
    ``step``; xyz decays linearly to ``lr_xyz * xyz_lr_floor``."""
    f32 = torch.float32
    dev = step.device

    def scalar(v):
        return torch.tensor(v, dtype=f32, device=dev)

    t = step.to(f32) / float(total)
    xyz = lr_xyz * torch.maximum(1.0 - t, scalar(xyz_lr_floor))
    return {
        "xyz": xyz,
        "features_dc": scalar(lr_features_dc),
        "features_rest": scalar(lr_features_rest),
        "scales": scalar(lr_scales),
        "rotation": scalar(lr_rotation),
        "opacity": scalar(lr_opacity),
    }


def covariance(params, scaling_modifier: float = 1.0) -> torch.Tensor:
    """Activated 3D covariance as a 6-vector (xx, xy, xz, yy, yz, zz) [C, 6];
    ``params`` a ``GaussianParams`` or a dict keyed by ``PARAM_NAMES``."""
    p = params if isinstance(params, Mapping) else params.tensors()
    cov = transforms.build_cov3d(torch.exp(p["scales"]) * scaling_modifier, p["rotation"])
    return transforms.strip_lowerdiag(cov)
