"""Small math utilities (torch counterparts of the JAX package's
``utils/transforms.py``).  Quaternions are w-first and unnormalized in
parameter space."""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logit, log(x / (1 - x))."""
    return torch.log(x / (1.0 - x))


def homogeneous(points: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 4] with trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def normalize_quaternion(quat: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-normalize with the smooth sqrt(|q|^2 + eps^2) guard."""
    norm = torch.sqrt(torch.sum(quat * quat, dim=-1, keepdim=True) + eps * eps)
    return quat / norm


def quat_to_rotmat(quat: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Unnormalized w-first quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    q = normalize_quaternion(quat, eps)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def build_scaling_rotation(scales: torch.Tensor, quat: torch.Tensor,
                           eps: float = 1e-8) -> torch.Tensor:
    """L = R @ diag(s): [..., 3, 3]."""
    return quat_to_rotmat(quat, eps) * scales[..., None, :]


def build_cov3d(scales: torch.Tensor, quat: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Sigma = L @ L^T from activated scales and raw quaternion, [..., 3, 3].

    Written as an elementwise product-sum rather than a matmul, so the result
    is full float32 whatever the TF32 settings of the card."""
    L = build_scaling_rotation(scales, quat, eps)
    return torch.sum(L[..., :, None, :] * L[..., None, :, :], dim=-1)


def strip_lowerdiag(cov: torch.Tensor) -> torch.Tensor:
    """Symmetric [..., 3, 3] -> 6-vector (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Cofactor 3x3 inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


def mask_to_indices(mask: torch.Tensor, fill_value: int = -1):
    """Boolean mask -> (indices [mask.numel()] int64, count 0-d int32): the
    indices of the True entries first, in order, then ``fill_value``.  The
    shape does not depend on the mask's contents (a stable argsort, not
    ``nonzero``)."""
    mask = mask.reshape(-1)
    n = mask.shape[0]
    count = torch.sum(mask.to(torch.int32))
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    idx = torch.where(torch.arange(n, device=mask.device) < count, order,
                      torch.full((), fill_value, dtype=order.dtype, device=mask.device))
    return idx, count
