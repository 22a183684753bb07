"""Loss and metric functions (torch counterpart of the JAX package's
``ops/losses.py``)."""

from __future__ import annotations

import torch

from . import ssim as ssim_mod


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse(pred, target):
    return torch.mean((pred - target) ** 2)


l2_loss = mse


def mse2psnr(value):
    """PSNR = -10 * log10(mse)."""
    return -10.0 * torch.log10(value)


def psnr(pred, target):
    return mse2psnr(mse(pred, target))


def depth_loss(depth, target_depth, mask):
    """Masked mean absolute depth error."""
    diff = torch.abs(depth - target_depth)
    m = mask.to(torch.float32)
    weight = torch.clamp_min(torch.sum(m), 1e-6)
    return torch.sum(diff * m) / weight


def total_loss(render, target_rgb, depth, target_depth, depth_mask,
               lambda_dssim: float = 0.2, lambda_depth: float = 0.0,
               ssim_window: int = 11, ssim_sigma: float = 1.5):
    """(1 - l) * L1 + l * (1 - SSIM) + ld * depth.  Returns (loss, parts)."""
    l1 = l1_loss(render, target_rgb)
    ssim_val = ssim_mod.ssim(render, target_rgb, ssim_window, ssim_sigma)
    d = depth_loss(depth, target_depth, depth_mask)
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim_val) + lambda_depth * d
    return loss, {"l1": l1, "ssim": ssim_val, "depth": d}


def smooth_l1_ohem(pred, target, beta: float = 1.0, ohem_fraction: float = 1.0):
    """Smooth-L1 with online hard example mining: the mean of the hardest
    ``ohem_fraction`` of the per-element losses (at least one).  The top-k
    cut takes a count fixed by the input's size, as the JAX package's
    ``lax.top_k`` does."""
    diff = torch.abs(pred - target)
    per_elem = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    flat = per_elem.reshape(-1)
    if ohem_fraction >= 1.0:
        return torch.mean(flat)
    k = max(1, int(flat.shape[0] * ohem_fraction))
    return torch.mean(torch.topk(flat, k).values)
