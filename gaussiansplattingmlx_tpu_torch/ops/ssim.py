"""SSIM with an 11x11 Gaussian window (torch counterpart of the JAX
package's ``ops/ssim.py``): C1 = 1e-4, C2 = 9e-4, zero-padded boundary.

The separable blur is written as explicit shifted multiply-adds over the
taps: exact float32 on every device, with no convolution library in it
(cuDNN runs float32 convolutions in TF32 by default, and a reduced-precision
blur can push SSIM above 1).  The five blurred maps of ``ssim_map`` go
through one blur of a stacked tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def gaussian_window(window_size: int, sigma: float) -> tuple:
    """1D Gaussian taps, normalized, as float32 values."""
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _blur_axis(x: torch.Tensor, taps: tuple, axis: int) -> torch.Tensor:
    """Zero-padded 1D blur of ``x`` along ``axis``: sum_k taps[k] * x[i + k - r]."""
    r = len(taps) // 2
    n = x.shape[axis]
    pad = [0, 0] * (x.dim() - 1 - axis) + [r, r]
    xp = torch.nn.functional.pad(x, pad)
    out = taps[0] * xp.narrow(axis, 0, n)
    for k in range(1, len(taps)):
        out = out + taps[k] * xp.narrow(axis, k, n)
    return out


def blur(x: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Separable depthwise Gaussian blur of [..., H, W, C]: rows, then
    columns."""
    taps = gaussian_window(window_size, sigma)
    return _blur_axis(_blur_axis(x, taps, x.dim() - 3), taps, x.dim() - 2)


def ssim_map(img1, img2, window_size: int = 11, sigma: float = 1.5,
             c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """Per-pixel SSIM map for [H, W, C] images in [0, 1]."""
    stats = blur(torch.stack([img1, img2, img1 * img1, img2 * img2, img1 * img2]),
                 window_size, sigma)
    mu1, mu2 = stats[0], stats[1]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = stats[2] - mu1_sq
    sigma2_sq = stats[3] - mu2_sq
    sigma12 = stats[4] - mu1_mu2
    num = (2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return num / den


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM."""
    return torch.mean(ssim_map(img1, img2, window_size, sigma))
