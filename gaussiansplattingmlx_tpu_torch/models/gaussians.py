"""Gaussian parameter store (torch counterpart of the JAX package's
``models/gaussians.py``).

Parameter semantics (identical to the JAX package):
  xyz           [C, 3]    world positions (identity activation)
  features_dc   [C, 1, 3] SH degree-0 coefficients
  features_rest [C, K-1, 3] higher-order SH coefficients
  scales        [C, 3]    log-space; activation exp
  rotation      [C, 4]    unnormalized w-first quaternion; activation row-norm
  opacity       [C, 1]    logit; activation sigmoid
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..data.ply import GaussianPly

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

    def to_numpy(self) -> dict:
        return {n: getattr(self, n).detach().cpu().numpy() for n in PARAM_NAMES}


def params_from_numpy(src, device) -> GaussianParams:
    """Carry parameters given as numpy arrays (a dict keyed by
    ``PARAM_NAMES``, or a ``GaussianPly``) into the port as float32 tensors
    on ``device``."""
    if isinstance(src, GaussianPly):
        src = {n: getattr(src, n) for n in PARAM_NAMES}
    device = torch.device(device)
    return GaussianParams(
        **{
            n: torch.as_tensor(np.asarray(src[n], np.float32)).to(device)
            for n in PARAM_NAMES
        }
    )


def activations(params: GaussianParams):
    """Raw params -> render-space quantities.

    Returns (means3d, shs [C, K, 3], opacity [C, 1], scales, rotations).
    """
    means3d = params.xyz
    opacity = torch.sigmoid(params.opacity)
    scales = torch.exp(params.scales)
    rotations = params.rotation  # normalized inside the projection math
    shs = torch.cat([params.features_dc, params.features_rest], dim=1)
    return means3d, shs, opacity, scales, rotations
