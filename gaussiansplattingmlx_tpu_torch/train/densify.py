"""Fixed-capacity densify (split/clone) and prune (torch counterpart of the
JAX package's ``train/densify.py``).

Every ``interval`` iterations within [from_iter, until_iter]:

  prune  if sigmoid(opacity) < min_opacity (or a row is not finite, or one
         of the optional world-scale, near-camera and needle rules holds)
                                                            -> 0 outputs
  split  if avg |grad_xyz| > grad_threshold and max(exp(scale)) > max_scale
                                                            -> 2 outputs
  clone  if avg |grad_xyz| > grad_threshold otherwise       -> 2 outputs
  keep   otherwise                                          -> 1 output

  split children: scales -= log(1.6); xyz +- mean(exp(src_scale)) * 0.1 * noise
  clone copy:     xyz += 0.01 * noise

All of it runs in the [capacity]-shaped buffers (classify, exclusive cumsum
of the output counts, a gather map built by index writes to unique slots,
one gather), with no host sync.  If the densified total would exceed the
capacity, densification is off for that round (keep and prune only); the
trainer grows the capacity between rounds.

``noise`` is the [capacity, 3] standard-normal draw that the JAX package
makes inside its function from a PRNG key; here the caller passes it
(``Trainer.densify_noise`` draws JAX's stream through ``utils/prng.py``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..models.gaussians import INACTIVE_OPACITY, PARAM_NAMES


class DensifyStats(NamedTuple):
    num_active: torch.Tensor  # [] int32 new live count
    n_keep: torch.Tensor
    n_split: torch.Tensor
    n_clone: torch.Tensor
    n_prune: torch.Tensor
    densify_enabled: torch.Tensor  # [] bool (False if capacity would overflow)


def _f32_log(x: float) -> float:
    """log(x) rounded as a float32 ``log`` rounds it, computed once on the
    host so that every device subtracts the same constant."""
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


@torch.no_grad()
def split_and_prune(
    params,
    num_active: torch.Tensor,
    grad_accum: torch.Tensor,  # [capacity] summed |grad_xyz|
    grad_denom: torch.Tensor,  # [] float accumulation count
    noise: torch.Tensor,  # [capacity, 3] float32 standard normal
    *,
    allow_densify: bool = True,
    grad_threshold: float = 2e-4,
    max_scale: float = 0.01,
    min_opacity: float = 5e-3,
    split_scale_div: float = 1.6,
    split_noise_factor: float = 0.1,
    clone_noise_std: float = 0.01,
    max_gaussians: int = 1_000_000,
    prune_world_scale: float = 0.0,
    prune_near_cameras: float = 0.0,
    camera_centers: torch.Tensor | None = None,  # [V, 3], needed if above > 0
    prune_needle_ratio: float = 0.0,
):
    """Classify, then gather the surviving and new rows to the front.

    ``params`` is a ``GaussianParams`` or a dict keyed by ``PARAM_NAMES``.
    Returns (dict of new parameter tensors, DensifyStats, gather_idx [cap]
    int32 source row of each slot, noise_mode [cap] int32: 0 keep or clone
    original, 1 split +, 2 split -, 3 clone copy).  Dead slots gather row 0
    with mode 0 and take opacity ``INACTIVE_OPACITY``."""
    p = params if isinstance(params, Mapping) else params.tensors()
    xyz, scales, opacity = p["xyz"], p["scales"], p["opacity"]
    cap = xyz.shape[0]
    dev = xyz.device
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    active = slot < num_active

    avg_grad = torch.where(grad_denom > 0,
                           grad_accum / torch.clamp_min(grad_denom, 1.0), 0.0)
    op_val = torch.sigmoid(opacity[:, 0])
    max_scale_val = torch.max(torch.exp(scales), dim=1).values

    allow = (num_active < max_gaussians) & bool(allow_densify)

    prune = active & (op_val < min_opacity)
    # Non-finite rows never recover and evade every comparison above (NaN
    # compares false): cull them unconditionally.
    finite = torch.isfinite(op_val)
    for name in ("xyz", "scales", "rotation", "features_dc", "features_rest"):
        finite &= torch.isfinite(p[name]).flatten(1).all(dim=1)
    prune |= active & ~finite
    if prune_world_scale > 0:
        prune |= active & (max_scale_val > prune_world_scale)
    if prune_near_cameras > 0:
        if camera_centers is None:
            raise ValueError("prune_near_cameras > 0 needs camera_centers")
        # |x - c|^2 = |x|^2 + |c|^2 - 2 x.c as one [N, V] product, as the JAX
        # package computes it; only the sign of d2 - r^2 matters, and it must
        # not depend on the device: the product runs in full float32.
        xx = torch.sum(xyz * xyz, dim=1, keepdim=True)
        cc = torch.sum(camera_centers * camera_centers, dim=1)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            xc = xyz @ camera_centers.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        d2 = xx + cc[None, :] - 2.0 * xc
        near = torch.min(d2, dim=1).values < prune_near_cameras ** 2
        prune |= active & near
    if prune_needle_ratio > 0:
        s_sorted = torch.sort(torch.exp(scales), dim=1).values  # ascending
        needle = s_sorted[:, 2] > prune_needle_ratio * torch.clamp_min(s_sorted[:, 1], 1e-12)
        prune |= active & needle
    grow = active & ~prune & allow & (avg_grad > grad_threshold)
    split = grow & (max_scale_val > max_scale)
    clone = grow & ~split
    keep = active & ~(prune | grow)

    i32 = torch.int32
    counts_densify = keep.to(i32) + 2 * (split | clone).to(i32)
    counts_plain = (active & ~prune).to(i32)
    # Capacity guard: keep/prune only when the densified result won't fit.
    densify_ok = torch.sum(counts_densify) <= cap
    counts = torch.where(densify_ok, counts_densify, counts_plain)
    split &= densify_ok
    clone &= densify_ok

    offsets = torch.cumsum(counts, 0, dtype=i32) - counts
    total = torch.sum(counts, dtype=i32)

    # The gather map, by index writes to unique slots; rows that write
    # nothing aim at slot ``cap`` of a [cap + 1] buffer, which is dropped.
    gather_idx = torch.zeros((cap + 1,), dtype=i32, device=dev)
    noise_mode = torch.zeros((cap + 1,), dtype=i32, device=dev)
    pos1 = torch.where(counts >= 1, offsets, cap).long()
    gather_idx[pos1] = slot
    noise_mode[pos1] = split.to(i32)
    pos2 = torch.where(counts >= 2, offsets + 1, cap).long()
    gather_idx[pos2] = slot
    noise_mode[pos2] = torch.where(split, 2, 3).to(i32)
    gather_idx, noise_mode = gather_idx[:cap], noise_mode[:cap]

    src = gather_idx.long()
    new = {n: p[n].detach()[src] for n in PARAM_NAMES}

    is_split_child = (noise_mode == 1) | (noise_mode == 2)
    # /split_scale_div in linear space = -log(split_scale_div) in log space.
    new["scales"] = new["scales"] - torch.where(
        is_split_child, _f32_log(split_scale_div), 0.0)[:, None]

    f32 = torch.float32
    src_scale_mean = torch.sum(torch.exp(scales.detach()[src]), dim=1, keepdim=True) / 3.0
    split_sign = (noise_mode == 1).to(f32) - (noise_mode == 2).to(f32)
    split_noise = split_sign[:, None] * src_scale_mean * split_noise_factor * noise
    clone_noise = torch.where(noise_mode == 3, clone_noise_std, 0.0)[:, None] * noise
    new["xyz"] = new["xyz"] + split_noise + clone_noise

    # Dead slots can never render.
    out_active = slot < total
    new["opacity"] = torch.where(out_active[:, None], new["opacity"], INACTIVE_OPACITY)

    stats = DensifyStats(
        num_active=total,
        n_keep=torch.sum(keep, dtype=i32),
        n_split=torch.sum(split, dtype=i32),
        n_clone=torch.sum(clone, dtype=i32),
        n_prune=torch.sum(prune, dtype=i32),
        densify_enabled=densify_ok,
    )
    return new, stats, gather_idx, noise_mode


@torch.no_grad()
def reset_opacity(opacity: torch.Tensor, num_active: torch.Tensor,
                  reset_value: float = 0.01) -> torch.Tensor:
    """INRIA-style opacity reset: live rows' opacity logits clamped to
    ``logit(reset_value)``; more transparent rows and inactive slots keep
    theirs.  Returns the new [capacity, 1] opacity."""
    logit = float(np.log(reset_value) - np.log1p(-reset_value))
    active = torch.arange(opacity.shape[0], device=opacity.device) < num_active
    return torch.where(active[:, None], torch.clamp_max(opacity, logit), opacity)


@torch.no_grad()
def remap_optimizer_moments(moments: dict, gather_idx: torch.Tensor,
                            noise_mode: torch.Tensor) -> dict:
    """Adam moments (a dict of tensors) gathered along the densify map, the
    rows of newly created Gaussians zeroed (dead slots carry row 0's)."""
    fresh = noise_mode != 0
    src = gather_idx.long()

    def remap(x):
        g = x[src]
        return torch.where(fresh.reshape((-1,) + (1,) * (g.dim() - 1)), 0.0, g)

    return {n: remap(x) for n, x in moments.items()}
