"""Adam as the JAX package's ``train/optimizer.py`` writes it (the MLX update
rule), by hand: ``torch.optim.Adam`` always applies bias correction.

    m <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g^2
    p <- p - lr m / (sqrt(v) + eps)                (eps = 1e-15)

with one learning rate per parameter.  ``bias_correction=True`` divides m
and v by (1 - b^count) first.  The update is in place: parameters, m and v
are overwritten, and nothing of the step is recorded by autograd.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AdamState:
    m: dict  # name -> tensor like the parameter
    v: dict
    count: torch.Tensor  # [] int32 (read only with bias correction)


def init(params: dict) -> AdamState:
    """Zero moments for a dict of parameter tensors."""
    dev = next(iter(params.values())).device
    return AdamState(
        m={n: torch.zeros_like(p) for n, p in params.items()},
        v={n: torch.zeros_like(p) for n, p in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


@torch.no_grad()
def update(params: dict, grads: dict, state: AdamState, lrs: dict,
           beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-15,
           bias_correction: bool = False) -> None:
    """One Adam step over the dicts ``params``/``grads``/``lrs`` (0-d
    tensors), in place."""
    state.count += 1
    c = state.count.to(torch.float32)
    for name, p in params.items():
        g = grads[name]
        m, v = state.m[name], state.v[name]
        m.mul_(beta1).add_((1.0 - beta1) * g)
        v.mul_(beta2).add_((1.0 - beta2) * (g * g))
        if bias_correction:
            mhat = m / (1.0 - beta1 ** c)
            vhat = v / (1.0 - beta2 ** c)
        else:
            mhat, vhat = m, v
        p.sub_(lrs[name] * mhat / (torch.sqrt(vhat) + eps))
