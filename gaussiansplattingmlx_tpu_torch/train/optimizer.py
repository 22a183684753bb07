"""Adam as the JAX package's ``train/optimizer.py`` writes it (the MLX update
rule), by hand: ``torch.optim.Adam`` always applies bias correction.

    m <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g^2
    p <- p - lr m / (sqrt(v) + eps)                (eps = 1e-15)

with one learning rate per parameter.  ``bias_correction=True`` divides m
and v by (1 - b^count) first.  The update is in place: parameters, m and v
are overwritten, and nothing of the step is recorded by autograd.

``update`` dispatches on the parameters' device: CPU tensors take
``update_plain``, the rule in plain torch ops; CUDA tensors take one launch
of ``csrc/adam.cu`` over every leaf, which gives the plain rule's bits on
the card, or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..ops import _kernels

# ctypes: count, per-leaf pointers (p, m, v, g, lr), per-leaf sizes (n,
# width, g_stride), constants (b1, b2, c1, c2, eps), d1, d2, stream.
KERNEL = _kernels.Kernel(
    "gsplat_adam_update",
    [ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
     ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
MAX_LEAVES = 8  # csrc/adam.cu kMaxLeaves: the launch's table


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
    tensors), in place: ``update_plain`` for CPU tensors, the kernel for
    CUDA tensors."""
    dev = next(iter(params.values())).device
    if dev.type == "cpu":
        update_plain(params, grads, state, lrs, beta1, beta2, eps, bias_correction)
    elif dev.type == "cuda":
        update_cuda(params, grads, state, lrs, beta1, beta2, eps, bias_correction)
    else:
        raise ValueError(f"adam update: unsupported device {dev}")


@torch.no_grad()
def update_plain(params: dict, grads: dict, state: AdamState, lrs: dict,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-15,
                 bias_correction: bool = False) -> None:
    """The update rule in plain torch ops, leaf by leaf."""
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


def _leaf(name: str, p, g, m, v, lr, device):
    """(p, m, v, g as rows, lr) of one leaf as the kernel takes them, or
    raise: p, m and v contiguous float32 of one shape on ``device``; g of that
    shape, its rows' elements contiguous at any row stride (else copied); lr
    one float32 value on ``device``."""
    for what, t in (("parameter", p), ("m", m), ("v", v)):
        _kernels.check(t.dtype == torch.float32 and t.device == device and t.is_contiguous()
                       and t.shape == p.shape,
                       f"adam {name}: {what} must be contiguous float32 {tuple(p.shape)} on "
                       f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                       f"{'' if t.is_contiguous() else ', not contiguous'}")
    _kernels.check(g.dtype == torch.float32 and g.device == device and g.shape == p.shape,
                   f"adam {name}: gradient must be float32 {tuple(p.shape)} on {device}, got "
                   f"{g.dtype} {tuple(g.shape)} on {g.device}")
    rows = p.shape[0] if p.dim() else 1
    g = g.reshape(rows, p.numel() // rows if rows else 0)
    if g.shape[1] > 1 and g.stride(1) != 1:
        g = g.contiguous()
    _kernels.check(isinstance(lr, torch.Tensor),
                   f"adam {name}: learning rate must be a tensor, got {type(lr).__name__}")
    _kernels.check(lr.numel() == 1 and lr.dtype == torch.float32 and lr.device == device,
                   f"adam {name}: learning rate must be one float32 value on {device}, got "
                   f"{lr.dtype} {tuple(lr.shape)} on {lr.device}")
    return p, m, v, g, lr


def pack(leaves: list) -> tuple:
    """The kernel's per-leaf pointer and size arrays for ``_leaf`` results
    (leaves with no elements left out)."""
    live = [x for x in leaves if x[0].numel()]
    ptrs = [t.data_ptr() for p, m, v, g, lr in live for t in (p, m, v, g, lr)]
    sizes = [s for p, m, v, g, lr in live
             for s in (p.numel(), g.shape[1], g.stride(0) if g.shape[0] > 1 else g.shape[1])]
    return (len(live), (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int64 * len(sizes))(*sizes))


def constants(beta1: float, beta2: float, eps: float):
    """b1, b2, c1 = 1 - b1, c2 = 1 - b2 and eps, each computed in double and
    rounded to float32, as PyTorch rounds a Python scalar for a float32
    tensor."""
    return (ctypes.c_float * 5)(beta1, beta2, 1.0 - beta1, 1.0 - beta2, eps)


@torch.no_grad()
def update_cuda(params: dict, grads: dict, state: AdamState, lrs: dict,
                beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-15,
                bias_correction: bool = False) -> None:
    """The update rule as one launch of ``csrc/adam.cu`` over every leaf."""
    dev = next(iter(params.values())).device
    _kernels.check(len(params) <= MAX_LEAVES,
                   f"adam: {len(params)} leaves, the kernel takes at most {MAX_LEAVES}")
    leaves = [_leaf(name, p, grads[name], state.m[name], state.v[name], lrs[name], dev)
              for name, p in params.items()]
    count, ptrs, sizes = pack(leaves)
    state.count += 1
    d1 = d2 = None
    if bias_correction:
        c = state.count.to(torch.float32)
        d1, d2 = 1.0 - beta1 ** c, 1.0 - beta2 ** c
    if count:
        with torch.cuda.device(dev):
            KERNEL.launch(count, ptrs, sizes, constants(beta1, beta2, eps),
                          None if d1 is None else d1.data_ptr(),
                          None if d2 is None else d2.data_ptr(), _kernels.stream_of(leaves[0][0]))
    torch.autograd.graph.increment_version([t for x in leaves for t in x[:3]])
