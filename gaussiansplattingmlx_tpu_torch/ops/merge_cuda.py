"""Pair-slot -> owner merge: fused with the table gather (kernel K2) and
alone (kernel K5).

Counterpart of the JAX package's ``ops/merge_pallas.py`` (``merge_gather``,
Pallas ``_merge_gather_kernel``; ``merge_ranks``, Pallas ``_merge_kernel``).
For every pair slot p in [0, max_pairs), rank(p) = #{j : cum[j] <= p} over
the compacted inclusive footprint cumsum.  ``merge_ranks`` returns the ranks;
``merge_gather`` returns column ``table[:, rank(p)]`` for every slot, zeros
where rank == n.

Both dispatch on the device of their inputs: CPU tensors take
``merge_ranks_plain`` / ``merge_gather_plain``; CUDA tensors launch
``csrc/merge_ranks.cu`` / ``csrc/merge_gather.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

# Table height of the payload-carriage staging: 6 head rows + 11 record rows,
# zero-padded to 24 (the JAX package's layout, kept for bit-equal buffers).
TBL_ROWS = 24
# Gaussian ids and slot indices ride as f32 values: exact up to 2^24.
F32_EXACT = 2 ** 24
# Slots per block of K5 (kBlockSlots in csrc/merge_ranks.cu): the tests
# place owner windows at its block edges.
RANKS_BLOCK_SLOTS = 2048

KERNEL = _kernels.Kernel(
    "gsplat_merge_gather",
    [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
     ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p],
)
RANKS_KERNEL = _kernels.Kernel(
    "gsplat_merge_ranks",
    [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p],
)


def _check_cum(cum: torch.Tensor, max_pairs: int) -> None:
    check = _kernels.check
    check(cum.dim() == 1 and cum.dtype == torch.int32, "cum must be 1-D int32")
    check(cum.is_contiguous(), "cum must be contiguous")
    check(0 < max_pairs < 2 ** 31, "need 0 < max_pairs < 2^31")


def merge_ranks_plain(cum: torch.Tensor, max_pairs: int) -> torch.Tensor:
    """Plain torch version of K5: searchsorted(right=True) of every slot."""
    _check_cum(cum, max_pairs)
    p = torch.arange(max_pairs, dtype=torch.int32, device=cum.device)
    return torch.searchsorted(cum, p, right=True).to(torch.int32)


def merge_ranks(cum: torch.Tensor, max_pairs: int) -> torch.Tensor:
    """int32 cum [n] (nondecreasing) -> int32 rank [max_pairs], rank(p) =
    #{j : cum[j] <= p}; n where no entry exceeds p."""
    if cum.device.type == "cpu":
        return merge_ranks_plain(cum, max_pairs)
    if cum.device.type != "cuda":
        raise ValueError(f"merge_ranks: unsupported device {cum.device}")
    _check_cum(cum, max_pairs)
    rank = torch.empty((max_pairs,), dtype=torch.int32, device=cum.device)
    with torch.cuda.device(cum.device):
        RANKS_KERNEL.launch(cum.data_ptr(), cum.shape[0], rank.data_ptr(), max_pairs,
                            _kernels.stream_of(cum))
    return rank


def _check(cum: torch.Tensor, table_cm: torch.Tensor, max_pairs: int) -> None:
    check = _kernels.check
    _check_cum(cum, max_pairs)
    n = cum.shape[0]
    check(table_cm.dim() == 2 and table_cm.shape[1] == n,
          f"table must be [R, {n}], got {tuple(table_cm.shape)}")
    check(table_cm.dtype == torch.float32, "table must be float32")
    check(table_cm.device == cum.device, "cum and table on different devices")
    check(table_cm.is_contiguous(), "table must be contiguous")
    check(max_pairs <= F32_EXACT and n <= F32_EXACT,
          "f32-exact value carriage needs max_pairs, n <= 2^24")


def merge_gather_plain(cum: torch.Tensor, table_cm: torch.Tensor,
                       max_pairs: int) -> torch.Tensor:
    """Plain torch version: the ranks (``merge_ranks_plain``), then a column
    gather from the table with one appended zero column."""
    _check(cum, table_cm, max_pairs)
    rank = merge_ranks_plain(cum, max_pairs)
    zero = torch.zeros((table_cm.shape[0], 1), dtype=table_cm.dtype,
                       device=table_cm.device)
    return torch.cat([table_cm, zero], dim=1)[:, rank]


def merge_gather(cum: torch.Tensor, table_cm: torch.Tensor,
                 max_pairs: int) -> torch.Tensor:
    """[R, n] table, int32 cum [n] -> [R, max_pairs] (see module docstring).

    ``cum`` must be nondecreasing, strictly increasing below the saturation
    clamp (binning compacts zero-footprint gaussians first)."""
    if cum.device.type == "cpu":
        return merge_gather_plain(cum, table_cm, max_pairs)
    if cum.device.type != "cuda":
        raise ValueError(f"merge_gather: unsupported device {cum.device}")
    _check(cum, table_cm, max_pairs)
    rows, n = table_cm.shape
    out = torch.empty((rows, max_pairs), dtype=torch.float32, device=cum.device)
    with torch.cuda.device(cum.device):
        KERNEL.launch(cum.data_ptr(), n, table_cm.data_ptr(), rows,
                      out.data_ptr(), max_pairs, _kernels.stream_of(cum))
    return out
