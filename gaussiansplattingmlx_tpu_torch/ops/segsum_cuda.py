"""Per-Gaussian segment sum of the per-pair gradient rows (kernel K4).

Counterpart of the JAX package's ``ops/rasterize_pallas.py``
``_segment_reduce_pallas`` (Pallas ``_segsum_kernel``).  The backward
compositing writes one gradient row per record column, ``[16, P]``; the
gradient of Gaussian g is the sum of the columns whose gaussian id is g.

``segment_reduce`` keeps the JAX structure: one stable sort of the gaussian
ids (``num_rec`` marks columns of no gaussian and sorts to the tail) carries
the 10 live rows (``LIVE_ROWS``: row 4 repeats row 3) through the
permutation, so each Gaussian's columns form one contiguous segment, in tile
order; ``segment_sum_sorted`` then sums every segment.  Its output is
``[num_rec, 16]`` in kernel row layout, with row 4 set to row 3 and rows
11-15 zero.  No float atomics: the sums are deterministic.

``segment_sum_sorted`` dispatches on the device of its inputs: CPU tensors
take ``segment_sum_sorted_plain`` (an ``index_add_``); CUDA tensors launch
``csrc/segsum.cu`` or raise.  The kernel cuts the columns and the segment
ends into equal stretches (a merge path), so a Gaussian that covers many
tiles is summed by many warps; the wrapper allocates the stretches' carry
records, which a second kernel behind the same entry point adds up.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels

REC_DIM = 16
# Gradient rows with distinct content (rows 3 and 4 both hold d_cs).
LIVE_ROWS = (0, 1, 2, 3, 5, 6, 7, 8, 9, 10)

KERNEL = _kernels.Kernel(
    "gsplat_segsum",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)


@functools.lru_cache(maxsize=None)
def _carries_fn():
    """``gsplat_segsum_carries(cols, num_rec)``: the kernel's stretches over
    ``cols`` columns and ``num_rec`` segments, its carry records."""
    fn = _kernels.LIBRARY.cdll().gsplat_segsum_carries
    fn.argtypes = [ctypes.c_int64, ctypes.c_int32]
    fn.restype = ctypes.c_int64
    return fn


@functools.lru_cache(maxsize=None)
def _live_index(device: torch.device) -> torch.Tensor:
    """``LIVE_ROWS`` as an int64 tensor on ``device``, made once."""
    return torch.tensor(LIVE_ROWS, dtype=torch.int64, device=device)


def _check(rows_s: torch.Tensor, offsets: torch.Tensor) -> None:
    check = _kernels.check
    check(rows_s.dim() == 2 and rows_s.shape[0] == len(LIVE_ROWS)
          and rows_s.dtype == torch.float32,
          f"sorted rows must be f32 [{len(LIVE_ROWS)}, P], got "
          f"{rows_s.dtype} {tuple(rows_s.shape)}")
    check(offsets.dim() == 1 and offsets.dtype == torch.int32 and offsets.shape[0] >= 1,
          "offsets must be int32 [num_rec + 1]")
    check(offsets.device == rows_s.device, "rows and offsets on different devices")
    check(rows_s.is_contiguous() and offsets.is_contiguous(),
          "rows and offsets must be contiguous")


def _full_layout(sums: torch.Tensor) -> torch.Tensor:
    """[N, 10] live-row sums -> [N, 16] kernel row layout, row 4 = row 3."""
    out = torch.zeros((sums.shape[0], REC_DIM), dtype=sums.dtype, device=sums.device)
    out[:, list(LIVE_ROWS)] = sums
    out[:, 4] = out[:, 3]
    return out


def segment_sum_sorted_plain(rows_s: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``index_add_`` of each column into its segment's
    row, columns in order."""
    _check(rows_s, offsets)
    num_rec = offsets.shape[0] - 1
    lengths = (offsets[1:] - offsets[:-1]).long()
    used = int(offsets[-1])
    seg = torch.repeat_interleave(torch.arange(num_rec, device=rows_s.device), lengths)
    sums = torch.zeros((num_rec, rows_s.shape[0]), dtype=torch.float32, device=rows_s.device)
    sums.index_add_(0, seg, rows_s[:, :used].T)
    return _full_layout(sums)


def segment_sum_sorted(rows_s: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Live rows sorted by gaussian id [10, P] and segment bounds
    ``offsets`` [num_rec + 1] int32 (segment g = columns
    [offsets[g], offsets[g+1])) -> [num_rec, 16] sums, row 4 = row 3."""
    if rows_s.device.type == "cpu":
        return segment_sum_sorted_plain(rows_s, offsets)
    if rows_s.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted: unsupported device {rows_s.device}")
    _check(rows_s, offsets)
    num_rec = offsets.shape[0] - 1
    cols = rows_s.shape[1]
    # The merge path's steps are int32 on the card.
    _kernels.check(cols + num_rec < 2 ** 30, f"{cols} columns and {num_rec} segments: too many")
    out = torch.empty((num_rec, REC_DIM), dtype=torch.float32, device=rows_s.device)
    if num_rec == 0:
        return out
    with torch.cuda.device(rows_s.device):
        carries = _carries_fn()(cols, num_rec)
        # A record: the segment open at the stretch's end, its sum there and
        # the stretch's part of its first segment.
        carry_seg = torch.empty(carries, dtype=torch.int32, device=rows_s.device)
        carry_sum = torch.empty((carries, 2 * len(LIVE_ROWS)), dtype=torch.float32,
                                device=rows_s.device)
        KERNEL.launch(rows_s.data_ptr(), cols, offsets.data_ptr(), num_rec, out.data_ptr(),
                      carry_seg.data_ptr(), carry_sum.data_ptr(), _kernels.stream_of(rows_s))
    return out


def sort_by_gid(g_cm: torch.Tensor, gid: torch.Tensor, num_rec: int):
    """One stable sort of the gaussian ids carrying the live rows: returns
    (rows_s [10, P] contiguous, offsets [num_rec + 1] int32)."""
    _kernels.check(g_cm.dim() == 2 and g_cm.shape[0] == REC_DIM
                   and gid.shape == (g_cm.shape[1],) and gid.dtype == torch.int32,
                   f"need rows [16, P] and int32 gid [P], got {tuple(g_cm.shape)} "
                   f"and {gid.dtype} {tuple(gid.shape)}")
    key = torch.clamp(gid, max=num_rec)
    gid_s, perm = torch.sort(key, stable=True)
    # The live rows, then their columns through the permutation: on the
    # card two gathers take less time than one two-index gather of the same
    # bits (chip_smoke.py times both).
    rows_s = g_cm[_live_index(g_cm.device)][:, perm]
    bounds = torch.arange(num_rec + 1, dtype=torch.int32, device=gid.device)
    offsets = torch.searchsorted(gid_s, bounds, side="left").to(torch.int32)
    return rows_s, offsets


def segment_reduce(g_cm: torch.Tensor, gid: torch.Tensor, num_rec: int) -> torch.Tensor:
    """[16, P] per-column gradient rows + [P] int32 gaussian ids ->
    [num_rec, 16] per-Gaussian sums (row 4 = row 3)."""
    rows_s, offsets = sort_by_gid(g_cm, gid, num_rec)
    return segment_sum_sorted(rows_s, offsets)
