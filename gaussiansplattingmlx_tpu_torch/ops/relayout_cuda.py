"""Sorted pair records -> the chunk-aligned per-tile layout (kernel K6).

Counterpart of the JAX package's ``ops/staging.py`` ``_relayout_pallas``
(Pallas ``_relayout_kernel``).  Aligned chunk c (``chunk`` columns) belongs
to tile ``owner[c]`` and holds that tile's sorted records from within-tile
rank ``rank0[c]`` (``rasterize_cuda.aligned_chunk_plan``; the plain
version's per-slot form is ``rasterize_cuda.aligned_slots``):

    nvalid = clip(tile_count[o] - rank0[c], 0, chunk),  o = owner[c]
    out[r, c * chunk + j] = in[r, tile_start[o] + rank0[c] + j]  (j < nvalid)

and exact zeros elsewhere, in all 16 output rows (input rows past
``in.shape[0]`` are zero too).  Row 11 of the staged input carries the
gaussian id as an exact float value, which the copy moves bit for bit.

``relayout`` dispatches on the device of its inputs: CPU tensors take
``relayout_plain``; CUDA tensors launch ``csrc/relayout.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels, rasterize_cuda

REC_DIM = 16

KERNEL = _kernels.Kernel(
    "gsplat_relayout",
    [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p],
)


def _check(sorted_cm, tile_start, tile_count, owner, rank0, chunk, num_aligned):
    check = _kernels.check
    check(sorted_cm.dim() == 2 and 0 < sorted_cm.shape[0] <= REC_DIM
          and sorted_cm.dtype == torch.float32 and sorted_cm.is_contiguous(),
          f"sorted records must be contiguous f32 [<= {REC_DIM}, P], got "
          f"{sorted_cm.dtype} {tuple(sorted_cm.shape)}")
    check(chunk > 0 and num_aligned % chunk == 0,
          f"num_aligned {num_aligned} must be a multiple of chunk {chunk}")
    nchunks = num_aligned // chunk
    for name, x, n in (("tile_start", tile_start, tile_count.shape[0]),
                       ("tile_count", tile_count, tile_count.shape[0]),
                       ("owner", owner, nchunks), ("rank0", rank0, nchunks)):
        check(x.dtype == torch.int32 and tuple(x.shape) == (n,) and x.is_contiguous(),
              f"{name} must be contiguous int32 [{n}], got {x.dtype} {tuple(x.shape)}")
        check(x.device == sorted_cm.device, f"{name} on another device")


def relayout_plain(sorted_cm, tile_start, tile_count, owner, rank0, chunk: int,
                   num_aligned: int) -> torch.Tensor:
    """Plain torch version of K6: the per-slot column gather."""
    _check(sorted_cm, tile_start, tile_count, owner, rank0, chunk, num_aligned)
    src, within = rasterize_cuda.aligned_slots(tile_start, tile_count, owner, rank0, chunk)
    out = torch.zeros((REC_DIM, num_aligned), dtype=torch.float32, device=sorted_cm.device)
    out[:sorted_cm.shape[0]] = torch.where(within, sorted_cm[:, src], 0.0)
    return out


def relayout(sorted_cm, tile_start, tile_count, owner, rank0, chunk: int,
             num_aligned: int) -> torch.Tensor:
    """Sorted records [rows <= 16, P] -> chunk-aligned records [16,
    num_aligned]."""
    if sorted_cm.device.type == "cpu":
        return relayout_plain(sorted_cm, tile_start, tile_count, owner, rank0, chunk,
                              num_aligned)
    if sorted_cm.device.type != "cuda":
        raise ValueError(f"relayout: unsupported device {sorted_cm.device}")
    _check(sorted_cm, tile_start, tile_count, owner, rank0, chunk, num_aligned)
    out = torch.empty((REC_DIM, num_aligned), dtype=torch.float32, device=sorted_cm.device)
    with torch.cuda.device(sorted_cm.device):
        KERNEL.launch(sorted_cm.data_ptr(), sorted_cm.shape[0], sorted_cm.shape[1],
                      tile_start.data_ptr(), tile_count.data_ptr(), owner.data_ptr(),
                      rank0.data_ptr(), chunk, out.data_ptr(), num_aligned,
                      _kernels.stream_of(sorted_cm))
    return out
