// K2: fused pair-slot -> owner merge and table-column gather.
//
// Replaces gaussiansplattingmlx_tpu/ops/merge_pallas.py `_merge_gather_kernel`
// (launched by `merge_gather`).  For every pair slot p in [0, max_pairs):
//
//     rank(p)   = #{ j : cum[j] <= p }   (upper bound in the compacted cumsum)
//     out[r, p] = rank < n ? table[r, rank] : 0          for r < rows
//
// `cum` is nondecreasing (strictly increasing below the saturation clamp, pads
// above every slot), so rank is one binary search (merge_search.cuh).  The
// TPU kernel found the rank with a blocked compare and selected the column
// with a one-hot MXU contraction, both forced by Mosaic's alignment rules;
// here each thread owns one slot, searches `cum` (n * 4 B, small enough to
// stay in the 50 MB L2) and copies its column.  The selection is a copy, so
// the output is bit-exact by construction.
//
// Bound: DRAM writes of rows * max_pairs * 4 B per call.  Writes are
// coalesced along p; the table reads of neighbouring slots hit the same or
// adjacent columns.  No alignment is assumed on n or max_pairs.
#include <cstdint>
#include <cuda_runtime.h>

#include "merge_search.cuh"

namespace {

__global__ void merge_gather_kernel(const int32_t* __restrict__ cum, int32_t n,
                                    const float* __restrict__ table, int32_t rows,
                                    float* __restrict__ out, int32_t max_pairs) {
    const int32_t p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= max_pairs) return;
    const int32_t rank = merge_rank(cum, n, p);
    if (rank < n) {
        for (int32_t r = 0; r < rows; ++r)
            out[static_cast<int64_t>(r) * max_pairs + p] =
                table[static_cast<int64_t>(r) * n + rank];
    } else {
        for (int32_t r = 0; r < rows; ++r)
            out[static_cast<int64_t>(r) * max_pairs + p] = 0.0f;
    }
}

}  // namespace

extern "C" int gsplat_merge_gather(const int32_t* cum, int32_t n, const float* table,
                                   int32_t rows, float* out, int32_t max_pairs,
                                   void* stream) {
    constexpr int kThreads = 256;
    const int blocks = (max_pairs + kThreads - 1) / kThreads;
    merge_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cum, n, table, rows, out, max_pairs);
    return static_cast<int>(cudaGetLastError());
}
