// K5: pair-slot -> owner rank (the merge without the table gather).
//
// Replaces gaussiansplattingmlx_tpu/ops/merge_pallas.py `_merge_kernel`
// (launched by `merge_ranks`).  For every pair slot p in [0, max_pairs):
//
//     rank[p] = #{ j : cum[j] <= p }   (upper bound in the compacted cumsum)
//
// `cum` is nondecreasing, so rank is one binary search, K2's
// (merge_search.cuh).  The TPU kernel counted a blocked (slots x 640-entry
// window) compare with an MXU contraction because Mosaic wants lane-aligned
// windows; here each thread owns one slot and searches `cum`.  Integer
// compares only: bit-exact by construction.
//
// Bound: DRAM writes of 4 * max_pairs bytes plus one read of cum.  Writes
// are coalesced along p; the ~log2(n) dependent L2 loads of each search set
// the time in practice (a block-shared window of `cum`, as the TPU kernel
// used, is the next step).
#include <cstdint>
#include <cuda_runtime.h>

#include "merge_search.cuh"

namespace {

__global__ void merge_ranks_kernel(const int32_t* __restrict__ cum, int32_t n,
                                   int32_t* __restrict__ rank, int32_t max_pairs) {
    const int32_t p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= max_pairs) return;
    rank[p] = merge_rank(cum, n, p);
}

}  // namespace

extern "C" int gsplat_merge_ranks(const int32_t* cum, int32_t n, int32_t* rank,
                                  int32_t max_pairs, void* stream) {
    constexpr int kThreads = 256;
    const int blocks = (max_pairs + kThreads - 1) / kThreads;
    merge_ranks_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cum, n, rank, max_pairs);
    return static_cast<int>(cudaGetLastError());
}
