// K5: pair-slot -> owner rank (the merge without the table gather).
//
// Replaces gaussiansplattingmlx_tpu/ops/merge_pallas.py `_merge_kernel`
// (launched by `merge_ranks`).  For every pair slot p in [0, max_pairs):
//
//     rank[p] = #{ j : cum[j] <= p }   (upper bound in the compacted cumsum)
//
// `cum` is nondecreasing.  Each block takes kBlockSlots = 2048 consecutive
// slots [p0, p1]: 256 threads with 8 slots each, slot p0 + i + 256 k for
// thread i, so every store is coalesced.  The ranks of those slots lie in
// [lo, hi], lo = rank(p0) and hi = rank(p1), hence
//
//     rank(p) = lo + #{ j in [lo, hi) : cum[j] <= p }.
//
// Warps 0 and 1 find lo and hi, each by a 32-way search of `cum` (every lane
// probes one of 32 points of the remaining range; ~log32(n) dependent L2
// loads where a binary search makes ~log2(n)).  The block then loads the
// window cum[lo, hi) into shared memory, coalesced, and each slot counts its
// entries there by a 12-step binary search.  Below the saturation clamp
// `cum` is strictly increasing (what binning produces, and the JAX kernel's
// contract), so the window holds at most kBlockSlots - 1 entries: the JAX
// kernel's own argument that a block of B slots has at most B owners
// (merge_pallas.py:10-15).  For any other nondecreasing `cum` (repeated
// values below the clamp) the block walks the longer window in pieces of
// kBlockSlots entries.  The windows of the blocks do not overlap, so `cum`
// is read about once.  Integer compares only: bit-exact by construction.
//
// Bound: DRAM writes of 4 * max_pairs bytes plus one read of cum.  What
// remains above it is the two searches' latency at the start of each block,
// which the other resident blocks hide.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;                       // slots per thread
constexpr int kBlockSlots = kThreads * kSlots;  // slots per block, and window piece
constexpr unsigned kFull = 0xffffffffu;

// rank(p) by the 32 lanes of a warp together: each step every lane probes
// one of 32 evenly spaced entries of the range [lo, hi) that holds the
// answer; the lanes whose entry is <= p are a prefix (cum is nondecreasing),
// so their count c narrows the range to the gap between probes c - 1 and c.
__device__ __forceinline__ int32_t warp_rank(const int32_t* __restrict__ cum, int32_t n,
                                             int32_t p, int lane) {
    int32_t lo = 0, hi = n;
    while (lo < hi) {
        const int32_t probe =
            lo + static_cast<int32_t>(static_cast<int64_t>(hi - lo) * lane / 32);
        const int c = __popc(__ballot_sync(kFull, cum[probe] <= p));
        const int32_t below = __shfl_sync(kFull, probe, (c + 31) & 31);  // lane c - 1
        const int32_t above = __shfl_sync(kFull, probe, c & 31);         // lane c
        if (c > 0) lo = below + 1;
        if (c < 32) hi = above;
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_ranks_kernel(const int32_t* __restrict__ cum, int32_t n, int32_t* __restrict__ rank,
                   int32_t max_pairs) {
    __shared__ int32_t s_cum[kBlockSlots];
    __shared__ int32_t s_range[2];
    const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
    const int32_t p0 = blockIdx.x * kBlockSlots;
    const int32_t last = min(max_pairs - p0, kBlockSlots) - 1;  // slots p0 .. p0 + last
    if (warp < 2) {
        const int32_t r = warp_rank(cum, n, p0 + (warp == 0 ? 0 : last), lane);
        if (lane == 0) s_range[warp] = r;
    }
    __syncthreads();
    const int32_t lo = s_range[0], hi = s_range[1];

    int32_t p[kSlots], r[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
        p[k] = p0 + min(i + k * kThreads, last);
        r[k] = lo;
    }
    for (int32_t base = lo; base < hi; base += kBlockSlots) {
        const int32_t w = min(hi - base, static_cast<int32_t>(kBlockSlots));
        if (base > lo) __syncthreads();  // every slot is done with the last piece
        for (int32_t j = i; j < w; j += kThreads) s_cum[j] = cum[base + j];
        __syncthreads();
        int32_t pos[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) pos[k] = 0;
#pragma unroll
        for (int step = kBlockSlots; step > 0; step >>= 1) {
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
                const int32_t next = pos[k] + step;
                if (next <= w && s_cum[next - 1] <= p[k]) pos[k] = next;
            }
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k) r[k] += pos[k];
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
        if (i + k * kThreads <= last) rank[p[k]] = r[k];
    }
}

}  // namespace

extern "C" int gsplat_merge_ranks(const int32_t* cum, int32_t n, int32_t* rank,
                                  int32_t max_pairs, void* stream) {
    const int blocks =
        static_cast<int>((static_cast<int64_t>(max_pairs) + kBlockSlots - 1) / kBlockSlots);
    merge_ranks_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cum, n, rank, max_pairs);
    return static_cast<int>(cudaGetLastError());
}
