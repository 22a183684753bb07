// K2's (merge_gather.cu) pair-slot -> owner search: rank(p) = #{ j : cum[j]
// <= p }, the upper bound of p in the nondecreasing compacted cumsum `cum`
// [n], by binary search, one per slot (~log2(n) dependent loads).  Integer
// compares only, so the rank is exact.  `cum` (n * 4 B) stays in the 50 MB
// L2, and neighbouring slots walk the same search path.  K5 (merge_ranks.cu)
// searches a block-shared window of `cum` instead, the design K2 would take
// next.  K4 (segsum.cu) finds where a warp's stretch of a segment sum's
// merge path starts with `warp_path_ends`, below.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ int32_t merge_rank(const int32_t* __restrict__ cum, int32_t n,
                                              int32_t p) {
    int32_t lo = 0, hi = n;
    while (lo < hi) {
        const int32_t mid = lo + ((hi - lo) >> 1);
        if (cum[mid] <= p) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// The merge path of a segment sum over CSR bounds `offsets` [n + 1]
// (Merrill & Garland, SC'16): the path takes the used columns 0 ..
// offsets[n] - 1 and the n segment ends in order, the end of segment k right
// after its last column, at path step offsets[k + 1] + k.  Returns how many
// segment ends lie among the first d steps, #{ k < n : offsets[k + 1] + k <
// d } (so d minus that many columns), found by the 32 lanes of a warp
// together: each step every lane probes one of 32 evenly spaced ends of the
// range [lo, hi) that holds the answer; the path steps of the ends increase,
// so the lanes whose end comes before step d are a prefix, and their count c
// narrows the range to the gap between probes c - 1 and c: ~log32(hi - lo)
// dependent loads where a binary search makes ~log2(hi - lo).  [lo, hi]
// must hold the answer ([0, n] always does).  Integer compares only; every
// lane returns the same count.  Needs offsets[n] + n < 2^31.
__device__ __forceinline__ int32_t warp_path_ends(const int32_t* __restrict__ offsets,
                                                  int32_t lo, int32_t hi, int32_t d, int lane) {
    constexpr unsigned kAll = 0xffffffffu;
    while (lo < hi) {
        const int32_t probe =
            lo + static_cast<int32_t>(static_cast<int64_t>(hi - lo) * lane / 32);
        const int c = __popc(__ballot_sync(kAll, offsets[probe + 1] + probe < d));
        const int32_t below = __shfl_sync(kAll, probe, (c + 31) & 31);  // lane c - 1
        const int32_t above = __shfl_sync(kAll, probe, c & 31);         // lane c
        if (c > 0) lo = below + 1;
        if (c < 32) hi = above;
    }
    return lo;
}

}  // namespace
