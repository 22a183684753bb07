// K2's (merge_gather.cu) pair-slot -> owner search: rank(p) = #{ j : cum[j]
// <= p }, the upper bound of p in the nondecreasing compacted cumsum `cum`
// [n], by binary search, one per slot (~log2(n) dependent loads).  Integer
// compares only, so the rank is exact.  `cum` (n * 4 B) stays in the 50 MB
// L2, and neighbouring slots walk the same search path.  K5 (merge_ranks.cu)
// searches a block-shared window of `cum` instead, the design K2 would take
// next.
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

}  // namespace
