// K4: per-Gaussian segment sum of the per-pair gradient rows.
//
// Replaces gaussiansplattingmlx_tpu/ops/rasterize_pallas.py `_segsum_kernel`
// (launched by `_segsum_call` from `_segment_reduce_pallas`).
//
// Input: the 10 live gradient rows already sorted by gaussian id,
// rows[10][cols] (row order 0 mx, 1 my, 2 c00, 3 cs, 4 c11, 5-7 rgb, 8 depth,
// 9 opacity), and segment bounds offsets[num_rec + 1]: Gaussian g owns the
// contiguous columns [offsets[g], offsets[g+1]).  Output out[num_rec][16] in
// kernel record layout: columns 0-3 and 5-10 are the sums, column 4 repeats
// column 3 (both conic off-diagonals receive d_cs), 11-15 are zero; a
// Gaussian with no column gets zeros.
//
// Work is balanced by columns, not by Gaussians: this is the row sum of a CSR
// matrix, split along its merge path (Merrill & Garland, "Merge-based
// parallel sparse matrix-vector multiplication", SC'16).  The path takes the
// used columns 0 .. offsets[num_rec] - 1 and the num_rec segment ends in
// order, each end right after its segment's columns.  It is cut into
// stretches of kStretch steps whatever the segment lengths: a segment longer
// than a stretch is cut among several, and an empty segment costs one step
// (zeros written, nothing loaded).  The grid is persistent, kGridBlocks
// small blocks at most: warp w takes stretches w, w + warps, ... until the
// path ends, so nothing runs for the budget's unused columns.  A block first
// samples every gap-th end's path step into shared memory; then for each of
// its stretches a warp
//  1. finds the stretch's first segment: a binary search of the sample, then
//     a 32-way search of the <= gap ends between two samples
//     (merge_search.cuh);
//  2. stages the ends that lie on the stretch in shared memory, 32 a load;
//  3. gives each lane kItems consecutive steps (its start by a binary search
//     of those ends); the lane loads its <= kItems columns of the 10 rows at
//     once, adds them in order into 10 registers, and writes every segment
//     that ends on its steps but the one it started inside;
//  4. scans the lanes' open sums by segment (inclusive, shuffles), which
//     gives each lane what the lanes before it summed into that segment;
//  5. leaves a carry record: the segment still open at the stretch's end and
//     its sum there, and, after the first stretch, the stretch's part of its
//     first segment, which an earlier stretch summed into too.
// A second kernel (programmatic dependent launch: it starts as the first one
// drains) writes each segment that crosses stretches: the carries of its run
// of stretches in stretch order, then the part of the stretch where it ends.
// The order of every add depends on the data only, not on which warp takes a
// stretch: two launches are bit-identical, with no atomics.  The TPU kernel
// summed blocks of 128 Gaussians with one-hot MXU products over their
// columns; a warp a Gaussian, this kernel's first design, left the warps of
// the longest segments walking them 32 columns a trip after the rest of the
// card was done.
//
// Bound: DRAM bytes.  Each used column's 10 floats are read once (40 B) and
// 64 B are written per Gaussian; the adds are one a float read.  What
// separates a stretch from its bytes is a chain of dependent loads (the
// search, the ends, the columns), hidden by the other warps' stretches; the
// second kernel costs a few microseconds of launch and one round of loads.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "merge_search.cuh"

namespace {

constexpr int kLive = 10;
constexpr int kOutCols = 16;
constexpr int kWarps = 2;  // warps a block: small blocks spread evenly over the SMs
constexpr int kThreads = 32 * kWarps;
// Path steps a lane: its columns of the 10 rows are held in 10 * kItems
// registers (108 a thread in all, so 9 blocks fit an SM).
constexpr int kItems = 7;
constexpr int kStretch = 32 * kItems;  // path steps a warp takes at a time
// Blocks of a launch at most: all resident on an H100 (132 SMs), so the
// grid is one wave.  A constant: the order of the adds does not depend on it.
constexpr int kGridBlocks = 1056;
constexpr int kSample = 256;  // sampled ends a block keeps
constexpr int kFixThreads = 128;
constexpr int kLookahead = 8;          // carries the fix-up reads at a time
// A stretch's carry record: the sum of the segment open at its end, then its
// part of its first segment (of a stretch after the first, where that
// segment ends).
constexpr int kCarry = 2 * kLive;
constexpr unsigned kFull = 0xffffffffu;

// out[g] = v in record layout (column 4 = column 3, 11-15 zero).
__device__ __forceinline__ void write_sum(float* __restrict__ out, int32_t g,
                                          const float (&v)[kLive]) {
    float4* o = reinterpret_cast<float4*>(out + static_cast<int64_t>(g) * kOutCols);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[3], v[4], v[5], v[6]);
    o[2] = make_float4(v[7], v[8], v[9], 0.0f);
    o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ rows, int64_t cols,
              const int32_t* __restrict__ offsets, int32_t num_rec,
              float* __restrict__ out, int32_t* __restrict__ carry_seg,
              float* __restrict__ carry_sum) {
    __shared__ int32_t s_sample[kSample];
    __shared__ int32_t s_ends_all[kWarps][kStretch];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t* s_ends = s_ends_all[warp];
    const int32_t length = offsets[num_rec] + num_rec;  // path steps
    // The path steps of ends 0, gap, 2 gap, ...: end k lies at step
    // offsets[k + 1] + k.
    const int32_t gap = (num_rec + kSample - 1) / kSample;
    const int32_t samples = (num_rec + gap - 1) / gap;
    for (int q = threadIdx.x; q < samples; q += kThreads)
        s_sample[q] = offsets[q * gap + 1] + q * gap;
    __syncthreads();

    for (int32_t s = static_cast<int32_t>(blockIdx.x) * kWarps + warp;;
         s += static_cast<int32_t>(gridDim.x) * kWarps) {
        const int32_t d0 = s * kStretch;
        if (d0 >= length) break;
        const int32_t d1 = min(d0 + kStretch, length);
        // 1. i0 = the ends before step d0, between the samples around d0.
        int32_t lo = 0, hi = samples;
        while (lo < hi) {
            const int32_t mid = (lo + hi) >> 1;
            if (s_sample[mid] < d0) lo = mid + 1; else hi = mid;
        }
        const int32_t i0 = warp_path_ends(offsets, lo > 0 ? (lo - 1) * gap + 1 : 0,
                                          lo < samples ? lo * gap : num_rec, d0, lane);
        const int32_t j0 = d0 - i0;  // the stretch's first column
        // 2. The ends on the stretch, 32 a load: end k of the stretch (of
        // segment i0 + k) lies at step offsets[i0 + k + 1] + i0 + k < d1.
        int32_t ni = 0;
        for (;;) {
            const int32_t k = ni + lane;
            const int32_t g = i0 + k;
            bool on = false;
            if (g < num_rec && k < kStretch) {
                const int32_t e = offsets[g + 1];
                on = e + g < d1;
                if (on) s_ends[k] = e;
            }
            const int c = __popc(__ballot_sync(kFull, on));
            ni += c;
            if (c < 32) break;
        }
        __syncwarp();
        // 3. The lane's steps [td, td + kItems) of the stretch's len.
        const int32_t len = d1 - d0, nc = len - ni;
        const int32_t td = min(lane * kItems, len);
        int32_t it = 0, top = ni;  // the stretch's ends among its first td steps
        while (it < top) {
            const int32_t mid = (it + top) >> 1;
            if (s_ends[mid] - j0 + mid < td) it = mid + 1; else top = mid;
        }
        int32_t col = td - it;  // the lane's first column, from j0
        float v[kItems][kLive];  // its columns, loaded at once
#pragma unroll
        for (int c = 0; c < kItems; ++c) {
            const bool in = col + c < nc;
            const float* src = rows + j0 + col + c;
#pragma unroll
            for (int r = 0; r < kLive; ++r) v[c][r] = in ? src[r * cols] : 0.0f;
        }
        int budget = min(kItems, len - td);
        float acc[kLive], first[kLive];
#pragma unroll
        for (int r = 0; r < kLive; ++r) acc[r] = first[r] = 0.0f;
        int32_t first_seg = -1;  // the segment the lane started inside, if it ends here
        // Column c of the lane comes after every end at or before it.
#define SEGSUM_ENDS_BEFORE_COLUMN                                                      \
        while (budget > 0 && it < ni && s_ends[it] - j0 <= col) {                      \
            if (first_seg < 0) {                                                       \
                first_seg = i0 + it;                                                   \
                _Pragma("unroll") for (int r = 0; r < kLive; ++r) first[r] = acc[r];  \
            } else {                                                                   \
                write_sum(out, i0 + it, acc);                                          \
            }                                                                          \
            _Pragma("unroll") for (int r = 0; r < kLive; ++r) acc[r] = 0.0f;          \
            ++it;                                                                      \
            --budget;                                                                  \
        }
#pragma unroll
        for (int c = 0; c < kItems; ++c) {
            SEGSUM_ENDS_BEFORE_COLUMN
            if (budget > 0) {
#pragma unroll
                for (int r = 0; r < kLive; ++r) acc[r] += v[c][r];
                ++col;
                --budget;
            }
        }
        SEGSUM_ENDS_BEFORE_COLUMN
#undef SEGSUM_ENDS_BEFORE_COLUMN
        // 4. Inclusive scan of the open sums by segment (the lanes' segments
        // do not decrease, so equal neighbours are one run).
        const int32_t seg = i0 + it;  // the segment open at the lane's end
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t up = __shfl_up_sync(kFull, seg, d);
#pragma unroll
            for (int r = 0; r < kLive; ++r) {
                const float x = __shfl_up_sync(kFull, acc[r], d);
                if (lane >= d && up == seg) acc[r] = x + acc[r];
            }
        }
#pragma unroll
        for (int r = 0; r < kLive; ++r) {
            const float x = __shfl_up_sync(kFull, acc[r], 1);  // the previous lane's sum
            if (first_seg >= 0 && lane > 0) first[r] = x + first[r];
        }
        if (first_seg == i0 && s > 0) {  // a stretch before summed into it too
#pragma unroll
            for (int r = 0; r < kLive; ++r)
                carry_sum[static_cast<int64_t>(s) * kCarry + kLive + r] = first[r];
        } else if (first_seg >= 0) {
            write_sum(out, first_seg, first);
        }
        // 5. The segment open at the stretch's end (i0 + ni), unless every
        // end is done.
        if (lane == 31) {
            const bool open = seg < num_rec;
            carry_seg[s] = open ? seg : -1;
            if (open) {
#pragma unroll
                for (int r = 0; r < kLive; ++r)
                    carry_sum[static_cast<int64_t>(s) * kCarry + r] = acc[r];
            }
        }
        __syncwarp();
    }
    // The fix-up may launch; it waits for this grid's writes.
    asm volatile("griddepcontrol.launch_dependents;");
}

// Each run of stretches that left a carry for one segment: the run's first
// entry writes the segment's sum, the run's carries in stretch order and
// then the part of the stretch after the run (where the segment ends).  A
// run of one, the common case, takes one round of loads.
__global__ void __launch_bounds__(kFixThreads)
segsum_carry_kernel(const int32_t* __restrict__ carry_seg, const float* __restrict__ carry_sum,
                    const int32_t* __restrict__ offsets, int32_t num_rec, int32_t stretches,
                    float* __restrict__ out) {
    asm volatile("griddepcontrol.wait;" ::: "memory");  // segsum_kernel is done
    const int32_t b = static_cast<int32_t>(blockIdx.x) * kFixThreads + threadIdx.x;
    if (b + 1 >= stretches) return;  // the last stretch leaves no carry
    // Entries past the path's end were not written: read them all at once
    // and drop them after.
    const int32_t length = offsets[num_rec] + num_rec;
    const int32_t g = carry_seg[b];
    const int32_t prev = b > 0 ? carry_seg[b - 1] : -1;
    int32_t next[kLookahead];
#pragma unroll
    for (int u = 0; u < kLookahead; ++u)
        next[u] = b + 1 + u < stretches ? carry_seg[b + 1 + u] : -1;
    float sum[kLive], tail[kLive];
#pragma unroll
    for (int r = 0; r < kLive; ++r) {
        sum[r] = carry_sum[static_cast<int64_t>(b) * kCarry + r];
        tail[r] = carry_sum[static_cast<int64_t>(b + 1) * kCarry + kLive + r];
    }
    const int32_t active = (length + kStretch - 1) / kStretch;
    if (b >= active || g < 0 || prev == g) return;
    for (int32_t c = b + 1;; c += kLookahead) {
        int k = 0;  // the run's entries among next[]
#pragma unroll
        for (int u = 0; u < kLookahead; ++u)
            k = (k == u && c + u < active && next[u] == g) ? u + 1 : k;
#pragma unroll
        for (int u = 0; u < kLookahead; ++u) {
            if (u < k) {
#pragma unroll
                for (int r = 0; r < kLive; ++r)
                    sum[r] += carry_sum[static_cast<int64_t>(c + u) * kCarry + r];
            }
        }
        if (k < kLookahead) {
            if (c + k != b + 1) {  // the stretch where the segment ends
#pragma unroll
                for (int r = 0; r < kLive; ++r)
                    tail[r] = carry_sum[static_cast<int64_t>(c + k) * kCarry + kLive + r];
            }
            break;
        }
#pragma unroll
        for (int u = 0; u < kLookahead; ++u)
            next[u] = c + kLookahead + u < stretches ? carry_seg[c + kLookahead + u] : -1;
    }
#pragma unroll
    for (int r = 0; r < kLive; ++r) sum[r] = sum[r] + tail[r];
    write_sum(out, g, sum);
}

}  // namespace

// Stretches of a launch over `cols` sorted columns and `num_rec` segments:
// the entries of the carry arrays the caller allocates.
extern "C" int64_t gsplat_segsum_carries(int64_t cols, int32_t num_rec) {
    return (cols + num_rec + kStretch - 1) / kStretch;
}

extern "C" int gsplat_segsum(const float* rows, int64_t cols, const int32_t* offsets,
                             int32_t num_rec, float* out, int32_t* carry_seg, float* carry_sum,
                             void* stream) {
    const auto stretches = static_cast<int32_t>(gsplat_segsum_carries(cols, num_rec));
    const auto s = static_cast<cudaStream_t>(stream);
    const int blocks = std::min((stretches + kWarps - 1) / kWarps, kGridBlocks);
    segsum_kernel<<<blocks, kThreads, 0, s>>>(rows, cols, offsets, num_rec, out, carry_seg,
                                              carry_sum);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((stretches + kFixThreads - 1) / kFixThreads);
    cfg.blockDim = dim3(kFixThreads);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, segsum_carry_kernel, static_cast<const int32_t*>(carry_seg),
                             static_cast<const float*>(carry_sum), offsets, num_rec, stretches,
                             out);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
