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
// column 3 (both conic off-diagonals receive d_cs), 11-15 are zero.
//
// One warp per Gaussian.  Lane l sums columns start+l, start+l+32, ... of
// every row (coalesced along each row), then a butterfly of shuffles adds
// the 32 partials; float addition is commutative, so every lane ends with
// the same sum, and the assignment of columns to lanes and the shuffle order
// are fixed.  No atomics: two launches give bit-identical output.  The TPU
// kernel reduced blocks of 128 Gaussians with a one-hot MXU contraction per
// DMA chunk; the card has no such constraint, and the segment bounds come
// from a searchsorted outside the kernel.
//
// Bound: DRAM bytes.  Every live row element is read once (40 B per pair
// column) and 64 B are written per Gaussian; the adds are ~1 per byte/4.
// Short segments (~14 columns per Gaussian at the bench workload) leave
// most lanes idle on the last pass, which costs issue slots, not bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLive = 10;
constexpr int kOutCols = 16;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segsum_kernel(const float* __restrict__ rows, int64_t cols,
              const int32_t* __restrict__ offsets, int32_t num_rec,
              float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (g >= num_rec) return;
    const int64_t start = offsets[g];
    const int64_t end = offsets[g + 1];
    float acc[kLive];
#pragma unroll
    for (int r = 0; r < kLive; ++r) acc[r] = 0.0f;
    for (int64_t p = start + lane; p < end; p += 32) {
#pragma unroll
        for (int r = 0; r < kLive; ++r) acc[r] += rows[r * cols + p];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kLive; ++r)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane < kOutCols) {
        // Output column -> live row: 0-3 -> 0-3, 4 -> 3, 5-10 -> 4-9, else none.
        const int src = lane < 4 ? lane : (lane == 4 ? 3 : (lane <= 10 ? lane - 1 : -1));
        float v = 0.0f;
#pragma unroll
        for (int r = 0; r < kLive; ++r)
            if (r == src) v = acc[r];
        out[g * kOutCols + lane] = v;
    }
}

}  // namespace

extern "C" int gsplat_segsum(const float* rows, int64_t cols, const int32_t* offsets,
                             int32_t num_rec, float* out, void* stream) {
    const int blocks = (num_rec + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segsum_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, cols, offsets, num_rec, out);
    return static_cast<int>(cudaGetLastError());
}
