// K6: sorted pair records -> chunk-aligned per-tile layout.
//
// Replaces gaussiansplattingmlx_tpu/ops/staging.py `_relayout_kernel`
// (launched by `_relayout_pallas`).  Aligned chunk c (C columns) belongs to
// tile owner[c] and holds that tile's sorted records at within-tile ranks
// rank0[c] .. rank0[c] + C - 1:
//
//     nvalid = clamp(tile_count[o] - rank0[c], 0, C),  o = owner[c]
//     out[r, c*C + j] = j < nvalid && r < rows ? in[r, tile_start[o] + rank0[c] + j] : 0
//
// for the 16 output rows.  Every aligned chunk copies one contiguous run of
// sorted columns, so on the card this is a strided copy: one thread per
// output column, neighbouring threads on neighbouring columns, so loads and
// stores are coalesced along the pair axis.  The TPU kernel's lane-aligned
// DMA window, lane roll and SMEM plan segmentation existed only for Mosaic.
// Row 11 carries the gaussian id as an exact float value; the copy moves
// bits, and the library is built without flush-to-zero flags.
//
// Bound: DRAM bytes, 4 * (rows * copied columns + 16 * num_aligned) plus the
// plan; there is no arithmetic to speak of.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOutRows = 16;

__global__ void relayout_kernel(const float* __restrict__ in, int32_t rows, int64_t in_cols,
                                const int32_t* __restrict__ tile_start,
                                const int32_t* __restrict__ tile_count,
                                const int32_t* __restrict__ owner,
                                const int32_t* __restrict__ rank0, int32_t chunk,
                                float* __restrict__ out, int64_t num_aligned) {
    const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (col >= num_aligned) return;
    const int64_t c = col / chunk;
    const int j = static_cast<int>(col - c * chunk);
    const int o = owner[c];
    const int r0 = rank0[c];
    const bool within = j < tile_count[o] - r0;  // also false on padding chunks
    const int64_t src = static_cast<int64_t>(tile_start[o]) + r0 + j;
    for (int r = 0; r < kOutRows; ++r)
        out[r * num_aligned + col] = within && r < rows ? in[r * in_cols + src] : 0.0f;
}

}  // namespace

extern "C" int gsplat_relayout(const float* in, int32_t rows, int64_t in_cols,
                               const int32_t* tile_start, const int32_t* tile_count,
                               const int32_t* owner, const int32_t* rank0, int32_t chunk,
                               float* out, int64_t num_aligned, void* stream) {
    constexpr int kThreads = 256;
    const int64_t blocks = (num_aligned + kThreads - 1) / kThreads;
    relayout_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        in, rows, in_cols, tile_start, tile_count, owner, rank0, chunk, out, num_aligned);
    return static_cast<int>(cudaGetLastError());
}
