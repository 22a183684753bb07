// K3: per-tile backward compositing over sorted-order records.
//
// Replaces gaussiansplattingmlx_tpu/ops/rasterize_pallas.py
// `_bwd_kernel_sorted` (launched by `_raster_bwd` in sorted mode).
//
// Tile t's records are the columns [tile_start[t], tile_start[t] +
// tile_count[t]) of records[16, rec_cols]; starts need not be aligned.  The
// replay, its arithmetic and the fixed-order pixel sums are
// rasterize_bwd_tile.cuh's (shared with K7).  The row of a replayed record
// is written to column tile_start + rank: on the card each column belongs to
// exactly one tile, so the TPU kernel's read-modify-write of shared 128-lane
// windows has no counterpart.  Columns past the replay, past the pairs and
// in the pad are not written, nor are rows 11-15; the caller zero-fills the
// output.
//
// Block shape and bound: rasterize_bwd_tile.cuh (128 threads with two
// pixels each at tile 16, 256 with four at tile 32; bound by the per-pixel
// arithmetic).
#include <cstdint>
#include <cuda_runtime.h>

#include "rasterize_bwd_tile.cuh"

namespace {

template <int kPix>
__global__ void __launch_bounds__(kBwdMaxThreads, 2)
raster_bwd_kernel(const float* __restrict__ records, int64_t rec_cols,
                  const int32_t* __restrict__ tile_start,
                  const int32_t* __restrict__ tile_count,
                  const float* __restrict__ cot, int32_t grid_w, int32_t tile_w,
                  int32_t tile_h, float alpha_clamp, float undo_floor,
                  float* __restrict__ grad) {
    raster_bwd_tile<kPix>(records, rec_cols, tile_start[blockIdx.x], tile_count[blockIdx.x],
                          cot, grid_w, tile_w, tile_h, alpha_clamp, undo_floor, grad);
}

}  // namespace

extern "C" int gsplat_raster_bwd(const float* records, int64_t rec_cols,
                                 const int32_t* tile_start, const int32_t* tile_count,
                                 const float* cot, int32_t num_tiles, int32_t grid_w,
                                 int32_t tile_w, int32_t tile_h, float alpha_clamp,
                                 float undo_floor, float* grad, void* stream) {
    const int tt = tile_w * tile_h;
    const int threads = raster_bwd_threads(tt);
    const int pix = raster_bwd_pix(tt);
    const auto kernel = pix == 1   ? &raster_bwd_kernel<1>
                        : pix == 2 ? &raster_bwd_kernel<2>
                                   : &raster_bwd_kernel<4>;
    kernel<<<num_tiles, threads, raster_bwd_smem_bytes(threads),
             static_cast<cudaStream_t>(stream)>>>(records, rec_cols, tile_start, tile_count,
                                                  cot, grid_w, tile_w, tile_h, alpha_clamp,
                                                  undo_floor, grad);
    return static_cast<int>(cudaGetLastError());
}
