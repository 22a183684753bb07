// K7: per-tile backward compositing over chunk-aligned records.
//
// Replaces gaussiansplattingmlx_tpu/ops/rasterize_pallas.py `_bwd_kernel`
// (launched by `_raster_bwd` outside sorted mode).
//
// Tile t owns the whole chunks [aligned_start[t], aligned_start[t] +
// ceil(count / C) * C) of records[16, rec_cols]; its records sit at the
// first count columns, zeros after them (the relayout K6 writes them so).
// The TPU kernel replays the live chunks, ranks below ceil(max ncon / C) *
// C, and zero-fills the dead tail.  Replayed ranks at or past max ncon (and
// the zero pad lanes of the last chunk) have no pixel that takes them, so
// their rows come out as exact zeros; this kernel replays the ranks below
// min(max ncon, count) with rasterize_bwd_tile.cuh (K3's device code, so K7
// and K3 agree bit for bit on the same buffer) and writes those zeros
// directly.  Every column the tile owns is written: the gradient rows 0-10
// of the replayed ranks, zeros in their rows 11-15 and in all rows of the
// rest.  The columns no tile owns, [owned end, rec_cols), are zero-filled
// too, split evenly over the blocks, so the caller allocates the output
// without clearing it.
//
// Block shape and bound: as K3 (rasterize_bwd_tile.cuh: 128 threads with
// two pixels each at tile 16, 256 with four at tile 32; bound by the
// per-pixel arithmetic); the zero writes add 64 B per column that is not
// replayed.
#include <cstdint>
#include <cuda_runtime.h>

#include "rasterize_bwd_tile.cuh"

namespace {

template <int kPix>
__global__ void __launch_bounds__(kBwdMaxThreads, 2)
raster_bwd_aligned_kernel(const float* __restrict__ records, int64_t rec_cols,
                          const int32_t* __restrict__ aligned_start,
                          const int32_t* __restrict__ tile_count, const float* __restrict__ cot,
                          int32_t num_tiles, int32_t grid_w, int32_t tile_w, int32_t tile_h,
                          int32_t chunk, float alpha_clamp, float undo_floor,
                          float* __restrict__ grad) {
    const int t = blockIdx.x;
    const int nthreads = blockDim.x;
    const int count = tile_count[t];
    const int64_t start = aligned_start[t];
    const int nrec = raster_bwd_tile<kPix>(records, rec_cols, start, count, cot, grid_w, tile_w,
                                           tile_h, alpha_clamp, undo_floor, grad);

    const int owned = (count + chunk - 1) / chunk * chunk;
    for (int k = threadIdx.x; k < owned; k += nthreads) {
        for (int r = k < nrec ? kRecRows : 0; r < kRecDim; ++r)
            grad[r * rec_cols + start + k] = 0.0f;
    }

    const int last = num_tiles - 1;
    const int64_t owned_end =
        aligned_start[last] + static_cast<int64_t>((tile_count[last] + chunk - 1) / chunk) * chunk;
    const int64_t per = (rec_cols - owned_end + num_tiles - 1) / num_tiles;
    const int64_t lo = owned_end + t * per;
    const int64_t hi = min(lo + per, rec_cols);
    for (int64_t col = lo + threadIdx.x; col < hi; col += nthreads) {
        for (int r = 0; r < kRecDim; ++r) grad[r * rec_cols + col] = 0.0f;
    }
}

}  // namespace

extern "C" int gsplat_raster_bwd_aligned(const float* records, int64_t rec_cols,
                                         const int32_t* aligned_start,
                                         const int32_t* tile_count, const float* cot,
                                         int32_t num_tiles, int32_t grid_w, int32_t tile_w,
                                         int32_t tile_h, int32_t chunk, float alpha_clamp,
                                         float undo_floor, float* grad, void* stream) {
    const int tt = tile_w * tile_h;
    const int threads = raster_bwd_threads(tt);
    const int pix = raster_bwd_pix(tt);
    const auto kernel = pix == 1   ? &raster_bwd_aligned_kernel<1>
                        : pix == 2 ? &raster_bwd_aligned_kernel<2>
                                   : &raster_bwd_aligned_kernel<4>;
    kernel<<<num_tiles, threads, raster_bwd_smem_bytes(threads),
             static_cast<cudaStream_t>(stream)>>>(records, rec_cols, aligned_start, tile_count,
                                                  cot, num_tiles, grid_w, tile_w, tile_h, chunk,
                                                  alpha_clamp, undo_floor, grad);
    return static_cast<int>(cudaGetLastError());
}
