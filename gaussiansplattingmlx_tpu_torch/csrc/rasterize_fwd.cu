// K1: per-tile front-to-back forward compositing.
//
// Replaces gaussiansplattingmlx_tpu/ops/rasterize_pallas.py `_fwd_kernel`
// (launched by `_fwd_call` via `rasterize_staged`).
//
// One thread block per tile, one thread per pixel (256 threads at tile 16,
// at most 1024 at tile 32).  The tile's depth-sorted records are the columns
// [tile_start, tile_start + tile_count) of the component-major buffer
// records[16, rec_cols] (rows 0 mx, 1 my, 2-5 c00 c01 c10 c11, 6-8 rgb,
// 9 depth, 10 opacity); starts need not be aligned.  The block walks the range
// in batches of blockDim records, loaded cooperatively into shared memory
// (11 floats per record, coalesced along each row), and each thread marches
// its pixel serially through the batch:
//
//     if (T < eps) stop;  a = min(exp(e) * op, clamp);  acc += T * a * attr;
//     T *= 1 - a;  ncon++
//
// with e = -0.5 (dx^2 c00 + dy^2 c11 + dx dy (c01 + c10)) at integer pixel
// coordinates.  A record counts while the transmittance BEFORE it is >= eps;
// there is no alpha < 1/255 skip, and opacity 0 gives alpha 0.  The block
// stops early once no pixel of the tile can take another record
// (__syncthreads_or).  Output per tile: [6, TT] = rgb, depth, alpha = 1 - T,
// n_contrib.  Pixels past the image edge are computed and cropped by the
// caller, as on the TPU.
//
// The TPU kernel's MXU formulation (basis @ coef exponent, triangular-matmul
// prefix product, colour contraction) existed only for Mosaic's layout rules
// and is not carried over.
//
// Bound: one exp and ~20 FLOPs per pixel x pair (tile_w * tile_h pixel-pairs
// per staged pair), all operands from shared memory (broadcast reads).  DRAM
// traffic is 44 B per pair plus 24 B per pixel, so it is not bound by DRAM
// bandwidth but by instruction issue and the serial march.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRecRows = 11;
constexpr int kOutChannels = 6;

__global__ void __launch_bounds__(1024)
raster_fwd_kernel(const float* __restrict__ records, int64_t rec_cols,
                  const int32_t* __restrict__ tile_start,
                  const int32_t* __restrict__ tile_count, int32_t grid_w,
                  int32_t tile_w, float alpha_clamp, float eps,
                  float* __restrict__ out) {
    extern __shared__ float smem[];  // [kRecRows][blockDim.x]
    const int tt = blockDim.x;
    const int t = blockIdx.x;
    const int i = threadIdx.x;
    const float px = static_cast<float>((t % grid_w) * tile_w + i % tile_w);
    const float py = static_cast<float>((t / grid_w) * (tt / tile_w) + i / tile_w);
    const int64_t start = tile_start[t];
    const int count = tile_count[t];

    float T = 1.0f;
    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
    int ncon = 0;
    for (int base = 0; base < count; base += tt) {
        const int nb = min(tt, count - base);
        if (i < nb) {
            const int64_t col = start + base + i;
#pragma unroll
            for (int r = 0; r < kRecRows; ++r)
                smem[r * tt + i] = records[r * rec_cols + col];
        }
        __syncthreads();
        for (int j = 0; j < nb && T >= eps; ++j) {
            const float dx = px - smem[j];
            const float dy = py - smem[tt + j];
            const float c00 = smem[2 * tt + j];
            const float cs = smem[3 * tt + j] + smem[4 * tt + j];
            const float c11 = smem[5 * tt + j];
            const float e = -0.5f * (dx * dx * c00 + dy * dy * c11 + dx * dy * cs);
            const float a = fminf(expf(e) * smem[10 * tt + j], alpha_clamp);
            const float w = T * a;
            acc_r += w * smem[6 * tt + j];
            acc_g += w * smem[7 * tt + j];
            acc_b += w * smem[8 * tt + j];
            acc_d += w * smem[9 * tt + j];
            T *= 1.0f - a;
            ++ncon;
        }
        // Also the barrier before the next batch overwrites shared memory.
        if (!__syncthreads_or(T >= eps)) break;
    }
    float* o = out + static_cast<int64_t>(t) * kOutChannels * tt;
    o[i] = acc_r;
    o[tt + i] = acc_g;
    o[2 * tt + i] = acc_b;
    o[3 * tt + i] = acc_d;
    o[4 * tt + i] = 1.0f - T;
    o[5 * tt + i] = static_cast<float>(ncon);
}

}  // namespace

extern "C" int gsplat_raster_fwd(const float* records, int64_t rec_cols,
                                 const int32_t* tile_start, const int32_t* tile_count,
                                 int32_t num_tiles, int32_t grid_w, int32_t tile_w,
                                 int32_t tile_h, float alpha_clamp, float eps,
                                 float* out, void* stream) {
    const int tt = tile_w * tile_h;
    const size_t smem = static_cast<size_t>(kRecRows) * tt * sizeof(float);
    raster_fwd_kernel<<<num_tiles, tt, smem, static_cast<cudaStream_t>(stream)>>>(
        records, rec_cols, tile_start, tile_count, grid_w, tile_w, alpha_clamp, eps,
        out);
    return static_cast<int>(cudaGetLastError());
}
