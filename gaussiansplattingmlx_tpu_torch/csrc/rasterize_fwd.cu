// K1: per-tile front-to-back forward compositing.
//
// Replaces gaussiansplattingmlx_tpu/ops/rasterize_pallas.py `_fwd_kernel`
// (launched by `_fwd_call` via `rasterize_staged`).
//
// The tile's depth-sorted records are the columns [tile_start, tile_start +
// tile_count) of the component-major buffer records[16, rec_cols] (rows 0
// mx, 1 my, 2-5 c00 c01 c10 c11, 6-8 rgb, 9 depth, 10 opacity); starts need
// not be aligned.  Each pixel marches through them in order:
//
//     if (T < eps) stop;  a = min(exp(e) * op, clamp);  acc += T * a * attr;
//     T *= 1 - a;  ncon++
//
// with e = -0.5 (dx^2 c00 + dy^2 c11 + dx dy (c01 + c10)) at integer pixel
// coordinates, the expression and order of the backward replay
// (rasterize_bwd_tile.cuh), which rebuilds T from this kernel's alpha.  A
// record counts while the transmittance BEFORE it is >= eps; there is no
// alpha < 1/255 skip, and opacity 0 gives alpha 0.  Output per tile: [6, TT]
// = rgb, depth, alpha = 1 - T, n_contrib.  Pixels past the image edge are
// computed and cropped by the caller, as on the TPU.
//
// Design.  A block takes a part of a tile: kPartPixels consecutive pixels in
// row-major order, one a thread (whole rows at tiles 8, 16 and 32: one block
// a tile at tile 8, two at tile 16, eight at tile 32); at 32 registers a
// thread an SM holds 16 such blocks, 64 warps.  Each block walks the tile's
// whole record list for its own pixels and stops when they are done, so the
// tail of a busy tile is split over eight blocks and a part that saturates
// early leaves its SM to others.  Records come in batches of blockDim.x,
// copied with cp.async (4 bytes a row, no registers held) into one of two
// shared-memory buffers as 3 x float4 a record (raster_tile.cuh): the block
// composites batch b while batch b + 1 is in flight, and one barrier a batch
// both publishes the next batch and checks the early stop
// (__syncthreads_or: no pixel of the part can take another record).  A
// thread reads a record with three broadcast 16-byte loads and takes groups
// of kUnroll records between its alive checks.  (Measured on the H100,
// PERF.md section 6: the replay's shape, two pixels a thread at tile 16 and
// four at tile 32 in one block a tile, was slower at both tiles, and so were
// predicated bodies that let the compiler interleave pixels or records: they
// take more registers.)
//
// The TPU kernel's MXU formulation (basis @ coef exponent, triangular-matmul
// prefix product, colour contraction) existed only for Mosaic's layout rules
// and is not carried over.
//
// Bound: ~24 operations (one exp) per pixel-record taken, from registers and
// broadcast shared-memory reads; DRAM traffic is 44 B per pair and 24 B per
// pixel, far below the operations' time.  The per-pixel chain issues ~30
// instructions a pixel-record (the exp alone 8), which bounds it.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "raster_tile.cuh"

namespace {

constexpr int kOutChannels = 6;
constexpr int kPartPixels = 128;  // pixels (threads) a block takes
constexpr int kMinBlocks = 16;    // blocks an SM holds
constexpr int kUnroll = 16;       // records between a thread's alive checks

__global__ void __launch_bounds__(kPartPixels, kMinBlocks)
raster_fwd_kernel(const float* __restrict__ records, int64_t rec_cols,
                  const int32_t* __restrict__ tile_start,
                  const int32_t* __restrict__ tile_count, int32_t grid_w,
                  int32_t tile_w, int32_t tile_h, int32_t parts, float alpha_clamp,
                  float eps, float* __restrict__ out) {
    extern __shared__ float4 srec[];  // [2][blockDim.x][3]: two batches of records
    const int nthreads = blockDim.x;
    const int i = threadIdx.x;
    const int t = blockIdx.x / parts;
    const int part = blockIdx.x - t * parts;
    const int tt = tile_w * tile_h;
    const int64_t start = tile_start[t];
    const int count = tile_count[t];

    const int p = part * kPartPixels + i;  // the thread's pixel in the tile
    const bool in = p < tt;
    const int lx = p % tile_w, ly = p / tile_w;
    const float px = static_cast<float>((t % grid_w) * tile_w + lx);
    const float py = static_cast<float>((t / grid_w) * tile_h + ly);
    float T = 1.0f;
    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
    int ncon = 0;
    auto alive = [&]() { return in && T >= eps; };

    // Thread i copies rank base + i of the tile's records into buffer buf.
    auto stage = [&](int buf, int base) {
        if (base + i < count) {
            const float* src = records + start + base + i;
            float* dst = reinterpret_cast<float*>(srec + (buf * nthreads + i) * 3);
#pragma unroll
            for (int r = 0; r < kRecRows; ++r)
                __pipeline_memcpy_async(dst + r, src + r * rec_cols, sizeof(float));
        }
        __pipeline_commit();
    };

    stage(0, 0);
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int base = 0, buf = 0; base < count; base += nthreads, buf ^= 1) {
        stage(buf ^ 1, base + nthreads);  // in flight while this batch composites
        const int nb = min(nthreads, count - base);
        const float4* cur = srec + buf * nthreads * 3;
        auto take = [&](int j) {
            if (!alive()) return;
            const float4 r0 = cur[3 * j], r1 = cur[3 * j + 1], r2 = cur[3 * j + 2];
            const float dx = px - r0.x;
            const float dy = py - r0.y;
            const float cs = r0.w + r1.x;
            const float e = -0.5f * (dx * dx * r0.z + dy * dy * r1.y + dx * dy * cs);
            const float a = fminf(expf(e) * r2.z, alpha_clamp);
            const float w = T * a;
            acc_r += w * r1.z;
            acc_g += w * r1.w;
            acc_b += w * r2.x;
            acc_d += w * r2.y;
            T *= 1.0f - a;
            ++ncon;
        };
        int j = 0;
        for (; j + kUnroll <= nb && alive(); j += kUnroll) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) take(j + u);
        }
        for (; j < nb && alive(); ++j) take(j);
        __pipeline_wait_prior(0);
        // Publishes the next batch; the buffer it overwrites was last read
        // before the previous barrier.
        if (!__syncthreads_or(alive())) break;
    }

    if (!in) return;
    float* o = out + static_cast<int64_t>(t) * kOutChannels * tt;
    o[p] = acc_r;
    o[tt + p] = acc_g;
    o[2 * tt + p] = acc_b;
    o[3 * tt + p] = acc_d;
    o[4 * tt + p] = 1.0f - T;
    o[5 * tt + p] = static_cast<float>(ncon);
}

}  // namespace

extern "C" int gsplat_raster_fwd(const float* records, int64_t rec_cols,
                                 const int32_t* tile_start, const int32_t* tile_count,
                                 int32_t num_tiles, int32_t grid_w, int32_t tile_w,
                                 int32_t tile_h, float alpha_clamp, float eps,
                                 float* out, void* stream) {
    const int tt = tile_w * tile_h;
    const int parts = (tt + kPartPixels - 1) / kPartPixels;
    const int threads = min(kPartPixels, (tt + 31) / 32 * 32);
    const size_t smem = 2 * static_cast<size_t>(threads) * kRecStride * sizeof(float);
    raster_fwd_kernel<<<num_tiles * parts, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        records, rec_cols, tile_start, tile_count, grid_w, tile_w, tile_h, parts, alpha_clamp,
        eps, out);
    return static_cast<int>(cudaGetLastError());
}
