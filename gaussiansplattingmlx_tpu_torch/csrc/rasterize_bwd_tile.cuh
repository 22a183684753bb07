// One tile's backward compositing: the device code K3 (sorted records,
// rasterize_bwd.cu) and K7 (chunk-aligned records, rasterize_bwd_aligned.cu)
// share, so the two layouts take the same arithmetic.
//
// One thread block per tile, one thread per pixel (256 threads at tile 16,
// 1024 at tile 32).  Each thread holds its pixel's cotangents (rgb, depth,
// alpha) and the forward's alpha and n_contrib from the cotangent block
// cot[T][TT][8] = (cotR, cotG, cotB, cotDepth, cotAlpha, alpha_fwd, ncon, 0).
// The block replays the tile's records at ranks [0, min(max ncon, count))
// from the last to the first, in batches of kBatch records staged in shared
// memory.  A pixel takes the record at rank j only if j < ncon; with T the
// transmittance after the record and acc the running suffix sum of w * u,
//
//     a = min(raw, clamp), raw = exp(e) * op,   T_before = T / (1 - a)
//     u = cot . (rgb, depth),   w = T_before * a
//     dl/da = u * T_before - (acc - cotAlpha * T_final) / max(1 - a, floor)
//     de = (raw <= clamp ? dl/da : 0) * raw
//
// and the record's gradient is d mean = de * (c00 dx + cs dy / 2, c11 dy +
// cs dx / 2), d c00 = -de dx^2 / 2, d cs = -de dx dy / 2 (rows 3 and 4),
// d c11 = -de dy^2 / 2, d rgb = cotRGB * w, d depth = cotDepth * w, and
// d op = sum(de) / op (0 where op <= 1e-37).  These are the quantities the
// TPU kernels formed in their quadratic-coefficient space with MXU
// contractions; the card computes them from dx, dy directly.
//
// Each record's gradient is summed over the tile's pixels without atomics:
// a butterfly of warp shuffles per quantity, the per-warp partials stored to
// shared memory, then one thread per (record, quantity) adds the warps in
// index order.  Two launches give bit-identical rows.  Rows 0-10 of column
// start + rank are written for the replayed ranks and nothing else.
//
// Bound: the per-(pixel, record) arithmetic (an exp and ~45 FLOPs) plus 50
// shuffles per (warp, record) for the reduction; DRAM traffic is 44 B read
// and 44 B written per replayed record plus 32 B per pixel, so it is bound
// by instruction throughput, not memory bandwidth.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRecRows = 11;
constexpr int kRecDim = 16;
constexpr int kBatch = 32;
constexpr int kGradQ = 10;  // mx, my, c00, cs, c11, r, g, b, depth, op
constexpr int kCotCols = 8;
constexpr unsigned kFull = 0xffffffffu;

__constant__ int kGradRow[kGradQ] = {0, 1, 2, 3, 5, 6, 7, 8, 9, 10};

// Dynamic shared memory of a block of tt threads.
inline size_t raster_bwd_smem_bytes(int tt) {
    return (static_cast<size_t>(kRecRows) * kBatch +
            static_cast<size_t>(kBatch) * (tt / 32) * kGradQ) *
           sizeof(float);
}

// Replays tile blockIdx.x, whose records are the columns [start, start +
// count); returns the number of ranks replayed, min(max ncon, count).
__device__ __forceinline__ int raster_bwd_tile(const float* __restrict__ records,
                                               int64_t rec_cols, int64_t start, int count,
                                               const float* __restrict__ cot, int32_t grid_w,
                                               int32_t tile_w, float alpha_clamp,
                                               float undo_floor, float* __restrict__ grad) {
    extern __shared__ float smem[];
    __shared__ int s_max_ncon;
    const int tt = blockDim.x;
    const int nwarps = tt >> 5;
    float* srec = smem;                     // [kRecRows][kBatch]
    float* part = smem + kRecRows * kBatch;  // [kBatch][nwarps][kGradQ]
    const int t = blockIdx.x;
    const int i = threadIdx.x;
    const int lane = i & 31;
    const int warp = i >> 5;
    const float px = static_cast<float>((t % grid_w) * tile_w + i % tile_w);
    const float py = static_cast<float>((t / grid_w) * (tt / tile_w) + i / tile_w);

    const float* c = cot + (static_cast<int64_t>(t) * tt + i) * kCotCols;
    const float cot_r = c[0], cot_g = c[1], cot_b = c[2], cot_d = c[3];
    const float t_final = 1.0f - c[5];
    const float tfin_term = -c[4] * t_final;
    const int ncon = static_cast<int>(c[6]);

    if (i == 0) s_max_ncon = 0;
    __syncthreads();
    const int warp_max = __reduce_max_sync(kFull, ncon);
    if (lane == 0) atomicMax(&s_max_ncon, warp_max);
    __syncthreads();
    const int nrec = min(s_max_ncon, count);

    float T = t_final;
    float acc = 0.0f;
    for (int hi = nrec; hi > 0; hi -= kBatch) {
        const int lo = max(hi - kBatch, 0);
        const int nb = hi - lo;
        for (int k = i; k < kRecRows * nb; k += tt) {
            const int r = k / nb, j = k - r * nb;
            srec[r * kBatch + j] = records[r * rec_cols + start + lo + j];
        }
        __syncthreads();
        for (int j = nb - 1; j >= 0; --j) {
            const bool take = lo + j < ncon;
            float* wp = part + (j * nwarps + warp) * kGradQ;
            if (!__any_sync(kFull, take)) {
                if (lane < kGradQ) wp[lane] = 0.0f;
                continue;
            }
            float g[kGradQ];
#pragma unroll
            for (int q = 0; q < kGradQ; ++q) g[q] = 0.0f;
            if (take) {
                const float dx = px - srec[j];
                const float dy = py - srec[kBatch + j];
                const float c00 = srec[2 * kBatch + j];
                const float cs = srec[3 * kBatch + j] + srec[4 * kBatch + j];
                const float c11 = srec[5 * kBatch + j];
                const float op = srec[10 * kBatch + j];
                const float e = -0.5f * (dx * dx * c00 + dy * dy * c11 + dx * dy * cs);
                const float raw = expf(e) * op;
                const float a = fminf(raw, alpha_clamp);
                const float one_minus = fmaxf(1.0f - a, undo_floor);
                const float tb = T / one_minus;
                const float w = tb * a;
                const float u = cot_r * srec[6 * kBatch + j] + cot_g * srec[7 * kBatch + j] +
                                cot_b * srec[8 * kBatch + j] + cot_d * srec[9 * kBatch + j];
                const float dl_da = u * tb - (acc + tfin_term) / one_minus;
                acc += w * u;
                T = tb;
                const float de = (raw <= alpha_clamp ? dl_da : 0.0f) * raw;
                g[0] = de * (dx * c00 + 0.5f * dy * cs);
                g[1] = de * (dy * c11 + 0.5f * dx * cs);
                g[2] = -0.5f * de * dx * dx;
                g[3] = -0.5f * de * dx * dy;
                g[4] = -0.5f * de * dy * dy;
                g[5] = cot_r * w;
                g[6] = cot_g * w;
                g[7] = cot_b * w;
                g[8] = cot_d * w;
                g[9] = de;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
                for (int q = 0; q < kGradQ; ++q) g[q] += __shfl_xor_sync(kFull, g[q], off);
            }
            if (lane == 0) {
#pragma unroll
                for (int q = 0; q < kGradQ; ++q) wp[q] = g[q];
            }
        }
        __syncthreads();
        for (int k = i; k < kGradQ * nb; k += tt) {
            const int q = k / nb, j = k - q * nb;
            const float* pj = part + j * nwarps * kGradQ + q;
            float s = 0.0f;
            for (int w = 0; w < nwarps; ++w) s += pj[w * kGradQ];
            if (q == kGradQ - 1) {
                const float op = srec[10 * kBatch + j];
                s = op > 1e-37f ? s / op : 0.0f;
            }
            const int64_t col = start + lo + j;
            grad[kGradRow[q] * rec_cols + col] = s;
            if (q == 3) grad[4 * rec_cols + col] = s;  // c10 shares d_cs
        }
        // Also the barrier before the next batch overwrites shared memory.
        __syncthreads();
    }
    return nrec;
}

}  // namespace
