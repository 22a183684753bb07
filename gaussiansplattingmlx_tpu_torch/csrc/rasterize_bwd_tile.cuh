// One tile's backward compositing: the device code K3 (sorted records,
// rasterize_bwd.cu) and K7 (chunk-aligned records, rasterize_bwd_aligned.cu)
// share, so the two layouts take the same arithmetic.
//
// One block per tile, kPix pixels per thread: pixel i + k * blockDim.x for
// k < kPix, with kPix 1 for tiles up to 128 pixels, 2 up to 512 and 4 up to
// 1024.  So tile 16 runs 128 threads with two rows 8 apart each, tile 32 256
// threads with four.  (At tile 16, one pixel a thread in 256 threads proved
// slower on the H100, PERF.md section 6: twice the warps reduce each
// record.)  Each thread holds its pixels' state in registers: the
// cotangents (rgb, depth, alpha) and the forward's alpha and n_contrib from
// the cotangent block cot[T][TT][8] = (cotR, cotG, cotB, cotDepth, cotAlpha,
// alpha_fwd, ncon, 0), the transmittance T and the suffix sum acc.  The
// block replays the tile's records at ranks [0, min(max ncon, count)) from
// the last to the first, in batches of kBatch records staged in shared
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
// Each record's gradient is summed over the tile's pixels without float
// atomics, in a fixed order, so two launches give bit-identical rows:
//   1. a thread adds its pixels' ten terms, pixel 0 first;
//   2. a warp takes kGroup = 3 records at once: their 30 values (and two
//      zero pads) sit in 32 registers per lane, and one recursive-halving
//      pass (16 + 8 + 4 + 2 + 1 = 31 shuffles; each lane keeps half of its
//      values and adds the half its partner sends) leaves lane l with the
//      warp's sum of value l, which it stores to the per-warp partials in one
//      coalesced store: ~10 shuffles a record where a butterfly per quantity
//      took 50;
//   3. after the batch, one thread per (record, quantity) adds the warps'
//      partials in warp order.
// A group that no pixel of the warp takes stores zeros and skips the rest.
// Rows 0-10 of column start + rank are written for the replayed ranks and
// nothing else.
//
// Bound: the per-(pixel, record) arithmetic, ~60 operations per pixel-record
// taken (an exp, two IEEE divisions and ~45 FLOPs, ten adds into the
// thread's sums), issued for all 32 lanes when any lane takes, so the lanes
// a record leaves idle cost as much as busy ones.  The reduction adds ~41
// instructions per (warp, record) (shuffles, adds, selects), a fraction of
// the kPix x ~80 a warp issues for the record's pixels.  DRAM traffic is
// 44 B read and 44 B written per replayed record plus 32 B per pixel.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "raster_tile.cuh"

namespace {

constexpr int kRecDim = 16;
constexpr int kGroup = 3;       // records per transposed warp reduction
constexpr int kBatch = 96;      // records per shared-memory batch, a multiple of kGroup
constexpr int kGradQ = 10;      // mx, my, c00, cs, c11, r, g, b, depth, op
constexpr int kCotCols = 8;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kGroup * kGradQ <= 32, "a group's values must fit the 32 lanes");
static_assert(kBatch % kGroup == 0, "batches hold whole groups");

constexpr int kBwdMaxThreads = 256;

// Pixels per thread for a tile of tt <= 1024 pixels (tt a multiple of 32):
// the launchers instantiate 1, 2 and 4.
inline int raster_bwd_pix(int tt) { return tt <= 128 ? 1 : tt <= 512 ? 2 : 4; }

// Threads of the block: at most kBwdMaxThreads, a whole number of warps.
inline int raster_bwd_threads(int tt) {
    const int pix = raster_bwd_pix(tt);
    return (tt + 32 * pix - 1) / (32 * pix) * 32;
}

// Dynamic shared memory of a block of `threads` threads.
inline size_t raster_bwd_smem_bytes(int threads) {
    return (static_cast<size_t>(kRecStride) * kBatch +
            static_cast<size_t>(threads / 32) * kBatch * kGradQ) *
           sizeof(float);
}

// One recursive-halving step of the transposed reduction: a lane keeps the
// half of v[0, 2S) its bit S selects, sends the other half to lane ^ S, and
// adds what it receives, so v[m] then holds value m + (lane & S ? S : 0).
template <int S>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
    const bool upper = (lane & S) != 0;
#pragma unroll
    for (int m = 0; m < S; ++m) {
        const float send = upper ? v[m] : v[m + S];
        const float keep = upper ? v[m + S] : v[m];
        v[m] = keep + __shfl_xor_sync(kFull, send, S);
    }
}

// The warp's sum of v[lane], left in lane `lane`: 31 shuffles for 32 values.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32], int lane) {
    halve<16>(v, lane);
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    return v[0];
}

// Replays tile blockIdx.x (tile_w x tile_h pixels, kPix a thread), whose
// records are the columns [start, start + count); returns the number of
// ranks replayed, min(max ncon, count).
template <int kPix>
__device__ __forceinline__ int raster_bwd_tile(const float* __restrict__ records,
                                               int64_t rec_cols, int64_t start, int count,
                                               const float* __restrict__ cot, int32_t grid_w,
                                               int32_t tile_w, int32_t tile_h, float alpha_clamp,
                                               float undo_floor, float* __restrict__ grad) {
    extern __shared__ float4 smem4[];
    __shared__ int s_max_ncon;
    float* smem = reinterpret_cast<float*>(smem4);
    const int nthreads = blockDim.x;
    const int nwarps = nthreads >> 5;
    const int tt = tile_w * tile_h;
    float* srec = smem;                        // [kBatch][kRecStride]
    float* part = smem + kRecStride * kBatch;  // [nwarps][kBatch * kGradQ]
    const int t = blockIdx.x;
    const int i = threadIdx.x;
    const int lane = i & 31;
    const int warp = i >> 5;
    const int x0 = (t % grid_w) * tile_w, y0 = (t / grid_w) * tile_h;

    float px[kPix], py[kPix], cot_r[kPix], cot_g[kPix], cot_b[kPix], cot_d[kPix];
    float tfin_term[kPix], T[kPix], acc[kPix];
    int ncon[kPix];
    int my_max = 0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
        const int p = i + k * nthreads;
        px[k] = static_cast<float>(x0 + p % tile_w);
        py[k] = static_cast<float>(y0 + p / tile_w);
        acc[k] = 0.0f;
        if (p < tt) {
            const int64_t pix = static_cast<int64_t>(t) * tt + p;
            const float4* c = reinterpret_cast<const float4*>(cot + pix * kCotCols);
            const float4 c0 = c[0], c1 = c[1];
            cot_r[k] = c0.x;
            cot_g[k] = c0.y;
            cot_b[k] = c0.z;
            cot_d[k] = c0.w;
            T[k] = 1.0f - c1.y;
            tfin_term[k] = -c1.x * T[k];
            ncon[k] = static_cast<int>(c1.z);
        } else {
            cot_r[k] = cot_g[k] = cot_b[k] = cot_d[k] = 0.0f;
            T[k] = 1.0f;
            tfin_term[k] = 0.0f;
            ncon[k] = 0;
        }
        my_max = max(my_max, ncon[k]);
    }

    if (i == 0) s_max_ncon = 0;
    __syncthreads();
    // The last rank any pixel of this warp takes, plus one.
    const int warp_max = __reduce_max_sync(kFull, my_max);
    if (lane == 0) atomicMax(&s_max_ncon, warp_max);
    __syncthreads();
    const int nrec = min(s_max_ncon, count);

    for (int hi = nrec; hi > 0; hi -= kBatch) {
        const int lo = max(hi - kBatch, 0);
        const int nb = hi - lo;
        for (int k = i; k < kRecRows * nb; k += nthreads) {
            const int r = k / nb, j = k - r * nb;
            srec[j * kRecStride + r] = records[r * rec_cols + start + lo + j];
        }
        __syncthreads();
        float* wpart = part + warp * (kBatch * kGradQ);
        // Groups of kGroup records from the top of the batch down; the
        // lowest group may reach below the batch (j < 0: no record).
        for (int jlo = nb - kGroup; jlo > -kGroup; jlo -= kGroup) {
            const bool lane_stores = lane < kGroup * kGradQ && jlo * kGradQ + lane >= 0;
            if (lo + max(jlo, 0) >= warp_max) {
                if (lane_stores) wpart[jlo * kGradQ + lane] = 0.0f;
                continue;
            }
            float v[32];
#pragma unroll
            for (int q = 0; q < 32; ++q) v[q] = 0.0f;
#pragma unroll
            for (int g = kGroup - 1; g >= 0; --g) {
                const int j = jlo + g;
                if (j < 0) continue;
                const int rank = lo + j;
                const float4* rec = reinterpret_cast<const float4*>(srec + j * kRecStride);
                const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2];
                const float c00 = r0.z;
                const float cs = r0.w + r1.x;
                const float c11 = r1.y;
                const float op = r2.z;
#pragma unroll
                for (int k = 0; k < kPix; ++k) {
                    if (rank < ncon[k]) {
                        const float dx = px[k] - r0.x;
                        const float dy = py[k] - r0.y;
                        const float e = -0.5f * (dx * dx * c00 + dy * dy * c11 + dx * dy * cs);
                        const float raw = expf(e) * op;
                        const float a = fminf(raw, alpha_clamp);
                        const float one_minus = fmaxf(1.0f - a, undo_floor);
                        const float tb = T[k] / one_minus;
                        const float w = tb * a;
                        const float u = cot_r[k] * r1.z + cot_g[k] * r1.w + cot_b[k] * r2.x +
                                        cot_d[k] * r2.y;
                        const float dl_da = u * tb - (acc[k] + tfin_term[k]) / one_minus;
                        acc[k] += w * u;
                        T[k] = tb;
                        const float de = (raw <= alpha_clamp ? dl_da : 0.0f) * raw;
                        const int b = g * kGradQ;
                        v[b + 0] += de * (dx * c00 + 0.5f * dy * cs);
                        v[b + 1] += de * (dy * c11 + 0.5f * dx * cs);
                        v[b + 2] += -0.5f * de * dx * dx;
                        v[b + 3] += -0.5f * de * dx * dy;
                        v[b + 4] += -0.5f * de * dy * dy;
                        v[b + 5] += cot_r[k] * w;
                        v[b + 6] += cot_g[k] * w;
                        v[b + 7] += cot_b[k] * w;
                        v[b + 8] += cot_d[k] * w;
                        v[b + 9] += de;
                    }
                }
            }
            const float s = warp_transpose_sum(v, lane);
            if (lane_stores) wpart[jlo * kGradQ + lane] = s;
        }
        __syncthreads();
        for (int k = i; k < kGradQ * nb; k += nthreads) {
            const int q = k / nb, j = k - q * nb;
            const float* pj = part + j * kGradQ + q;
            float s = 0.0f;
            for (int w = 0; w < nwarps; ++w) s += pj[w * (kBatch * kGradQ)];
            if (q == kGradQ - 1) {
                const float op = srec[j * kRecStride + 10];
                s = op > 1e-37f ? s / op : 0.0f;
            }
            const int64_t col = start + lo + j;
            const int row = q < 4 ? q : q + 1;  // row 4 (c10) is written with row 3
            grad[row * rec_cols + col] = s;
            if (q == 3) grad[4 * rec_cols + col] = s;  // c10 shares d_cs
        }
        // Also the barrier before the next batch overwrites shared memory.
        __syncthreads();
    }
    return nrec;
}

}  // namespace
