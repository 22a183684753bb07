// Adam over every parameter leaf in one pass.
//
// No TPU kernel: replaces the plain `train/optimizer.py` rule, which XLA
// fuses on the TPU but which PyTorch runs as a dozen elementwise kernels a
// leaf, each reading and writing whole leaf-sized tensors (~112 B an
// element, temporaries included).
//
// adam_update_kernel: one launch updates up to kMaxLeaves leaves.  A table
// passed by value (a __grid_constant__ parameter, read from the constant
// bank) gives each leaf's p, m, v, g and learning-rate pointers, its sizes
// and its first block; a block finds its leaf by that prefix and takes one
// chunk of it.  Each thread keeps kGroups 16-byte loads of each of p, m, v
// and g in flight before it computes, and every load and store is streaming
// (__ldcs / __stcs): nothing is read twice.  p, m and v are contiguous.  The
// gradient may be rows of any stride: features_dc's and features_rest's are
// column slices of d shs [N, 16, 3], row stride 48.  Where it is not
// contiguous and aligned like p, a warp reads the 128 elements of its groups
// as consecutive floats (coalesced) and hands them to its threads through
// shared memory: each thread reading its own 4 elements, 16 bytes apart
// across the warp, took 20.5 ms in place of 17.4 over Rubble's leaves.  A
// leaf whose p, m or v is not 16-byte aligned runs in scalars; a length not
// a multiple of 4 leaves a scalar tail of up to 3 elements.  Nothing is
// allocated and nothing synchronises.
//
// Bound: bytes at 3.35 TB/s, 28 B an element (p, g, m, v read once; p, m, v
// written once).  Its 12 to 14 operations an element are two orders below.
//
// Bits: each element takes the plain rule's correctly rounded operations in
// its order on the card (__fmul_rn and friends keep nvcc from contracting a
// multiply and an add into an FMA):
//   m = b1 m + c1 g;  v = b2 v + c2 (g g)
//   p = p - (lr mhat) / (sqrt(vhat) + eps),  mhat = m / d1, vhat = v / d2
// with b1, b2, c1 = 1 - b1, c2 = 1 - b2 and eps rounded to float32 on the
// host as PyTorch rounds a Python scalar for a float32 tensor, and lr, d1 =
// 1 - b1^t and d2 = 1 - b2^t read from device scalars (d1, d2 null: no bias
// correction).  NaN and inf pass through as the plain rule passes them.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;  // 16-byte groups of each stream a thread has in flight
constexpr int64_t kGroupsPerBlock = int64_t(kThreads) * kGroups;
constexpr int kMaxLeaves = 8;

struct Leaf {
    float* p;
    float* m;
    float* v;
    const float* g;
    const float* lr;  // 0-d float32
    int64_t n;  // elements
    int64_t width;  // elements a row
    int64_t g_stride;  // elements from one gradient row to the next
    int64_t groups;  // 16-byte groups of p, m and v (0: the leaf runs in scalars)
    int64_t block0;  // the leaf's first block
    int g_vec;  // the gradient is contiguous and aligned like p
};

struct Table {
    Leaf leaf[kMaxLeaves];
    int count;
};

struct Consts {
    float b1, b2, c1, c2, eps;
};

// One leaf's scalars, as every element of it reads them.
struct Rule {
    Consts c;
    float lr;
    bool bias;  // divide m and v by d1 and d2
    float d1, d2;
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v, float g, const Rule& r) {
    m = __fadd_rn(__fmul_rn(m, r.c.b1), __fmul_rn(g, r.c.c1));
    v = __fadd_rn(__fmul_rn(v, r.c.b2), __fmul_rn(__fmul_rn(g, g), r.c.c2));
    float mhat = m, vhat = v;
    if (r.bias) {
        mhat = __fdiv_rn(m, r.d1);
        vhat = __fdiv_rn(v, r.d2);
    }
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(r.lr, mhat), __fadd_rn(__fsqrt_rn(vhat), r.c.eps)));
}

// The gradient of element e of a leaf (row e / width, column e % width).
__device__ __forceinline__ float grad_at(const Leaf& L, int64_t e) {
    const int64_t row = e / L.width;
    return __ldcs(L.g + row * L.g_stride + (e - row * L.width));
}

// Loads g at elements e, e + 32, e + 64 and e + 96 of a strided gradient
// (row e / width, column e % width) below `end`: lane l of a warp whose
// groups start at element E takes E + l + 32k, so each load is coalesced.
__device__ __forceinline__ void grad_rows(const Leaf& L, int64_t e, int64_t end, float out[4]) {
    const int64_t step_rows = 32 / L.width, step_cols = 32 - step_rows * L.width;
    int64_t row = e / L.width;
    int64_t col = e - row * L.width;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        out[k] = e + 32 * k < end ? __ldcs(L.g + row * L.g_stride + col) : 0.0f;
        row += step_rows;
        col += step_cols;
        if (col >= L.width) {
            col -= L.width;
            ++row;
        }
    }
}

__device__ __forceinline__ void adam4(float4& p, float4& m, float4& v, const float4& g,
                                      const Rule& r) {
    adam_one(p.x, m.x, v.x, g.x, r);
    adam_one(p.y, m.y, v.y, g.y, r);
    adam_one(p.z, m.z, v.z, g.z, r);
    adam_one(p.w, m.w, v.w, g.w, r);
}

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const __grid_constant__ Table table, const Consts c, const float* d1,
                   const float* d2) {
    int l = 0;
    while (l + 1 < table.count && int64_t(blockIdx.x) >= table.leaf[l + 1].block0) ++l;
    const Leaf& L = table.leaf[l];
    const int64_t chunk = int64_t(blockIdx.x) - L.block0;
    const bool bias = d1 != nullptr;
    const Rule r{c, __ldg(L.lr), bias, bias ? __ldg(d1) : 1.0f, bias ? __ldg(d2) : 1.0f};

    // The 16-byte groups: kGroups of each stream loaded before any is used.
    // A strided gradient is loaded by the warp as 128 consecutive elements a
    // group (coalesced floats), then handed to the threads' groups of 4
    // through shared memory.
    __shared__ float4 gbuf[kThreads / 32][kGroups][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t q0 = chunk * kGroupsPerBlock + threadIdx.x;
    float4 p[kGroups], m[kGroups], v[kGroups], g[kGroups];
    float gs[kGroups][4];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
        const int64_t q = q0 + int64_t(j) * kThreads;
        if (q < L.groups) {
            p[j] = __ldcs(reinterpret_cast<const float4*>(L.p) + q);
            m[j] = __ldcs(reinterpret_cast<const float4*>(L.m) + q);
            v[j] = __ldcs(reinterpret_cast<const float4*>(L.v) + q);
            if (L.g_vec) g[j] = __ldcs(reinterpret_cast<const float4*>(L.g) + q);
        }
        if (!L.g_vec) grad_rows(L, 4 * (q - lane) + lane, 4 * L.groups, gs[j]);
    }
    if (!L.g_vec) {
        float* buf = reinterpret_cast<float*>(gbuf[warp]);
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
#pragma unroll
            for (int k = 0; k < 4; ++k) buf[128 * j + 32 * k + lane] = gs[j][k];
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kGroups; ++j) g[j] = gbuf[warp][j][lane];
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
        const int64_t q = q0 + int64_t(j) * kThreads;
        if (q < L.groups) {
            adam4(p[j], m[j], v[j], g[j], r);
            __stcs(reinterpret_cast<float4*>(L.p) + q, p[j]);
            __stcs(reinterpret_cast<float4*>(L.m) + q, m[j]);
            __stcs(reinterpret_cast<float4*>(L.v) + q, v[j]);
        }
    }

    // The elements past the groups: a tail of up to 3, or the whole leaf
    // where it runs in scalars.
    const int64_t e0 = 4 * L.groups + chunk * (4 * kGroupsPerBlock) + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 4 * kGroups; ++j) {
        const int64_t e = e0 + int64_t(j) * kThreads;
        if (e < L.n) {
            float pe = __ldcs(L.p + e), me = __ldcs(L.m + e), ve = __ldcs(L.v + e);
            adam_one(pe, me, ve, grad_at(L, e), r);
            __stcs(L.p + e, pe);
            __stcs(L.m + e, me);
            __stcs(L.v + e, ve);
        }
    }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

int64_t blocks_for(int64_t items, int64_t per_block) { return (items + per_block - 1) / per_block; }

}  // namespace

// ptrs: per leaf p, m, v, g, lr; sizes: per leaf n, width, g_stride.
// consts: b1, b2, c1, c2, eps.  d1, d2: the bias-correction divisors, or
// null.  Leaves with no elements are skipped.
extern "C" int gsplat_adam_update(int32_t count, void* const* ptrs, const int64_t* sizes,
                                  const float* consts, const float* d1, const float* d2,
                                  void* stream) {
    if (count < 0 || count > kMaxLeaves || (d1 == nullptr) != (d2 == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    Table table{};
    int64_t blocks = 0;
    for (int i = 0; i < count; ++i) {
        Leaf L{};
        L.p = static_cast<float*>(ptrs[5 * i]);
        L.m = static_cast<float*>(ptrs[5 * i + 1]);
        L.v = static_cast<float*>(ptrs[5 * i + 2]);
        L.g = static_cast<const float*>(ptrs[5 * i + 3]);
        L.lr = static_cast<const float*>(ptrs[5 * i + 4]);
        L.n = sizes[3 * i];
        L.width = sizes[3 * i + 1];
        L.g_stride = sizes[3 * i + 2];
        if (L.n <= 0) continue;
        if (L.width <= 0) return static_cast<int>(cudaErrorInvalidValue);
        const bool vec = aligned16(L.p) && aligned16(L.m) && aligned16(L.v);
        L.groups = vec ? L.n / 4 : 0;
        L.g_vec = vec && aligned16(L.g) && (L.g_stride == L.width || L.n == L.width);
        L.block0 = blocks;
        const int64_t vec_blocks = blocks_for(L.groups, kGroupsPerBlock);
        const int64_t scalar_blocks = blocks_for(L.n - 4 * L.groups, 4 * kGroupsPerBlock);
        blocks += vec_blocks > scalar_blocks ? vec_blocks : scalar_blocks;
        table.leaf[table.count++] = L;
    }
    if (blocks == 0) return 0;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    Consts c;
    std::memcpy(&c, consts, sizeof c);
    adam_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(table, c, d1, d2);
    return static_cast<int>(cudaGetLastError());
}
