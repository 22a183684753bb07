// A probe for scripts/torch_k4_ab.py (not a kernel of the port): the floor of
// K4's memory traffic.  It reads the used columns of the 10 sorted gradient
// rows once, float4 a load in a grid-stride loop, and writes zeros over the
// [num_rec, 16] output, with K4's C interface, so the A/B times it beside K4
// on the same buffers:
//
//     python3 scripts/torch_k4_ab.py --sources scripts/probe_k4_stream.cu
//
// It computes no sums (the A/B does not check a `probe_` source).  Needs a
// column count that is a multiple of 4, as the staged budgets are.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ rows, int64_t cols, const int32_t* __restrict__ offsets,
              int32_t num_rec, float* __restrict__ out) {
    const int32_t used = offsets[num_rec];
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
    float acc = 0.0f;
    if (cols % 4 == 0) {
        for (int64_t k = i; k < used / 4; k += step) {
#pragma unroll
            for (int r = 0; r < 10; ++r) {
                const float4 v = reinterpret_cast<const float4*>(rows + r * cols)[k];
                acc += v.x + v.y + v.z + v.w;
            }
        }
    }
    // Zeros, kept dependent on the loads so that they are not dropped.
    const float zero = acc == 1e30f ? 1.0f : 0.0f;
    for (int64_t k = i; k < static_cast<int64_t>(num_rec) * 4; k += step)
        reinterpret_cast<float4*>(out)[k] = make_float4(zero, 0.0f, 0.0f, 0.0f);
}

}  // namespace

// One carry record, unused: the A/B allocates what K4's interface asks for.
extern "C" int64_t gsplat_segsum_carries(int64_t, int32_t) { return 1; }

extern "C" int gsplat_segsum(const float* rows, int64_t cols, const int32_t* offsets,
                             int32_t num_rec, float* out, int32_t*, float*, void* stream) {
    int64_t blocks = (cols / 4 + kThreads - 1) / kThreads;
    blocks = blocks < 1 ? 1 : (blocks < kMaxBlocks ? blocks : kMaxBlocks);
    stream_kernel<<<static_cast<unsigned>(blocks), kThreads,
                    0, static_cast<cudaStream_t>(stream)>>>(rows, cols, offsets, num_rec, out);
    return static_cast<int>(cudaGetLastError());
}
