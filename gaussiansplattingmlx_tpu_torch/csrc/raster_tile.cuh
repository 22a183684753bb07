// The shared-memory record layout of the tile kernels, forward compositing
// K1 (rasterize_fwd.cu) and the backward replay of K3 and K7
// (rasterize_bwd_tile.cuh): a record's kRecRows rows of records[16, P] are
// staged as 3 x float4 (kRecStride floats), (mx, my, c00, c01), (c10, c11,
// r, g), (b, depth, opacity, pad), so that a thread reads a record with
// three broadcast 16-byte loads.
#pragma once

namespace {

constexpr int kRecRows = 11;    // record rows the compositing reads
constexpr int kRecStride = 12;  // shared-memory floats per staged record (3 x float4)

}  // namespace
