// Pieces shared by the long-sequence attention forwards and backwards
// (flash_attention_long.cu, flash_attention_long_bwd.cu): one template
// serves f32 and bf16, so the dtype enters only through these loads,
// casts and stores; every product and sum runs in f32.
#pragma once

#include "attention_f32.cuh"

namespace dial {
namespace attn {

constexpr int kPerThread = kDh / kPhases;  // head columns a thread owns
constexpr int kKeysPerThread = kChunk / kPhases;
// row stride of the [kRows, kChunk] probability tile: the 4 rows and 8
// phases of a warp land on 32 distinct banks
constexpr int kPLd = kChunk + 8;

// Rows [r0, r0 + NROWS) of one head into a [NROWS, kPad] f32 tile. S is a
// multiple of kChunk (the wrapper checks), so every row is real.
template <int NROWS, typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* base, long long row_stride, int r0) {
  for (int i = threadIdx.x; i < NROWS * kDh; i += kThreads) {
    const int r = i / kDh, d = i % kDh;
    dst[r * kPad + d] = to_f32(base[(r0 + r) * row_stride + d]);
  }
}

// The max and the sum over the 8 neighbouring lanes that share a row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = kPhases / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kPhases / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace attn
}  // namespace dial
