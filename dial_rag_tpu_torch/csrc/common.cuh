// Helpers shared by the fused encoder-block kernels (sm_90a, bf16 WMMA
// tensor-core tiles with f32 accumulation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace dial {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// bge-small widths the kernels are specialised for; the Python wrappers
// check them before launching.
constexpr int kHidden = 384;
constexpr int kHeadDim = 32;
constexpr float kLayerNormEps = 1e-12f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Copies a [rows, cols] bf16 tile (row stride `ld` elements in global
// memory) into shared memory with row stride `cols`, 16 bytes a thread
// and a step. Rows at or past `rows_valid` are zero-filled. `cols`, `ld`
// and the column offset of `src` must be multiples of 8 elements.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t ld, int rows_valid) {
  constexpr int kVecPerRow = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += THREADS) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) v = *reinterpret_cast<const uint4*>(src + r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * COLS + c) = v;
  }
}

// out[r, :] = bf16(LN(resid[r, :] + (acc[r, :] + bias))) for the block's
// rows, one row per warp at a time: the residual sum and the two-pass
// mean/variance run in f32, as the TPU kernels' _layernorm_f32 does.
template <int ROWS, int WARPS>
__device__ __forceinline__ void residual_layernorm_rows(
    const float* acc, const bf16* resid, int resid_ld, const float* bias, const float* gamma,
    const float* beta, bf16* out, int rows_valid) {
  constexpr int kPerLane = kHidden / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS && r < rows_valid; r += WARPS) {
    float v[kPerLane];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = __bfloat162float(resid[r * resid_ld + c]) + (acc[r * kHidden + c] + bias[c]);
      sum += v[i];
    }
    const float mean = warp_sum(sum) / kHidden;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) sq += (v[i] - mean) * (v[i] - mean);
    const float inv = rsqrtf(warp_sum(sq) / kHidden + kLayerNormEps);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      out[r * kHidden + c] = __float2bfloat16((v[i] - mean) * inv * gamma[c] + beta[c]);
    }
  }
}

}  // namespace dial
