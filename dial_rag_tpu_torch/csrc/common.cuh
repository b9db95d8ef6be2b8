// Helpers shared by the encoder-block and attention kernels (sm_90a): the
// element-type casts, warp reductions, the tanh GELU, a 16-byte tile copy
// and the residual + LayerNorm epilogue. The kernels are templates on the
// element type (float or bf16) and on the widths (H, head_dim); the
// Python wrappers check that an instantiation exists before launching.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dial {

using bf16 = __nv_bfloat16;

constexpr float kLayerNormEps = 1e-12f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// x after a round trip through T: the reference's casts of P, e and dS
template <typename T>
__device__ __forceinline__ float through(float x) {
  return to_f32(from_f32<T>(x));
}

// The additive mask bias of one key: given as f32 (1 - mask) * f32.min by
// the attention wrappers, or formed in the kernel from the int32 mask the
// fused blocks take, with the same value.
__device__ __forceinline__ float bias_value(float b) { return b; }
__device__ __forceinline__ float bias_value(int32_t m) { return (1.f - static_cast<float>(m)) * -FLT_MAX; }

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

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x))));
}

// Copies a [rows, cols] tile of T (row stride `ld` elements in global
// memory) into shared memory with row stride `cols`, 16 bytes a thread
// and a step. Rows at or past `rows_valid` are zero-filled. `cols`, `ld`
// and the column offset of `src` must be multiples of 16 bytes.
template <int ROWS, int COLS, int THREADS, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t ld, int rows_valid) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(COLS % kVec == 0, "rows must be whole 16-byte vectors");
  constexpr int kVecPerRow = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += THREADS) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) v = *reinterpret_cast<const uint4*>(src + r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * COLS + c) = v;
  }
}

// out[r, :] = T(LN(resid[r, :] + (acc[r, :] + bias))) for the block's
// rows of width H, one row per warp at a time: the residual sum and the
// two-pass mean/variance run in f32, as the TPU kernels' _layernorm_f32
// does.
template <int ROWS, int WARPS, int H, typename T>
__device__ __forceinline__ void residual_layernorm_rows(
    const float* acc, const T* resid, int resid_ld, const float* bias, const float* gamma,
    const float* beta, T* out, int rows_valid) {
  constexpr int kPerLane = H / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS && r < rows_valid; r += WARPS) {
    float v[kPerLane];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = to_f32(resid[r * resid_ld + c]) + (acc[r * H + c] + bias[c]);
      sum += v[i];
    }
    const float mean = warp_sum(sum) / H;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) sq += (v[i] - mean) * (v[i] - mean);
    const float inv = rsqrtf(warp_sum(sq) / H + kLayerNormEps);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      out[r * H + c] = from_f32<T>((v[i] - mean) * inv * gamma[c] + beta[c]);
    }
  }
}

}  // namespace dial
