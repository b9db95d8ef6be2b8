// Helpers shared by the encoder-block and attention kernels (sm_90a): the
// element-type casts, warp reductions, the encoder blocks' widths
// (at_width), the tanh GELU, the residual + LayerNorm epilogue and the
// encoder blocks' LayerNorm pass. The kernels are templates on the element
// type (float or bf16) and on the widths (H, head_dim); the Python
// wrappers check that an instantiation exists before launching.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

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

// Calls launch(std::integral_constant<int, H>{}, std::integral_constant<int,
// DH>{}) at an instantiated width of the encoder blocks, in either dtype (H
// = num_heads * head_dim, head_dim: (384, 32), (768, 64) or (1024, 64), as
// ops/fused_encoder.py::KERNEL_WIDTHS lists them); returns its error,
// cudaErrorInvalidValue at any other width.
template <class Launch>
cudaError_t at_width(int num_heads, int head_dim, const Launch& launch) {
  const int hidden = num_heads * head_dim;
  if (hidden == 384 && head_dim == 32)
    return launch(std::integral_constant<int, 384>{}, std::integral_constant<int, 32>{});
  if (hidden == 768 && head_dim == 64)
    return launch(std::integral_constant<int, 768>{}, std::integral_constant<int, 64>{});
  if (hidden == 1024 && head_dim == 64)
    return launch(std::integral_constant<int, 1024>{}, std::integral_constant<int, 64>{});
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x))));
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

// out = T(LN(x + (y + b))) for rows blockIdx.x * 8 .. + 7 of width H, one
// warp a row: the encoder blocks' last launch, after their products into
// y (f32), in bf16 (encoder_tc.cuh) and f32 (encoder_tf32.cuh).
constexpr int kLnRows = 8;

namespace {

template <int H, typename T>
__global__ void __launch_bounds__(32 * kLnRows)
    layernorm_kernel(const float* __restrict__ y, const T* __restrict__ x, const float* __restrict__ b,
                     const float* __restrict__ gamma, const float* __restrict__ beta, T* __restrict__ out, int m) {
  const int r0 = blockIdx.x * kLnRows;
  const size_t at = static_cast<size_t>(r0) * H;
  residual_layernorm_rows<kLnRows, kLnRows, H>(y + at, x + at, H, b, gamma, beta, out + at, m - r0);
}

// Launches layernorm_kernel<H, T> over m rows on `st`; returns cudaGetLastError().
template <int H, typename T>
cudaError_t launch_layernorm(const float* y, const T* x, const float* b, const float* gamma, const float* beta,
                             T* out, int m, cudaStream_t st) {
  layernorm_kernel<H, T><<<(m + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, st>>>(y, x, b, gamma, beta, out, m);
  return cudaGetLastError();
}

}  // namespace

}  // namespace dial
