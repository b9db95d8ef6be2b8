// Pieces the single-tile attention kernels in f32 (attention_fwd_tf32.cuh,
// flash_attention_bwd.cu) and the long-sequence kernels share: the views,
// the padding of S, the score expression and the shared-memory limit
// query.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace dial {
namespace attn {

constexpr int kChunk = 64;  // the multiple S is padded to

// Element strides of one [B, h, S, Dh] operand; the head dimension has
// unit stride. A packed [B, S, 3H] qkv is read as three such views.
struct View {
  long long b, h, r;
};

__host__ __device__ inline int padded_seq(int s) { return (s + kChunk - 1) / kChunk * kChunk; }

// scores * scale + bias, rounded as the reference rounds it (no fused
// multiply-add across the two).
__device__ __forceinline__ float scaled_score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// The four views of the single-tile forward (attention_fwd_tf32.cuh).
struct FwdViews {
  View q, k, v, o;
};

// The longest S, a multiple of 64, whose dynamic shared memory
// (`smem_bytes`) fits the opt-in per-block limit of the current device.
inline cudaError_t max_seq_for(size_t (*smem_bytes)(int), int* max_seq) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int s = 0;
  while (smem_bytes(s + kChunk) <= static_cast<size_t>(limit)) s += kChunk;
  *max_seq = s;
  return cudaSuccess;
}

}  // namespace attn
}  // namespace dial
