// The CUDA-core single-tile attention pieces of the bf16 single-tile
// backward (flash_attention_bwd.cu): the score tile turned into
// probabilities and the products it rebuilds P and dP with. Also the
// views, the padding of S, the score expression and the shared-memory
// limit query that the f32 split-TF32 single-tile kernels
// (attention_fwd_tf32.cuh, flash_attention_bwd.cu) and the long-sequence
// kernels share. The single-tile code is a template on the element type T
// (loads in T, every product and sum in f32) and on the head width DH (32
// or 64).
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace dial {
namespace attn {

constexpr int kRows = 32;      // query rows (or keys) a block owns
constexpr int kChunk = 64;     // keys streamed through shared memory at a time
constexpr int kThreads = 256;  // 8 warps; thread t owns row t / 8, phase t % 8
constexpr int kPhases = 8;
// f32 [*, DH] tiles in shared memory have rows of DH + 1 floats, so the
// lanes of a warp reading one column land on distinct banks

// Element strides of one [B, h, S, Dh] operand; the head dimension has
// unit stride. A packed [B, S, 3H] qkv is read as three such views.
struct View {
  long long b, h, r;
};

__host__ __device__ inline int padded_seq(int s) { return (s + kChunk - 1) / kChunk * kChunk; }
// Row stride of the [kRows, S] score tile: odd, so the 4 rows a warp
// touches at one column sit on different banks.
__host__ __device__ inline int score_ld(int s) { return padded_seq(s) + 1; }

// a . b over the head width, in one fixed order (d = 0..DH-1, fused
// multiply-add); every pass that forms a score or a dP uses it.
template <int DH>
__device__ __forceinline__ float dot_dh(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// scores * scale + bias, rounded as the reference rounds it (no fused
// multiply-add across the two).
__device__ __forceinline__ float scaled_score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// exp(score - max) / denominator: the probability of one entry.
__device__ __forceinline__ float prob(float score, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(score, m)), l);
}

// Copies rows [r0, r0 + NROWS) of one head of a view into an f32
// [NROWS, DH + 1] tile, zero past `s`.
template <int NROWS, int DH, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base, long long row_stride, int r0, int s) {
  for (int i = threadIdx.x; i < NROWS * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 1) + d] = r0 + r < s ? to_f32(base[(r0 + r) * row_stride + d]) : 0.f;
  }
}

// The block's [kRows, S] score tile turned into probabilities in place,
// exactly as the TPU kernel orders it: scores * scale + bias for every
// key, then per row the max, exp(s - max), their sum and the division.
// `q_row` is this thread's query row in registers (thread t owns row
// t / kPhases); `s_kv` is a [kChunk, DH + 1] staging tile; `s_bias` holds
// the S bias values. Leaves the row max and the denominator in s_m, s_l.
template <int DH, typename T>
__device__ __forceinline__ void probabilities(float* s_p, float* s_kv, const float* s_bias, float* s_m, float* s_l,
                                              const float* q_row, const T* k_head, long long k_row_stride, int s,
                                              float scale) {
  const int ld = score_ld(s);
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    load_rows<kChunk, DH>(s_kv, k_head, k_row_stride, c0, s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk / kPhases; ++i) {
      const int c = j + kPhases * i;
      if (c0 + c < s) s_p[r * ld + c0 + c] = scaled_score(dot_dh<DH>(q_row, s_kv + c * (DH + 1)), scale, s_bias[c0 + c]);
    }
    __syncthreads();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kRowsPerWarp = kRows / (kThreads / 32);
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = warp * kRowsPerWarp + rr;
    float* p = s_p + row * ld;
    float m = -INFINITY;
    for (int c = lane; c < s; c += 32) m = fmaxf(m, p[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < s; c += 32) {
      const float e = expf(__fsub_rn(p[c], m));
      p[c] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int c = lane; c < s; c += 32) p[c] = __fdiv_rn(p[c], l);
    if (lane == 0) {
      s_m[row] = m;
      s_l[row] = l;
    }
  }
  __syncthreads();
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
