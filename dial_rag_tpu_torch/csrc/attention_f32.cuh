// Pieces shared by the f32 single-tile attention forward and backward
// (flash_attention_fwd.cu, flash_attention_bwd.cu). Both recompute the
// same probabilities, so the arithmetic that produces them lives here
// once: a pass that rebuilds P from a saved row max and denominator gets
// the forward's bits exactly.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#include "common.cuh"

namespace dial {
namespace attn {

constexpr int kDh = 32;        // head width (bge-small); the wrappers check it
constexpr int kRows = 32;      // query rows (or keys) a block owns
constexpr int kChunk = 64;     // keys streamed through shared memory at a time
constexpr int kThreads = 256;  // 8 warps; thread t owns row t / 8, phase t % 8
constexpr int kPhases = 8;
constexpr int kPad = kDh + 1;  // padded [*, Dh] rows: lanes on distinct banks

// Element strides of one [B, h, S, Dh] operand; the head dimension has
// unit stride. A packed [B, S, 3H] qkv is read as three such views.
struct View {
  long long b, h, r;
};

__host__ __device__ inline int padded_seq(int s) { return (s + kChunk - 1) / kChunk * kChunk; }
// Row stride of the [kRows, S] score tile: odd, so the 4 rows a warp
// touches at one column sit on different banks.
__host__ __device__ inline int score_ld(int s) { return padded_seq(s) + 1; }

// a . b over the head width, in one fixed order (d = 0..31, fused
// multiply-add); every pass that forms a score or a dP uses it.
__device__ __forceinline__ float dot_dh(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kDh; ++d) acc = fmaf(a[d], b[d], acc);
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

// Copies rows [r0, r0 + n) of one head of a view into a [n_rows, kPad]
// tile, zero past `s`. A warp reads one 128-byte row at a time.
template <int NROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long row_stride, int r0, int s) {
  for (int i = threadIdx.x; i < NROWS * kDh; i += kThreads) {
    const int r = i / kDh, d = i % kDh;
    dst[r * kPad + d] = r0 + r < s ? base[(r0 + r) * row_stride + d] : 0.f;
  }
}

// The block's [kRows, S] score tile turned into probabilities in place,
// exactly as the TPU kernel orders it: scores * scale + bias for every
// key, then per row the max, exp(s - max), their sum and the division.
// `q_row` is this thread's query row in registers (thread t owns row
// t / kPhases); `s_kv` is a [kChunk, kPad] staging tile; `s_bias` holds
// the S bias values. Leaves the row max and the denominator in s_m, s_l.
__device__ __forceinline__ void probabilities(float* s_p, float* s_kv, const float* s_bias, float* s_m, float* s_l,
                                              const float* q_row, const float* k_head, long long k_row_stride, int s,
                                              float scale) {
  const int ld = score_ld(s);
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    load_rows<kChunk>(s_kv, k_head, k_row_stride, c0, s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk / kPhases; ++i) {
      const int c = j + kPhases * i;
      if (c0 + c < s) s_p[r * ld + c0 + c] = scaled_score(dot_dh(q_row, s_kv + c * kPad), scale, s_bias[c0 + c]);
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

}  // namespace attn
}  // namespace dial
