// The CUDA-core single-tile attention: the forward of the f32 fused
// blocks (fused_blocks.cuh, kernels 1 and 3 in f32) and the probabilities
// the bf16 single-tile backward (flash_attention_bwd.cu) rebuilds; their
// arithmetic lives here once, so a pass that rebuilds P from a saved row
// max and denominator gets the forward's bits exactly. Also the views,
// the padding of S, the score expression and the shared-memory limit
// query that the f32 split-TF32 single-tile kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) and the long-sequence kernels share. The
// single-tile code is a template on the element type T (f32 or bf16:
// loads and stores in T, every product and sum in f32, P cast through T
// where the reference casts it) and on the head width DH (32 or 64).
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

// ---- the single-tile forward (TPU kernels 4 and 5) -------------------------
struct FwdViews {
  View q, k, v, o;
};

template <int DH>
size_t fwd_smem_bytes(int s) {
  return sizeof(float) * (static_cast<size_t>(kRows) * score_ld(s) + (kChunk + kRows) * (DH + 1) + padded_seq(s) +
                          2 * kRows);
}

// o = softmax(q k^T * scale + bias) v for one (32-query tile, head, batch
// row) block: the tile's full score rows in dynamic shared memory
// (fwd_smem_bytes), K then V streamed through a 64-key staging tile.
// Thread t owns query row t / 8 (in registers) and every 8th key (scores)
// or every 8th head column (P . V). P is cast through T before P . V.
template <typename T, int DH, typename BiasT>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const BiasT* __restrict__ bias, T* __restrict__ o, FwdViews vw, int s, float scale) {
  constexpr int kPadH = DH + 1;
  extern __shared__ __align__(16) float attn_smem[];
  const int ld = score_ld(s);
  float* s_p = attn_smem;               // [kRows, ld] scores, then probabilities
  float* s_kv = s_p + kRows * ld;       // [kChunk, kPadH] K or V chunk
  float* s_q = s_kv + kChunk * kPadH;   // [kRows, kPadH]
  float* s_bias = s_q + kRows * kPadH;  // [padded S]
  float* s_m = s_bias + padded_seq(s);
  float* s_l = s_m + kRows;

  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const T* q_head = q + b * vw.q.b + head * vw.q.h;
  const T* k_head = k + b * vw.k.b + head * vw.k.h;
  const T* v_head = v + b * vw.v.b + head * vw.v.h;
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;

  load_rows<kRows, DH>(s_q, q_head, vw.q.r, q0, s);
  for (int i = threadIdx.x; i < s; i += kThreads) s_bias[i] = bias_value(bias[static_cast<long long>(b) * s + i]);
  __syncthreads();
  float q_row[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) q_row[d] = s_q[r * kPadH + d];

  probabilities<DH>(s_p, s_kv, s_bias, s_m, s_l, q_row, k_head, vw.k.r, s, scale);

  // o[r, j + 8t] = sum_c cast(P[r, c]) v[c, j + 8t], keys in order
  float acc[DH / kPhases] = {};
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    load_rows<kChunk, DH>(s_kv, v_head, vw.v.r, c0, s);
    __syncthreads();
    const int n = min(kChunk, s - c0);
    for (int c = 0; c < n; ++c) {
      const float p = through<T>(s_p[r * ld + c0 + c]);
#pragma unroll
      for (int t = 0; t < DH / kPhases; ++t) acc[t] = fmaf(p, s_kv[c * kPadH + j + kPhases * t], acc[t]);
    }
    __syncthreads();
  }
  if (q0 + r < s) {
    T* o_row = o + b * vw.o.b + head * vw.o.h + (q0 + r) * vw.o.r;
#pragma unroll
    for (int t = 0; t < DH / kPhases; ++t) o_row[j + kPhases * t] = from_f32<T>(acc[t]);
  }
}

// Launches attention_fwd_kernel<T, DH> on [B, h, S, DH] views; returns
// the first CUDA error.
template <typename T, int DH, typename BiasT>
cudaError_t launch_attention_fwd(const T* q, const T* k, const T* v, const BiasT* bias, T* o, const FwdViews& vw,
                                 int batch, int heads, int seq, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DH>(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, DH, BiasT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_fwd_kernel<T, DH, BiasT>
      <<<dim3((seq + kRows - 1) / kRows, heads, batch), kThreads, smem, stream>>>(q, k, v, bias, o, vw, seq, scale);
  return cudaGetLastError();
}

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
