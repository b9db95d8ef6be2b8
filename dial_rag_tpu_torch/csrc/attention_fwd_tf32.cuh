// The single-tile attention forward in f32 on Hopper's tensor cores in
// split TF32 (sm_90a): TPU kernels 4 and 5 in f32 (flash_attention_fwd.cu,
// its note gives the design) and stage (b) of the f32 encoder blocks,
// kernels 1 and 3 (encoder_tf32.cuh), which read q, k and v by strides
// from their packed qkv. Each of those sources builds into its own
// library, so each gets its own copy. The kernel is a template on the
// head width DH (32 or 64) and on the key bias it is given: f32 (1 - mask)
// * f32.min [B, S] from the attention wrappers, or the int32 mask [B, S]
// of the fused blocks, from which it forms the same value (bias_value).
#pragma once

#include <cfloat>

#include "attention_f32.cuh"
#include "tensor_core_tf32.cuh"

namespace dial {
namespace attn {
namespace {

constexpr int kKeyChunk = 32;              // keys a ring stage holds
constexpr int kChunkTiles = kKeyChunk / 8;  // 8-key accumulator tiles of a chunk

// Dynamic shared memory at sequence length s: the q tile, two ring
// stages, the bias row and the block's scores (16 x padded S a warp).
template <int DH>
struct TileFwdLayout {
  static constexpr int kQ = tf32::kTileRows * tf32::kLd<DH>;
  static constexpr int kStage = kKeyChunk * tf32::kLd<DH>;
  static size_t bytes(int s) {
    const size_t padded = padded_seq(s);
    return sizeof(float) * (kQ + 2 * kStage + padded + tf32::kTileRows * padded);
  }
};

template <int DH>
size_t tile_fwd_bytes(int s) {
  return TileFwdLayout<DH>::bytes(s);
}

template <int DH, typename BiasT>
__global__ void __launch_bounds__(tf32::kThreads)
    single_tile_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            const BiasT* __restrict__ bias, float* __restrict__ o, FwdViews vw, int s, float scale) {
  using L = TileFwdLayout<DH>;
  extern __shared__ __align__(16) float fwd_smem[];
  const int padded = padded_seq(s);
  float* s_q = fwd_smem;
  float* s_ring = s_q + L::kQ;
  float* s_bias = s_ring + 2 * L::kStage;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
  // this lane's scores: 4 floats (rows g, g + 8; columns 2c, 2c + 1) per 8-key tile t, at + 128 t
  float* s_x = s_bias + padded + warp * 16 * padded + 4 * lane;
  const int q0 = blockIdx.x * tf32::kTileRows, head = blockIdx.y, b = blockIdx.z;
  const float* k_head = k + b * vw.k.b + head * vw.k.h;
  const float* v_head = v + b * vw.v.b + head * vw.v.h;
  const BiasT* bias_row = bias + static_cast<long long>(b) * s;
  const float* q_warp = s_q + 16 * warp * tf32::kLd<DH>;
  const int n_chunks = (s + kKeyChunk - 1) / kKeyChunk;
  auto issue = [&](int chunk, const float* head_rows, long long row_stride) {
    tf32::copy_rows_async<DH>(s_ring + (chunk % 2) * L::kStage, head_rows, row_stride, chunk * kKeyChunk,
                              kKeyChunk, s, blockDim.x);
  };

  // the block's 64 query rows, then the first K chunk; the warp's q rows
  // go to registers as split fragments, split once for every key chunk
  tf32::copy_rows_async<DH>(s_q, q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, tf32::kTileRows, s, blockDim.x);
  tc::cp_async_commit();
  issue(0, k_head, vw.k.r);
  tc::cp_async_commit();
  for (int i = threadIdx.x; i < n_chunks * kKeyChunk; i += blockDim.x)
    s_bias[i] = i < s ? bias_value(bias_row[i]) : -INFINITY;
  tc::cp_async_wait<1>();
  __syncthreads();
  tf32::FragA qa[DH / 8];
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) tf32::load_a(qa[ks], q_warp + 8 * ks, tf32::kLd<DH>);

  // pass 1: scores q . k * scale + bias (keys past S: -inf), kept; the
  // lane's max of its two rows
  float m[2] = {-INFINITY, -INFINITY};
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = tf32::ring_step(ch, n_chunks, [&](int next) { issue(next, k_head, vw.k.r); });
    float x[kChunkTiles][4];
    tf32::product_frags<kChunkTiles, DH>(x, qa, s_ring + st * L::kStage);
    const float* kb = s_bias + ch * kKeyChunk + 2 * c;
#pragma unroll
    for (int n = 0; n < kChunkTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = scaled_score(x[n][e], scale, kb[8 * n + e % 2]);
      m[0] = fmaxf(m[0], fmaxf(x[n][0], x[n][1]));
      m[1] = fmaxf(m[1], fmaxf(x[n][2], x[n][3]));
      *reinterpret_cast<float4*>(s_x + 128 * (ch * kChunkTiles + n)) = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
    }
    __syncthreads();
  }

  // per row: the max over its four lanes (key 0 is real, so it is
  // finite), e = exp(s - max) in place of the scores, the sum of e
  float l[2] = {0.f, 0.f}, r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = tf32::quad_max(m[h]);
  for (int t = 0; t < n_chunks * kChunkTiles; ++t) {
    float4* p = reinterpret_cast<float4*>(s_x + 128 * t);
    float4 e = *p;
    e.x = expf(__fsub_rn(e.x, m[0]));
    e.y = expf(__fsub_rn(e.y, m[0]));
    e.z = expf(__fsub_rn(e.z, m[1]));
    e.w = expf(__fsub_rn(e.w, m[1]));
    l[0] += e.x + e.y;
    l[1] += e.z + e.w;
    *p = e;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = tf32::quad_sum(l[h]);
    r[h] = __frcp_rn(l[h]);
  }

  // pass 2: o = sum over the keys of (e / l) v, one partial per 64 keys
  // added in f32
  float acc[DH / 8][4] = {}, part[DH / 8][4] = {};
  issue(0, v_head, vw.v.r);
  tc::cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = tf32::ring_step(ch, n_chunks, [&](int next) { issue(next, v_head, vw.v.r); });
    float p[kChunkTiles][4];
#pragma unroll
    for (int n = 0; n < kChunkTiles; ++n) {
      const float4 e = *reinterpret_cast<const float4*>(s_x + 128 * (ch * kChunkTiles + n));
      p[n][0] = tc::div_by(e.x, l[0], r[0]);
      p[n][1] = tc::div_by(e.y, l[0], r[0]);
      p[n][2] = tc::div_by(e.z, l[1], r[1]);
      p[n][3] = tc::div_by(e.w, l[1], r[1]);
    }
    tf32::accumulate_pairs<kChunkTiles, DH>(part, p, s_ring + st * L::kStage);
    if (ch % 2 == 1 || ch + 1 == n_chunks) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
          part[j][e] = 0.f;
        }
    }
    __syncthreads();
  }
  tf32::store_rows<DH>(o + b * vw.o.b + head * vw.o.h, vw.o.r, q0 + 16 * warp, s, acc);
}

// Launches single_tile_tf32_kernel<DH, BiasT> on [B, h, S, DH] views;
// returns the first CUDA error.
template <int DH, typename BiasT>
cudaError_t launch_single_tile(const float* q, const float* k, const float* v, const BiasT* bias, float* o,
                               const FwdViews& vw, int batch, int heads, int seq, float scale, cudaStream_t stream) {
  const size_t smem = tile_fwd_bytes<DH>(seq);
  cudaError_t err = cudaFuncSetAttribute(single_tile_tf32_kernel<DH, BiasT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  single_tile_tf32_kernel<DH, BiasT>
      <<<dim3((seq + tf32::kTileRows - 1) / tf32::kTileRows, heads, batch), tf32::kThreads, smem, stream>>>(
          q, k, v, bias, o, vw, seq, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace attn
}  // namespace dial
