// Fused attention block of the bge-small encoder, for Hopper (sm_90a).
//
// Replaces: dial_rag_tpu/ops/fused_encoder.py::_attn_block_kernel
// (pallas_call in _attn_block_forward, wrapper fused_attention_block).
// Computes, per batch row,
//   out = LN(x + W_out . MHA(bf16(W_qkv . x + b_qkv)) + b_out)
// with f32 accumulation, f32 softmax over scores*scale + (1-mask)*f32.min,
// probabilities cast to bf16 before P.V, LayerNorm eps 1e-12, bf16 out.
//
// Bound on an H100 SXM at B=128, S=256, H=384, 12 heads (Dh=32):
//   operations: QKV 29.0 + QK^T 6.4 + PV 6.4 + out-proj 9.7 = 51.5 GFLOP
//               -> 0.052 ms at 989 TFLOP/s bf16;
//   bytes:      x 25.2 MB in, out 25.2 MB, weights 1.2 MB, mask 0.1 MB
//               -> 0.0154 ms at 3.35 TB/s.
//   So the block is bound by operations (0.052 ms).
//
// Design. The TPU kernel keeps the whole [S, S] f32 score tile of a head
// in 16 MiB of VMEM; an H100 block has 227 KB of shared memory, so the
// work is split into three launches:
//   (a) qkv_proj_kernel: [B*S, H] x [H, 3H] + b -> bf16 scratch [B, S, 3H];
//   (b) attention_kernel: one block per (64-query tile, head, batch row),
//       reading q/k/v straight out of the [B, S, 3H] layout. Two passes
//       over 64-key tiles: the first finds each row's max and softmax
//       denominator, the second rebuilds the scores and forms the
//       normalised probabilities, so P is cast to bf16 after the
//       division, exactly where the TPU kernel casts it;
//   (c) proj_residual_layernorm_kernel: [64 rows, H] of ctx . W_out, then
//       bias, residual and LayerNorm, one row per warp.
// The products run on the tensor cores through WMMA bf16 16x16x16 tiles
// with f32 accumulators. What the design still moves through device
// memory and the TPU kernel did not: the qkv scratch (75.5 MB written,
// read back) and ctx (25.2 MB written, read back) at the shape above.
// Keeping them on chip is the first target of a later optimisation.
#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace dial {
namespace {

// ---- (a) qkv = bf16(x . W_qkv + b_qkv) ----------------------------------
constexpr int kPBM = 64, kPBN = 64, kPBK = 32, kPThreads = 128;

__global__ void __launch_bounds__(kPThreads)
    qkv_proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                    const float* __restrict__ bias, bf16* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(128) bf16 s_a[kPBM * kPBK];
  __shared__ __align__(128) bf16 s_w[kPBK * kPBN];
  __shared__ __align__(128) float s_c[kPBM * kPBN];
  const int m0 = blockIdx.y * kPBM;
  const int n0 = blockIdx.x * kPBN;
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;  // each warp owns a 32x32 sub-tile

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kPBK) {
    load_tile<kPBM, kPBK, kPThreads>(s_a, a + static_cast<size_t>(m0) * k + k0, k, m - m0);
    load_tile<kPBK, kPBN, kPThreads>(s_w, w + static_cast<size_t>(k0) * n + n0, n, kPBK);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPBK; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], s_a + (wr * 32 + i * 16) * kPBK + kk, kPBK);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, s_w + kk * kPBN + wc * 32 + j * 16, kPBN);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s_c + (wr * 32 + i * 16) * kPBN + wc * 32 + j * 16, acc[i][j], kPBN,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kPBM * kPBN; i += kPThreads) {
    const int r = i / kPBN, col = i % kPBN;
    if (m0 + r < m)
      c[static_cast<size_t>(m0 + r) * n + n0 + col] = __float2bfloat16(s_c[i] + bias[n0 + col]);
  }
}

// ---- (b) ctx = softmax(q k^T * scale + bias) v, per head -----------------
constexpr int kAQ = 64, kAK = 64, kAThreads = 128;  // 4 warps, 16 query rows each

__global__ void __launch_bounds__(kAThreads)
    attention_kernel(const bf16* __restrict__ qkv, const int32_t* __restrict__ mask,
                     bf16* __restrict__ ctx, int s, int num_heads, float scale) {
  __shared__ __align__(128) bf16 s_q[kAQ * kHeadDim];
  __shared__ __align__(128) bf16 s_k[kAK * kHeadDim];
  __shared__ __align__(128) bf16 s_v[kAK * kHeadDim];
  __shared__ __align__(128) float s_s[kAQ * kAK];
  __shared__ __align__(128) bf16 s_p[kAQ * kAK];
  __shared__ float s_bias[kAK];
  __shared__ float s_m[kAQ];
  __shared__ float s_l[kAQ];

  const int q0 = blockIdx.x * kAQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hid = num_heads * kHeadDim;
  const size_t ld = 3 * static_cast<size_t>(hid);
  const bf16* base = qkv + static_cast<size_t>(b) * s * ld;
  const int32_t* mrow = mask + static_cast<size_t>(b) * s;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's query rows within the tile

  load_tile<kAQ, kHeadDim, kAThreads>(s_q, base + static_cast<size_t>(q0) * ld + head * kHeadDim, ld, s - q0);
  if (threadIdx.x < kAQ) {
    s_m[threadIdx.x] = -INFINITY;
    s_l[threadIdx.x] = 0.f;
  }
  __syncthreads();
  FragA fq[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) wmma::load_matrix_sync(fq[kk], s_q + row0 * kHeadDim + kk * 16, kHeadDim);

  const int n_tiles = (s + kAK - 1) / kAK;

  // Loads key tile t (and the value tile when `with_v`) plus its mask
  // bias, then writes this warp's 16x64 block of raw q.k^T scores.
  auto scores_tile = [&](int t, bool with_v) {
    const int k0 = t * kAK;
    load_tile<kAK, kHeadDim, kAThreads>(s_k, base + static_cast<size_t>(k0) * ld + hid + head * kHeadDim, ld, s - k0);
    if (with_v)
      load_tile<kAK, kHeadDim, kAThreads>(s_v, base + static_cast<size_t>(k0) * ld + 2 * hid + head * kHeadDim, ld,
                                          s - k0);
    if (threadIdx.x < kAK) {
      const int kv = k0 + threadIdx.x;
      s_bias[threadIdx.x] = kv < s ? (1.f - static_cast<float>(mrow[kv])) * -FLT_MAX : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAK / 16; ++j) {
      FragC sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        FragBt fk;  // k^T as a col-major [Dh, 64] operand is k row-major
        wmma::load_matrix_sync(fk, s_k + j * 16 * kHeadDim + kk * 16, kHeadDim);
        wmma::mma_sync(sc, fq[kk], fk, sc);
      }
      wmma::store_matrix_sync(s_s + row0 * kAK + j * 16, sc, kAK, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // pass 1: row max and softmax denominator over all key tiles
  for (int t = 0; t < n_tiles; ++t) {
    scores_tile(t, false);
    const int k0 = t * kAK;
    const bool ok0 = k0 + lane < s, ok1 = k0 + lane + 32 < s;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const float v0 = ok0 ? s_s[r * kAK + lane] * scale + s_bias[lane] : -INFINITY;
      const float v1 = ok1 ? s_s[r * kAK + lane + 32] * scale + s_bias[lane + 32] : -INFINITY;
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(v0, v1)));
      const float e = (ok0 ? expf(v0 - m_new) : 0.f) + (ok1 ? expf(v1 - m_new) : 0.f);
      const float sum = warp_sum(e);
      __syncwarp();  // every lane has read s_m[r] before lane 0 updates it
      if (lane == 0) {
        s_l[r] = s_l[r] * expf(m_old - m_new) + sum;
        s_m[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // pass 2: normalised bf16 probabilities, P . V accumulated in f32
  FragC acc[kHeadDim / 16];
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    scores_tile(t, true);
    const int k0 = t * kAK;
    const bool ok0 = k0 + lane < s, ok1 = k0 + lane + 32 < s;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const float m = s_m[r], l = s_l[r];
      const float p0 = ok0 ? expf(s_s[r * kAK + lane] * scale + s_bias[lane] - m) / l : 0.f;
      const float p1 = ok1 ? expf(s_s[r * kAK + lane + 32] * scale + s_bias[lane + 32] - m) / l : 0.f;
      s_p[r * kAK + lane] = __float2bfloat16(p0);
      s_p[r * kAK + lane + 32] = __float2bfloat16(p1);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kAK / 16; ++kk) {
      FragA fp;
      wmma::load_matrix_sync(fp, s_p + row0 * kAK + kk * 16, kAK);
#pragma unroll
      for (int j = 0; j < kHeadDim / 16; ++j) {
        FragB fv;
        wmma::load_matrix_sync(fv, s_v + kk * 16 * kHeadDim + j * 16, kHeadDim);
        wmma::mma_sync(acc[j], fp, fv, acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j)
    wmma::store_matrix_sync(s_s + row0 * kAK + j * 16, acc[j], kAK, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int q = q0 + row0 + rr;
    if (q < s)
      ctx[(static_cast<size_t>(b) * s + q) * hid + head * kHeadDim + lane] =
          __float2bfloat16(s_s[(row0 + rr) * kAK + lane]);
  }
}

// ---- (c) out = LN(x + ctx . W_out + b_out) -------------------------------
constexpr int kRBM = 64, kRBK = 32, kRThreads = 256;  // 8 warps: 2 x 4 of 32x96
constexpr size_t kProjSmem = (kRBM * kRBK + kRBK * kHidden) * sizeof(bf16) + kRBM * kHidden * sizeof(float);

__global__ void __launch_bounds__(kRThreads)
    proj_residual_layernorm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                                   const float* __restrict__ bias, const bf16* __restrict__ resid,
                                   const float* __restrict__ gamma, const float* __restrict__ beta,
                                   bf16* __restrict__ out, int m) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_a + kRBM * kRBK;
  float* s_c = reinterpret_cast<float*>(s_w + kRBK * kHidden);
  const int m0 = blockIdx.x * kRBM;
  const int warp = threadIdx.x / 32;
  const int wr = warp / 4, wc = warp % 4;

  FragC acc[2][6];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < kHidden; k0 += kRBK) {
    load_tile<kRBM, kRBK, kRThreads>(s_a, a + static_cast<size_t>(m0) * kHidden + k0, kHidden, m - m0);
    load_tile<kRBK, kHidden, kRThreads>(s_w, w + static_cast<size_t>(k0) * kHidden, kHidden, kRBK);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRBK; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], s_a + (wr * 32 + i * 16) * kRBK + kk, kRBK);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, s_w + kk * kHidden + wc * 96 + j * 16, kHidden);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      wmma::store_matrix_sync(s_c + (wr * 32 + i * 16) * kHidden + wc * 96 + j * 16, acc[i][j], kHidden,
                              wmma::mem_row_major);
  __syncthreads();
  residual_layernorm_rows<kRBM, kRThreads / 32>(s_c, resid + static_cast<size_t>(m0) * kHidden, kHidden, bias,
                                                gamma, beta, out + static_cast<size_t>(m0) * kHidden, m - m0);
}

}  // namespace
}  // namespace dial

// C entry point. All pointers are device pointers: x, wqkv, wout, qkv
// (scratch [B, S, 3H]), ctx (scratch [B, S, H]) and out are bf16; bqkv,
// bout, gamma, beta are f32; mask is int32 [B, S]. Launches the three
// kernels on `stream` and returns the first CUDA error (0 on success).
extern "C" int dial_attention_block_bf16(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* bout, const void* gamma, const void* beta,
                                         void* qkv, void* ctx, void* out, int batch, int seq, int num_heads,
                                         float scale, void* stream) {
  using namespace dial;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = batch * seq;
  const int n3 = 3 * kHidden;
  qkv_proj_kernel<<<dim3(n3 / kPBN, (m + kPBM - 1) / kPBM), kPThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<bf16*>(qkv), m, n3, kHidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<<<dim3((seq + kAQ - 1) / kAQ, num_heads, batch), kAThreads, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const int32_t*>(mask), static_cast<bf16*>(ctx), seq, num_heads,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(proj_residual_layernorm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kProjSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  proj_residual_layernorm_kernel<<<(m + kRBM - 1) / kRBM, kRThreads, kProjSmem, st>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(wout), static_cast<const float*>(bout),
      static_cast<const bf16*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
