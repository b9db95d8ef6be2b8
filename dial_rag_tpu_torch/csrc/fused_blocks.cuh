// Device code shared by the bf16 encoder-block kernels (sm_90a):
// fused_attention.cu (TPU kernel _attn_block_kernel), fused_ffn.cu
// (_ffn_kernel) and fused_layer.cu (_layer_kernel). Each of those sources
// is built into its own library, so each gets its own copy.
//   (a) qkv_proj_kernel: qkv = bf16(x . W_qkv + b_qkv) -> [B, S, 3H];
//   (b) attention_kernel: ctx = softmax(q k^T * scale + bias) v per head,
//       P cast to bf16 after the division -> [B, S, H] bf16;
//   launch_qkv_attention: the host launch of (a) then (b), shared by the
//       entry points of fused_attention.cu and fused_layer.cu;
//   proj_tile: the [64, H] f32 image of 64 rows of ctx . W_out;
//   ffn_tile: the [64, H] f32 image of bf16(gelu_tanh(a . W1 + b1)) . W2
//       for 64 rows of a held in shared memory.
// The products run on the tensor cores through WMMA bf16 16x16x16 tiles
// with f32 accumulators.
#pragma once

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

// ---- (c) the [64, H] f32 image of a[m0 : m0 + 64] . W, W [H, H] -------
constexpr int kRBM = 64, kRBK = 32, kRThreads = 256;  // 8 warps: 2 x 4 of 32x96
constexpr size_t kProjSmem = (kRBM * kRBK + kRBK * kHidden) * sizeof(bf16) + kRBM * kHidden * sizeof(float);

// Uses kProjSmem bytes of shared memory at `smem` (128-byte aligned);
// returns the image, which lives there too.
__device__ __forceinline__ float* proj_tile(unsigned char* smem, const bf16* __restrict__ a,
                                            const bf16* __restrict__ w, int m0, int m) {
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_a + kRBM * kRBK;
  float* s_c = reinterpret_cast<float*>(s_w + kRBK * kHidden);
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
  return s_c;
}

// ---- ffn_tile: bf16(gelu_tanh(x . W1 + b1)) . W2 for 64 rows -----------
constexpr int kFBM = 64, kFCH = 64, kFThreads = 256;
constexpr size_t kXBytes = kFBM * kHidden * sizeof(bf16);     // 48 KB
constexpr size_t kW1Bytes = kHidden * kFCH * sizeof(bf16);    // 48 KB
constexpr size_t kW2Bytes = kFCH * kHidden * sizeof(bf16);    // 48 KB
constexpr size_t kHfBytes = kFBM * kFCH * sizeof(float);      // 16 KB
constexpr size_t kHbBytes = kFBM * kFCH * sizeof(bf16);       //  8 KB
constexpr size_t kFfnWorkBytes = kW1Bytes + kW2Bytes + kHfBytes + kHbBytes;
// the [64, 384] f32 accumulator image reuses the two weight panels
static_assert(kFBM * kHidden * sizeof(float) <= kW1Bytes + kW2Bytes, "accumulator image must fit");
static_assert(kRThreads == kFThreads, "the layer kernel runs both tiles with one block");

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x))));
}

// s_x: the block's [64, H] bf16 rows in shared memory; `work`:
// kFfnWorkBytes of shared memory (128-byte aligned). Walks the
// intermediate columns in chunks of 64: h = s_x . W1[:, chunk] to shared
// memory, + b1, tanh GELU in f32 and the cast to bf16 there, then at once
// into the [64, H] f32 accumulators with the matching 64 rows of W2.
// Returns the accumulators' image, which lives in `work`.
__device__ __forceinline__ float* ffn_tile(const bf16* s_x, unsigned char* work, const bf16* __restrict__ w1,
                                           const float* __restrict__ b1, const bf16* __restrict__ w2, int inter) {
  bf16* s_w1 = reinterpret_cast<bf16*>(work);
  bf16* s_w2 = reinterpret_cast<bf16*>(work + kW1Bytes);
  float* s_hf = reinterpret_cast<float*>(work + kW1Bytes + kW2Bytes);
  bf16* s_hb = reinterpret_cast<bf16*>(work + kW1Bytes + kW2Bytes + kHfBytes);
  float* s_c = reinterpret_cast<float*>(work);  // after the last chunk only

  const int warp = threadIdx.x / 32;
  const int wr = warp / 4, wc = warp % 4;         // second product: 32 rows x 96 cols a warp
  const int hr = warp / 2, hc = (warp % 2) * 2;   // first product: 16 rows x 32 cols a warp

  FragC acc[2][6];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int c0 = 0; c0 < inter; c0 += kFCH) {
    load_tile<kHidden, kFCH, kFThreads>(s_w1, w1 + c0, inter, kHidden);
    load_tile<kFCH, kHidden, kFThreads>(s_w2, w2 + static_cast<size_t>(c0) * kHidden, kHidden, kFCH);
    __syncthreads();

    // h chunk [64, 64] = x [64, 384] . W1[:, c0:c0+64]
    FragC h[2];
    wmma::fill_fragment(h[0], 0.f);
    wmma::fill_fragment(h[1], 0.f);
    for (int kk = 0; kk < kHidden; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, s_x + hr * 16 * kHidden + kk, kHidden);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, s_w1 + kk * kFCH + (hc + j) * 16, kFCH);
        wmma::mma_sync(h[j], fa, fb, h[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s_hf + hr * 16 * kFCH + (hc + j) * 16, h[j], kFCH, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < kFBM * kFCH; i += kFThreads)
      s_hb[i] = __float2bfloat16(gelu_tanh(s_hf[i] + b1[c0 + i % kFCH]));
    __syncthreads();

    // acc [64, 384] += bf16(h chunk) . W2[c0:c0+64, :]
#pragma unroll
    for (int kk = 0; kk < kFCH; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], s_hb + (wr * 32 + i * 16) * kFCH + kk, kFCH);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, s_w2 + kk * kHidden + wc * 96 + j * 16, kHidden);
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
  return s_c;
}

// Launches (a) and (b) on `st`: qkv [B, S, 3H] and ctx [B, S, H] are
// device scratch. Returns the first CUDA error (cudaSuccess if none).
inline cudaError_t launch_qkv_attention(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                        void* qkv, void* ctx, int batch, int seq, int num_heads, float scale,
                                        cudaStream_t st) {
  const int m = batch * seq;
  const int n3 = 3 * kHidden;
  qkv_proj_kernel<<<dim3(n3 / kPBN, (m + kPBM - 1) / kPBM), kPThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<bf16*>(qkv), m, n3, kHidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_kernel<<<dim3((seq + kAQ - 1) / kAQ, num_heads, batch), kAThreads, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const int32_t*>(mask), static_cast<bf16*>(ctx), seq, num_heads,
      scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dial
