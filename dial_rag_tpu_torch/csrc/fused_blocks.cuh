// Device code shared by the encoder-block kernels (sm_90a):
// fused_attention.cu (TPU kernel _attn_block_kernel), fused_ffn.cu
// (_ffn_kernel) and fused_layer.cu (_layer_kernel). Each of those sources
// is built into its own library, so each gets its own copy.
//
// Every piece is a template on the element type T and the hidden width H;
// the instantiations are {bf16, f32} x {(H 384, head_dim 32), (H 768,
// head_dim 64)} (Tiles below; the Python wrappers check the set):
//   launch_qkv_attention: the host launch of
//     (a) the QKV projection, qkv = T(x . W_qkv + b_qkv) -> [B, S, 3H], and
//     (b) the attention, ctx = T(softmax(q k^T * scale + bias) T(P) v) per
//         head -> [B, S, H];
//   proj_tile: the [rows, H] f32 image of rows of ctx . W_out;
//   ffn_tile: the [rows, H] f32 image of T(gelu_tanh(a . W1 + b1)) . W2 for
//     rows of a held in shared memory.
// bf16 products run on the tensor cores through WMMA bf16 16x16x16 tiles
// with f32 accumulators. f32 products run on the CUDA cores in full f32
// (fused multiply-adds over K in order): WMMA has no f32 operands, and
// TF32 keeps about three decimal digits, too few for the reference's f32
// tolerance (2e-5); the f32 attention is the single-tile attention
// kernel's own device code (attention_f32.cuh) reading the packed qkv.
#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "attention_f32.cuh"

namespace dial {
namespace {

constexpr int kBlockThreads = 256;  // 8 warps: projection, FFN and layer tiles
constexpr int kMaxSmem = 232448;    // the opt-in shared memory of one H100 block

template <typename T>
constexpr bool kTensorCores = std::is_same<T, bf16>::value;

// Rows a block owns and the FFN's intermediate chunk, per instantiation.
// bf16 x 384 keeps the first design (64 rows, 64-column chunks); f32 x 384 has
// the bytes per row of bf16 x 768, so both take 32 rows and 32-column
// chunks; f32 x 768 halves them again. The budgets are asserted below.
template <typename T, int H>
struct Tiles;
template <>
struct Tiles<bf16, 384> {
  static constexpr int kRows = 64, kChunk = 64;
};
template <>
struct Tiles<bf16, 768> {
  static constexpr int kRows = 32, kChunk = 32;
};
template <>
struct Tiles<float, 384> {
  static constexpr int kRows = 32, kChunk = 32;
};
template <>
struct Tiles<float, 768> {
  static constexpr int kRows = 16, kChunk = 16;
};

constexpr int kRBK = 32;  // K step of the bf16 projection tile
constexpr int kSBK = 16;  // K step of the f32 projection tiles

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// the block's [rows, H] tile of T (FFN input, or the layer's a)
template <typename T, int H>
__host__ __device__ constexpr size_t x_bytes() {
  return static_cast<size_t>(Tiles<T, H>::kRows) * H * sizeof(T);
}
// the [rows, H] f32 accumulator image the LayerNorm epilogue reads
template <typename T, int H>
__host__ __device__ constexpr size_t image_bytes() {
  return static_cast<size_t>(Tiles<T, H>::kRows) * H * sizeof(float);
}
// proj_tile: bf16 stages a [rows, 32] and a [32, H] panel beside the
// image; f32 keeps its accumulators in registers, so the image reuses the
// [rows, 16] and [16, H] staging panels
template <typename T, int H>
__host__ __device__ constexpr size_t proj_bytes() {
  constexpr size_t rows = Tiles<T, H>::kRows;
  return kTensorCores<T> ? (rows * kRBK + kRBK * H) * sizeof(bf16) + image_bytes<T, H>()
                         : cmax((rows * kSBK + kSBK * H) * sizeof(float), image_bytes<T, H>());
}
template <typename T, int H>
__host__ __device__ constexpr size_t w_chunk_bytes() {
  return static_cast<size_t>(H) * Tiles<T, H>::kChunk * sizeof(T);
}
// ffn_tile: the W1 and W2 chunks and the h chunk (f32, plus its bf16
// copy on the tensor-core path)
template <typename T, int H>
__host__ __device__ constexpr size_t ffn_work_bytes() {
  constexpr size_t h = static_cast<size_t>(Tiles<T, H>::kRows) * Tiles<T, H>::kChunk;
  return 2 * w_chunk_bytes<T, H>() + h * sizeof(float) + (kTensorCores<T> ? h * sizeof(bf16) : 0);
}
template <typename T, int H>
__host__ __device__ constexpr size_t ffn_smem() {
  return x_bytes<T, H>() + ffn_work_bytes<T, H>();
}
template <typename T, int H>
__host__ __device__ constexpr size_t layer_smem() {
  return x_bytes<T, H>() + cmax(proj_bytes<T, H>(), ffn_work_bytes<T, H>());
}

template <typename T, int H>
__host__ __device__ constexpr bool fits() {
  // the FFN's accumulator image reuses the two weight chunks
  return image_bytes<T, H>() <= 2 * w_chunk_bytes<T, H>() && proj_bytes<T, H>() <= kMaxSmem &&
         ffn_smem<T, H>() <= kMaxSmem && layer_smem<T, H>() <= kMaxSmem;
}
static_assert(fits<bf16, 384>() && fits<bf16, 768>() && fits<float, 384>() && fits<float, 768>(),
              "an instantiation's tiles exceed a block's shared memory");

// ---- f32 on the CUDA cores ---------------------------------------------
// Thread t of 256 owns rows (t / 32) * TM .. + TM of the block's tile and
// columns t % 32 + 32 j, j < TN: a warp reads one broadcast A value per
// row and 32 neighbouring W values per step, free of bank conflicts.
// acc[i][j] += sum_k A[row i, k] W[k, col j] over KB steps, k in order.
template <int TM, int TN, int KB, int LDA, int LDW>
__device__ __forceinline__ void simt_product(float (&acc)[TM][TN], const float* s_a, const float* s_w) {
  const int r0 = (threadIdx.x / 32) * TM, c0 = threadIdx.x % 32;
#pragma unroll 4
  for (int k = 0; k < KB; ++k) {
    float a[TM], w[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = s_a[(r0 + i) * LDA + k];
#pragma unroll
    for (int j = 0; j < TN; ++j) w[j] = s_w[k * LDW + c0 + 32 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

template <int TM, int TN, int LD>
__device__ __forceinline__ void store_image(float* s_c, const float (&acc)[TM][TN]) {
  const int r0 = (threadIdx.x / 32) * TM, c0 = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s_c[(r0 + i) * LD + c0 + 32 * j] = acc[i][j];
}

// (a) f32: qkv = x . W_qkv + b_qkv, a [32, 128] output tile per block
constexpr int kQM = 32, kQN = 128;

__global__ void __launch_bounds__(kBlockThreads)
    qkv_proj_f32_kernel(const float* __restrict__ a, const float* __restrict__ w, const float* __restrict__ bias,
                        float* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float s_a[kQM * kSBK];
  __shared__ __align__(16) float s_w[kSBK * kQN];
  constexpr int TM = kQM / 8, TN = kQN / 32;
  const int m0 = blockIdx.y * kQM, n0 = blockIdx.x * kQN;
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < k; k0 += kSBK) {
    load_tile<kQM, kSBK, kBlockThreads>(s_a, a + static_cast<size_t>(m0) * k + k0, k, m - m0);
    load_tile<kSBK, kQN, kBlockThreads>(s_w, w + static_cast<size_t>(k0) * n + n0, n, kSBK);
    __syncthreads();
    simt_product<TM, TN, kSBK, kSBK, kQN>(acc, s_a, s_w);
    __syncthreads();
  }
  const int r0 = (threadIdx.x / 32) * TM, c0 = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + c0 + 32 * j;
      if (m0 + r0 + i < m) c[static_cast<size_t>(m0 + r0 + i) * n + col] = acc[i][j] + bias[col];
    }
}

// ---- bf16 on the tensor cores --------------------------------------------
// (a) bf16: qkv = bf16(x . W_qkv + b_qkv), a [64, 64] output tile per block
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

// (b) bf16: ctx = softmax(q k^T * scale + bias) v, per head
constexpr int kAQ = 64, kAK = 64, kAThreads = 128;  // 4 warps, 16 query rows each

template <int DH>
__host__ __device__ constexpr size_t attention_smem() {
  return 3 * kAQ * DH * sizeof(bf16) + kAQ * kAK * (sizeof(float) + sizeof(bf16)) + 3 * kAQ * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kAThreads)
    attention_kernel(const bf16* __restrict__ qkv, const int32_t* __restrict__ mask,
                     bf16* __restrict__ ctx, int s, int num_heads, float scale) {
  // dynamic: at head_dim 64 the tiles pass the 48 KB of static memory
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);           // [kAQ, DH]
  bf16* s_k = s_q + kAQ * DH;                          // [kAK, DH]
  bf16* s_v = s_k + kAK * DH;                          // [kAK, DH]
  float* s_s = reinterpret_cast<float*>(s_v + kAK * DH);  // [kAQ, kAK] raw scores
  bf16* s_p = reinterpret_cast<bf16*>(s_s + kAQ * kAK);   // [kAQ, kAK] bf16 probabilities
  float* s_bias = reinterpret_cast<float*>(s_p + kAQ * kAK);
  float* s_m = s_bias + kAK;
  float* s_l = s_m + kAQ;

  const int q0 = blockIdx.x * kAQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hid = num_heads * DH;
  const size_t ld = 3 * static_cast<size_t>(hid);
  const bf16* base = qkv + static_cast<size_t>(b) * s * ld;
  const int32_t* mrow = mask + static_cast<size_t>(b) * s;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's query rows within the tile

  load_tile<kAQ, DH, kAThreads>(s_q, base + static_cast<size_t>(q0) * ld + head * DH, ld, s - q0);
  if (threadIdx.x < kAQ) {
    s_m[threadIdx.x] = -INFINITY;
    s_l[threadIdx.x] = 0.f;
  }
  __syncthreads();
  FragA fq[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wmma::load_matrix_sync(fq[kk], s_q + row0 * DH + kk * 16, DH);

  const int n_tiles = (s + kAK - 1) / kAK;

  // Loads key tile t (and the value tile when `with_v`) plus its mask
  // bias, then writes this warp's 16x64 block of raw q.k^T scores.
  auto scores_tile = [&](int t, bool with_v) {
    const int k0 = t * kAK;
    load_tile<kAK, DH, kAThreads>(s_k, base + static_cast<size_t>(k0) * ld + hid + head * DH, ld, s - k0);
    if (with_v)
      load_tile<kAK, DH, kAThreads>(s_v, base + static_cast<size_t>(k0) * ld + 2 * hid + head * DH, ld, s - k0);
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
      for (int kk = 0; kk < DH / 16; ++kk) {
        FragBt fk;  // k^T as a col-major [Dh, 64] operand is k row-major
        wmma::load_matrix_sync(fk, s_k + j * 16 * DH + kk * 16, DH);
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
  FragC acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
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
      for (int j = 0; j < DH / 16; ++j) {
        FragB fv;
        wmma::load_matrix_sync(fv, s_v + kk * 16 * DH + j * 16, DH);
        wmma::mma_sync(acc[j], fp, fv, acc[j]);
      }
    }
    __syncthreads();
  }

  static_assert(DH <= kAK, "the context goes out through the score tile");
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(s_s + row0 * kAK + j * 16, acc[j], kAK, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int q = q0 + row0 + rr;
    if (q < s)
      for (int c = lane; c < DH; c += 32)
        ctx[(static_cast<size_t>(b) * s + q) * hid + head * DH + c] = __float2bfloat16(s_s[(row0 + rr) * kAK + c]);
  }
}

// ---- (c) the [rows, H] f32 image of a[m0 : m0 + rows] . W, W [H, H] ----
// bf16: 8 warps as (rows / 32) x (8 / (rows / 32)), each a 32 x (96 or 96)
// sub-tile of 2 x 6 fragments. f32: simt_product over 16-deep K panels.
// Uses proj_bytes<T, H>() of shared memory at `smem` (128-byte aligned);
// returns the image, which lives there too.
template <typename T, int H>
__device__ __forceinline__ float* proj_tile(unsigned char* smem, const T* __restrict__ a, const T* __restrict__ w,
                                            int m0, int m) {
  constexpr int kRows = Tiles<T, H>::kRows;
  if constexpr (kTensorCores<T>) {
    constexpr int WR = kRows / 32, WC = 8 / WR, FN = H / WC / 16;
    bf16* s_a = reinterpret_cast<bf16*>(smem);
    bf16* s_w = s_a + kRows * kRBK;
    float* s_c = reinterpret_cast<float*>(s_w + kRBK * H);
    const int warp = threadIdx.x / 32;
    const int wr = warp / WC, wc = warp % WC;

    FragC acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < H; k0 += kRBK) {
      load_tile<kRows, kRBK, kBlockThreads>(s_a, a + static_cast<size_t>(m0) * H + k0, H, m - m0);
      load_tile<kRBK, H, kBlockThreads>(s_w, w + static_cast<size_t>(k0) * H, H, kRBK);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kRBK; kk += 16) {
        FragA fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], s_a + (wr * 32 + i * 16) * kRBK + kk, kRBK);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, s_w + kk * H + wc * FN * 16 + j * 16, H);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(s_c + (wr * 32 + i * 16) * H + wc * FN * 16 + j * 16, acc[i][j], H,
                                wmma::mem_row_major);
    __syncthreads();
    return s_c;
  } else {
    constexpr int TM = kRows / 8, TN = H / 32;
    float* s_a = reinterpret_cast<float*>(smem);
    float* s_w = s_a + kRows * kSBK;
    float acc[TM][TN] = {};
    for (int k0 = 0; k0 < H; k0 += kSBK) {
      load_tile<kRows, kSBK, kBlockThreads>(s_a, a + static_cast<size_t>(m0) * H + k0, H, m - m0);
      load_tile<kSBK, H, kBlockThreads>(s_w, w + static_cast<size_t>(k0) * H, H, kSBK);
      __syncthreads();
      simt_product<TM, TN, kSBK, kSBK, H>(acc, s_a, s_w);
      __syncthreads();
    }
    float* s_c = reinterpret_cast<float*>(smem);  // the panels are read: the image takes their place
    store_image<TM, TN, H>(s_c, acc);
    __syncthreads();
    return s_c;
  }
}

// ---- ffn_tile: T(gelu_tanh(x . W1 + b1)) . W2 for the block's rows ------
// s_x: the block's [rows, H] rows of T in shared memory; `work`:
// ffn_work_bytes<T, H>() of shared memory (128-byte aligned). Walks the
// intermediate columns in chunks: h = s_x . W1[:, chunk] in f32, + b1,
// tanh GELU in f32 and the cast to T, then at once into the [rows, H] f32
// accumulators with the matching rows of W2. Returns the accumulators'
// image, which lives in `work`.
template <typename T, int H>
__device__ __forceinline__ float* ffn_tile(const T* s_x, unsigned char* work, const T* __restrict__ w1,
                                           const float* __restrict__ b1, const T* __restrict__ w2, int inter) {
  constexpr int kRows = Tiles<T, H>::kRows, kCh = Tiles<T, H>::kChunk;
  T* s_w1 = reinterpret_cast<T*>(work);                            // [H, kCh]
  T* s_w2 = reinterpret_cast<T*>(work + w_chunk_bytes<T, H>());    // [kCh, H]
  float* s_hf = reinterpret_cast<float*>(work + 2 * w_chunk_bytes<T, H>());  // [kRows, kCh]
  float* s_c = reinterpret_cast<float*>(work);  // after the last chunk only
  const int warp = threadIdx.x / 32;

  if constexpr (kTensorCores<T>) {
    constexpr int WR = kRows / 32, WC = 8 / WR, FN = H / WC / 16;
    // first product: warp w owns row fragment hr and the kFPW column
    // fragments from hc, sharing each A fragment across them (16 rows x
    // 32 cols a warp at 64 x 64; 16 x 16 for warps 0-3 at 32 x 32)
    constexpr int kHFragCols = kCh / 16, kHFrags = (kRows / 16) * kHFragCols;
    constexpr int kFPW = kHFrags >= 8 ? kHFrags / 8 : 1, kWarpsPerRow = kHFragCols / kFPW;
    const int hr = warp / kWarpsPerRow, hc = (warp % kWarpsPerRow) * kFPW;
    bf16* s_hb = reinterpret_cast<bf16*>(s_hf + kRows * kCh);  // [kRows, kCh]
    const int wr = warp / WC, wc = warp % WC;  // second product: 32 rows x FN * 16 cols a warp

    FragC acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int c0 = 0; c0 < inter; c0 += kCh) {
      load_tile<H, kCh, kBlockThreads>(s_w1, w1 + c0, inter, H);
      load_tile<kCh, H, kBlockThreads>(s_w2, w2 + static_cast<size_t>(c0) * H, H, kCh);
      __syncthreads();

      // h chunk [kRows, kCh] = x [kRows, H] . W1[:, c0 : c0 + kCh]
      if (hr < kRows / 16) {
        FragC h[kFPW];
#pragma unroll
        for (int j = 0; j < kFPW; ++j) wmma::fill_fragment(h[j], 0.f);
        for (int kk = 0; kk < H; kk += 16) {
          FragA fa;
          wmma::load_matrix_sync(fa, s_x + hr * 16 * H + kk, H);
#pragma unroll
          for (int j = 0; j < kFPW; ++j) {
            FragB fb;
            wmma::load_matrix_sync(fb, s_w1 + kk * kCh + (hc + j) * 16, kCh);
            wmma::mma_sync(h[j], fa, fb, h[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kFPW; ++j)
          wmma::store_matrix_sync(s_hf + hr * 16 * kCh + (hc + j) * 16, h[j], kCh, wmma::mem_row_major);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * kCh; i += kBlockThreads)
        s_hb[i] = __float2bfloat16(gelu_tanh(s_hf[i] + b1[c0 + i % kCh]));
      __syncthreads();

      // acc [kRows, H] += bf16(h chunk) . W2[c0 : c0 + kCh, :]
#pragma unroll
      for (int kk = 0; kk < kCh; kk += 16) {
        FragA fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], s_hb + (wr * 32 + i * 16) * kCh + kk, kCh);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, s_w2 + kk * H + wc * FN * 16 + j * 16, H);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(s_c + (wr * 32 + i * 16) * H + wc * FN * 16 + j * 16, acc[i][j], H,
                                wmma::mem_row_major);
  } else {
    constexpr int TM = kRows / 8, TN = H / 32;
    // first product: thread t owns column t % kCh of the chunk and rows
    // t / kCh + (256 / kCh) u, u < kHPer
    static_assert(kBlockThreads % kCh == 0 && (kRows * kCh) % kBlockThreads == 0, "h chunk per thread");
    constexpr int kHPer = kRows * kCh / kBlockThreads, kRowStep = kBlockThreads / kCh;
    const int hc = threadIdx.x % kCh, hr = threadIdx.x / kCh;
    float acc[TM][TN] = {};

    for (int c0 = 0; c0 < inter; c0 += kCh) {
      load_tile<H, kCh, kBlockThreads>(s_w1, w1 + c0, inter, H);
      load_tile<kCh, H, kBlockThreads>(s_w2, w2 + static_cast<size_t>(c0) * H, H, kCh);
      __syncthreads();
      float h[kHPer] = {};
      for (int k = 0; k < H; ++k) {
        const float w = s_w1[k * kCh + hc];
#pragma unroll
        for (int u = 0; u < kHPer; ++u) h[u] = fmaf(s_x[(hr + kRowStep * u) * H + k], w, h[u]);
      }
#pragma unroll
      for (int u = 0; u < kHPer; ++u) s_hf[(hr + kRowStep * u) * kCh + hc] = gelu_tanh(h[u] + b1[c0 + hc]);
      __syncthreads();
      simt_product<TM, TN, kCh, kCh, H>(acc, s_hf, s_w2);
      __syncthreads();
    }
    store_image<TM, TN, H>(s_c, acc);
  }
  __syncthreads();
  return s_c;
}

// Launches (a) and (b) on `st`: qkv [B, S, 3H] and ctx [B, S, H] are
// device scratch of T. Returns the first CUDA error (cudaSuccess if none).
template <typename T, int H, int DH>
cudaError_t launch_qkv_attention(const void* x, const void* mask, const void* wqkv, const void* bqkv, void* qkv,
                                 void* ctx, int batch, int seq, int num_heads, float scale, cudaStream_t st) {
  const int m = batch * seq;
  const int n3 = 3 * H;
  cudaError_t err;
  if constexpr (kTensorCores<T>) {
    qkv_proj_kernel<<<dim3(n3 / kPBN, (m + kPBM - 1) / kPBM), kPThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
        static_cast<bf16*>(qkv), m, n3, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    constexpr size_t smem = attention_smem<DH>();
    err = cudaFuncSetAttribute(attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attention_kernel<DH><<<dim3((seq + kAQ - 1) / kAQ, num_heads, batch), kAThreads, smem, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const int32_t*>(mask), static_cast<bf16*>(ctx), seq, num_heads,
        scale);
    return cudaGetLastError();
  } else {
    qkv_proj_f32_kernel<<<dim3(n3 / kQN, (m + kQM - 1) / kQM), kBlockThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wqkv), static_cast<const float*>(bqkv),
        static_cast<float*>(qkv), m, n3, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // q, k and v as [B, h, S, DH] views of the packed qkv, ctx as one of [B, S, H]
    const long long sq = static_cast<long long>(seq);
    const attn::View packed{sq * n3, DH, n3}, out{sq * H, DH, H};
    const attn::FwdViews vw{packed, packed, packed, out};
    const float* q = static_cast<const float*>(qkv);
    return attn::launch_attention_fwd<float, DH>(q, q + H, q + 2 * H, static_cast<const int32_t*>(mask),
                                                 static_cast<float*>(ctx), vw, batch, num_heads, seq, scale, st);
  }
}

}  // namespace
}  // namespace dial
