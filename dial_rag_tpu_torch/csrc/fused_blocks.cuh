// Device code shared by the f32 encoder-block kernels (sm_90a):
// fused_attention.cu (TPU kernel _attn_block_kernel), fused_ffn.cu
// (_ffn_kernel) and fused_layer.cu (_layer_kernel) in f32; in bf16 they
// run on the tensor cores (encoder_tc.cuh). Each of those sources is built
// into its own library, so each gets its own copy.
//
// The pieces are templates on the element type T, instantiated for f32,
// and the hidden width H, at H 384 (head_dim 32) and 768 (head_dim 64)
// (Tiles below; the Python wrappers check the set):
//   launch_qkv_attention: the host launch of
//     (a) the QKV projection, qkv = x . W_qkv + b_qkv -> [B, S, 3H], and
//     (b) the attention, ctx = softmax(q k^T * scale + bias) v per head ->
//         [B, S, H];
//   proj_tile: the [rows, H] f32 image of rows of ctx . W_out;
//   ffn_tile: the [rows, H] f32 image of gelu_tanh(a . W1 + b1) . W2 for
//     rows of a held in shared memory.
// Products run on the CUDA cores in full f32 (fused multiply-adds over K
// in order): the tensor cores take no f32 operands, and TF32 keeps about
// three decimal digits, too few for the reference's f32 tolerance (2e-5);
// the attention is the single-tile attention kernel's own device code
// (attention_f32.cuh) reading the packed qkv.
#pragma once

#include <cstdint>

#include "attention_f32.cuh"

namespace dial {
namespace {

constexpr int kBlockThreads = 256;  // 8 warps: projection, FFN and layer tiles
constexpr int kMaxSmem = 232448;    // the opt-in shared memory of one H100 block

// Rows a block owns and the FFN's intermediate chunk, per instantiation:
// 32 rows and 32-column chunks at H 384; H 768 halves them. The budgets
// are asserted below.
template <typename T, int H>
struct Tiles;
template <>
struct Tiles<float, 384> {
  static constexpr int kRows = 32, kChunk = 32;
};
template <>
struct Tiles<float, 768> {
  static constexpr int kRows = 16, kChunk = 16;
};

constexpr int kSBK = 16;  // K step of the projection tiles

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
// proj_tile keeps its accumulators in registers, so the image reuses the
// [rows, 16] and [16, H] staging panels
template <typename T, int H>
__host__ __device__ constexpr size_t proj_bytes() {
  constexpr size_t rows = Tiles<T, H>::kRows;
  return cmax((rows * kSBK + kSBK * H) * sizeof(float), image_bytes<T, H>());
}
template <typename T, int H>
__host__ __device__ constexpr size_t w_chunk_bytes() {
  return static_cast<size_t>(H) * Tiles<T, H>::kChunk * sizeof(T);
}
// ffn_tile: the W1 and W2 chunks and the f32 h chunk
template <typename T, int H>
__host__ __device__ constexpr size_t ffn_work_bytes() {
  constexpr size_t h = static_cast<size_t>(Tiles<T, H>::kRows) * Tiles<T, H>::kChunk;
  return 2 * w_chunk_bytes<T, H>() + h * sizeof(float);
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
static_assert(fits<float, 384>() && fits<float, 768>(),
              "an instantiation's tiles exceed a block's shared memory");

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

// (a) qkv = x . W_qkv + b_qkv, a [32, 128] output tile per block
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

// ---- (c) the [rows, H] f32 image of a[m0 : m0 + rows] . W, W [H, H] ----
// simt_product over 16-deep K panels. Uses proj_bytes<T, H>() of shared
// memory at `smem` (128-byte aligned); returns the image, which lives
// there too.
template <typename T, int H>
__device__ __forceinline__ float* proj_tile(unsigned char* smem, const T* __restrict__ a, const T* __restrict__ w,
                                            int m0, int m) {
  constexpr int kRows = Tiles<T, H>::kRows;
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

// ---- ffn_tile: gelu_tanh(x . W1 + b1) . W2 for the block's rows ---------
// s_x: the block's [rows, H] rows in shared memory; `work`:
// ffn_work_bytes<T, H>() of shared memory (128-byte aligned). Walks the
// intermediate columns in chunks: h = s_x . W1[:, chunk] in f32, + b1,
// tanh GELU in f32, then at once into the [rows, H] f32 accumulators
// with the matching rows of W2. Returns the accumulators' image, which
// lives in `work`.
template <typename T, int H>
__device__ __forceinline__ float* ffn_tile(const T* s_x, unsigned char* work, const T* __restrict__ w1,
                                           const float* __restrict__ b1, const T* __restrict__ w2, int inter) {
  constexpr int kRows = Tiles<T, H>::kRows, kCh = Tiles<T, H>::kChunk;
  T* s_w1 = reinterpret_cast<T*>(work);                            // [H, kCh]
  T* s_w2 = reinterpret_cast<T*>(work + w_chunk_bytes<T, H>());    // [kCh, H]
  float* s_hf = reinterpret_cast<float*>(work + 2 * w_chunk_bytes<T, H>());  // [kRows, kCh]
  float* s_c = reinterpret_cast<float*>(work);  // after the last chunk only

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
  __syncthreads();
  return s_c;
}

// Launches (a) and (b) on `st`: qkv [B, S, 3H] and ctx [B, S, H] are f32
// device scratch. Returns the first CUDA error (cudaSuccess if none).
template <int H, int DH>
cudaError_t launch_qkv_attention(const void* x, const void* mask, const void* wqkv, const void* bqkv, void* qkv,
                                 void* ctx, int batch, int seq, int num_heads, float scale, cudaStream_t st) {
  const int m = batch * seq;
  const int n3 = 3 * H;
  qkv_proj_f32_kernel<<<dim3(n3 / kQN, (m + kQM - 1) / kQM), kBlockThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<float*>(qkv), m, n3, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // q, k and v as [B, h, S, DH] views of the packed qkv, ctx as one of [B, S, H]
  const long long sq = static_cast<long long>(seq);
  const attn::View packed{sq * n3, DH, n3}, out{sq * H, DH, H};
  const attn::FwdViews vw{packed, packed, packed, out};
  const float* q = static_cast<const float*>(qkv);
  return attn::launch_attention_fwd<float, DH>(q, q + H, q + 2 * H, static_cast<const int32_t*>(mask),
                                               static_cast<float*>(ctx), vw, batch, num_heads, seq, scale, st);
}

}  // namespace
}  // namespace dial
