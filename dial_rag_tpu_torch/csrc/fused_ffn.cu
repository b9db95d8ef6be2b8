// Fused FFN block of the bge-small encoder, for Hopper (sm_90a).
//
// Replaces: dial_rag_tpu/ops/fused_encoder.py::_ffn_kernel (pallas_call in
// _ffn_forward, wrapper fused_ffn_block). Computes, over rows of [B*S, H],
//   out = LN(x + W2 . bf16(gelu_tanh(f32(W1 . x + b1))) + b2)
// with f32 accumulation, GELU and LayerNorm (eps 1e-12) in f32, bf16 out.
//
// Bound on an H100 SXM at B=128, S=256 (32768 rows), H=384, I=1536:
//   operations: 2 x 2 x 32768 x 384 x 1536 = 77.3 GFLOP
//               -> 0.078 ms at 989 TFLOP/s bf16;
//   bytes:      x 25.2 MB in, out 25.2 MB, W1 + W2 2.4 MB
//               -> 0.0158 ms at 3.35 TB/s.
//   So the block is bound by operations (0.078 ms).
//
// Design. One block of 8 warps owns 64 rows and keeps them in shared
// memory. It walks the 1536 intermediate columns in chunks of 64: the
// chunk of h = x . W1 (WMMA bf16 tiles, f32 accumulators) goes to shared
// memory, takes b1, tanh GELU in f32 and the cast to bf16 there, and is
// at once multiplied into the block's [64, 384] f32 accumulators with the
// matching 64 rows of W2. The [rows, 1536] intermediate never reaches
// device memory, as on the TPU. The accumulators then go through shared
// memory to the bias + residual + LayerNorm epilogue, one row per warp.
// Rows past B*S are zero-filled on load and never stored (the TPU kernel
// halves its row block until it divides B*S instead). Each block reads
// both weight panels once (2.4 MB, mostly from L2): 1.2 GB of L2 reads
// for the 512 blocks at the shape above, the traffic a larger row block
// or thread-block clusters sharing the panels would cut.
#include "common.cuh"

namespace dial {
namespace {

constexpr int kFBM = 64, kFCH = 64, kFThreads = 256;
constexpr size_t kXBytes = kFBM * kHidden * sizeof(bf16);     // 48 KB
constexpr size_t kW1Bytes = kHidden * kFCH * sizeof(bf16);    // 48 KB
constexpr size_t kW2Bytes = kFCH * kHidden * sizeof(bf16);    // 48 KB
constexpr size_t kHfBytes = kFBM * kFCH * sizeof(float);      // 16 KB
constexpr size_t kHbBytes = kFBM * kFCH * sizeof(bf16);       //  8 KB
constexpr size_t kFfnSmem = kXBytes + kW1Bytes + kW2Bytes + kHfBytes + kHbBytes;
// the [64, 384] f32 accumulator image reuses the two weight panels
static_assert(kFBM * kHidden * sizeof(float) <= kW1Bytes + kW2Bytes, "accumulator image must fit");

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x))));
}

__global__ void __launch_bounds__(kFThreads)
    ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ out, int m, int inter) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_x = reinterpret_cast<bf16*>(smem);
  bf16* s_w1 = reinterpret_cast<bf16*>(smem + kXBytes);
  bf16* s_w2 = reinterpret_cast<bf16*>(smem + kXBytes + kW1Bytes);
  float* s_hf = reinterpret_cast<float*>(smem + kXBytes + kW1Bytes + kW2Bytes);
  bf16* s_hb = reinterpret_cast<bf16*>(smem + kXBytes + kW1Bytes + kW2Bytes + kHfBytes);
  float* s_c = reinterpret_cast<float*>(smem + kXBytes);  // after the last chunk only

  const int m0 = blockIdx.x * kFBM;
  const int warp = threadIdx.x / 32;
  const int wr = warp / 4, wc = warp % 4;         // second product: 32 rows x 96 cols a warp
  const int hr = warp / 2, hc = (warp % 2) * 2;   // first product: 16 rows x 32 cols a warp

  load_tile<kFBM, kHidden, kFThreads>(s_x, x + static_cast<size_t>(m0) * kHidden, kHidden, m - m0);

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
  residual_layernorm_rows<kFBM, kFThreads / 32>(s_c, s_x, kHidden, b2, gamma, beta,
                                                out + static_cast<size_t>(m0) * kHidden, m - m0);
}

}  // namespace
}  // namespace dial

// C entry point. x, w1 [H, I], w2 [I, H] and out are bf16 device
// pointers; b1, b2, gamma, beta are f32. rows = B*S. Launches on `stream`
// and returns the first CUDA error (0 on success).
extern "C" int dial_ffn_block_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                   const void* gamma, const void* beta, void* out, int rows, int inter,
                                   void* stream) {
  using namespace dial;
  cudaError_t err =
      cudaFuncSetAttribute(ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kFfnSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_kernel<<<(rows + kFBM - 1) / kFBM, kFThreads, kFfnSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), rows, inter);
  return static_cast<int>(cudaGetLastError());
}
