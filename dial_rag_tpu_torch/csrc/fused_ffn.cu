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
// The chunk loop (ffn_tile) lives in fused_blocks.cuh, which
// fused_layer.cu shares.
#include "fused_blocks.cuh"

namespace dial {
namespace {

constexpr size_t kFfnSmem = kXBytes + kFfnWorkBytes;

__global__ void __launch_bounds__(kFThreads)
    ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ out, int m, int inter) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_x = reinterpret_cast<bf16*>(smem);
  const int m0 = blockIdx.x * kFBM;
  load_tile<kFBM, kHidden, kFThreads>(s_x, x + static_cast<size_t>(m0) * kHidden, kHidden, m - m0);
  const float* s_c = ffn_tile(s_x, smem + kXBytes, w1, b1, w2, inter);
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
