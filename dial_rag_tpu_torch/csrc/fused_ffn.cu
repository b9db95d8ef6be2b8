// Fused FFN block of a BERT encoder layer in f32, for Hopper (sm_90a).
//
// Replaces, in f32: dial_rag_tpu/ops/fused_encoder.py::_ffn_kernel
// (pallas_call in _ffn_forward, wrapper fused_ffn_block; in bf16
// ffn_tc.cu takes it). Computes, over rows of [B*S, H],
//   out = LN(x + W2 . T(gelu_tanh(f32(W1 . x + b1))) + b2)
// with f32 accumulation, GELU and LayerNorm (eps 1e-12) in f32, T out. The
// kernel is a template on T; its entry point instantiates T = f32, at H
// 384 or 768, the intermediate width any multiple of 64.
//
// Bound on an H100 SXM at B=128, S=256 (32768 rows), f32 on the CUDA
// cores: H=384, I=1536: 2 x 2 x 32768 x 384 x 1536 = 77.3 GFLOP -> 1.154
// ms at 67 TFLOP/s; H=768, I=3072: 309.2 GFLOP -> 4.615 ms; x in and out
// 50.3 MB at H=384 -> 0.015 ms at 3.35 TB/s. So the block is bound by
// operations.
//
// Design. One block of 8 warps owns a tile of rows (Tiles<T, H>: 32 rows
// at H 384, 16 at H 768) and
// keeps them in shared memory. It walks the intermediate columns in
// chunks (64, 32, 32, 16 columns): the chunk of h = x . W1 goes to shared
// memory, takes b1, tanh GELU in f32 and the cast to T there, and is at
// once multiplied into the block's [rows, H] f32 accumulators with the
// matching rows of W2. The [rows, I] intermediate never reaches device
// memory, as on the TPU. The accumulators then go through shared memory
// to the bias + residual + LayerNorm epilogue, one row per warp. Rows past
// B*S are zero-filled on load and never stored (the TPU kernel halves its
// row block until it divides B*S instead). Each block reads both weight
// panels once (mostly from L2), the traffic a larger row block or
// thread-block clusters sharing the panels would cut. Products run on the
// CUDA cores in full f32. The chunk loop (ffn_tile) lives in
// fused_blocks.cuh, which fused_layer.cu shares.
#include "fused_blocks.cuh"

namespace dial {
namespace {

template <typename T, int H>
__global__ void __launch_bounds__(kBlockThreads)
    ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
               const T* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ out, int m, int inter) {
  constexpr int kRows = Tiles<T, H>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_x = reinterpret_cast<T*>(smem);
  const int m0 = blockIdx.x * kRows;
  load_tile<kRows, H, kBlockThreads>(s_x, x + static_cast<size_t>(m0) * H, H, m - m0);
  const float* s_c = ffn_tile<T, H>(s_x, smem + x_bytes<T, H>(), w1, b1, w2, inter);
  residual_layernorm_rows<kRows, kBlockThreads / 32, H>(s_c, s_x, H, b2, gamma, beta,
                                                        out + static_cast<size_t>(m0) * H, m - m0);
}

template <typename T, int H>
cudaError_t ffn_block(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                      const void* gamma, const void* beta, void* out, int rows, int inter, cudaStream_t st) {
  constexpr int kRows = Tiles<T, H>::kRows;
  constexpr size_t smem = ffn_smem<T, H>();
  cudaError_t err =
      cudaFuncSetAttribute(ffn_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ffn_kernel<T, H><<<(rows + kRows - 1) / kRows, kBlockThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), rows, inter);
  return cudaGetLastError();
}

template <typename T>
int ffn_block_any(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, const void* gamma,
                  const void* beta, void* out, int rows, int hidden, int inter, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inter % 64) return static_cast<int>(cudaErrorInvalidValue);
  if (hidden == 384) return ffn_block<T, 384>(x, w1, b1, w2, b2, gamma, beta, out, rows, inter, st);
  if (hidden == 768) return ffn_block<T, 768>(x, w1, b1, w2, b2, gamma, beta, out, rows, inter, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace dial

// C entry point. x, w1 [H, I], w2 [I, H] and out are device pointers of
// f32; b1, b2, gamma, beta are f32. rows = B*S; hidden 384 or 768 and
// inter a multiple of 64 (else cudaErrorInvalidValue).
// Launches on `stream` and returns the first CUDA error (0 on success).
extern "C" int dial_ffn_block_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                  const void* gamma, const void* beta, void* out, int rows, int hidden, int inter,
                                  void* stream) {
  return dial::ffn_block_any<float>(x, w1, b1, w2, b2, gamma, beta, out, rows, hidden, inter, stream);
}
