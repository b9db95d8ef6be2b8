// The bf16 encoder blocks on Hopper's tensor cores (sm_90a) as launch
// sequences: kernel 1 (attention_block), kernel 2 (ffn_block) and kernel 3
// (layer_block, the two in turn). ffn_tc.cu, fused_attention.cu and
// fused_layer.cu launch them, so the whole layer runs exactly the stages,
// tiles and summation orders of kernels 1 then 2 and equals them bit for
// bit. Every stage is gemm_tc.cuh's product or LayerNorm pass or
// attention_tc.cuh's attention; the instantiations are (H, head_dim) =
// (384, 32), (768, 64) and (1024, 64).
#pragma once

#include "attention_tc.cuh"
#include "gemm_tc.cuh"

namespace dial {
namespace enc {
namespace {

// Kernel 1, out = bf16(LN(x + (f32(ctx . W_out) + b_out))) with
//   (a) qkv = bf16(f32(x . W_qkv) + b_qkv)            [m, 3H], gemm kBiasBf16;
//   (b) ctx = the attention of each head of qkv's q, k and v under the
//       int32 mask [B, S]                            [m, H] bf16;
//   (c) y = f32(ctx . W_out)                           [m, H] f32, gemm kF32;
//   (d) out = bf16(LN(x + (y + b_out)))                layernorm_kernel.
// qkv, ctx and y are device scratch; m = batch * seq.
template <int H, int DH>
cudaError_t attention_block(const bf16* x, const int32_t* mask, const bf16* wqkv, const float* bqkv, const bf16* wout,
                            const float* bout, const float* gamma, const float* beta, bf16* qkv, bf16* ctx,
                            float* y, bf16* out, int batch, int seq, float scale, cudaStream_t st) {
  const int m = batch * seq;
  cudaError_t err = gemm::launch_gemm<gemm::kBiasBf16>(x, wqkv, bqkv, qkv, m, 3 * H, H, st);
  if (err != cudaSuccess) return err;
  // q, k and v as [B, h, S, DH] views of the packed qkv, ctx as one of [B, S, H]
  const long long sq = seq;
  const tc::View packed{sq * 3 * H, DH, 3 * H}, rows{sq * H, DH, H};
  tc::attention_tc_kernel<DH, int32_t><<<tc::grid_of(batch, H / DH, seq), tc::kThreads, 0, st>>>(
      qkv, qkv + H, qkv + 2 * H, mask, ctx, tc::Views{packed, packed, packed, rows}, seq, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = gemm::launch_gemm<gemm::kF32>(ctx, wout, nullptr, y, m, H, H, st)) != cudaSuccess) return err;
  return launch_layernorm<H>(y, x, bout, gamma, beta, out, m, st);
}

// Kernel 2, out = bf16(LN(x + (f32(h . W2) + b2))) with h = bf16(gelu_tanh(
// f32(x . W1) + b1)) [rows, inter] and y = f32(h . W2) [rows, H] device
// scratch; inter % 128 == 0.
template <int H>
cudaError_t ffn_block(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                      const float* gamma, const float* beta, bf16* out, bf16* h, float* y, int rows, int inter,
                      cudaStream_t st) {
  cudaError_t err = gemm::launch_gemm<gemm::kGeluBf16>(x, w1, b1, h, rows, inter, H, st);
  if (err != cudaSuccess) return err;
  if ((err = gemm::launch_gemm<gemm::kF32>(h, w2, nullptr, y, rows, H, inter, st)) != cudaSuccess) return err;
  return launch_layernorm<H>(y, x, b2, gamma, beta, out, rows, st);
}

// Kernel 3: a = kernel 1's output (bf16, what the reference rounds a to,
// in device scratch), then out = kernel 2 on a; y serves both.
template <int H, int DH>
cudaError_t layer_block(const bf16* x, const int32_t* mask, const bf16* wqkv, const float* bqkv, const bf16* wout,
                        const float* bout, const float* g1, const float* beta1, const bf16* w1, const float* b1,
                        const bf16* w2, const float* b2, const float* g2, const float* beta2, bf16* qkv, bf16* ctx,
                        float* y, bf16* a, bf16* h, bf16* out, int batch, int seq, int inter, float scale,
                        cudaStream_t st) {
  const cudaError_t err =
      attention_block<H, DH>(x, mask, wqkv, bqkv, wout, bout, g1, beta1, qkv, ctx, y, a, batch, seq, scale, st);
  if (err != cudaSuccess) return err;
  return ffn_block<H>(a, w1, b1, w2, b2, g2, beta2, out, h, y, batch * seq, inter, st);
}

}  // namespace
}  // namespace enc
}  // namespace dial
