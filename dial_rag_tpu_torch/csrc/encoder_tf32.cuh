// The f32 encoder blocks on Hopper's tensor cores in split TF32 (sm_90a)
// as launch sequences: kernel 1 (attention_block), kernel 2 (ffn_block)
// and kernel 3 (layer_block, the two in turn), the same sequences as
// encoder_tc.cuh's bf16 ones. fused_ffn.cu, fused_attention.cu and
// fused_layer.cu launch them, so the whole layer runs exactly the stages,
// tiles and summation orders of kernels 1 then 2 and equals them bit for
// bit. Every product is gemm_tf32.cuh's (W split into its planes, then
// the product), the attention attention_fwd_tf32.cuh's single-tile
// kernel, the LayerNorm common.cuh's pass. In f32 every cast of the
// reference to the compute type is the identity: P is normalised before
// P . V, and the output products are never rounded before the bias, the
// residual and the LayerNorm. The instantiations are common.cuh's
// at_width: (H, head_dim) = (384, 32), (768, 64) and (1024, 64) (bge-large:
// 16 heads of 64, FFN 4096; at B=128, S=256 its scratch is qkv 403 MB, h
// 537 MB and the planes 34 MB).
#pragma once

#include "attention_fwd_tf32.cuh"
#include "gemm_tf32.cuh"

namespace dial {
namespace enc32 {
namespace {

// Kernel 1, out = LN(x + (ctx . W_out + b_out)) with
//   (a) qkv = x . W_qkv + b_qkv                   [m, 3H], product kBias;
//   (b) ctx = the attention of each head of qkv's q, k and v under the
//       int32 mask [B, S]                         [m, H];
//   (c) y = ctx . W_out                           [m, H], product kPlain;
//   (d) out = LN(x + (y + b_out))                 layernorm_kernel.
// qkv, ctx, y and `planes` (gemm32::split_floats(H, 3H)) are device
// scratch; m = batch * seq.
template <int H, int DH>
cudaError_t attention_block(const float* x, const int32_t* mask, const float* wqkv, const float* bqkv,
                            const float* wout, const float* bout, const float* gamma, const float* beta, float* qkv,
                            float* ctx, float* y, float* planes, float* out, int batch, int seq, float scale,
                            cudaStream_t st) {
  const int m = batch * seq;
  cudaError_t err = gemm32::launch_product<gemm32::kBias>(x, wqkv, bqkv, qkv, planes, m, 3 * H, H, st);
  if (err != cudaSuccess) return err;
  // q, k and v as [B, h, S, DH] views of the packed qkv, ctx as one of [B, S, H]
  const long long sq = seq;
  const attn::View packed{sq * 3 * H, DH, 3 * H}, rows{sq * H, DH, H};
  err = attn::launch_single_tile<DH, int32_t>(qkv, qkv + H, qkv + 2 * H, mask, ctx,
                                              attn::FwdViews{packed, packed, packed, rows}, batch, H / DH, seq,
                                              scale, st);
  if (err != cudaSuccess) return err;
  err = gemm32::launch_product<gemm32::kPlain>(ctx, wout, nullptr, y, planes, m, H, H, st);
  if (err != cudaSuccess) return err;
  return launch_layernorm<H>(y, x, bout, gamma, beta, out, m, st);
}

// Kernel 2, out = LN(x + (h . W2 + b2)) with h = gelu_tanh(x . W1 + b1)
// [rows, inter] and y = h . W2 [rows, H] device scratch, `planes`
// gemm32::split_floats(H, inter); inter % 128 == 0.
template <int H>
cudaError_t ffn_block(const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
                      const float* gamma, const float* beta, float* out, float* h, float* y, float* planes, int rows,
                      int inter, cudaStream_t st) {
  cudaError_t err = gemm32::launch_product<gemm32::kGelu>(x, w1, b1, h, planes, rows, inter, H, st);
  if (err != cudaSuccess) return err;
  err = gemm32::launch_product<gemm32::kPlain>(h, w2, nullptr, y, planes, rows, H, inter, st);
  if (err != cudaSuccess) return err;
  return launch_layernorm<H>(y, x, b2, gamma, beta, out, rows, st);
}

// Kernel 3: a = kernel 1's output (in device scratch: in f32 its round
// trip rounds nothing), then out = kernel 2 on a; y and the planes serve
// both (planes: gemm32::split_floats(H, max(3H, inter))).
template <int H, int DH>
cudaError_t layer_block(const float* x, const int32_t* mask, const float* wqkv, const float* bqkv, const float* wout,
                        const float* bout, const float* g1, const float* beta1, const float* w1, const float* b1,
                        const float* w2, const float* b2, const float* g2, const float* beta2, float* qkv,
                        float* ctx, float* y, float* a, float* h, float* planes, float* out, int batch, int seq,
                        int inter, float scale, cudaStream_t st) {
  const cudaError_t err = attention_block<H, DH>(x, mask, wqkv, bqkv, wout, bout, g1, beta1, qkv, ctx, y, planes, a,
                                                 batch, seq, scale, st);
  if (err != cudaSuccess) return err;
  return ffn_block<H>(a, w1, b1, w2, b2, g2, beta2, out, h, y, planes, batch * seq, inter, st);
}

}  // namespace
}  // namespace enc32
}  // namespace dial
