// FFN block of a BERT encoder layer in bf16 on Hopper's tensor cores
// (sm_90a), at H 384, 768 and 1024.
//
// Replaces, in bf16: dial_rag_tpu/ops/fused_encoder.py::_ffn_kernel
// (pallas_call in _ffn_forward, wrapper fused_ffn_block). Over rows of x
// [M = B*S, H], with I the intermediate width (4H in the BERT family):
//   h   = bf16(gelu_tanh(f32(x . W1) + b1))   [M, I]: f32 accumulation,
//         GELU in f32, one cast after it;
//   y   = f32(h . W2)                          [M, H], never rounded;
//   out = bf16(LN(f32(x) + (y + b2)))          LayerNorm in f32, eps 1e-12.
//
// Bound on an H100 SXM at B=128, S=256 (M = 32768), I = 4H: 4 M H I FLOPs
// at 989 TFLOP/s, H 384 77.3 GFLOP (0.078 ms), H 768 309.2 GFLOP (0.313
// ms), H 1024 549.8 GFLOP (0.556 ms), against x in, out and both weights
// once (H 768: 106 MB, 0.032 ms at 3.35 TB/s): bound by operations.
//
// Design. LayerNorm needs whole rows, and the TPU kernel's one fused pass
// keeps a row block's [rows, H] f32 accumulator on chip while it walks I.
// Here a [128, 768] f32 accumulator is 384 KB, more than an SM's register
// file, so a fused pass holds 32-64 rows and every block streams both
// weight panels whole (fused_ffn.cu's bf16 kernel: 9.7 GB through L2 at H
// 768, B=128, S=256). So three launches behind one wrapper:
//   (1) gemm_kernel<kGeluBf16>: h = bf16(gelu_tanh(x . W1 + b1)), over
//       K = H;
//   (2) gemm_kernel<kF32>: y = h . W2 in f32, over K = I;
//   (3) layernorm_kernel: out = bf16(LN(x + (y + b2))), one warp a row
//       (residual_layernorm_rows, the fused blocks' epilogue).
// h in bf16 is what the TPU kernel rounds to, so its round trip through
// device memory changes no bit of the contract (H 768: 2 x 201 MB, ~0.12
// ms at 3.35 TB/s); y in f32 keeps the product unrounded (2 x 101 MB,
// ~0.06 ms).
//
// The products and the LayerNorm pass are gemm_tc.cuh's (its note gives
// their tiles and what still holds them back), launched in turn by
// encoder_tc.cuh's ffn_block, which kernel 3 (fused_layer.cu) runs too.
#include "encoder_tc.cuh"

// C entry point. x [rows, hidden], w1 [hidden, inter], w2 [inter, hidden]
// and out [rows, hidden]: device pointers of bf16, x, w1 and w2 16-byte
// aligned; b1 [inter], b2, gamma, beta [hidden]: f32; h: bf16 [rows,
// inter] and y: f32 [rows, hidden] device scratch, 16-byte aligned.
// hidden 384, 768 or 1024 and inter a multiple of 128 (else
// cudaErrorInvalidValue). Launches the three kernels on `stream` and
// returns the first CUDA error (0 on success).
extern "C" int dial_ffn_block_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                   const void* gamma, const void* beta, void* out, void* h, void* y, int rows,
                                   int hidden, int inter, void* stream) {
  using dial::bf16;
  if (inter % dial::gemm::kBN || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto width) {
    return dial::enc::ffn_block<decltype(width)::value>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<bf16*>(out), static_cast<bf16*>(h), static_cast<float*>(y),
        rows, inter, static_cast<cudaStream_t>(stream));
  };
  if (hidden == 384) return static_cast<int>(launch(std::integral_constant<int, 384>{}));
  if (hidden == 768) return static_cast<int>(launch(std::integral_constant<int, 768>{}));
  if (hidden == 1024) return static_cast<int>(launch(std::integral_constant<int, 1024>{}));
  return static_cast<int>(cudaErrorInvalidValue);
}
