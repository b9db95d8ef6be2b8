// FFN block of a BERT encoder layer in f32 on Hopper's tensor cores in
// split TF32 (sm_90a), at H 384, 768 and 1024.
//
// Replaces, in f32: dial_rag_tpu/ops/fused_encoder.py::_ffn_kernel
// (pallas_call in _ffn_forward, wrapper fused_ffn_block; in bf16
// ffn_tc.cu takes it). Over rows of x [M = B*S, H], with I the
// intermediate width (4H in the BERT family):
//   h   = gelu_tanh(x . W1 + b1)    [M, I]: f32 products, GELU in f32;
//   y   = h . W2                     [M, H], never rounded;
//   out = LN(x + (y + b2))           LayerNorm in f32, eps 1e-12.
//
// Bound on an H100 SXM at B=128, S=256 (M = 32768), I = 4H: 4 M H I FLOPs,
// H 384 77.3 GFLOP, H 768 309.2 GFLOP, H 1024 549.8 GFLOP: 0.468 / 1.874
// / 3.332 ms at 165 TFLOP/s of 3xTF32 (the products' rate), 1.154 / 4.615
// / 8.206 ms at 67 TFLOP/s of f32 on the CUDA cores; x in, out and both
// weights once (H 768: 220 MB, 0.066 ms at 3.35 TB/s): bound by
// operations.
//
// Design. LayerNorm needs whole rows, and the TPU kernel's one fused pass
// keeps a row block's [rows, H] f32 accumulator on chip while it walks I.
// Here a [128, 768] f32 accumulator is 384 KB, more than an SM's register
// file, so a fused pass holds 16-32 rows and every block streams both
// weight panels whole (this kernel's CUDA-core design before: 10 TFLOP/s
// at H 768). So, as in bf16 (ffn_tc.cu), five launches behind one
// wrapper, encoder_tf32.cuh's ffn_block:
//   (1) split_kernel, then gemm_tf32_kernel<kGelu>: h = gelu_tanh(x . W1 +
//       b1), over K = H;
//   (2) split_kernel, then gemm_tf32_kernel<kPlain>: y = h . W2, over K = I;
//   (3) layernorm_kernel: out = LN(x + (y + b2)), one warp a row.
// h and y go through device memory in f32, which rounds nothing (H 768:
// 2 x 403 MB and 2 x 101 MB, ~0.30 ms at 3.35 TB/s). The products, their
// split-TF32 arithmetic, tiles and order of sums are gemm_tf32.cuh's (its
// note); kernel 3 (fused_layer.cu) runs the same ffn_block.
#include "encoder_tf32.cuh"

// C entry point. x [rows, hidden], w1 [hidden, inter], w2 [inter, hidden],
// out [rows, hidden], h (scratch [rows, inter]), y (scratch [rows,
// hidden]) and planes (scratch, 2 hidden inter floats): device pointers
// of f32, x and h 16-byte aligned; b1 [inter], b2, gamma, beta [hidden]:
// f32. hidden 384, 768 or 1024 and inter a multiple of 128 (else
// cudaErrorInvalidValue). Launches the five kernels on `stream` and
// returns the first CUDA error (0 on success).
extern "C" int dial_ffn_block_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                  const void* gamma, const void* beta, void* out, void* h, void* y, void* planes,
                                  int rows, int hidden, int inter, void* stream) {
  if (inter % dial::gemm32::kBN || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto width) {
    return dial::enc32::ffn_block<decltype(width)::value>(
        static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(out), static_cast<float*>(h), static_cast<float*>(y),
        static_cast<float*>(planes), rows, inter, static_cast<cudaStream_t>(stream));
  };
  if (hidden == 384) return static_cast<int>(launch(std::integral_constant<int, 384>{}));
  if (hidden == 768) return static_cast<int>(launch(std::integral_constant<int, 768>{}));
  if (hidden == 1024) return static_cast<int>(launch(std::integral_constant<int, 1024>{}));
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry point, for the card's tests and measurements of the product on
// its own: out [m, n] = a [m, k] . w [k, n] through the epilogue
// `epilogue` (0 gelu_tanh(. + bias), 1 the product, 2 . + bias), w split
// first into `planes` (2 k n floats). a, w, out, planes: f32 device
// pointers, a 16-byte aligned; bias f32 [n] (unread by 1). n % 128 == 0
// and k % 32 == 0 (else cudaErrorInvalidValue). Launches the split and the
// product on `stream` and returns the first CUDA error (0 on success).
extern "C" int dial_gemm_tf32(const void* a, const void* w, const void* bias, void* out, void* planes, int m, int n,
                              int k, int epilogue, void* stream) {
  using namespace dial::gemm32;
  if (n % kBN || k % kBK || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto e) {
    return static_cast<int>(launch_product<decltype(e)::value>(
        static_cast<const float*>(a), static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(out), static_cast<float*>(planes), m, n, k, static_cast<cudaStream_t>(stream)));
  };
  if (epilogue == kGelu) return launch(std::integral_constant<Epilogue, kGelu>{});
  if (epilogue == kPlain) return launch(std::integral_constant<Epilogue, kPlain>{});
  if (epilogue == kBias) return launch(std::integral_constant<Epilogue, kBias>{});
  return static_cast<int>(cudaErrorInvalidValue);
}
