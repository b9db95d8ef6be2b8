// One whole BERT encoder layer, for Hopper (sm_90a).
//
// Replaces: dial_rag_tpu/ops/fused_encoder.py::_layer_kernel (pallas_call
// in _layer_forward, wrapper fused_layer_block). Computes, per batch row,
//   a   = T(LN(x + W_out . MHA(T(W_qkv . x + b_qkv)) + b_out))
//   out = T(LN(a + W2 . T(gelu_tanh(W1 . a + b1)) + b2))
// with the TPU kernel's cast points: qkv, P (after the division), ctx, a
// and the GELU output are cast to T (bf16 or f32); products accumulate in
// f32; both LayerNorms (eps 1e-12) run in f32. At H 384 (12 heads of
// 32), 768 (12 heads of 64) and 1024 (16 heads of 64), in bf16 and f32.
//
// Bound on an H100 SXM at B=128, S=256, I = 4H: the attention block's
// work plus the FFN's, 128.8 GFLOP at H=384 (0.130 ms at 989 TFLOP/s
// bf16), 489.6 GFLOP at H=768 (0.495 ms) and 859.0 GFLOP at H=1024 (0.869
// ms); x in and out only, 0.015 ms at 3.35 TB/s at H=384 bf16: bound by
// operations. f32, products in split TF32: 0.781 / 2.967 / 5.206 ms at H
// 384 / 768 / 1024 at 165 TFLOP/s of 3xTF32 (1.923 / 7.308 / 12.821 at 67
// TFLOP/s on the CUDA cores).
//
// Design, bf16: the seven launches of kernel 1 then kernel 2
// (encoder_tc.cuh's layer_block: attention_block, then ffn_block on its
// output), through the same launch functions, tiles and summation orders,
// so the layer equals kernels 1 then 2 bit for bit. What the TPU kernel
// saves over that composition is the round trip of the post-attention
// state a through device memory; here a goes through device memory in
// bf16, the value the reference rounds it to, so no bit of the contract
// moves, and it costs 2 x 50.3 MB at H 768, B=128, S=256: about 0.03 ms
// at 3.35 TB/s against the layer's 0.495 ms bound. Keeping a on chip
// would need its [rows, H] f32 LayerNorm accumulator there (a [128, 768]
// tile is 384 KB, more than an SM's registers) and so small row tiles
// that stream every weight panel once a block: not worth 0.03 ms on this
// card. What still holds the layer back is kernels 1's and 2's (their
// notes: the products without a TMA producer warp, clusters or a
// persistent schedule; the attention's two passes; qkv, ctx, y and h
// through device memory).
//
// Design, f32: the same composition of encoder_tf32.cuh's sequences
// (layer_block: kernel 1's six launches into an f32 scratch a, then
// kernel 2's five on it), every product split TF32 on the tensor cores
// (gemm_tf32.cuh), the attention TPU kernel 4's f32 kernel; so it too
// equals kernels 1 then 2 bit for bit. In f32 a's round trip rounds
// nothing and costs 2 x 101 MB at H 768, B=128, S=256: 0.06 ms.
#include "encoder_tc.cuh"
#include "encoder_tf32.cuh"

// C entry points, one per dtype. All pointers are device pointers; wqkv
// is [H, 3H], wout [H, H], w1 [H, I], w2 [I, H]; bqkv, bout, g1, beta1,
// b1, b2, g2 and beta2 are f32.
//
// bf16: x, the matrices, qkv (scratch [B, S, 3H]), ctx, a (scratch [B, S,
// H]), h (scratch [B, S, I]) and out are bf16, x and the matrices 16-byte
// aligned; mask is int32 [B, S]; y (scratch [B, S, H]) is f32. (H =
// num_heads * head_dim, head_dim) is (384, 32), (768, 64) or (1024, 64)
// and I a multiple of 128. Launches the seven kernels on `stream`.
//
// f32: x, the matrices, qkv, ctx, y, a, h (the bf16 entry's scratch
// shapes), planes (scratch, 2 H max(3H, I) floats) and out are f32, x
// 16-byte aligned; mask is int32 [B, S]. (H, head_dim) is (384, 32),
// (768, 64) or (1024, 64) and I a multiple of 128. Launches the eleven kernels on
// `stream`.
//
// Anything else is cudaErrorInvalidValue. Each returns the first CUDA
// error (0 on success).
extern "C" int dial_layer_block_bf16(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                     const void* wout, const void* bout, const void* g1, const void* beta1,
                                     const void* w1, const void* b1, const void* w2, const void* b2, const void* g2,
                                     const void* beta2, void* qkv, void* ctx, void* y, void* a, void* h, void* out,
                                     int batch, int seq, int num_heads, int head_dim, int inter, float scale,
                                     void* stream) {
  using dial::bf16;
  if (inter % dial::gemm::kBN) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dial::at_width(num_heads, head_dim, [&](auto hid, auto dh) {
    return dial::enc::layer_block<decltype(hid)::value, decltype(dh)::value>(
        static_cast<const bf16*>(x), static_cast<const int32_t*>(mask), static_cast<const bf16*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<const bf16*>(wout), static_cast<const float*>(bout),
        static_cast<const float*>(g1), static_cast<const float*>(beta1), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(g2), static_cast<const float*>(beta2), static_cast<bf16*>(qkv),
        static_cast<bf16*>(ctx), static_cast<float*>(y), static_cast<bf16*>(a), static_cast<bf16*>(h),
        static_cast<bf16*>(out), batch, seq, inter, scale, static_cast<cudaStream_t>(stream));
  }));
}

extern "C" int dial_layer_block_f32(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                    const void* wout, const void* bout, const void* g1, const void* beta1,
                                    const void* w1, const void* b1, const void* w2, const void* b2, const void* g2,
                                    const void* beta2, void* qkv, void* ctx, void* y, void* a, void* h, void* planes,
                                    void* out, int batch, int seq, int num_heads, int head_dim, int inter,
                                    float scale, void* stream) {
  if (inter % dial::gemm32::kBN) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dial::at_width(num_heads, head_dim, [&](auto hid, auto dh) {
    return dial::enc32::layer_block<decltype(hid)::value, decltype(dh)::value>(
        static_cast<const float*>(x), static_cast<const int32_t*>(mask), static_cast<const float*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<const float*>(wout), static_cast<const float*>(bout),
        static_cast<const float*>(g1), static_cast<const float*>(beta1), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(g2), static_cast<const float*>(beta2), static_cast<float*>(qkv),
        static_cast<float*>(ctx), static_cast<float*>(y), static_cast<float*>(a), static_cast<float*>(h),
        static_cast<float*>(planes), static_cast<float*>(out), batch, seq, inter, scale,
        static_cast<cudaStream_t>(stream));
  }));
}
