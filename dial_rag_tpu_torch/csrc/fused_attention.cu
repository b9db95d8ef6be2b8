// Fused attention block of a BERT encoder layer, for Hopper (sm_90a).
//
// Replaces: dial_rag_tpu/ops/fused_encoder.py::_attn_block_kernel
// (pallas_call in _attn_block_forward, wrapper fused_attention_block).
// Computes, per batch row,
//   out = LN(x + W_out . MHA(T(W_qkv . x + b_qkv)) + b_out)
// with f32 accumulation, f32 softmax over scores*scale + (1-mask)*f32.min,
// probabilities cast to T after the division, before P.V, ctx cast to T
// once, the output projection never rounded before the bias, residual and
// LayerNorm (eps 1e-12), T out. At (H 384, 12 heads of 32), (H 768, 12
// heads of 64) and bge-large's (H 1024, 16 heads of 64), in bf16 and f32.
//
// Bound on an H100 SXM at B=128, S=256 (m = 32768 rows), QKV + QK^T + PV
// + output projection:
//   H=384, bf16: 29.0 + 6.4 + 6.4 + 9.7 = 51.5 GFLOP -> 0.052 ms at 989
//     TFLOP/s; x 25.2 MB in, out 25.2 MB -> 0.015 ms;
//   H=768, bf16: 116.0 + 12.9 + 12.9 + 38.7 = 180.4 GFLOP -> 0.182 ms;
//   H=1024, bf16: 206.2 + 17.2 + 17.2 + 68.7 = 309.2 GFLOP -> 0.313 ms;
//     x in and out 134 MB -> 0.040 ms;
//   f32 (split TF32): H=384 51.5 GFLOP -> 0.312 ms at 165 TFLOP/s of
//     3xTF32, 0.769 ms at 67 TFLOP/s on the CUDA cores; H=768 180.4
//     GFLOP -> 1.093 / 2.692 ms; H=1024 309.2 GFLOP -> 1.874 / 4.615 ms.
// So the block is bound by operations.
//
// Design. The TPU kernel keeps a batch row's qkv [S, 3H] and each head's
// [S, S] f32 score tile in VMEM; an H100 block has 227 KB of shared
// memory and a [rows, H] f32 accumulator for the LayerNorm outgrows an
// SM's registers, so the block is four launches (bf16, encoder_tc.cuh's
// attention_block), each at the tiles that suit it:
//   (a) gemm_kernel<kBiasBf16>: qkv = bf16(f32(x . W_qkv) + b_qkv), the
//       [m, 3H] scratch, on wgmma (gemm_tc.cuh: 256 x 128 tiles, a
//       4-stage 128-byte-swizzled cp.async ring);
//   (b) attention_tc_kernel (attention_tc.cuh, TPU kernel 4's forward):
//       q, k and v read by strides straight from the packed qkv, two
//       exact-softmax passes over 64-key chunks on mma.sync, P cast to
//       bf16 after the division, ctx [B, S, H] written once in bf16; it
//       forms each key's bias (1 - mask) * f32.min from the int32 mask;
//   (c) gemm_kernel<kF32>: y = f32(ctx . W_out), the [m, H] f32 scratch;
//   (d) layernorm_kernel<H>: out = bf16(LN(x + (y + b_out))), one warp a
//       row: the reference's order, attn_out = dot + b_out, r = x +
//       attn_out.
// The cast points are the reference's: qkv after the bias, P after the
// division, ctx once, y never rounded. What goes through device memory
// that the TPU kernel kept on chip: qkv (H 768: 2 x 151 MB), ctx (2 x 50
// MB) and y (2 x 101 MB), 0.180 ms at 3.35 TB/s, as long again as the
// 0.182 ms bound. What still holds it back: the products' own limits
// (gemm_tc.cuh: no TMA producer warp, no clusters, no persistent
// schedule), the shallow K of the projections at H 384 (six 64-deep
// slices, two of them the ring's prologue), the output projection's few
// column tiles (N = H: 384 blocks at H 384), and the attention's two
// passes (Q K^T twice).
// f32 runs the same four stages (encoder_tf32.cuh's attention_block),
// each product in split TF32 on the tensor cores after a launch that
// splits its W into hi and lo planes (gemm_tf32.cuh: 128 x 128 tiles on
// mma.sync m16n8k8, a 4-stage cp.async ring of 32-deep K slices, each
// slice's products a partial added in f32), and (b) TPU kernel 4's f32
// kernel (attention_fwd_tf32.cuh) on the packed qkv with the int32 mask:
// six launches. qkv, ctx and y go through device memory in f32, which
// rounds nothing (H 768: 2 x 302, 2 x 101 and 2 x 101 MB, 0.30 ms at
// 3.35 TB/s).
#include "encoder_tc.cuh"
#include "encoder_tf32.cuh"

// C entry points, one per dtype. All pointers are device pointers.
//
// bf16: x, wqkv [H, 3H], wout [H, H], qkv (scratch [B, S, 3H]), ctx
// (scratch [B, S, H]) and out are bf16, x, wqkv and wout 16-byte aligned;
// mask is int32 [B, S]; bqkv, bout, gamma, beta and y (scratch [B, S, H])
// are f32. (H = num_heads * head_dim, head_dim) is (384, 32), (768, 64)
// or (1024, 64). Launches the four kernels on `stream`.
//
// f32: x, wqkv, wout, qkv (scratch [B, S, 3H]), ctx, y (scratch [B, S,
// H]), planes (scratch, 6 H^2 floats) and out are f32, x 16-byte aligned;
// mask is int32 [B, S]; bqkv, bout, gamma and beta are f32. (H, head_dim)
// is (384, 32), (768, 64) or (1024, 64). Launches the six kernels on
// `stream`.
//
// Another width is cudaErrorInvalidValue. Each returns the first CUDA
// error (0 on success).
extern "C" int dial_attention_block_bf16(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* bout, const void* gamma, const void* beta,
                                         void* qkv, void* ctx, void* y, void* out, int batch, int seq, int num_heads,
                                         int head_dim, float scale, void* stream) {
  using dial::bf16;
  return static_cast<int>(dial::at_width(num_heads, head_dim, [&](auto hid, auto dh) {
    return dial::enc::attention_block<decltype(hid)::value, decltype(dh)::value>(
        static_cast<const bf16*>(x), static_cast<const int32_t*>(mask), static_cast<const bf16*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<const bf16*>(wout), static_cast<const float*>(bout),
        static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<bf16*>(qkv),
        static_cast<bf16*>(ctx), static_cast<float*>(y), static_cast<bf16*>(out), batch, seq, scale,
        static_cast<cudaStream_t>(stream));
  }));
}

extern "C" int dial_attention_block_f32(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                        const void* wout, const void* bout, const void* gamma, const void* beta,
                                        void* qkv, void* ctx, void* y, void* planes, void* out, int batch, int seq,
                                        int num_heads, int head_dim, float scale, void* stream) {
  return static_cast<int>(dial::at_width(num_heads, head_dim, [&](auto hid, auto dh) {
    return dial::enc32::attention_block<decltype(hid)::value, decltype(dh)::value>(
        static_cast<const float*>(x), static_cast<const int32_t*>(mask), static_cast<const float*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<const float*>(wout), static_cast<const float*>(bout),
        static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<float*>(qkv),
        static_cast<float*>(ctx), static_cast<float*>(y), static_cast<float*>(planes), static_cast<float*>(out),
        batch, seq, scale, static_cast<cudaStream_t>(stream));
  }));
}
