// Fused attention block of the bge-small encoder, for Hopper (sm_90a).
//
// Replaces: dial_rag_tpu/ops/fused_encoder.py::_attn_block_kernel
// (pallas_call in _attn_block_forward, wrapper fused_attention_block).
// Computes, per batch row,
//   out = LN(x + W_out . MHA(bf16(W_qkv . x + b_qkv)) + b_out)
// with f32 accumulation, f32 softmax over scores*scale + (1-mask)*f32.min,
// probabilities cast to bf16 before P.V, LayerNorm eps 1e-12, bf16 out.
//
// Bound on an H100 SXM at B=128, S=256, H=384, 12 heads (Dh=32):
//   operations: QKV 29.0 + QK^T 6.4 + PV 6.4 + out-proj 9.7 = 51.5 GFLOP
//               -> 0.052 ms at 989 TFLOP/s bf16;
//   bytes:      x 25.2 MB in, out 25.2 MB, weights 1.2 MB, mask 0.1 MB
//               -> 0.0154 ms at 3.35 TB/s.
//   So the block is bound by operations (0.052 ms).
//
// Design. The TPU kernel keeps the whole [S, S] f32 score tile of a head
// in 16 MiB of VMEM; an H100 block has 227 KB of shared memory, so the
// work is split into three launches:
//   (a) qkv_proj_kernel: [B*S, H] x [H, 3H] + b -> bf16 scratch [B, S, 3H];
//   (b) attention_kernel: one block per (64-query tile, head, batch row),
//       reading q/k/v straight out of the [B, S, 3H] layout. Two passes
//       over 64-key tiles: the first finds each row's max and softmax
//       denominator, the second rebuilds the scores and forms the
//       normalised probabilities, so P is cast to bf16 after the
//       division, exactly where the TPU kernel casts it;
//   (c) proj_residual_layernorm_kernel: [64 rows, H] of ctx . W_out, then
//       bias, residual and LayerNorm, one row per warp.
// (a), (b) and the product of (c) live in fused_blocks.cuh, which
// fused_layer.cu shares.
// The products run on the tensor cores through WMMA bf16 16x16x16 tiles
// with f32 accumulators. What the design still moves through device
// memory and the TPU kernel did not: the qkv scratch (75.5 MB written,
// read back) and ctx (25.2 MB written, read back) at the shape above.
// Keeping them on chip is the first target of a later optimisation.
#include "fused_blocks.cuh"

namespace dial {
namespace {

// ---- (c) out = LN(x + ctx . W_out + b_out) -------------------------------
__global__ void __launch_bounds__(kRThreads)
    proj_residual_layernorm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                                   const float* __restrict__ bias, const bf16* __restrict__ resid,
                                   const float* __restrict__ gamma, const float* __restrict__ beta,
                                   bf16* __restrict__ out, int m) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * kRBM;
  const float* s_c = proj_tile(smem, a, w, m0, m);
  residual_layernorm_rows<kRBM, kRThreads / 32>(s_c, resid + static_cast<size_t>(m0) * kHidden, kHidden, bias,
                                                gamma, beta, out + static_cast<size_t>(m0) * kHidden, m - m0);
}

}  // namespace
}  // namespace dial

// C entry point. All pointers are device pointers: x, wqkv, wout, qkv
// (scratch [B, S, 3H]), ctx (scratch [B, S, H]) and out are bf16; bqkv,
// bout, gamma, beta are f32; mask is int32 [B, S]. Launches the three
// kernels on `stream` and returns the first CUDA error (0 on success).
extern "C" int dial_attention_block_bf16(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* bout, const void* gamma, const void* beta,
                                         void* qkv, void* ctx, void* out, int batch, int seq, int num_heads,
                                         float scale, void* stream) {
  using namespace dial;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = batch * seq;
  cudaError_t err = launch_qkv_attention(x, mask, wqkv, bqkv, qkv, ctx, batch, seq, num_heads, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(proj_residual_layernorm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kProjSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  proj_residual_layernorm_kernel<<<(m + kRBM - 1) / kRBM, kRThreads, kProjSmem, st>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(wout), static_cast<const float*>(bout),
      static_cast<const bf16*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
