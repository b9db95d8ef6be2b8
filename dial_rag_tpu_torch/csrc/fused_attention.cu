// Fused attention block of a BERT encoder layer, for Hopper (sm_90a).
//
// Replaces: dial_rag_tpu/ops/fused_encoder.py::_attn_block_kernel
// (pallas_call in _attn_block_forward, wrapper fused_attention_block).
// Computes, per batch row,
//   out = LN(x + W_out . MHA(T(W_qkv . x + b_qkv)) + b_out)
// with f32 accumulation, f32 softmax over scores*scale + (1-mask)*f32.min,
// probabilities cast to T before P.V, LayerNorm eps 1e-12, T out. T is
// bf16 or f32, at (H 384, 12 heads of 32) or (H 768, 12 heads of 64).
//
// Bound on an H100 SXM at B=128, S=256 (m = 32768 rows):
//   H=384, bf16: QKV 29.0 + QK^T 6.4 + PV 6.4 + out-proj 9.7 = 51.5 GFLOP
//     -> 0.052 ms at 989 TFLOP/s; x 25.2 MB in, out 25.2 MB -> 0.0154 ms;
//   H=768, bf16: 116.0 + 12.9 + 12.9 + 38.7 = 180.4 GFLOP -> 0.182 ms;
//   H=384, f32: 51.5 GFLOP -> 0.769 ms at 67 TFLOP/s (CUDA cores).
//   So the block is bound by operations.
//
// Design. The TPU kernel keeps the whole [S, S] f32 score tile of a head
// in 16 MiB of VMEM; an H100 block has 227 KB of shared memory, so the
// work is split into three launches:
//   (a) the QKV projection: [B*S, H] x [H, 3H] + b -> scratch [B, S, 3H]
//       of T;
//   (b) the attention, one block per (64-query tile (bf16) or 32-query
//       tile (f32), head, batch row), reading q/k/v straight out of the
//       [B, S, 3H] layout. bf16: two passes over 64-key tiles on the
//       tensor cores, the first finding each row's max and softmax
//       denominator, the second forming the normalised probabilities, so
//       P is cast to bf16 after the division, exactly where the TPU kernel
//       casts it. f32: the single-tile attention kernel's device code
//       (attention_f32.cuh), exact per-row softmax in f32;
//   (c) proj_residual_layernorm_kernel: [rows, H] of ctx . W_out, then
//       bias, residual and LayerNorm, one row per warp.
// (a), (b) and the product of (c) live in fused_blocks.cuh, which
// fused_layer.cu shares. bf16 products on the tensor cores (WMMA, f32
// accumulators); f32 products on the CUDA cores in full f32. What the
// design still moves through device memory and the TPU kernel did not:
// the qkv scratch (75.5 MB written, read back at H=384 bf16) and ctx
// (25.2 MB). Keeping them on chip is the first target of a later
// optimisation.
#include "fused_blocks.cuh"

namespace dial {
namespace {

// ---- (c) out = LN(x + ctx . W_out + b_out) -------------------------------
template <typename T, int H>
__global__ void __launch_bounds__(kBlockThreads)
    proj_residual_layernorm_kernel(const T* __restrict__ a, const T* __restrict__ w,
                                   const float* __restrict__ bias, const T* __restrict__ resid,
                                   const float* __restrict__ gamma, const float* __restrict__ beta,
                                   T* __restrict__ out, int m) {
  constexpr int kRows = Tiles<T, H>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * kRows;
  const float* s_c = proj_tile<T, H>(smem, a, w, m0, m);
  residual_layernorm_rows<kRows, kBlockThreads / 32, H>(s_c, resid + static_cast<size_t>(m0) * H, H, bias, gamma,
                                                        beta, out + static_cast<size_t>(m0) * H, m - m0);
}

template <typename T, int H, int DH>
cudaError_t attention_block(const void* x, const void* mask, const void* wqkv, const void* bqkv, const void* wout,
                            const void* bout, const void* gamma, const void* beta, void* qkv, void* ctx, void* out,
                            int batch, int seq, int num_heads, float scale, cudaStream_t st) {
  constexpr int kRows = Tiles<T, H>::kRows;
  const int m = batch * seq;
  cudaError_t err = launch_qkv_attention<T, H, DH>(x, mask, wqkv, bqkv, qkv, ctx, batch, seq, num_heads, scale, st);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = proj_bytes<T, H>();
  err = cudaFuncSetAttribute(proj_residual_layernorm_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  proj_residual_layernorm_kernel<T, H><<<(m + kRows - 1) / kRows, kBlockThreads, smem, st>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(wout), static_cast<const float*>(bout),
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(out), m);
  return cudaGetLastError();
}

template <typename T>
int attention_block_any(const void* x, const void* mask, const void* wqkv, const void* bqkv, const void* wout,
                        const void* bout, const void* gamma, const void* beta, void* qkv, void* ctx, void* out,
                        int batch, int seq, int num_heads, int head_dim, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hidden = num_heads * head_dim;
  if (hidden == 384 && head_dim == 32)
    return attention_block<T, 384, 32>(x, mask, wqkv, bqkv, wout, bout, gamma, beta, qkv, ctx, out, batch, seq,
                                       num_heads, scale, st);
  if (hidden == 768 && head_dim == 64)
    return attention_block<T, 768, 64>(x, mask, wqkv, bqkv, wout, bout, gamma, beta, qkv, ctx, out, batch, seq,
                                       num_heads, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace dial

// C entry points, one per dtype T. All pointers are device pointers: x,
// wqkv, wout, qkv (scratch [B, S, 3H]), ctx (scratch [B, S, H]) and out
// are T; bqkv, bout, gamma, beta are f32; mask is int32 [B, S]. H =
// num_heads * head_dim must be 384 with head_dim 32 or 768 with head_dim
// 64 (else cudaErrorInvalidValue). Launches the three kernels on
// `stream` and returns the first CUDA error (0 on success).
extern "C" int dial_attention_block_bf16(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* bout, const void* gamma, const void* beta,
                                         void* qkv, void* ctx, void* out, int batch, int seq, int num_heads,
                                         int head_dim, float scale, void* stream) {
  return dial::attention_block_any<dial::bf16>(x, mask, wqkv, bqkv, wout, bout, gamma, beta, qkv, ctx, out, batch,
                                               seq, num_heads, head_dim, scale, stream);
}

extern "C" int dial_attention_block_f32(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                        const void* wout, const void* bout, const void* gamma, const void* beta,
                                        void* qkv, void* ctx, void* out, int batch, int seq, int num_heads,
                                        int head_dim, float scale, void* stream) {
  return dial::attention_block_any<float>(x, mask, wqkv, bqkv, wout, bout, gamma, beta, qkv, ctx, out, batch, seq,
                                          num_heads, head_dim, scale, stream);
}
