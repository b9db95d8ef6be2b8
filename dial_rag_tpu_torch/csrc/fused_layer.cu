// One whole bge-small encoder layer, bf16, for Hopper (sm_90a).
//
// Replaces: dial_rag_tpu/ops/fused_encoder.py::_layer_kernel (pallas_call
// in _layer_forward, wrapper fused_layer_block). Computes, per batch row,
//   a   = bf16(LN(x + W_out . MHA(bf16(W_qkv . x + b_qkv)) + b_out))
//   out = bf16(LN(a + W2 . bf16(gelu_tanh(W1 . a + b1)) + b2))
// with the TPU kernel's cast points: qkv, P (after the division), ctx, a
// and the GELU output are cast to bf16; products accumulate in f32; both
// LayerNorms (eps 1e-12) run in f32.
//
// Bound on an H100 SXM at B=128, S=256, H=384, 12 heads, I=1536: the
// attention block's 51.5 GFLOP plus the FFN's 77.3 GFLOP, 128.8 GFLOP,
// 0.130 ms at 989 TFLOP/s bf16; x 25.2 MB in and 25.2 MB out (a never
// leaves the chip), 0.016 ms at 3.35 TB/s: bound by operations.
//
// Design. What the TPU kernel saves over its two-block composition is the
// round trip of the post-attention state a through device memory. Here a
// layer is three launches, against four for fused_attention.cu +
// fused_ffn.cu:
//   (a), (b) the qkv projection and the attention of fused_attention.cu
//       (fused_blocks.cuh): qkv [B, S, 3H] and ctx [B, S, H] still go
//       through device memory, as they do in kernel 1;
//   (c) layer_tail_kernel, one block of 8 warps per 64 rows: ctx . W_out +
//       b_out, the residual with x and the LayerNorm give a, kept in
//       shared memory as bf16 (64 x 384, 48 KB); then the FFN of
//       fused_ffn.cu over that tile (W1 + b1, tanh GELU, W2 + b2), the
//       residual with a and the second LayerNorm, and only out is stored.
// Shared memory: a (48 KB) plus the larger of the out-projection's
// staging and accumulator image (124 KB) and the FFN's panels (120 KB).
#include "fused_blocks.cuh"

namespace dial {
namespace {

constexpr size_t kLayerWorkBytes = kProjSmem > kFfnWorkBytes ? kProjSmem : kFfnWorkBytes;
constexpr size_t kLayerSmem = kXBytes + kLayerWorkBytes;
static_assert(kRBM == kFBM, "one 64-row tile runs both halves");

__global__ void __launch_bounds__(kRThreads)
    layer_tail_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ wout, const float* __restrict__ bout,
                      const bf16* __restrict__ x, const float* __restrict__ g1, const float* __restrict__ beta1,
                      const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ g2, const float* __restrict__ beta2,
                      bf16* __restrict__ out, int m, int inter) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);  // a: never leaves the block
  unsigned char* work = smem + kXBytes;
  const int m0 = blockIdx.x * kRBM;
  const int rows = min(kRBM, m - m0);

  const float* s_c = proj_tile(work, ctx, wout, m0, m);
  residual_layernorm_rows<kRBM, kRThreads / 32>(s_c, x + static_cast<size_t>(m0) * kHidden, kHidden, bout, g1,
                                                beta1, s_a, rows);
  // rows past B*S are zero, so the FFN reads no uninitialised memory
  for (int i = rows * kHidden + threadIdx.x; i < kRBM * kHidden; i += kRThreads) s_a[i] = __float2bfloat16(0.f);
  __syncthreads();  // a complete, and the image in `work` read, before the FFN reuses it

  s_c = ffn_tile(s_a, work, w1, b1, w2, inter);
  residual_layernorm_rows<kFBM, kFThreads / 32>(s_c, s_a, kHidden, b2, g2, beta2,
                                                out + static_cast<size_t>(m0) * kHidden, rows);
}

}  // namespace
}  // namespace dial

// C entry point. All pointers are device pointers: x, wqkv [H, 3H], wout
// [H, H], w1 [H, I], w2 [I, H], qkv (scratch [B, S, 3H]), ctx (scratch
// [B, S, H]) and out are bf16; bqkv, bout, g1, beta1, b1, b2, g2, beta2 are
// f32; mask is int32 [B, S]. Launches the three kernels on `stream` and
// returns the first CUDA error (0 on success).
extern "C" int dial_layer_block_bf16(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                     const void* wout, const void* bout, const void* g1, const void* beta1,
                                     const void* w1, const void* b1, const void* w2, const void* b2, const void* g2,
                                     const void* beta2, void* qkv, void* ctx, void* out, int batch, int seq,
                                     int num_heads, int inter, float scale, void* stream) {
  using namespace dial;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = batch * seq;
  cudaError_t err = launch_qkv_attention(x, mask, wqkv, bqkv, qkv, ctx, batch, seq, num_heads, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(layer_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kLayerSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_tail_kernel<<<(m + kRBM - 1) / kRBM, kRThreads, kLayerSmem, st>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(wout), static_cast<const float*>(bout),
      static_cast<const bf16*>(x), static_cast<const float*>(g1), static_cast<const float*>(beta1),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2), static_cast<const float*>(beta2),
      static_cast<bf16*>(out), m, inter);
  return static_cast<int>(cudaGetLastError());
}
