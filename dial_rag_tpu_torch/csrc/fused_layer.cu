// One whole BERT encoder layer, for Hopper (sm_90a).
//
// Replaces: dial_rag_tpu/ops/fused_encoder.py::_layer_kernel (pallas_call
// in _layer_forward, wrapper fused_layer_block). Computes, per batch row,
//   a   = T(LN(x + W_out . MHA(T(W_qkv . x + b_qkv)) + b_out))
//   out = T(LN(a + W2 . T(gelu_tanh(W1 . a + b1)) + b2))
// with the TPU kernel's cast points: qkv, P (after the division), ctx, a
// and the GELU output are cast to T (bf16 or f32); products accumulate in
// f32; both LayerNorms (eps 1e-12) run in f32. H 384 (12 heads of 32) or
// 768 (12 heads of 64).
//
// Bound on an H100 SXM at B=128, S=256: the attention block's work plus
// the FFN's, 128.8 GFLOP at H=384 (0.130 ms at 989 TFLOP/s bf16) and
// 489.6 GFLOP at H=768 (0.495 ms); x in and out only (a never leaves the
// chip), 0.016 ms at 3.35 TB/s at H=384 bf16: bound by operations.
//
// Design. What the TPU kernel saves over its two-block composition is the
// round trip of the post-attention state a through device memory. Here a
// layer is three launches, against four for fused_attention.cu and the
// FFN in f32 (fused_ffn.cu), five in bf16 (ffn_tc.cu):
//   (a), (b) the qkv projection and the attention of fused_attention.cu
//       (fused_blocks.cuh): qkv [B, S, 3H] and ctx [B, S, H] still go
//       through device memory, as they do in kernel 1;
//   (c) layer_tail_kernel, one block of 8 warps per tile of rows
//       (Tiles<T, H>): ctx . W_out + b_out, the residual with x and the
//       LayerNorm give a, kept in shared memory as T; then the FFN tile
//       of fused_blocks.cuh over that tile (W1 + b1, tanh GELU, W2 +
//       b2), the residual with a and the second LayerNorm, and only out
//       is stored.
// Shared memory: a plus the larger of the out-projection's staging and
// accumulator image and the FFN's panels: 172, 194, 148 and 145 KB at
// bf16 x 384, bf16 x 768, f32 x 384 and f32 x 768 (layer_smem). It runs
// the device code of kernel 1 and, in f32, of kernel 2; in bf16 kernel 2
// is ffn_tc.cu, whose products sum K in this FFN tile's order (f32
// accumulators, ascending 16-deep tensor-core steps) and whose epilogue
// is the same, so its output equals theirs bit for bit.
#include "fused_blocks.cuh"

namespace dial {
namespace {

template <typename T, int H>
__global__ void __launch_bounds__(kBlockThreads)
    layer_tail_kernel(const T* __restrict__ ctx, const T* __restrict__ wout, const float* __restrict__ bout,
                      const T* __restrict__ x, const float* __restrict__ g1, const float* __restrict__ beta1,
                      const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ g2, const float* __restrict__ beta2,
                      T* __restrict__ out, int m, int inter) {
  constexpr int kRows = Tiles<T, H>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_a = reinterpret_cast<T*>(smem);  // a: never leaves the block
  unsigned char* work = smem + x_bytes<T, H>();
  const int m0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - m0);

  const float* s_c = proj_tile<T, H>(work, ctx, wout, m0, m);
  residual_layernorm_rows<kRows, kBlockThreads / 32, H>(s_c, x + static_cast<size_t>(m0) * H, H, bout, g1, beta1,
                                                        s_a, rows);
  // rows past B*S are zero, so the FFN reads no uninitialised memory
  for (int i = rows * H + threadIdx.x; i < kRows * H; i += kBlockThreads) s_a[i] = from_f32<T>(0.f);
  __syncthreads();  // a complete, and the image in `work` read, before the FFN reuses it

  s_c = ffn_tile<T, H>(s_a, work, w1, b1, w2, inter);
  residual_layernorm_rows<kRows, kBlockThreads / 32, H>(s_c, s_a, H, b2, g2, beta2,
                                                        out + static_cast<size_t>(m0) * H, rows);
}

template <typename T, int H, int DH>
cudaError_t layer_block(const void* x, const void* mask, const void* wqkv, const void* bqkv, const void* wout,
                        const void* bout, const void* g1, const void* beta1, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* g2, const void* beta2, void* qkv, void* ctx,
                        void* out, int batch, int seq, int num_heads, int inter, float scale, cudaStream_t st) {
  constexpr int kRows = Tiles<T, H>::kRows;
  const int m = batch * seq;
  cudaError_t err = launch_qkv_attention<T, H, DH>(x, mask, wqkv, bqkv, qkv, ctx, batch, seq, num_heads, scale, st);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = layer_smem<T, H>();
  err = cudaFuncSetAttribute(layer_tail_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  layer_tail_kernel<T, H><<<(m + kRows - 1) / kRows, kBlockThreads, smem, st>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(wout), static_cast<const float*>(bout),
      static_cast<const T*>(x), static_cast<const float*>(g1), static_cast<const float*>(beta1),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2), static_cast<const float*>(beta2),
      static_cast<T*>(out), m, inter);
  return cudaGetLastError();
}

template <typename T>
int layer_block_any(const void* x, const void* mask, const void* wqkv, const void* bqkv, const void* wout,
                    const void* bout, const void* g1, const void* beta1, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* g2, const void* beta2, void* qkv, void* ctx,
                    void* out, int batch, int seq, int num_heads, int head_dim, int inter, float scale,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hidden = num_heads * head_dim;
  if (inter % 64) return static_cast<int>(cudaErrorInvalidValue);
  if (hidden == 384 && head_dim == 32)
    return layer_block<T, 384, 32>(x, mask, wqkv, bqkv, wout, bout, g1, beta1, w1, b1, w2, b2, g2, beta2, qkv, ctx,
                                   out, batch, seq, num_heads, inter, scale, st);
  if (hidden == 768 && head_dim == 64)
    return layer_block<T, 768, 64>(x, mask, wqkv, bqkv, wout, bout, g1, beta1, w1, b1, w2, b2, g2, beta2, qkv, ctx,
                                   out, batch, seq, num_heads, inter, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace dial

// C entry points, one per dtype T. All pointers are device pointers: x,
// wqkv [H, 3H], wout [H, H], w1 [H, I], w2 [I, H], qkv (scratch [B, S,
// 3H]), ctx (scratch [B, S, H]) and out are T; bqkv, bout, g1, beta1, b1,
// b2, g2, beta2 are f32; mask is int32 [B, S]. (H, head_dim) is (384, 32)
// or (768, 64) and I a multiple of 64 (else cudaErrorInvalidValue).
// Launches the three kernels on `stream` and returns the first CUDA error
// (0 on success).
extern "C" int dial_layer_block_bf16(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                     const void* wout, const void* bout, const void* g1, const void* beta1,
                                     const void* w1, const void* b1, const void* w2, const void* b2, const void* g2,
                                     const void* beta2, void* qkv, void* ctx, void* out, int batch, int seq,
                                     int num_heads, int head_dim, int inter, float scale, void* stream) {
  return dial::layer_block_any<dial::bf16>(x, mask, wqkv, bqkv, wout, bout, g1, beta1, w1, b1, w2, b2, g2, beta2,
                                           qkv, ctx, out, batch, seq, num_heads, head_dim, inter, scale, stream);
}

extern "C" int dial_layer_block_f32(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                                    const void* wout, const void* bout, const void* g1, const void* beta1,
                                    const void* w1, const void* b1, const void* w2, const void* b2, const void* g2,
                                    const void* beta2, void* qkv, void* ctx, void* out, int batch, int seq,
                                    int num_heads, int head_dim, int inter, float scale, void* stream) {
  return dial::layer_block_any<float>(x, mask, wqkv, bqkv, wout, bout, g1, beta1, w1, b1, w2, b2, g2, beta2, qkv,
                                      ctx, out, batch, seq, num_heads, head_dim, inter, scale, stream);
}
