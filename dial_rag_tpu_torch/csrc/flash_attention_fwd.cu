// Single-tile attention forward, f32, for Hopper (sm_90a).
//
// Replaces two TPU kernels of dial_rag_tpu/ops/flash_attention.py with one
// strided kernel:
//   _qkv_native_kernel (pallas_call in _qkv_native_forward): q, k, v read
//     straight from the packed [B, S, 3H] QKV projection, out as [B, S, H];
//   _attention_kernel (pallas_call in _forward, S <= 512 or S % 256 != 0):
//     head-major [B, h, S, Dh] in and out.
// Each operand arrives as a base pointer plus batch, head and row strides,
// so both layouts are read in place with no relayout. Computes
//   o = softmax(q k^T * scale + bias) v,  bias = (1 - mask) * f32.min,
// with the softmax exact per row, in the reference's order: every score,
// then the row max, exp, sum and division, then P . V. No online
// rescaling, so the numbers follow the TPU kernel's.
//
// Bound on an H100 SXM: 4 * B * h * S^2 * Dh FLOPs in f32 on the CUDA
// cores (67 TFLOP/s); at B=128, S=256, 12 heads of 32 that is 12.9 GFLOP,
// 0.192 ms, against 151 MB of qkv read and 50 MB of context written,
// 0.060 ms at 3.35 TB/s: bound by operations.
//
// Design: one block per (32-query tile, head, batch row), 256 threads.
// The tile's full score rows live in dynamic shared memory (32 x S f32,
// 64 KB at S = 512, above the 48 KB default), which bounds S: 1600 on an
// H100's 227 KB (dial_attention_fwd_max_seq works it out; the wrapper
// raises beyond it). K, then V, stream through a
// 64-key staging tile. Thread t owns query row t / 8 and every 8th key
// (scores) or every 8th head column (P . V); its q row sits in registers.
// TF32 and the tensor cores are not used: the products stay full f32, as
// on the reference's f32 path.
#include <cstdint>

#include "attention_f32.cuh"

namespace dial {
namespace attn {
namespace {

struct FwdViews {
  View q, k, v, o;
};

size_t fwd_smem_bytes(int s) {
  return sizeof(float) * (static_cast<size_t>(kRows) * score_ld(s) + kChunk * kPad + kRows * kPad + padded_seq(s) +
                          2 * kRows);
}

__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ bias, float* __restrict__ o, FwdViews vw, int s, float scale) {
  extern __shared__ float smem[];
  const int ld = score_ld(s);
  float* s_p = smem;                   // [kRows, ld] scores, then probabilities
  float* s_kv = s_p + kRows * ld;      // [kChunk, kPad] K or V chunk
  float* s_q = s_kv + kChunk * kPad;   // [kRows, kPad]
  float* s_bias = s_q + kRows * kPad;  // [padded S]
  float* s_m = s_bias + padded_seq(s);
  float* s_l = s_m + kRows;

  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const float* q_head = q + b * vw.q.b + head * vw.q.h;
  const float* k_head = k + b * vw.k.b + head * vw.k.h;
  const float* v_head = v + b * vw.v.b + head * vw.v.h;
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;

  load_rows<kRows>(s_q, q_head, vw.q.r, q0, s);
  for (int i = threadIdx.x; i < s; i += kThreads) s_bias[i] = bias[static_cast<long long>(b) * s + i];
  __syncthreads();
  float q_row[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) q_row[d] = s_q[r * kPad + d];

  probabilities(s_p, s_kv, s_bias, s_m, s_l, q_row, k_head, vw.k.r, s, scale);

  // o[r, j + 8t] = sum_c P[r, c] v[c, j + 8t], keys in order
  float acc[kDh / kPhases] = {};
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    load_rows<kChunk>(s_kv, v_head, vw.v.r, c0, s);
    __syncthreads();
    const int n = min(kChunk, s - c0);
    for (int c = 0; c < n; ++c) {
      const float p = s_p[r * ld + c0 + c];
#pragma unroll
      for (int t = 0; t < kDh / kPhases; ++t) acc[t] = fmaf(p, s_kv[c * kPad + j + kPhases * t], acc[t]);
    }
    __syncthreads();
  }
  if (q0 + r < s) {
    float* o_row = o + b * vw.o.b + head * vw.o.h + (q0 + r) * vw.o.r;
#pragma unroll
    for (int t = 0; t < kDh / kPhases; ++t) o_row[j + kPhases * t] = acc[t];
  }
}

}  // namespace
}  // namespace attn
}  // namespace dial

// C entry point. q, k, v, o: f32 device pointers to [B, h, S, 32] views
// whose (batch, head, row) element strides are `strides[0..11]` (a host
// array: q, k, v, o in turn); bias: f32 [B, S] device pointer. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dial_attention_fwd_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                                      const void* strides, int batch, int heads, int seq, float scale, void* stream) {
  using namespace dial::attn;
  const long long* st = static_cast<const long long*>(strides);
  FwdViews vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.o};
  for (int i = 0; i < 4; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const size_t smem = fwd_smem_bytes(seq);
  cudaError_t err =
      cudaFuncSetAttribute(attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_fwd_kernel<<<dim3((seq + kRows - 1) / kRows, heads, batch), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(o), vw, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

// C entry point. Writes to *max_seq (an int) the longest S, a multiple of
// 64, whose dynamic shared memory (fwd_smem_bytes) fits the opt-in per-block
// limit of the current device; returns the CUDA error of the query.
extern "C" int dial_attention_fwd_max_seq(void* max_seq) {
  using namespace dial::attn;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int s = 0;
  while (fwd_smem_bytes(s + kChunk) <= static_cast<size_t>(limit)) s += kChunk;
  *static_cast<int*>(max_seq) = s;
  return 0;
}
