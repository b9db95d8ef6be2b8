// Single-tile attention forward on the CUDA cores, f32, head_dim 32 and 64,
// for Hopper (sm_90a).
//
// Replaces, in f32, two TPU kernels of dial_rag_tpu/ops/flash_attention.py
// with one strided kernel (in bf16 the tensor-core kernel of
// attention_tc.cu takes them):
//   _qkv_native_kernel (pallas_call in _qkv_native_forward): q, k, v read
//     straight from the packed [B, S, 3H] QKV projection, out as [B, S, H];
//   _attention_kernel (pallas_call in _forward, S <= 512 or S % 256 != 0):
//     head-major [B, h, S, Dh] in and out.
// Each operand arrives as a base pointer plus batch, head and row strides,
// so both layouts are read in place with no relayout. Computes
//   o = softmax(q k^T * scale + bias) v,  bias = (1 - mask) * f32.min,
// with the softmax exact per row, in the reference's order: every score,
// then the row max, exp, sum and division, then P . V, P cast to the
// input dtype first (as the reference's probs.astype(q.dtype), the
// identity in f32). No online rescaling, so the numbers follow the TPU
// kernel's.
//
// Bound on an H100 SXM: 4 * B * h * S^2 * Dh FLOPs; at B=128, S=256, 12
// heads of 32 that is 12.9 GFLOP, 0.192 ms at 67 TFLOP/s in f32, against
// 151 MB of qkv read and 50 MB of context written, 0.060 ms at 3.35 TB/s:
// bound by operations. At 12 heads of 64 (H = 768) 25.8 GFLOP, 0.385 ms.
//
// Design: one block per (32-query tile, head, batch row), 256 threads
// (attention_f32.cuh, attention_fwd_kernel). The tile's full score rows
// live in dynamic shared memory (32 x S f32, 64 KB at S = 512, above the
// 48 KB default), which bounds S: dial_attention_fwd_max_seq works the
// limit out per head width (1600 at head_dim 32 on an H100's 227 KB);
// beyond it the wrapper takes the query-blocked kernel's code
// (flash_attention_long.cu), which computes the same function at any S.
// K, then V, stream through a 64-key staging tile. Thread t owns query row
// t / 8 and every 8th key (scores) or every 8th head column (P . V); its q
// row sits in registers (32 or 64 floats). TF32 and the tensor cores are
// not used: the products stay full f32, as on the reference's f32 path
// (HIGHEST precision). The f32 fused attention block (fused_blocks.cuh,
// kernel 1) runs the same device code.
#include "attention_f32.cuh"

namespace {

using namespace dial;
using namespace dial::attn;

// C entry point body: q, k, v, o device pointers to [B, h, S, head_dim]
// views of T whose (batch, head, row) element strides are
// `strides[0..11]` (a host array: q, k, v, o in turn); bias: f32 [B, S].
template <typename T>
int attention_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, const void* strides,
                  int batch, int heads, int seq, int head_dim, float scale, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  FwdViews vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.o};
  for (int i = 0; i < 4; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const float* fb = static_cast<const float*>(bias);
  T* to = static_cast<T*>(o);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_attention_fwd<T, 32>(tq, tk, tv, fb, to, vw, batch, heads, seq, scale, stm);
  if (head_dim == 64) return launch_attention_fwd<T, 64>(tq, tk, tv, fb, to, vw, batch, heads, seq, scale, stm);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point. Launches on `stream` and returns cudaGetLastError() (0 on
// success); an unsupported head_dim returns cudaErrorInvalidValue.
extern "C" int dial_attention_fwd_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                                      const void* strides, int batch, int heads, int seq, int head_dim, float scale,
                                      void* stream) {
  return attention_fwd<float>(q, k, v, bias, o, strides, batch, heads, seq, head_dim, scale, stream);
}

// C entry point. Writes to *max_seq (an int) the longest S, a multiple of
// 64, whose dynamic shared memory (fwd_smem_bytes) fits the opt-in per-block limit of the
// current device at `head_dim`; returns the CUDA error of the query.
extern "C" int dial_attention_fwd_max_seq(int head_dim, void* max_seq) {
  int* out = static_cast<int*>(max_seq);
  if (head_dim == 32) return static_cast<int>(max_seq_for(fwd_smem_bytes<32>, out));
  if (head_dim == 64) return static_cast<int>(max_seq_for(fwd_smem_bytes<64>, out));
  return static_cast<int>(cudaErrorInvalidValue);
}
