// Single-tile attention forward in f32, head_dim 32 and 64, on Hopper's
// tensor cores in split TF32 (sm_90a).
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
// with the softmax exact per row, in the reference's order: every score
// (scores * scale + bias), then per row the max, exp(s - max), their sum
// and the division, then P . V. No online rescaling.
//
// Products in split TF32 (tensor_core_tf32.cuh: each f32 operand split
// into two TF32 parts, hi.lo + lo.hi + hi.hi by mma.sync.m16n8k8, about
// 2^-21 relative a product), Hopper's counterpart of the HIGHEST precision
// the reference asks for on f32. P . V is summed over the keys as one
// partial per 64 keys added in f32 on the CUDA cores, as in the
// query-blocked kernel (flash_attention_long.cu).
//
// Bound on an H100 SXM: 4 B h S^2 Dh FLOPs (Q K^T and P . V once); at
// B=128, S=256, 12 heads of 64 (H = 768) 25.8 GFLOP, 0.385 ms at 67
// TFLOP/s in f32 on the CUDA cores, 0.156 ms at 165 TFLOP/s of 3xTF32
// (495 / 3), against 302 MB of qkv read and 101 MB of context written,
// 0.120 ms at 3.35 TB/s: bound by operations (12 heads of 32: 12.9
// GFLOP, 0.192 / 0.078 ms).
//
// Design: one block of 4 warps per (64-query tile, head, batch row), 16
// query rows a warp. What the single tile allows: the block's full score
// rows fit in shared memory, so Q K^T is formed once (the query-blocked
// kernel, which has no S limit, forms it twice). Pass 1 streams K through
// a two-stage cp.async ring of 32-key chunks (f32 rows of DH + 4 floats),
// forms each chunk's scores against the warp's q rows, held in registers
// already split (split once, not once a chunk), and keeps them; each lane
// keeps the entries it holds in the accumulator layout, so the score tile
// is private to the lane (float4 rows of shared memory, no bank conflict,
// no barrier). Then each lane takes its two rows' max over the row's four
// lanes, replaces its scores by e = exp(s - max), and the row sums of e
// follow. Pass 2
// streams V through the same ring and forms P . V with p = e / l
// (correctly rounded, tc::div_by) as the A operand. The scores bound S:
// dial_attention_fwd_max_seq works the limit out per head width (768 at
// head_dim 32, 704 at 64 on an H100's 227 KB); beyond it the wrapper
// takes the query-blocked kernel's code, which computes the same function
// at any S. K, V and Q rows are copied 16 bytes at a time, so the
// wrapper raises on views that are not 16-byte aligned. The kernel lives
// in attention_fwd_tf32.cuh, which the f32 encoder blocks (kernels 1 and
// 3) share for their attention stage.
#include "attention_fwd_tf32.cuh"

// C entry point. q, k, v, o: device pointers to f32 [B, h, S, head_dim]
// views whose (batch, head, row) element strides are `strides[0..11]` (a
// host array: q, k, v, o in turn), q, k and v 16-byte aligned with
// strides in whole 16 bytes; bias: f32 [B, S]; S within
// dial_attention_fwd_max_seq. Launches on `stream` and returns
// cudaGetLastError() (0 on success); an unsupported head_dim returns
// cudaErrorInvalidValue.
extern "C" int dial_attention_fwd_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                                      const void* strides, int batch, int heads, int seq, int head_dim, float scale,
                                      void* stream) {
  using namespace dial::attn;
  const long long* st = static_cast<const long long*>(strides);
  FwdViews vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.o};
  for (int i = 0; i < 4; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fb = static_cast<const float*>(bias);
  float* fo = static_cast<float*>(o);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return static_cast<int>(launch_single_tile<32>(fq, fk, fv, fb, fo, vw, batch, heads, seq, scale, stm));
  if (head_dim == 64)
    return static_cast<int>(launch_single_tile<64>(fq, fk, fv, fb, fo, vw, batch, heads, seq, scale, stm));
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry point. Writes to *max_seq (an int) the longest S, a multiple of
// 64, whose dynamic shared memory (TileFwdLayout) fits the opt-in
// per-block limit of the current device at `head_dim`; returns the CUDA
// error of the query.
extern "C" int dial_attention_fwd_max_seq(int head_dim, void* max_seq) {
  using namespace dial::attn;
  int* out = static_cast<int*>(max_seq);
  if (head_dim == 32) return static_cast<int>(max_seq_for(tile_fwd_bytes<32>, out));
  if (head_dim == 64) return static_cast<int>(max_seq_for(tile_fwd_bytes<64>, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry point. Writes to *bytes (an int) the dynamic shared memory
// (TileFwdLayout) a block of dial_attention_fwd_f32 is launched with at S =
// `seq` and `head_dim`; an unsupported head_dim returns
// cudaErrorInvalidValue.
extern "C" int dial_attention_fwd_smem_bytes(int head_dim, int seq, void* bytes) {
  using namespace dial::attn;
  int* out = static_cast<int*>(bytes);
  if (head_dim == 32) *out = static_cast<int>(tile_fwd_bytes<32>(seq));
  else if (head_dim == 64) *out = static_cast<int>(tile_fwd_bytes<64>(seq));
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}
