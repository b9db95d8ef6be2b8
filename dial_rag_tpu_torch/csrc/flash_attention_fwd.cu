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
// wrapper raises on views that are not 16-byte aligned. The f32 fused
// attention block (fused_blocks.cuh, kernel 1) keeps the CUDA-core
// forward of attention_f32.cuh.
#include <cfloat>

#include "attention_f32.cuh"
#include "tensor_core_tf32.cuh"

namespace dial {
namespace attn {
namespace {

constexpr int kKeyChunk = 32;              // keys a ring stage holds
constexpr int kChunkTiles = kKeyChunk / 8;  // 8-key accumulator tiles of a chunk

// Dynamic shared memory at sequence length s: the q tile, two ring
// stages, the bias row and the block's scores (16 x padded S a warp).
template <int DH>
struct TileFwdLayout {
  static constexpr int kQ = tf32::kTileRows * tf32::kLd<DH>;
  static constexpr int kStage = kKeyChunk * tf32::kLd<DH>;
  static size_t bytes(int s) {
    const size_t padded = padded_seq(s);
    return sizeof(float) * (kQ + 2 * kStage + padded + tf32::kTileRows * padded);
  }
};

template <int DH>
size_t tile_fwd_bytes(int s) {
  return TileFwdLayout<DH>::bytes(s);
}

template <int DH>
__global__ void __launch_bounds__(tf32::kThreads)
    single_tile_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ bias, float* __restrict__ o, FwdViews vw, int s, float scale) {
  using L = TileFwdLayout<DH>;
  extern __shared__ __align__(16) float fwd_smem[];
  const int padded = padded_seq(s);
  float* s_q = fwd_smem;
  float* s_ring = s_q + L::kQ;
  float* s_bias = s_ring + 2 * L::kStage;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
  // this lane's scores: 4 floats (rows g, g + 8; columns 2c, 2c + 1) per 8-key tile t, at + 128 t
  float* s_x = s_bias + padded + warp * 16 * padded + 4 * lane;
  const int q0 = blockIdx.x * tf32::kTileRows, head = blockIdx.y, b = blockIdx.z;
  const float* k_head = k + b * vw.k.b + head * vw.k.h;
  const float* v_head = v + b * vw.v.b + head * vw.v.h;
  const float* bias_row = bias + static_cast<long long>(b) * s;
  const float* q_warp = s_q + 16 * warp * tf32::kLd<DH>;
  const int n_chunks = (s + kKeyChunk - 1) / kKeyChunk;
  auto issue = [&](int chunk, const float* head_rows, long long row_stride) {
    tf32::copy_rows_async<DH>(s_ring + (chunk % 2) * L::kStage, head_rows, row_stride, chunk * kKeyChunk,
                              kKeyChunk, s, blockDim.x);
  };

  // the block's 64 query rows, then the first K chunk; the warp's q rows
  // go to registers as split fragments, split once for every key chunk
  tf32::copy_rows_async<DH>(s_q, q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, tf32::kTileRows, s, blockDim.x);
  tc::cp_async_commit();
  issue(0, k_head, vw.k.r);
  tc::cp_async_commit();
  for (int i = threadIdx.x; i < n_chunks * kKeyChunk; i += blockDim.x) s_bias[i] = i < s ? bias_row[i] : -INFINITY;
  tc::cp_async_wait<1>();
  __syncthreads();
  tf32::FragA qa[DH / 8];
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) tf32::load_a(qa[ks], q_warp + 8 * ks, tf32::kLd<DH>);

  // pass 1: scores q . k * scale + bias (keys past S: -inf), kept; the
  // lane's max of its two rows
  float m[2] = {-INFINITY, -INFINITY};
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = tf32::ring_step(ch, n_chunks, [&](int next) { issue(next, k_head, vw.k.r); });
    float x[kChunkTiles][4];
    tf32::product_frags<kChunkTiles, DH>(x, qa, s_ring + st * L::kStage);
    const float* kb = s_bias + ch * kKeyChunk + 2 * c;
#pragma unroll
    for (int n = 0; n < kChunkTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = scaled_score(x[n][e], scale, kb[8 * n + e % 2]);
      m[0] = fmaxf(m[0], fmaxf(x[n][0], x[n][1]));
      m[1] = fmaxf(m[1], fmaxf(x[n][2], x[n][3]));
      *reinterpret_cast<float4*>(s_x + 128 * (ch * kChunkTiles + n)) = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
    }
    __syncthreads();
  }

  // per row: the max over its four lanes (key 0 is real, so it is
  // finite), e = exp(s - max) in place of the scores, the sum of e
  float l[2] = {0.f, 0.f}, r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = tf32::quad_max(m[h]);
  for (int t = 0; t < n_chunks * kChunkTiles; ++t) {
    float4* p = reinterpret_cast<float4*>(s_x + 128 * t);
    float4 e = *p;
    e.x = expf(__fsub_rn(e.x, m[0]));
    e.y = expf(__fsub_rn(e.y, m[0]));
    e.z = expf(__fsub_rn(e.z, m[1]));
    e.w = expf(__fsub_rn(e.w, m[1]));
    l[0] += e.x + e.y;
    l[1] += e.z + e.w;
    *p = e;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = tf32::quad_sum(l[h]);
    r[h] = __frcp_rn(l[h]);
  }

  // pass 2: o = sum over the keys of (e / l) v, one partial per 64 keys
  // added in f32
  float acc[DH / 8][4] = {}, part[DH / 8][4] = {};
  issue(0, v_head, vw.v.r);
  tc::cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = tf32::ring_step(ch, n_chunks, [&](int next) { issue(next, v_head, vw.v.r); });
    float p[kChunkTiles][4];
#pragma unroll
    for (int n = 0; n < kChunkTiles; ++n) {
      const float4 e = *reinterpret_cast<const float4*>(s_x + 128 * (ch * kChunkTiles + n));
      p[n][0] = tc::div_by(e.x, l[0], r[0]);
      p[n][1] = tc::div_by(e.y, l[0], r[0]);
      p[n][2] = tc::div_by(e.z, l[1], r[1]);
      p[n][3] = tc::div_by(e.w, l[1], r[1]);
    }
    tf32::accumulate_pairs<kChunkTiles, DH>(part, p, s_ring + st * L::kStage);
    if (ch % 2 == 1 || ch + 1 == n_chunks) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
          part[j][e] = 0.f;
        }
    }
    __syncthreads();
  }
  tf32::store_rows<DH>(o + b * vw.o.b + head * vw.o.h, vw.o.r, q0 + 16 * warp, s, acc);
}

template <int DH>
int launch_single_tile(const float* q, const float* k, const float* v, const float* bias, float* o,
                       const FwdViews& vw, int batch, int heads, int seq, float scale, cudaStream_t stream) {
  const size_t smem = tile_fwd_bytes<DH>(seq);
  cudaError_t err = cudaFuncSetAttribute(single_tile_tf32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  single_tile_tf32_kernel<DH>
      <<<dim3((seq + tf32::kTileRows - 1) / tf32::kTileRows, heads, batch), tf32::kThreads, smem, stream>>>(
          q, k, v, bias, o, vw, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace attn
}  // namespace dial

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
  if (head_dim == 32) return launch_single_tile<32>(fq, fk, fv, fb, fo, vw, batch, heads, seq, scale, stm);
  if (head_dim == 64) return launch_single_tile<64>(fq, fk, fv, fb, fo, vw, batch, heads, seq, scale, stm);
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
