// Long-sequence attention forwards in f32, head_dim 32 and 64, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of dial_rag_tpu/ops/flash_attention.py (the
// pallas_calls in _forward for S > 512 with S % 256 == 0), in f32 (bf16
// takes the tensor-core kernels of attention_tc.cu):
//   _attention_q_blocked_kernel (flash_attention.py:115; S <= 4096 or
//     S % 512 != 0): per 256-query block, the exact per-row softmax over
//     every key, then P . V;
//   _attention_kv_blocked_fwd_kernel (flash_attention.py:165; the rest):
//     the online softmax over 512-key blocks (running max m from f32.min,
//     corr = exp(m_prev - m_next), e = exp(s - m_next), o = acc / l at the
//     end), which also writes lse = m + log(l), f32 [B, h, S], for the
//     blocked backward.
// The query-blocked code also serves the single-tile kernels
// (_qkv_native_kernel, _attention_kernel) in f32 past their shared-memory
// limit: it computes the same function at any S, a ragged last key chunk
// and query tile masked inside the kernel.
// Both take head-major [B, h, S, Dh] views with (batch, head, row) element
// strides, as flash_attention_fwd.cu does, so q, k and v are read straight
// out of the packed [B, S, 3H] projection and o can be written in the
// [B, S, H] layout the next product reads. bias = (1 - mask) * f32.min,
// never -inf: a fully masked row gets uniform weights and stays finite.
//
// The query-blocked forward (q_blocked_tf32_kernel) runs its products on
// the tensor cores in split TF32 (tensor_core_tf32.cuh: each f32 operand
// split into two TF32 parts, hi.lo + lo.hi + hi.hi by mma.sync.m16n8k8,
// about 2^-21 relative a product), Hopper's counterpart of the HIGHEST
// precision the reference asks for on f32 (itself several bf16 passes on
// the TPU's MXU). A block of 4 warps owns 64 query rows of one (head,
// batch row), 16 a warp; K and V stream through a two-stage cp.async ring
// of 64-key chunks in dynamic shared memory (f32 rows of DH + 4 floats;
// 104 KB a block at head_dim 64, 56 KB at 32). Pass 1 forms each chunk's
// scores, Q K^T, and keeps each lane's running max and denominator of its
// two rows (merged over the row's four lanes at the end); pass 2 forms
// them again, p = exp(s - max) / l, and P . V into a per-chunk partial
// that is added to o in f32 on the CUDA cores (the tensor core's
// accumulator rounds in its own way, so no long sum stays in it). The
// softmax stays exact per row, normalised before P . V; only the
// denominator is summed in another order.
// Bound on an H100 SXM: 4 B h S^2 Dh FLOPs (Q K^T and P . V once); at
// [1, 12, 4096, 32] 25.8 GFLOP: 0.385 ms at 67 TFLOP/s in f32 on the
// CUDA cores, 0.156 ms at 165 TFLOP/s of 3xTF32 (495 / 3); 0.769 and
// 0.312 ms at head_dim 64; q, k, v and o (25-50 MB) take 0.008-0.015 ms
// at 3.35 TB/s: bound by operations. The kernel computes three [S, S] products (Q K^T in both
// passes, then P . V) against the bound's two. What still holds it back:
// that third product, the split of every operand at each fragment load
// (three conversions per element, in every warp that reads it), mma.sync
// rather than wgmma (wgmma takes TF32 only K-major, so V would have to be
// transposed in shared memory), and two blocks an SM at head_dim 64.
//
// The KV-blocked forward (kv_blocked_tf32_kernel) runs on the same
// blocks, ring and split-TF32 pieces in one sweep: each 64-key chunk
// forms Q K^T once (each head-width step's products a partial added in
// f32: tensor_core_tf32.cuh's kStepPartials, which keeps the lse as close
// to an f64 evaluation as the plain version is), takes the chunk's row max
// (merged over the row's four lanes, so they share m), corr = exp(m - m_next) and e = exp(s - m_next),
// rescales the lane's share of l and the accumulator by corr, and forms
// e . V into a per-chunk partial added to acc corr in f32 on the CUDA
// cores; at the end o = acc / l and lse = m + log(l), l merged over the
// quad. Two [S, S] products, the bound's count (kernel 6 forms Q K^T
// twice). The reference rescales at every 512 keys; this kernel rescales
// at every 64-key chunk, the same function rounded otherwise (about an
// ulp a rescale): keeping the 512-key max would need Q K^T twice a block
// or a [64, 512] score tile in shared memory, a third product. At [1, 12,
// 8192, 64] its 206 GFLOP take 1.25 ms at 165 TFLOP/s of 3xTF32 (3.08 ms
// at 67 TFLOP/s on the CUDA cores); 0.62 and 1.54 ms at head_dim 32;
// q, k, v, o and lse (101 MB at head_dim 64) take 0.03 ms: bound by
// operations.
#include <cfloat>
#include <cstdint>

#include "attention_long.cuh"
#include "tensor_core_tf32.cuh"

namespace dial {
namespace attn {
namespace {

struct LongViews {
  View q, k, v, o;
};

// ---- _attention_q_blocked_kernel (f32, split-TF32 tensor-core products) ----
// The warp's 16 query rows against a 64-key chunk in stage `st`: x[n][e]
// is row g + 8 (e / 2) and key 8 n + 2c + e % 2, as q . k * scale + bias
// rounded as the reference rounds it; q . k summed as product_rows'
// kStepPartials says.
template <int DH, bool kStepPartials = false>
__device__ __forceinline__ void tf32_scores(float (&x)[8][4], const float* q_warp, const tf32::Layout<DH>& sm,
                                            int st, float scale) {
  tf32::product_rows<8, DH, false, kStepPartials>(x, q_warp, sm.tile(st, 0));
  const float* bias = sm.extra(st) + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = scaled_score(x[n][e], scale, bias[8 * n + e % 2]);
}

template <int DH>
__global__ void __launch_bounds__(tf32::kThreads)
    q_blocked_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ bias, float* __restrict__ o, LongViews vw, int s, float scale) {
  extern __shared__ __align__(16) float tf32_smem[];
  const tf32::Layout<DH> sm{tf32_smem};
  const int q0 = blockIdx.x * tf32::kTileRows, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const float* k_head = k + b * vw.k.b + head * vw.k.h;
  const float* v_head = v + b * vw.v.b + head * vw.v.h;
  const float* bias_row = bias + static_cast<long long>(b) * s;
  const float* q_warp = sm.fixed(0) + 16 * warp * tf32::kLd<DH>;
  const int n_chunks = (s + tf32::kTileRows - 1) / tf32::kTileRows;
  // key chunk c (V too when with_v) and its bias (-inf past S) into stage c % 2
  auto issue = [&](int c, bool with_v) {
    const int c0 = c * tf32::kTileRows, st = c % 2;
    tf32::copy_rows_async<DH>(sm.tile(st, 0), k_head, vw.k.r, c0, tf32::kTileRows, s, tf32::kThreads);
    if (with_v) tf32::copy_rows_async<DH>(sm.tile(st, 1), v_head, vw.v.r, c0, tf32::kTileRows, s, tf32::kThreads);
    if (threadIdx.x < tf32::kTileRows) sm.extra(st)[threadIdx.x] = key_bias(bias_row, c0 + threadIdx.x, s);
  };

  // the block's 64 query rows, copied with the first key chunk
  tf32::copy_rows_async<DH>(sm.fixed(0), q + b * vw.q.b + head * vw.q.h, vw.q.r,
                            q0, tf32::kTileRows, s, tf32::kThreads);

  // pass 1: this lane's running max and denominator of its two rows (g and
  // g + 8) over its keys. The max starts at f32.min, not -inf, so a lane
  // none of whose keys is real yet rescales by exp(0), not exp(NaN).
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  issue(0, false);
  tc::cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int st = tf32::ring_step(c, n_chunks, [&](int next) { issue(next, false); });
    float x[8][4];
    tf32_scores(x, q_warp, sm, st, scale);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cm = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) cm = fmaxf(cm, fmaxf(x[n][2 * h], x[n][2 * h + 1]));
      const float m_new = fmaxf(m[h], cm);
      float add = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        add += expf(__fsub_rn(x[n][2 * h], m_new)) + expf(__fsub_rn(x[n][2 * h + 1], m_new));
      l[h] = l[h] * expf(__fsub_rn(m[h], m_new)) + add;
      m[h] = m_new;
    }
    __syncthreads();
  }
  // merged over the four lanes of each row: its max and sum(exp(s - max))
  float m_row[2], l_row[2], r_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_row[h] = tf32::quad_max(m[h]);
    l_row[h] = tf32::quad_sum(l[h] * expf(__fsub_rn(m[h], m_row[h])));
    r_row[h] = __frcp_rn(l_row[h]);
  }

  // pass 2: p = exp(s - max) / l, then P . V chunk by chunk, each chunk's
  // partial added to o in f32
  float acc[DH / 8][4] = {};
  issue(0, true);
  tc::cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int st = tf32::ring_step(c, n_chunks, [&](int next) { issue(next, true); });
    float x[8][4];
    tf32_scores(x, q_warp, sm, st, scale);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[n][e] = tc::div_by(expf(__fsub_rn(x[n][e], m_row[e / 2])), l_row[e / 2], r_row[e / 2]);
    float part[DH / 8][4] = {};
    tf32::accumulate_pairs<8, DH>(part, x, sm.tile(st, 1));
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
    __syncthreads();
  }
  tf32::store_rows<DH>(o + b * vw.o.b + head * vw.o.h, vw.o.r, q0 + 16 * warp, s, acc);
}

// ---- _attention_kv_blocked_fwd_kernel (f32, split-TF32 tensor-core products) ----
template <int DH>
__global__ void __launch_bounds__(tf32::kThreads)
    kv_blocked_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           const float* __restrict__ bias, float* __restrict__ o, float* __restrict__ lse,
                           LongViews vw, int s, float scale) {
  extern __shared__ __align__(16) float tf32_smem[];
  const tf32::Layout<DH> sm{tf32_smem};
  const int q0 = blockIdx.x * tf32::kTileRows, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* k_head = k + b * vw.k.b + head * vw.k.h;
  const float* v_head = v + b * vw.v.b + head * vw.v.h;
  const float* bias_row = bias + static_cast<long long>(b) * s;
  const float* q_warp = sm.fixed(0) + 16 * warp * tf32::kLd<DH>;
  const int n_chunks = (s + tf32::kTileRows - 1) / tf32::kTileRows;
  // key chunk c, K and V, and its bias (-inf past S) into stage c % 2
  auto issue = [&](int c) {
    const int c0 = c * tf32::kTileRows, st = c % 2;
    tf32::copy_rows_async<DH>(sm.tile(st, 0), k_head, vw.k.r, c0, tf32::kTileRows, s, tf32::kThreads);
    tf32::copy_rows_async<DH>(sm.tile(st, 1), v_head, vw.v.r, c0, tf32::kTileRows, s, tf32::kThreads);
    if (threadIdx.x < tf32::kTileRows) sm.extra(st)[threadIdx.x] = key_bias(bias_row, c0 + threadIdx.x, s);
  };

  // the block's 64 query rows, copied with the first key chunk
  tf32::copy_rows_async<DH>(sm.fixed(0), q + b * vw.q.b + head * vw.q.h, vw.q.r,
                            q0, tf32::kTileRows, s, tf32::kThreads);

  // per row of this lane (g and g + 8): the running max, from f32.min as
  // the reference starts it and the same in the row's four lanes; this
  // lane's share of the denominator (its keys' e); the accumulator o
  // before the division, rescaled with them
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4] = {};
  issue(0);
  tc::cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int st = tf32::ring_step(c, n_chunks, issue);
    float x[8][4];
    tf32_scores<DH, true>(x, q_warp, sm, st, scale);
    // m_next = max(m, the chunk's row max), corr = exp(m - m_next), e =
    // exp(s - m_next) in place of the scores, l = l corr + sum(e)
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cm = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) cm = fmaxf(cm, fmaxf(x[n][2 * h], x[n][2 * h + 1]));
      const float m_next = fmaxf(m[h], tf32::quad_max(cm));
      corr[h] = expf(__fsub_rn(m[h], m_next));
      float add = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          x[n][2 * h + j] = expf(__fsub_rn(x[n][2 * h + j], m_next));
          add += x[n][2 * h + j];
        }
      l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), add);
      m[h] = m_next;
    }
    // acc = acc corr + e . V, the chunk's e . V a partial of its own
    float part[DH / 8][4] = {};
    tf32::accumulate_pairs<8, DH>(part, x, sm.tile(st, 1));
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], corr[e / 2]), part[j][e]);
    __syncthreads();
  }
  // o = acc / l and lse = m + log(l), f32 [B, h, S], l merged over the
  // row's four lanes
  float l_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_row[h] = tf32::quad_sum(l[h]);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fdiv_rn(acc[j][e], l_row[e / 2]);
  tf32::store_rows<DH>(o + b * vw.o.b + head * vw.o.h, vw.o.r, q0 + 16 * warp, s, acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (lane % 4 == 0 && row < s)
      lse[(static_cast<long long>(b) * gridDim.y + head) * s + row] = m[h] + logf(l_row[h]);
  }
}

LongViews read_views(const void* strides) {
  const long long* st = static_cast<const long long*>(strides);
  LongViews vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.o};
  for (int i = 0; i < 4; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return vw;
}

// Opts kernel in to tf32::Layout's dynamic shared memory and launches it
// on a grid of 64-query tiles; returns cudaGetLastError() (0 on success).
template <int DH, typename Kernel, typename... Args>
int launch_tf32(Kernel kernel, int batch, int heads, int seq, void* stream, Args... args) {
  constexpr size_t kSmem = tf32::Layout<DH>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((seq + tf32::kTileRows - 1) / tf32::kTileRows, heads, batch), tf32::kThreads, kSmem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_q_blocked(const void* q, const void* k, const void* v, const void* bias, void* o, const void* strides,
                     int batch, int heads, int seq, float scale, void* stream) {
  return launch_tf32<DH>(q_blocked_tf32_kernel<DH>, batch, heads, seq, stream, static_cast<const float*>(q),
                         static_cast<const float*>(k), static_cast<const float*>(v), static_cast<const float*>(bias),
                         static_cast<float*>(o), read_views(strides), seq, scale);
}

template <int DH>
int launch_kv_blocked(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
                      const void* strides, int batch, int heads, int seq, float scale, void* stream) {
  return launch_tf32<DH>(kv_blocked_tf32_kernel<DH>, batch, heads, seq, stream, static_cast<const float*>(q),
                         static_cast<const float*>(k), static_cast<const float*>(v), static_cast<const float*>(bias),
                         static_cast<float*>(o), static_cast<float*>(lse), read_views(strides), seq, scale);
}

}  // namespace
}  // namespace attn
}  // namespace dial

// C entry points. q, k, v, o: device pointers to f32 [B, h, S, head_dim]
// views whose (batch, head, row) element strides are `strides[0..11]` (a
// host array: q, k, v, o in turn), q, k and v 16-byte aligned with
// strides that are multiples of 4 elements (cp.async copies); bias: f32
// [B, S]; lse: f32 [B, h, S]. Any S >= 1; head_dim 32 or 64 (else
// cudaErrorInvalidValue). Launch on `stream` and return cudaGetLastError()
// (0 on success).
extern "C" int dial_attention_q_blocked_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                                            const void* strides, int batch, int heads, int seq, int head_dim,
                                            float scale, void* stream) {
  using namespace dial::attn;
  if (head_dim == 32) return launch_q_blocked<32>(q, k, v, bias, o, strides, batch, heads, seq, scale, stream);
  if (head_dim == 64) return launch_q_blocked<64>(q, k, v, bias, o, strides, batch, heads, seq, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The KV-blocked forward (TPU kernel 7); writes lse too.
extern "C" int dial_attention_kv_blocked_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                                             void* lse, const void* strides, int batch, int heads, int seq,
                                             int head_dim, float scale, void* stream) {
  using namespace dial::attn;
  if (head_dim == 32) return launch_kv_blocked<32>(q, k, v, bias, o, lse, strides, batch, heads, seq, scale, stream);
  if (head_dim == 64) return launch_kv_blocked<64>(q, k, v, bias, o, lse, strides, batch, heads, seq, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
