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
// The KV-blocked forward (kv_blocked_kernel) runs on the CUDA cores in
// full f32: one block per (32-query tile, head, batch row), 256 threads,
// thread t owning query row t / 8 (in registers) and every 8th key of a
// 64-key chunk that K and V stream through in shared memory (42 KB at
// head_dim 64, static); m, l and the accumulator live in registers and
// are rescaled at every 64-key chunk. The TPU kernel rescales at every 512
// keys, so the two round differently by about one ulp per rescale. At
// [1, 12, 8192, 32] its 103 GFLOP take 1.5 ms at 67 TFLOP/s.
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

template <int DH>
struct BlockSmem {
  float k[kChunk * (DH + 1)];  // K chunk; the q tile at first
  float v[kChunk * (DH + 1)];  // V chunk
  float p[kRows * kPLd];       // P (or e) of the chunk, cast through T
  float bias[kChunk];
};
static_assert(sizeof(BlockSmem<64>) <= kStaticSmemLimit && kStaticSmemLimit <= kSmemLimit,
              "the forward block's shared memory must fit statically");

// Loads key chunk c0 (K, V, the bias) and leaves this thread's
// kKeysPerThread scores (keys j + 8 i of the chunk) in `sc`; keys past S
// score -inf.
template <int DH, typename T>
__device__ __forceinline__ void chunk_scores(BlockSmem<DH>& sm, float* sc, const float* q_row, const T* k_head,
                                             const T* v_head, const float* bias_row, const LongViews& vw, int c0,
                                             int s, float scale) {
  load_tile_rows<kChunk, DH>(sm.k, k_head, vw.k.r, c0, s);
  load_tile_rows<kChunk, DH>(sm.v, v_head, vw.v.r, c0, s);
  if (threadIdx.x < kChunk) sm.bias[threadIdx.x] = key_bias(bias_row, c0 + threadIdx.x, s);
  __syncthreads();
  const int j = threadIdx.x % kPhases;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int c = j + kPhases * i;
    sc[i] = scaled_score(dot_dh<DH>(q_row, sm.k + c * (DH + 1)), scale, sm.bias[c]);
  }
}

// acc[t] += sum over the chunk's keys c of P[r, c] v[c, j + 8t]
template <int DH>
__device__ __forceinline__ void accumulate_pv(const BlockSmem<DH>& sm, float* acc) {
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  for (int c = 0; c < kChunk; ++c) {
    const float p = sm.p[r * kPLd + c];
#pragma unroll
    for (int t = 0; t < DH / kPhases; ++t) acc[t] = fmaf(p, sm.v[c * (DH + 1) + j + kPhases * t], acc[t]);
  }
}

// A block's (query tile, head, batch row) bases; this thread's q row goes
// to registers.
template <typename T>
struct BlockSetup {
  const T* k_head;
  const T* v_head;
  T* o_head;
  const float* bias_row;
  int q0;
};

template <int DH, typename T>
__device__ __forceinline__ BlockSetup<T> setup(BlockSmem<DH>& sm, float* q_row, const T* q, const T* k, const T* v,
                                               const float* bias, T* o, const LongViews& vw, int s) {
  BlockSetup<T> bs;
  bs.q0 = blockIdx.x * kRows;
  const int head = blockIdx.y, b = blockIdx.z;
  bs.k_head = k + b * vw.k.b + head * vw.k.h;
  bs.v_head = v + b * vw.v.b + head * vw.v.h;
  bs.o_head = o + b * vw.o.b + head * vw.o.h;
  bs.bias_row = bias + static_cast<long long>(b) * s;
  row_to_registers<DH>(sm.k, q_row, q + b * vw.q.b + head * vw.q.h, vw.q.r, bs.q0, s);
  return bs;
}

// ---- _attention_q_blocked_kernel (f32, split-TF32 tensor-core products) ----
// The warp's 16 query rows against a 64-key chunk in stage `st`: x[n][e]
// is row g + 8 (e / 2) and key 8 n + 2c + e % 2, as q . k * scale + bias
// rounded as the reference rounds it.
template <int DH>
__device__ __forceinline__ void tf32_scores(float (&x)[8][4], const float* q_warp, const tf32::Layout<DH>& sm,
                                            int st, float scale) {
  tf32::product_rows<8, DH>(x, q_warp, sm.tile(st, 0));
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

// ---- _attention_kv_blocked_fwd_kernel --------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    kv_blocked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse, LongViews vw,
                      int s, float scale) {
  __shared__ BlockSmem<DH> sm;
  float q_row[DH];
  const BlockSetup<T> bs = setup<DH>(sm, q_row, q, k, v, bias, o, vw, s);
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  float sc[kKeysPerThread];

  // the row's running max (from f32.min, as the TPU kernel starts it),
  // denominator and accumulator, the same in the row's 8 threads
  float m = -FLT_MAX, l = 0.f;
  float acc[DH / kPhases] = {};
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    chunk_scores(sm, sc, q_row, bs.k_head, bs.v_head, bs.bias_row, vw, c0, s, scale);
    float cm = sc[0];
#pragma unroll
    for (int i = 1; i < kKeysPerThread; ++i) cm = fmaxf(cm, sc[i]);
    const float m_next = fmaxf(m, row_max(cm));
    const float corr = expf(__fsub_rn(m, m_next));
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float e = expf(__fsub_rn(sc[i], m_next));
      part += e;
      sm.p[r * kPLd + j + kPhases * i] = through<T>(e);
    }
    l = __fadd_rn(__fmul_rn(l, corr), row_sum(part));
    m = m_next;
    __syncthreads();
    float pv[DH / kPhases] = {};
    accumulate_pv(sm, pv);
#pragma unroll
    for (int t = 0; t < DH / kPhases; ++t) acc[t] = __fadd_rn(__fmul_rn(acc[t], corr), pv[t]);
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < DH / kPhases; ++t) acc[t] = __fdiv_rn(acc[t], l);
  store_row<DH>(bs.o_head, vw.o.r, bs.q0, s, acc);
  if (j == 0 && bs.q0 + r < s)
    lse[(static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * s + bs.q0 + r] = m + logf(l);
}

LongViews read_views(const void* strides) {
  const long long* st = static_cast<const long long*>(strides);
  LongViews vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.o};
  for (int i = 0; i < 4; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return vw;
}

dim3 grid_of(int batch, int heads, int seq) { return dim3((seq + kRows - 1) / kRows, heads, batch); }

template <int DH>
int launch_q_blocked_tf32(const void* q, const void* k, const void* v, const void* bias, void* o, const void* strides,
                          int batch, int heads, int seq, float scale, void* stream) {
  constexpr size_t kSmem = tf32::Layout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(q_blocked_tf32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  q_blocked_tf32_kernel<DH>
      <<<dim3((seq + tf32::kTileRows - 1) / tf32::kTileRows, heads, batch), tf32::kThreads, kSmem,
         static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                              static_cast<const float*>(v), static_cast<const float*>(bias),
                                              static_cast<float*>(o), read_views(strides), seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_kv_blocked(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
                      const void* strides, int batch, int heads, int seq, float scale, void* stream) {
  kv_blocked_kernel<T, DH><<<grid_of(batch, heads, seq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), read_views(strides), seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int kv_blocked(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
               const void* strides, int batch, int heads, int seq, int head_dim, float scale, void* stream) {
  if (head_dim == 32) return launch_kv_blocked<T, 32>(q, k, v, bias, o, lse, strides, batch, heads, seq, scale, stream);
  if (head_dim == 64) return launch_kv_blocked<T, 64>(q, k, v, bias, o, lse, strides, batch, heads, seq, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace attn
}  // namespace dial

// C entry points. q, k, v, o: device pointers to f32 [B, h, S, head_dim]
// views whose (batch, head, row) element strides are `strides[0..11]` (a
// host array: q, k, v, o in turn); bias: f32 [B, S]; lse: f32 [B, h, S]. Any S >= 1; head_dim 32 or 64 (else
// cudaErrorInvalidValue). Launch on `stream` and return cudaGetLastError()
// (0 on success).
extern "C" int dial_attention_q_blocked_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                                            const void* strides, int batch, int heads, int seq, int head_dim,
                                            float scale, void* stream) {
  using namespace dial::attn;
  if (head_dim == 32) return launch_q_blocked_tf32<32>(q, k, v, bias, o, strides, batch, heads, seq, scale, stream);
  if (head_dim == 64) return launch_q_blocked_tf32<64>(q, k, v, bias, o, strides, batch, heads, seq, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dial_attention_kv_blocked_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                                             void* lse, const void* strides, int batch, int heads, int seq,
                                             int head_dim, float scale, void* stream) {
  return dial::attn::kv_blocked<float>(q, k, v, bias, o, lse, strides, batch, heads, seq, head_dim, scale, stream);
}
