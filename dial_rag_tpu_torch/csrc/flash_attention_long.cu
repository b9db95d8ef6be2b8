// Long-sequence attention forwards on the CUDA cores, head_dim 32 and 64,
// for Hopper (sm_90a).
//
// Replaces two TPU kernels of dial_rag_tpu/ops/flash_attention.py (the
// pallas_calls in _forward for S > 512 with S % 256 == 0):
//   _attention_q_blocked_kernel (S <= 4096 or S % 512 != 0), in f32: per
//     256-query block, the exact per-row softmax over every key, then
//     P . V (in bf16 the tensor-core kernel of attention_tc.cu takes it);
//   _attention_kv_blocked_fwd_kernel (the rest), in f32 (in bf16 the
//     tensor-core kernel of attention_tc.cu takes it): the online softmax
//     over 512-key blocks (running max m from f32.min,
//     corr = exp(m_prev - m_next), e = exp(s - m_next) cast to the input
//     dtype before P . V, o = acc / l at the end), which also writes
//     lse = m + log(l), f32 [B, h, S], for the blocked backward.
// The query-blocked code also serves the single-tile kernels
// (_qkv_native_kernel, _attention_kernel) in f32 past their shared-memory
// limit: it computes the same function at any S, a ragged last key chunk
// and query tile masked inside the kernel (attention_long.cuh).
// Both take head-major [B, h, S, Dh] views with (batch, head, row) element
// strides, as flash_attention_fwd.cu does, so q, k and v are read straight
// out of the packed [B, S, 3H] projection and o can be written in the
// [B, S, H] layout the next product reads. bias = (1 - mask) * f32.min,
// never -inf: a fully masked row gets uniform weights and stays finite.
//
// Bound on an H100 SXM: 4 * B * h * S^2 * Dh FLOPs; at [1, 12, 8192, 32]
// that is 103 GFLOP, 1.5 ms at 67 TFLOP/s in f32, against 26 MB of q, k,
// v and o: bound by operations; twice that at head_dim 64.
//
// Design. The TPU kernels keep K and V whole in VMEM (the query-blocked
// one) or walk 512-key blocks with the running statistics in VMEM
// scratch. At S = 4096 f32 K and V alone take 1 MB (2 MB at head_dim 64);
// an H100 block has 227 KB. So one block per (32-query tile, head, batch
// row), 256 threads, thread t owning query row t / 8 (in registers: 32 or
// 64 floats) and every 8th key of a 64-key chunk that K and V stream
// through in shared memory (42 KB at head_dim 64, static):
//   q-blocked: pass 1 over the key chunks finds each row's max and
//     softmax denominator (a running pair per thread, merged across the
//     row's 8 threads); pass 2 rebuilds the scores, divides, and
//     accumulates P . V. The softmax stays exact per row, normalised
//     before P . V; only the denominator is summed in another order.
//   kv-blocked: one pass; m, l and the accumulator live in registers and
//     are rescaled at every 64-key chunk. The TPU kernel rescales at every
//     512 keys, so the two round differently by about one ulp per rescale.
// Products run on the CUDA cores in full f32: the reference's HIGHEST
// precision, with no TF32. The kernels are templates on the element type
// (the loads, the cast of P or e and the store), instantiated for f32.
#include <cfloat>
#include <cstdint>

#include "attention_long.cuh"

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

// Loads key chunk c0 (K, V when `with_v`, the bias) and leaves this
// thread's kKeysPerThread scores (keys j + 8 i of the chunk) in `sc`;
// keys past S score -inf.
template <int DH, typename T>
__device__ __forceinline__ void chunk_scores(BlockSmem<DH>& sm, float* sc, const float* q_row, const T* k_head,
                                             const T* v_head, const float* bias_row, const LongViews& vw, int c0,
                                             int s, bool with_v, float scale) {
  load_tile_rows<kChunk, DH>(sm.k, k_head, vw.k.r, c0, s);
  if (with_v) load_tile_rows<kChunk, DH>(sm.v, v_head, vw.v.r, c0, s);
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

// ---- _attention_q_blocked_kernel -------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    q_blocked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ o, LongViews vw, int s, float scale) {
  __shared__ BlockSmem<DH> sm;
  float q_row[DH];
  const BlockSetup<T> bs = setup<DH>(sm, q_row, q, k, v, bias, o, vw, s);
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  float sc[kKeysPerThread];

  // pass 1: this thread's running max and denominator over its keys; the
  // max starts at f32.min, not -inf, so a thread none of whose keys is
  // real yet rescales by exp(0) instead of exp(-inf - -inf)
  float m = -FLT_MAX, l = 0.f;
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    chunk_scores(sm, sc, q_row, bs.k_head, bs.v_head, bs.bias_row, vw, c0, s, false, scale);
    float cm = sc[0];
#pragma unroll
    for (int i = 1; i < kKeysPerThread; ++i) cm = fmaxf(cm, sc[i]);
    const float m_new = fmaxf(m, cm);
    float add = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) add += expf(__fsub_rn(sc[i], m_new));
    l = l * expf(m - m_new) + add;
    m = m_new;
    __syncthreads();
  }
  // merged over the row's 8 threads: the row max and sum(exp(s - max))
  const float m_row = row_max(m);
  const float l_row = row_sum(l * expf(m - m_row));

  // pass 2: P = exp(s - max) / l, cast through T, then P . V
  float acc[DH / kPhases] = {};
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    chunk_scores(sm, sc, q_row, bs.k_head, bs.v_head, bs.bias_row, vw, c0, s, true, scale);
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i)
      sm.p[r * kPLd + j + kPhases * i] = through<T>(prob(sc[i], m_row, l_row));
    __syncthreads();
    accumulate_pv(sm, acc);
    __syncthreads();
  }
  store_row<DH>(bs.o_head, vw.o.r, bs.q0, s, acc);
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
    chunk_scores(sm, sc, q_row, bs.k_head, bs.v_head, bs.bias_row, vw, c0, s, true, scale);
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
int launch_q_blocked(const void* q, const void* k, const void* v, const void* bias, void* o, const void* strides,
                     int batch, int heads, int seq, float scale, void* stream) {
  q_blocked_kernel<float, DH><<<grid_of(batch, heads, seq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(o), read_views(strides), seq, scale);
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
  if (head_dim == 32) return launch_q_blocked<32>(q, k, v, bias, o, strides, batch, heads, seq, scale, stream);
  if (head_dim == 64) return launch_q_blocked<64>(q, k, v, bias, o, strides, batch, heads, seq, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dial_attention_kv_blocked_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                                             void* lse, const void* strides, int batch, int heads, int seq,
                                             int head_dim, float scale, void* stream) {
  return dial::attn::kv_blocked<float>(q, k, v, bias, o, lse, strides, batch, heads, seq, head_dim, scale, stream);
}
