// Long-sequence attention backwards, f32 and bf16, head_dim 32 and 64, for
// Hopper (sm_90a).
//
// Replaces three TPU kernels of dial_rag_tpu/ops/flash_attention.py, the
// backward of a blocked S (> 512, S % 256 == 0) as _bwd_rule dispatches it:
//   _attention_bwd_q_blocked_kernel (pallas_call in _backward; the forward
//     left no log-sum-exp): per 256-query block, P exact over every key,
//     dV += cast(P)^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)),
//     dQ = cast(scale dS) K, dK += cast(scale dS)^T Q; dK and dV summed in
//     f32 over the query blocks and cast at the end;
//   _bwd_dq_kv_blocked_kernel and _bwd_dkv_kv_blocked_kernel
//     (_backward_kv_blocked, after the KV-blocked forward): P = exp(s - lse)
//     from the forward's log-sum-exp, delta = rowsum(dO O) from its o,
//     dS = cast(P (dP - delta) scale); the dQ pass walks the keys, the
//     dK/dV pass the queries.
// The query-blocked code also serves the single-tile backward
// (_attention_bwd_kernel, the same gradient with the same casts) past its
// shared-memory limit: it runs at any S, a ragged last key chunk and query
// tile masked inside the kernel (attention_long.cuh).
// Operands are head-major [B, h, S, Dh] views with (batch, head, row)
// element strides, as in flash_attention_long.cu, so they may be read out
// of (and the gradients written into) a packed [B, S, 3H] layout. bias =
// (1 - mask) * f32.min, never -inf: a fully masked row stays finite (its
// P is uniform in the query-blocked backward and exp(0) = 1 per key in the
// KV-blocked one, as in the reference).
//
// Bound on an H100 SXM (flash attention's count, each [S, S] product once):
// 10 B h S^2 32 FLOPs for the query-blocked backward (QK^T, dP, dV, dQ,
// dK), 6 for the dQ pass (QK^T, dP, dQ), 8 for the dK/dV pass (QK^T, dP,
// dV, dK). At [4, 12, 4096, 32] and [4, 12, 8192, 32] that is 257.7, 618.5
// and 824.6 GFLOP: 3.85, 9.23 and 12.31 ms at 67 TFLOP/s in f32 (0.26,
// 0.63, 0.83 ms at 989 TFLOP/s in bf16), against 0.05-0.1 ms for their
// 176-201 MB of operands: bound by operations; twice that at head_dim 64.
//
// Design. The TPU kernels carry dK/dV (or dQ) in VMEM from one grid step to
// the next and hold [256, S] score tiles (4 MB at S = 4096 in f32); an H100
// block has 227 KB and blocks run in no set order. So every backward is two
// launches with no atomics (a training run is reproducible bit for bit),
// each a loop inside the block over 64-key chunks or 32-query tiles that
// stream through shared memory; no S limit:
//   dQ pass, one block per (32-query tile, head, batch row), thread t
//     owning query row t / 8 (its q and dO rows in registers, 2 x head_dim
//     floats) and keys t % 8 + 8 i of each chunk. Query-blocked: a first
//     sweep keeps a running max, denominator and sum of e dP per thread,
//     rescaled as the max grows and merged over the row's 8 threads, which
//     gives the row's max, denominator and delta = sum(dP P) (saved for
//     the dK/dV pass).
//     KV-blocked: delta = dO . O from the forward's o row, P from lse, no
//     first sweep. Then one sweep forms cast(scale dS) for a chunk in
//     shared memory and accumulates dQ.
//   dK/dV pass, one block per (32-key tile, head, batch row), thread t
//     owning key t / 8 (its k and v rows in registers, 2 x head_dim floats
//     beside its dK and dV sums: the pass that holds the most registers at
//     head_dim 64): a loop over every 32-query tile rebuilds P with the dQ
//     pass's expression (the same bits, for the query-blocked backward)
//     and dS, and accumulates dV += cast(P)^T dO and dK += cast(scale
//     dS)^T Q in f32 registers.
// The long sums over S (dQ over the keys, dK and dV over the queries) add
// one partial per chunk or tile to the total with a compensation term: in
// the KV-blocked backward a fully masked row's P is 1, so its gradients
// are sums of S = 8192 terms of size 1, where a plain running sum would
// drift by ~1e-4.
// Products run on the CUDA cores in f32 for both dtypes (a bf16 x bf16
// product is exact in f32): the f32 path keeps the reference's HIGHEST
// precision with no TF32; the bf16 path casts P and scale dS where the
// reference casts them and accumulates in f32.
#include <cfloat>
#include <cstdint>
#include <initializer_list>

#include "attention_long.cuh"

namespace dial {
namespace attn {
namespace {

struct BwdViews {
  View q, k, v, o, d_o, dq, dk, dv;
};

// row stride of the [32 keys, 32 queries] P and dS tiles of the dK/dV
// pass: the 4 keys and 8 query phases a warp writes land on 32 banks
constexpr int kTLd = kRows + 8;

// sum += x with a compensation term (Kahan), rounded as written
__device__ __forceinline__ void add_compensated(float& sum, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// ---- dQ passes -----------------------------------------------------------
template <int DH>
struct DqSmem {
  float k[kChunk * (DH + 1)];  // K chunk; a staging tile at first
  float v[kChunk * (DH + 1)];  // V chunk
  float ds[kRows * kPLd];      // cast(scale dS) of the chunk
  float bias[kChunk];
};
static_assert(sizeof(DqSmem<64>) <= kStaticSmemLimit && kStaticSmemLimit <= kSmemLimit,
              "the dQ pass's shared memory must fit statically");

template <int DH, typename T>
__device__ __forceinline__ void load_chunk(DqSmem<DH>& sm, const T* k_head, const T* v_head, const float* bias_row,
                                           const BwdViews& vw, int c0, int s) {
  load_tile_rows<kChunk, DH>(sm.k, k_head, vw.k.r, c0, s);
  load_tile_rows<kChunk, DH>(sm.v, v_head, vw.v.r, c0, s);
  if (threadIdx.x < kChunk) sm.bias[threadIdx.x] = key_bias(bias_row, c0 + threadIdx.x, s);
  __syncthreads();
}

// dq[t] (head column j + 8 t of this thread's row) = sum over keys c of
// cast(scale P (dP - delta))[r, c] k[c, j + 8 t], P = exp(s - a) (a = lse)
// when LSE, else exp(s - a) / b (a, b = the row's max and denominator).
// A key past S scores -inf: its P, and so its dS, is 0.
template <typename T, int DH, bool LSE>
__device__ __forceinline__ void dq_sweep(DqSmem<DH>& sm, float* dq, const float* q_row, const float* do_row, float a,
                                         float b, float delta, const T* k_head, const T* v_head,
                                         const float* bias_row, const BwdViews& vw, int s, float scale) {
  constexpr int kPerThread = DH / kPhases;
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  float comp[kPerThread] = {};
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) dq[t] = 0.f;
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    load_chunk(sm, k_head, v_head, bias_row, vw, c0, s);
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int c = j + kPhases * i;
      const float sc = scaled_score(dot_dh<DH>(q_row, sm.k + c * (DH + 1)), scale, sm.bias[c]);
      const float p = LSE ? expf(__fsub_rn(sc, a)) : prob(sc, a, b);
      const float dp = dot_dh<DH>(do_row, sm.v + c * (DH + 1));
      sm.ds[r * kPLd + c] = through<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale));
    }
    __syncthreads();
    float part[kPerThread] = {};
    for (int c = 0; c < kChunk; ++c) {
      const float ds = sm.ds[r * kPLd + c];
#pragma unroll
      for (int t = 0; t < kPerThread; ++t) part[t] = fmaf(ds, sm.k[c * (DH + 1) + j + kPhases * t], part[t]);
    }
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) add_compensated(dq[t], comp[t], part[t]);
    __syncthreads();
  }
}

// _attention_bwd_q_blocked_kernel, pass 1: dQ, and each row's max and
// denominator (stats [B, h, S, 2]) and delta ([B, h, S]).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    q_blocked_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ d_o, const float* __restrict__ bias, T* __restrict__ dq,
                        float* __restrict__ stats, float* __restrict__ delta_out, BwdViews vw, int s, float scale) {
  __shared__ DqSmem<DH> sm;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  const T* k_head = k + b * vw.k.b + head * vw.k.h;
  const T* v_head = v + b * vw.v.b + head * vw.v.h;
  const float* bias_row = bias + static_cast<long long>(b) * s;
  float q_row[DH], do_row[DH];
  row_to_registers<DH>(sm.k, q_row, q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, s);
  row_to_registers<DH>(sm.k, do_row, d_o + b * vw.d_o.b + head * vw.d_o.h, vw.d_o.r, q0, s);

  // sweep 1: per thread, over its keys, the running max m, sum(exp(s - m))
  // and sum(exp(s - m) dP), rescaled whenever m grows; m starts at
  // f32.min, not -inf, so a thread none of whose keys is real yet
  // rescales by exp(0) instead of exp(-inf - -inf)
  float m = -FLT_MAX, l = 0.f, ed = 0.f;
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    load_chunk(sm, k_head, v_head, bias_row, vw, c0, s);
    float sc[kKeysPerThread], dp[kKeysPerThread];
    float cm = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int c = j + kPhases * i;
      sc[i] = scaled_score(dot_dh<DH>(q_row, sm.k + c * (DH + 1)), scale, sm.bias[c]);
      dp[i] = dot_dh<DH>(do_row, sm.v + c * (DH + 1));
      cm = fmaxf(cm, sc[i]);
    }
    const float m_new = fmaxf(m, cm);
    const float corr = expf(m - m_new);
    float add_l = 0.f, add_ed = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float e = expf(__fsub_rn(sc[i], m_new));
      add_l += e;
      add_ed = fmaf(e, dp[i], add_ed);
    }
    l = l * corr + add_l;
    ed = ed * corr + add_ed;
    m = m_new;
    __syncthreads();
  }
  // merged over the row's 8 threads: the row max, the denominator and
  // delta = sum(dP exp(s - max)) / denominator = sum(dP P)
  const float m_row = row_max(m);
  const float f = expf(m - m_row);
  const float l_row = row_sum(l * f);
  const float delta = __fdiv_rn(row_sum(ed * f), l_row);

  float acc[DH / kPhases];
  dq_sweep<T, DH, false>(sm, acc, q_row, do_row, m_row, l_row, delta, k_head, v_head, bias_row, vw, s, scale);
  store_row<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, q0, s, acc);
  if (j == 0 && q0 + r < s) {
    const long long row = (static_cast<long long>(b) * gridDim.y + head) * s + q0 + r;
    stats[2 * row] = m_row;
    stats[2 * row + 1] = l_row;
    delta_out[row] = delta;
  }
}

// _bwd_dq_kv_blocked_kernel: dQ from the forward's lse; writes delta =
// rowsum(dO O) ([B, h, S]) for the dK/dV pass.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    kv_blocked_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ o, const T* __restrict__ d_o, const float* __restrict__ bias,
                         const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta_out,
                         BwdViews vw, int s, float scale) {
  __shared__ DqSmem<DH> sm;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  const long long row = (static_cast<long long>(b) * gridDim.y + head) * s + q0 + r;
  float q_row[DH], do_row[DH];
  row_to_registers<DH>(sm.k, do_row, d_o + b * vw.d_o.b + head * vw.d_o.h, vw.d_o.r, q0, s);
  // delta = dO . O, the o row read from shared memory (no third register row)
  load_tile_rows<kRows, DH>(sm.k, o + b * vw.o.b + head * vw.o.h, vw.o.r, q0, s);
  __syncthreads();
  const float delta = dot_dh<DH>(do_row, sm.k + r * (DH + 1));
  __syncthreads();
  row_to_registers<DH>(sm.k, q_row, q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, s);
  float acc[DH / kPhases];
  dq_sweep<T, DH, true>(sm, acc, q_row, do_row, q0 + r < s ? lse[row] : 0.f, 0.f, delta,
                        k + b * vw.k.b + head * vw.k.h, v + b * vw.v.b + head * vw.v.h,
                        bias + static_cast<long long>(b) * s, vw, s, scale);
  store_row<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, q0, s, acc);
  if (j == 0 && q0 + r < s) delta_out[row] = delta;
}

// ---- dK/dV passes ----------------------------------------------------------
template <int DH>
struct DkvSmem {
  float q[kRows * (DH + 1)];    // q rows of the query tile; a staging tile at first
  float d_o[kRows * (DH + 1)];  // dO rows of the query tile
  float p[kRows * kTLd];        // cast(P)[key, query] of the tile pair
  float ds[kRows * kTLd];       // cast(scale dS)[key, query]
  float row[3 * kRows];         // (max, denominator, delta) or (lse, -, delta) per query
  float bias[kRows];
};
static_assert(sizeof(DkvSmem<64>) <= kStaticSmemLimit && kStaticSmemLimit <= kSmemLimit,
              "the dK/dV pass's shared memory must fit statically");

// dK and dV of one 32-key tile; P = exp(s - lse) when LSE (stats [B, h, S]),
// else exp(s - max) / denominator (stats [B, h, S, 2]). Keys past S score
// -inf and queries past S get P = dS = 0, so neither adds to a sum.
template <typename T, int DH, bool LSE>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ d_o, const float* __restrict__ bias, const float* __restrict__ stats,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, BwdViews vw, int s,
               float scale) {
  constexpr int kPadH = DH + 1, kPerThread = DH / kPhases;
  __shared__ DkvSmem<DH> sm;
  const int k0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int c = threadIdx.x / kPhases, j = threadIdx.x % kPhases;  // key c of the tile
  const T* q_head = q + b * vw.q.b + head * vw.q.h;
  const T* do_head = d_o + b * vw.d_o.b + head * vw.d_o.h;
  const long long rows0 = (static_cast<long long>(b) * gridDim.y + head) * s;
  float k_row[DH], v_row[DH];
  row_to_registers<DH>(sm.q, k_row, k + b * vw.k.b + head * vw.k.h, vw.k.r, k0, s);
  row_to_registers<DH>(sm.q, v_row, v + b * vw.v.b + head * vw.v.h, vw.v.r, k0, s);
  if (threadIdx.x < kRows) sm.bias[threadIdx.x] = key_bias(bias + static_cast<long long>(b) * s, k0 + threadIdx.x, s);

  float dk_sum[kPerThread] = {}, dv_sum[kPerThread] = {}, dk_comp[kPerThread] = {}, dv_comp[kPerThread] = {};
  for (int q0 = 0; q0 < s; q0 += kRows) {
    load_tile_rows<kRows, DH>(sm.q, q_head, vw.q.r, q0, s);
    load_tile_rows<kRows, DH>(sm.d_o, do_head, vw.d_o.r, q0, s);
    if (threadIdx.x < kRows && q0 + threadIdx.x < s) {
      const long long row = rows0 + q0 + threadIdx.x;
      sm.row[3 * threadIdx.x] = LSE ? stats[row] : stats[2 * row];
      sm.row[3 * threadIdx.x + 1] = LSE ? 0.f : stats[2 * row + 1];
      sm.row[3 * threadIdx.x + 2] = delta[row];
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kRows / kPhases; ++t) {
      const int qi = j + kPhases * t;
      const float* st = sm.row + 3 * qi;
      float p = 0.f, ds = 0.f;
      if (q0 + qi < s) {
        const float sc = scaled_score(dot_dh<DH>(sm.q + qi * kPadH, k_row), scale, sm.bias[c]);
        p = LSE ? expf(__fsub_rn(sc, st[0])) : prob(sc, st[0], st[1]);
        const float dp = dot_dh<DH>(sm.d_o + qi * kPadH, v_row);
        ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, st[2])), scale);
      }
      sm.p[c * kTLd + qi] = through<T>(p);
      sm.ds[c * kTLd + qi] = through<T>(ds);
    }
    __syncthreads();
    float pk[kPerThread] = {}, pv[kPerThread] = {};
    for (int qi = 0; qi < kRows; ++qi) {
      const float p = sm.p[c * kTLd + qi], ds = sm.ds[c * kTLd + qi];
#pragma unroll
      for (int t = 0; t < kPerThread; ++t) {
        pv[t] = fmaf(p, sm.d_o[qi * kPadH + j + kPhases * t], pv[t]);
        pk[t] = fmaf(ds, sm.q[qi * kPadH + j + kPhases * t], pk[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      add_compensated(dv_sum[t], dv_comp[t], pv[t]);
      add_compensated(dk_sum[t], dk_comp[t], pk[t]);
    }
    __syncthreads();
  }
  store_row<DH>(dk + b * vw.dk.b + head * vw.dk.h, vw.dk.r, k0, s, dk_sum);
  store_row<DH>(dv + b * vw.dv.b + head * vw.dv.h, vw.dv.r, k0, s, dv_sum);
}

// The views named by `order`, in turn, from a host array of (batch, head,
// row) element strides.
BwdViews read_views(const void* strides, std::initializer_list<View BwdViews::*> order) {
  const long long* st = static_cast<const long long*>(strides);
  BwdViews vw{};
  int i = 0;
  for (View BwdViews::*member : order) {
    vw.*member = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
    ++i;
  }
  return vw;
}

dim3 grid_of(int batch, int heads, int seq) { return dim3((seq + kRows - 1) / kRows, heads, batch); }

template <typename T, int DH>
int launch_q_blocked(const void* q, const void* k, const void* v, const void* d_o, const void* bias, void* dq,
                     void* dk, void* dv, void* stats, void* delta, const void* strides, int batch, int heads,
                     int seq, float scale, void* stream) {
  const BwdViews vw = read_views(strides, {&BwdViews::q, &BwdViews::k, &BwdViews::v, &BwdViews::d_o,
                                           &BwdViews::dq, &BwdViews::dk, &BwdViews::dv});
  const dim3 grid = grid_of(batch, heads, seq);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k), *tv = static_cast<const T*>(v),
          *tdo = static_cast<const T*>(d_o);
  const float* fbias = static_cast<const float*>(bias);
  q_blocked_dq_kernel<T, DH><<<grid, kThreads, 0, stm>>>(tq, tk, tv, tdo, fbias, static_cast<T*>(dq),
                                                         static_cast<float*>(stats), static_cast<float*>(delta), vw,
                                                         seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<T, DH, false><<<grid, kThreads, 0, stm>>>(tq, tk, tv, tdo, fbias, static_cast<const float*>(stats),
                                                       static_cast<const float*>(delta), static_cast<T*>(dk),
                                                       static_cast<T*>(dv), vw, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dq_kv_blocked(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                         const void* bias, const void* lse, void* dq, void* delta, const void* strides, int batch,
                         int heads, int seq, float scale, void* stream) {
  const BwdViews vw = read_views(strides, {&BwdViews::q, &BwdViews::k, &BwdViews::v, &BwdViews::o,
                                           &BwdViews::d_o, &BwdViews::dq});
  kv_blocked_dq_kernel<T, DH><<<grid_of(batch, heads, seq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(d_o), static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), vw, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkv_kv_blocked(const void* q, const void* k, const void* v, const void* d_o, const void* bias,
                          const void* lse, const void* delta, void* dk, void* dv, const void* strides, int batch,
                          int heads, int seq, float scale, void* stream) {
  const BwdViews vw = read_views(strides, {&BwdViews::q, &BwdViews::k, &BwdViews::v, &BwdViews::d_o,
                                           &BwdViews::dk, &BwdViews::dv});
  dkv_kernel<T, DH, true><<<grid_of(batch, heads, seq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(d_o),
      static_cast<const float*>(bias), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), vw, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace attn
}  // namespace dial

// The instantiation of launcher F for head_dim 32 or 64, else
// cudaErrorInvalidValue.
#define DIAL_BY_HEAD_DIM(F, T, ...)                                                   \
  (head_dim == 32   ? dial::attn::F<T, 32>(__VA_ARGS__)                               \
   : head_dim == 64 ? dial::attn::F<T, 64>(__VA_ARGS__)                               \
                    : static_cast<int>(cudaErrorInvalidValue))

// C entry points. Tensor arguments are device pointers: q, k, v, o, d_o
// (inputs) and dq, dk, dv (outputs) to [B, h, S, head_dim] views, f32 or
// bf16 as the name says, whose (batch, head, row) element strides are in
// `strides` (a host array, the views in the order of the arguments); bias
// f32 [B, S]; lse, delta f32 [B, h, S]; stats f32 scratch [B, h, S, 2].
// Any S >= 1; head_dim 32 or 64 (else cudaErrorInvalidValue). Each
// launches on `stream` and returns cudaGetLastError() (0 on success).
//
// The query-blocked backward: the dQ pass (writing stats and delta), then
// the dK/dV pass. Strides of q, k, v, d_o, dq, dk, dv.
extern "C" int dial_attention_bwd_q_blocked_f32(const void* q, const void* k, const void* v, const void* d_o,
                                                const void* bias, void* dq, void* dk, void* dv, void* stats,
                                                void* delta, const void* strides, int batch, int heads, int seq,
                                                int head_dim, float scale, void* stream) {
  return DIAL_BY_HEAD_DIM(launch_q_blocked, float, q, k, v, d_o, bias, dq, dk, dv, stats, delta, strides, batch,
                          heads, seq, scale, stream);
}

extern "C" int dial_attention_bwd_q_blocked_bf16(const void* q, const void* k, const void* v, const void* d_o,
                                                 const void* bias, void* dq, void* dk, void* dv, void* stats,
                                                 void* delta, const void* strides, int batch, int heads, int seq,
                                                 int head_dim, float scale, void* stream) {
  return DIAL_BY_HEAD_DIM(launch_q_blocked, dial::bf16, q, k, v, d_o, bias, dq, dk, dv, stats, delta, strides,
                          batch, heads, seq, scale, stream);
}

// The KV-blocked dQ pass: writes dq and delta. Strides of q, k, v, o, d_o, dq.
extern "C" int dial_attention_bwd_dq_kv_blocked_f32(const void* q, const void* k, const void* v, const void* o,
                                                    const void* d_o, const void* bias, const void* lse, void* dq,
                                                    void* delta, const void* strides, int batch, int heads,
                                                    int seq, int head_dim, float scale, void* stream) {
  return DIAL_BY_HEAD_DIM(launch_dq_kv_blocked, float, q, k, v, o, d_o, bias, lse, dq, delta, strides, batch,
                          heads, seq, scale, stream);
}

extern "C" int dial_attention_bwd_dq_kv_blocked_bf16(const void* q, const void* k, const void* v, const void* o,
                                                     const void* d_o, const void* bias, const void* lse, void* dq,
                                                     void* delta, const void* strides, int batch, int heads,
                                                     int seq, int head_dim, float scale, void* stream) {
  return DIAL_BY_HEAD_DIM(launch_dq_kv_blocked, dial::bf16, q, k, v, o, d_o, bias, lse, dq, delta, strides, batch,
                          heads, seq, scale, stream);
}

// The KV-blocked dK/dV pass, after the dQ pass. Strides of q, k, v, d_o, dk, dv.
extern "C" int dial_attention_bwd_dkv_kv_blocked_f32(const void* q, const void* k, const void* v, const void* d_o,
                                                     const void* bias, const void* lse, const void* delta,
                                                     void* dk, void* dv, const void* strides, int batch,
                                                     int heads, int seq, int head_dim, float scale, void* stream) {
  return DIAL_BY_HEAD_DIM(launch_dkv_kv_blocked, float, q, k, v, d_o, bias, lse, delta, dk, dv, strides, batch,
                          heads, seq, scale, stream);
}

extern "C" int dial_attention_bwd_dkv_kv_blocked_bf16(const void* q, const void* k, const void* v,
                                                      const void* d_o, const void* bias, const void* lse,
                                                      const void* delta, void* dk, void* dv, const void* strides,
                                                      int batch, int heads, int seq, int head_dim, float scale,
                                                      void* stream) {
  return DIAL_BY_HEAD_DIM(launch_dkv_kv_blocked, dial::bf16, q, k, v, d_o, bias, lse, delta, dk, dv, strides,
                          batch, heads, seq, scale, stream);
}
