// Long-sequence attention backwards, f32 and bf16, head_dim 32 and 64, for
// Hopper (sm_90a).
//
// Replaces three TPU kernels of dial_rag_tpu/ops/flash_attention.py, the
// backward of a blocked S (> 512, S % 256 == 0) as _bwd_rule dispatches it:
//   _attention_bwd_q_blocked_kernel (flash_attention.py:360, pallas_call in
//     _backward; the forward left no log-sum-exp): per 256-query block, P
//     exact over every key, dV += cast(P)^T dO, dP = dO V^T, dS = P (dP -
//     rowsum(dP P)), dQ = cast(scale dS) K, dK += cast(scale dS)^T Q; dK
//     and dV summed in f32 over the query blocks and cast at the end;
//   _bwd_dq_kv_blocked_kernel and _bwd_dkv_kv_blocked_kernel
//     (flash_attention.py:417, 461; _backward_kv_blocked, after the
//     KV-blocked forward): P = exp(s - lse) from the forward's
//     log-sum-exp, delta = rowsum(dO O) from its o, dS = cast(P (dP -
//     delta) scale); the dQ pass walks the keys, the dK/dV pass the
//     queries.
// The query-blocked code also serves the single-tile backward
// (_attention_bwd_kernel, the same gradient with the same casts) past its
// shared-memory limit: it runs at any S, a ragged last key chunk and query
// tile masked inside the kernel.
// Operands are head-major [B, h, S, Dh] views with (batch, head, row)
// element strides, as in flash_attention_long.cu, so they may be read out
// of (and the gradients written into) a packed [B, S, 3H] layout. bias =
// (1 - mask) * f32.min, never -inf: a fully masked row stays finite (its
// P is uniform in the query-blocked backward and exp(0) = 1 per key in the
// KV-blocked one, as in the reference). Every backward is two launches
// with no atomics, so a training run is reproducible bit for bit.
//
// Bounds on an H100 SXM (flash attention's count, each [S, S] product
// once): 10 B h S^2 Dh FLOPs for the query-blocked backward (QK^T, dP,
// dV, dQ, dK), 6 for the KV-blocked dQ pass (QK^T, dP, dQ), 8 for its
// dK/dV pass (QK^T, dP, dV, dK). At [4, 12, 4096, 32] the query-blocked
// backward's 257.7 GFLOP take 3.85 ms at 67 TFLOP/s in f32 on the CUDA
// cores and 1.56 ms at 165 TFLOP/s of 3xTF32 (495 / 3); 7.69 and 3.12 ms
// at head_dim 64. At [4, 12, 8192, 32] the dQ and dK/dV passes' 618.5 and
// 824.6 GFLOP take 9.23 and 12.31 ms in f32 (0.63, 0.83 ms at 989 TFLOP/s
// in bf16); twice that at head_dim 64. Their 176-201 MB of operands take
// 0.05-0.1 ms: bound by operations.
//
// The query-blocked backward in f32 (q_blocked_dq_tf32_kernel, then
// q_blocked_dkv_tf32_kernel) runs its products on the tensor cores in
// split TF32 (tensor_core_tf32.cuh: each f32 operand split into two TF32
// parts, hi.lo + lo.hi + hi.hi by mma.sync.m16n8k8, about 2^-21 relative a
// product), Hopper's counterpart of the HIGHEST precision the reference
// asks for on f32 (itself several bf16 passes on the TPU's MXU). Blocks
// of 4 warps own 64 rows, 16 a warp; the other side streams through a
// two-stage cp.async ring of 64-row chunks in dynamic shared memory (104
// KB a block at head_dim 64, 56 KB at 32):
//   dQ pass, a block per 64-query tile: a first sweep over the key chunks
//     forms Q K^T and dO V^T and keeps each lane's running max,
//     denominator and sum of e dP (rescaled as the max grows, merged over
//     the row's four lanes), which gives the row's max, denominator and
//     delta = sum(dP P) (saved for the dK/dV pass); a second sweep forms
//     them again, dS = P (dP - delta) scale, and dQ += dS K, each chunk's
//     partial added to the total with a compensation term (add_compensated).
//   dK/dV pass, a block per 64-key tile: a loop over the query chunks
//     forms K Q^T and V dO^T (rows keys), rebuilds P and dS with the dQ
//     pass's expressions from its stats and delta, and accumulates dV +=
//     P^T dO and dK += dS^T Q, each chunk's partial added in f32 with no
//     compensation term (the gates at S = 4352 and on a fully masked row
//     hold without it; with it the sums would not fit the registers at
//     head_dim 64).
// It computes nine [S, S] products (QK^T and dO V^T three times, dS K,
// P^T dO and dS^T Q) against the bound's five: the sweeps keep the
// reference's expressions, delta = rowsum(dP P) and P normalised before
// use. What else still holds it back: the split of every operand at each
// fragment load (three conversions per element, in every warp that reads
// it), mma.sync rather than wgmma (wgmma takes TF32 only K-major), and
// two blocks an SM at head_dim 64.
//
// The bf16 query-blocked backward and both KV-blocked passes (both dtypes)
// run on the CUDA cores, products in f32 (a bf16 x bf16 product is exact
// in f32; the f32 KV-blocked passes keep the reference's HIGHEST precision
// with no TF32): two launches, each a loop inside the block over 64-key
// chunks or 32-query tiles that stream through shared memory, no S limit:
//   dQ pass, one block per (32-query tile, head, batch row), thread t
//     owning query row t / 8 (its q and dO rows in registers, 2 x head_dim
//     floats) and keys t % 8 + 8 i of each chunk. Query-blocked: a first
//     sweep as above, per thread and merged over the row's 8 threads.
//     KV-blocked: delta = dO . O from the forward's o row, P from lse, no
//     first sweep. Then one sweep forms cast(scale dS) for a chunk in
//     shared memory and accumulates dQ.
//   dK/dV pass, one block per (32-key tile, head, batch row), thread t
//     owning key t / 8 (its k and v rows in registers beside its dK and dV
//     sums): a loop over every 32-query tile rebuilds P with the dQ pass's
//     expression (the same bits, for the query-blocked backward) and dS,
//     and accumulates dV += cast(P)^T dO and dK += cast(scale dS)^T Q in
//     f32 registers; the bf16 path casts P and scale dS where the
//     reference casts them.
// The long sums over S (dQ over the keys, dK and dV over the queries) add
// one partial per chunk or tile to the total with a compensation term: in
// the KV-blocked backward a fully masked row's P is 1, so its gradients
// are sums of S = 8192 terms of size 1, where a plain running sum would
// drift by ~1e-4.
#include <cfloat>
#include <cstdint>
#include <initializer_list>

#include "attention_long.cuh"
#include "tensor_core_tf32.cuh"

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

// ---- _attention_bwd_q_blocked_kernel in f32 (split-TF32 tensor-core products) ----
// Both passes are blocks of tf32::kThreads threads owning a 64-row tile
// (queries, then keys), 16 rows a warp, the other side streaming through
// tf32::Layout's two-stage ring in 64-row chunks. A chunk is taken in two
// halves of 32 (kHalf), which keeps two [16, 32] D tiles (scores and dP)
// live beside the gradient sums. In a D tile x[n][e] the warp's row is
// g + 8 (e / 2) and the column (key or query) 8 n + 2c + e % 2 of the half.
constexpr int kHalf = 32;
constexpr int kHalfTiles = kHalf / 8;

// pass 1: dQ, each row's max and denominator (stats [B, h, S, 2]) and
// delta = sum(dP P) ([B, h, S]), for query rows q0 .. q0 + 63
template <int DH>
__global__ void __launch_bounds__(tf32::kThreads)
    q_blocked_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ d_o, const float* __restrict__ bias, float* __restrict__ dq,
                             float* __restrict__ stats, float* __restrict__ delta_out, BwdViews vw, int s,
                             float scale) {
  extern __shared__ __align__(16) float tf32_smem[];
  const tf32::Layout<DH> sm{tf32_smem};  // fixed: q, dO; a stage: K, V, the chunk's bias
  const int q0 = blockIdx.x * tf32::kTileRows, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, c = threadIdx.x % 4;
  const float* k_head = k + b * vw.k.b + head * vw.k.h;
  const float* v_head = v + b * vw.v.b + head * vw.v.h;
  const float* bias_row = bias + static_cast<long long>(b) * s;
  const float* q_warp = sm.fixed(0) + 16 * warp * tf32::kLd<DH>;
  const float* do_warp = sm.fixed(1) + 16 * warp * tf32::kLd<DH>;
  const int n_chunks = (s + tf32::kTileRows - 1) / tf32::kTileRows;
  auto issue = [&](int chunk) {
    const int c0 = chunk * tf32::kTileRows, st = chunk % 2;
    tf32::copy_rows_async<DH>(sm.tile(st, 0), k_head, vw.k.r, c0, tf32::kTileRows, s, tf32::kThreads);
    tf32::copy_rows_async<DH>(sm.tile(st, 1), v_head, vw.v.r, c0, tf32::kTileRows, s, tf32::kThreads);
    if (threadIdx.x < tf32::kTileRows) sm.extra(st)[threadIdx.x] = key_bias(bias_row, c0 + threadIdx.x, s);
  };
  // the scores (q . k * scale + bias) and dP (dO . v) of half `hf` of the chunk in stage st
  auto products = [&](int st, int hf, float (&x)[kHalfTiles][4], float (&dp)[kHalfTiles][4]) {
    tf32::product_rows<kHalfTiles, DH>(x, q_warp, sm.tile(st, 0) + kHalf * hf * tf32::kLd<DH>);
    tf32::product_rows<kHalfTiles, DH>(dp, do_warp, sm.tile(st, 1) + kHalf * hf * tf32::kLd<DH>);
    const float* key_bias_s = sm.extra(st) + kHalf * hf + 2 * c;
#pragma unroll
    for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = scaled_score(x[n][e], scale, key_bias_s[8 * n + e % 2]);
  };

  tf32::copy_rows_async<DH>(sm.fixed(0), q + b * vw.q.b + head * vw.q.h, vw.q.r,
                            q0, tf32::kTileRows, s, tf32::kThreads);
  tf32::copy_rows_async<DH>(sm.fixed(1), d_o + b * vw.d_o.b + head * vw.d_o.h, vw.d_o.r,
                            q0, tf32::kTileRows, s, tf32::kThreads);

  // sweep 1: per lane, over its keys, the running max m, sum(exp(s - m))
  // and sum(exp(s - m) dP) of its two rows, rescaled whenever m grows; m
  // starts at f32.min, not -inf, so a lane none of whose keys is real yet
  // rescales by exp(0) instead of exp(-inf - -inf)
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, ed[2] = {0.f, 0.f};
  issue(0);
  tc::cp_async_commit();
  for (int t = 0; t < n_chunks; ++t) {
    const int st = tf32::ring_step(t, n_chunks, issue);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x[kHalfTiles][4], dp[kHalfTiles][4];
      products(st, hf, x, dp);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cm = -INFINITY;
#pragma unroll
        for (int n = 0; n < kHalfTiles; ++n) cm = fmaxf(cm, fmaxf(x[n][2 * h], x[n][2 * h + 1]));
        const float m_new = fmaxf(m[h], cm);
        const float corr = expf(__fsub_rn(m[h], m_new));
        float add_l = 0.f, add_ed = 0.f;
#pragma unroll
        for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float e = expf(__fsub_rn(x[n][2 * h + j], m_new));
            add_l += e;
            add_ed = fmaf(e, dp[n][2 * h + j], add_ed);
          }
        l[h] = l[h] * corr + add_l;
        ed[h] = ed[h] * corr + add_ed;
        m[h] = m_new;
      }
    }
    __syncthreads();
  }
  // merged over the row's four lanes: the row max, the denominator and
  // delta = sum(dP exp(s - max)) / denominator = sum(dP P)
  float m_row[2], l_row[2], r_row[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_row[h] = tf32::quad_max(m[h]);
    const float f = expf(__fsub_rn(m[h], m_row[h]));
    l_row[h] = tf32::quad_sum(l[h] * f);
    r_row[h] = __frcp_rn(l_row[h]);
    delta[h] = __fdiv_rn(tf32::quad_sum(ed[h] * f), l_row[h]);
  }

  // sweep 2: dS = P (dP - delta) scale, dQ += dS K, each chunk's partial
  // added to the total with a compensation term
  float acc[DH / 8][4] = {}, comp[DH / 8][4] = {};
  issue(0);
  tc::cp_async_commit();
  for (int t = 0; t < n_chunks; ++t) {
    const int st = tf32::ring_step(t, n_chunks, issue);
    float part[DH / 8][4] = {};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x[kHalfTiles][4], dp[kHalfTiles][4];
      products(st, hf, x, dp);
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = tc::div_by(expf(__fsub_rn(x[n][e], m_row[e / 2])), l_row[e / 2], r_row[e / 2]);
          x[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], delta[e / 2])), scale);
        }
      tf32::accumulate_pairs<kHalfTiles, DH>(part, x, sm.tile(st, 0) + kHalf * hf * tf32::kLd<DH>);
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) add_compensated(acc[j][e], comp[j][e], part[j][e]);
    __syncthreads();
  }
  tf32::store_rows<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, q0 + 16 * warp, s, acc);
  if (c == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + 16 * warp + threadIdx.x % 32 / 4 + 8 * h;
      if (r >= s) continue;
      const long long row = (static_cast<long long>(b) * gridDim.y + head) * s + r;
      stats[2 * row] = m_row[h];
      stats[2 * row + 1] = l_row[h];
      delta_out[row] = delta[h];
    }
  }
}

// pass 2: dK and dV of keys k0 .. k0 + 63 over every query chunk, P
// rebuilt with the dQ pass's expression from its stats and delta.
// Queries past S get P = dS = 0; keys past S score -inf. Each chunk's
// partials are added to the sums in f32 without compensation: at S = 4352
// and on a fully masked row the f32 gates hold without it, and the
// compensation terms would not fit the registers at head_dim 64.
template <int DH>
__global__ void __launch_bounds__(tf32::kThreads)
    q_blocked_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                              const float* __restrict__ d_o, const float* __restrict__ bias,
                              const float* __restrict__ stats, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, BwdViews vw, int s, float scale) {
  extern __shared__ __align__(16) float tf32_smem[];
  // fixed: k, v; a stage: Q, dO, (max, denominator, 1 / denominator, delta) per query
  const tf32::Layout<DH> sm{tf32_smem};
  const int k0 = blockIdx.x * tf32::kTileRows, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
  const float* q_head = q + b * vw.q.b + head * vw.q.h;
  const float* do_head = d_o + b * vw.d_o.b + head * vw.d_o.h;
  const long long rows0 = (static_cast<long long>(b) * gridDim.y + head) * s;
  const float* k_warp = sm.fixed(0) + 16 * warp * tf32::kLd<DH>;
  const float* v_warp = sm.fixed(1) + 16 * warp * tf32::kLd<DH>;
  const int n_chunks = (s + tf32::kTileRows - 1) / tf32::kTileRows;
  auto issue = [&](int chunk) {
    const int c0 = chunk * tf32::kTileRows, st = chunk % 2;
    tf32::copy_rows_async<DH>(sm.tile(st, 0), q_head, vw.q.r, c0, tf32::kTileRows, s, tf32::kThreads);
    tf32::copy_rows_async<DH>(sm.tile(st, 1), do_head, vw.d_o.r, c0, tf32::kTileRows, s, tf32::kThreads);
    if (threadIdx.x < tf32::kTileRows && c0 + threadIdx.x < s) {
      const long long row = rows0 + c0 + threadIdx.x;
      float* r = sm.extra(st) + 4 * threadIdx.x;
      r[0] = stats[2 * row];
      r[1] = stats[2 * row + 1];
      r[2] = __frcp_rn(r[1]);
      r[3] = delta[row];
    }
  };
  // the bias of this lane's two keys
  const float* bias_row = bias + static_cast<long long>(b) * s;
  const float kb[2] = {key_bias(bias_row, k0 + 16 * warp + lane / 4, s),
                       key_bias(bias_row, k0 + 16 * warp + lane / 4 + 8, s)};

  tf32::copy_rows_async<DH>(sm.fixed(0), k + b * vw.k.b + head * vw.k.h, vw.k.r,
                            k0, tf32::kTileRows, s, tf32::kThreads);
  tf32::copy_rows_async<DH>(sm.fixed(1), v + b * vw.v.b + head * vw.v.h, vw.v.r,
                            k0, tf32::kTileRows, s, tf32::kThreads);

  float dk_sum[DH / 8][4] = {}, dv_sum[DH / 8][4] = {};
  issue(0);
  tc::cp_async_commit();
  for (int t = 0; t < n_chunks; ++t) {
    const int st = tf32::ring_step(t, n_chunks, issue);
    float dk_part[DH / 8][4] = {}, dv_part[DH / 8][4] = {};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* q_rows = sm.tile(st, 0) + kHalf * hf * tf32::kLd<DH>;
      const float* do_rows = sm.tile(st, 1) + kHalf * hf * tf32::kLd<DH>;
      // scores^T (k . q) and dP^T (v . dO): rows keys, columns queries
      float p[kHalfTiles][4], ds[kHalfTiles][4];
      tf32::product_rows<kHalfTiles, DH>(p, k_warp, q_rows);
      tf32::product_rows<kHalfTiles, DH>(ds, v_warp, do_rows);
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = kHalf * hf + 8 * n + 2 * c + e % 2;
          float pe = 0.f, dse = 0.f;
          if (t * tf32::kTileRows + qi < s) {
            const float* r = sm.extra(st) + 4 * qi;
            pe = tc::div_by(expf(__fsub_rn(scaled_score(p[n][e], scale, kb[e / 2]), r[0])), r[1], r[2]);
            dse = __fmul_rn(__fmul_rn(pe, __fsub_rn(ds[n][e], r[3])), scale);
          }
          p[n][e] = pe;
          ds[n][e] = dse;
        }
      tf32::accumulate_pairs<kHalfTiles, DH>(dv_part, p, do_rows);
      tf32::accumulate_pairs<kHalfTiles, DH>(dk_part, ds, q_rows);
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_sum[j][e] = __fadd_rn(dk_sum[j][e], dk_part[j][e]);
        dv_sum[j][e] = __fadd_rn(dv_sum[j][e], dv_part[j][e]);
      }
    __syncthreads();
  }
  tf32::store_rows<DH>(dk + b * vw.dk.b + head * vw.dk.h, vw.dk.r, k0 + 16 * warp, s, dk_sum);
  tf32::store_rows<DH>(dv + b * vw.dv.b + head * vw.dv.h, vw.dv.r, k0 + 16 * warp, s, dv_sum);
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

// The two passes of the f32 query-blocked backward, on the tensor cores.
template <int DH>
int launch_q_blocked_tf32(const void* q, const void* k, const void* v, const void* d_o, const void* bias, void* dq,
                          void* dk, void* dv, void* stats, void* delta, const void* strides, int batch, int heads,
                          int seq, float scale, void* stream) {
  const BwdViews vw = read_views(strides, {&BwdViews::q, &BwdViews::k, &BwdViews::v, &BwdViews::d_o,
                                           &BwdViews::dq, &BwdViews::dk, &BwdViews::dv});
  constexpr size_t kSmem = tf32::Layout<DH>::kBytes;
  for (const void* kernel : {reinterpret_cast<const void*>(q_blocked_dq_tf32_kernel<DH>),
                             reinterpret_cast<const void*>(q_blocked_dkv_tf32_kernel<DH>)}) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq + tf32::kTileRows - 1) / tf32::kTileRows, heads, batch);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fdo = static_cast<const float*>(d_o),
              *fbias = static_cast<const float*>(bias);
  q_blocked_dq_tf32_kernel<DH><<<grid, tf32::kThreads, kSmem, stm>>>(
      fq, fk, fv, fdo, fbias, static_cast<float*>(dq), static_cast<float*>(stats), static_cast<float*>(delta), vw,
      seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  q_blocked_dkv_tf32_kernel<DH><<<grid, tf32::kThreads, kSmem, stm>>>(
      fq, fk, fv, fdo, fbias, static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), vw, seq, scale);
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
  if (head_dim == 32)
    return dial::attn::launch_q_blocked_tf32<32>(q, k, v, d_o, bias, dq, dk, dv, stats, delta, strides, batch,
                                                 heads, seq, scale, stream);
  if (head_dim == 64)
    return dial::attn::launch_q_blocked_tf32<64>(q, k, v, d_o, bias, dq, dk, dv, stats, delta, strides, batch,
                                                 heads, seq, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
