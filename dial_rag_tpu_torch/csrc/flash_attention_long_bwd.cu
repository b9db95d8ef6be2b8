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
// 824.6 GFLOP take 9.23 and 12.31 ms in f32 on the CUDA cores, 3.75 and
// 5.00 ms at 3xTF32's 165 TFLOP/s (0.63, 0.83 ms at 989 TFLOP/s in bf16);
// twice that at head_dim 64. Their 176-201 MB of operands take 0.05-0.1
// ms: bound by operations.
//
// The f32 backwards run their products on the tensor cores in split TF32
// (tensor_core_tf32.cuh: each f32 operand split into two TF32 parts,
// hi.lo + lo.hi + hi.hi by mma.sync.m16n8k8, about 2^-21 relative a
// product), Hopper's counterpart of the HIGHEST precision the reference
// asks for on f32 (itself several bf16 passes on the TPU's MXU): two
// launches of one pair of templates, dq_tf32_kernel then dkv_tf32_kernel,
// with LSE false for the query-blocked backward and true for the KV-blocked
// passes. Blocks of 4 warps own 64 rows, 16 a warp; the other side streams
// through a two-stage cp.async ring of 64-row chunks in dynamic shared
// memory (104 KB a block at head_dim 64, 56 KB at 32):
//   dQ pass, a block per 64-query tile. Query-blocked: a first sweep over
//     the key chunks forms Q K^T and dO V^T and keeps each lane's running
//     max, denominator and sum of e dP (rescaled as the max grows, merged
//     over the row's four lanes), which gives the row's max, denominator
//     and delta = sum(dP P) (saved for the dK/dV pass). KV-blocked: P =
//     exp(s - lse) from the forward's lse, delta = dO . O from its o tile
//     (staged through a ring stage before the sweep), no first sweep. Then
//     a sweep forms Q K^T and dO V^T, dS = P (dP - delta) scale, and dQ +=
//     dS K.
//   dK/dV pass, a block per 64-key tile: a loop over the query chunks
//     forms K Q^T and V dO^T (rows keys, so P^T and dS^T come out as A
//     operands), rebuilds P and dS with the dQ pass's expressions from its
//     statistics and delta, and accumulates dV += P^T dO and dK += dS^T Q.
// The query-blocked backward computes nine [S, S] products (QK^T and dO V^T
// three times, dS K, P^T dO and dS^T Q) against the bound's five: the
// sweeps keep the reference's expressions, delta = rowsum(dP P) and P
// normalised before use. The KV-blocked passes compute the bound's three
// and four. What else still holds them back: the split of every operand at
// each fragment load (three conversions per element, in every warp that
// reads it), mma.sync rather than wgmma (wgmma takes TF32 only K-major),
// and two blocks an SM at head_dim 64.
//
// The bf16 backwards run on the bf16 tensor cores (mma.sync.m16n8k16):
// dq_tc_kernel then dkv_tc_kernel (attention_bwd_tc.cuh), the f32 pair's
// structure and expressions on bf16 products, with LSE false for the
// query-blocked backward (nine [S, S] products, as in f32) and true for the
// KV-blocked passes (three and four).
//
// The long sums over S (dQ over the keys, dK and dV over the queries) add
// one partial per chunk or half chunk to the total in f32 on the CUDA
// cores. The query-blocked split-TF32 dQ pass compensates each chunk's
// partial and its dK/dV pass adds each half chunk's plainly (its P is at
// most 1 / S on a fully masked row, and the f32 gates hold without it);
// the bf16 tensor-core passes add their partials plainly (the bf16 gates
// are 3e-2 of the largest gradient). In the KV-blocked backward a fully
// masked row's P is 1, so its gradients are sums of S = 8192 terms of size
// 1. The split-TF32 KV-blocked passes compensate a partial
// every 32 rows (half a chunk) and, at head_dim 64, form dP with its small
// terms apart (kDpSmallApart): a tensor core rounds the f32 sum of each
// mma.sync in its own way, and on a fully masked row, where P is exactly 1,
// partials carried over 64 rows put dK farther from an f64 evaluation than
// the plain version is (the gates refuse it at head_dim 64), and dP's
// rounding over the head width leaves it within a few percent of the
// plain version's. PERF.md has the readings on an H100, from
// dial_rag_tpu_torch/scripts/kv_blocked_bwd_variants.py, which builds this
// source with each of these choices undone.
#include <cfloat>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "attention_bwd_tc.cuh"
#include "attention_long.cuh"
#include "tensor_core_tf32.cuh"

namespace dial {
namespace attn {
namespace {

// sum += x with a compensation term (Kahan), rounded as written
__device__ __forceinline__ void add_compensated(float& sum, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// ---- the f32 blocked backwards (split-TF32 tensor-core products) ---------
// _attention_bwd_q_blocked_kernel (LSE false) and the KV-blocked passes
// _bwd_dq_kv_blocked_kernel, _bwd_dkv_kv_blocked_kernel (LSE true) in f32.
// Both passes are blocks of tf32::kThreads threads owning a 64-row tile
// (queries, then keys), 16 rows a warp, the other side streaming through
// tf32::Layout's two-stage ring in 64-row chunks. A chunk is taken in two
// halves of 32 (kHalf, attention_bwd_tc.cuh). In a D tile x[n][e] the
// warp's row is g + 8 (e / 2) and the column (key or query) 8 n + 2c +
// e % 2 of the half.

// Whether a pass forms dP with its small terms apart (product_rows'
// kSmallApart): the KV-blocked passes at head_dim 64, where dP's rounding
// over the head width made most of a fully masked row's error (the
// header's last paragraph). At head_dim 32 the gates hold with a wide
// margin without it, and its extra accumulator's registers cost the dK/dV
// pass a block an SM and time on an H100 (PERF.md).
template <int DH, bool LSE>
constexpr bool kDpSmallApart = LSE && DH == 64;

// sum += part, element by element, then part = 0. With kCompensated each
// add takes a compensation term (add_compensated) kept as bf16, two to a
// register (comp[j][h]: elements 2h and 2h + 1 of sum[j]): a term only
// has to carry a rounding error to a few bits, and as f32 the terms made
// the KV-blocked dK/dV pass at head_dim 64 spill more registers
// (PERF.md).
template <bool kCompensated, int DH>
__device__ __forceinline__ void add_partial(float (&sum)[DH / 8][4], uint32_t (&comp)[DH / 8][2],
                                            float (&part)[DH / 8][4]) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kCompensated) {
        float c0 = __uint_as_float(comp[j][h] << 16), c1 = __uint_as_float(comp[j][h] & 0xffff0000u);
        add_compensated(sum[j][2 * h], c0, part[j][2 * h]);
        add_compensated(sum[j][2 * h + 1], c1, part[j][2 * h + 1]);
        comp[j][h] = tc::pack_bf16(c0, c1);
      } else {
        sum[j][2 * h] = __fadd_rn(sum[j][2 * h], part[j][2 * h]);
        sum[j][2 * h + 1] = __fadd_rn(sum[j][2 * h + 1], part[j][2 * h + 1]);
      }
      part[j][2 * h] = part[j][2 * h + 1] = 0.f;
    }
}

// pass 1: dQ of query rows q0 .. q0 + 63 and each row's delta ([B, h, S])
// for the dK/dV pass.
//   LSE false: a first sweep over the key chunks gives each row's max and
//     denominator (written to stats [B, h, S, 2]) and delta = sum(dP P);
//     P = exp(s - max) / denominator. Each chunk's dQ partial is added to
//     the total with a compensation term.
//   LSE true: P = exp(s - lse) from the forward's lse and delta = dO . O
//     from its o (staged through ring stage 1 before the sweep): no first
//     sweep. A fully masked row's P is 1 for every key, so its dQ is a sum
//     of S terms of size 1: each half chunk's partial is added with a
//     compensation term, and at head_dim 64 dP's product keeps its small
//     terms apart (kDpSmallApart).
template <int DH, bool LSE>
__global__ void __launch_bounds__(tf32::kThreads)
    dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ o, const float* __restrict__ d_o, const float* __restrict__ bias,
                   const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ stats,
                   float* __restrict__ delta_out, BwdViews vw, int s, float scale) {
  extern __shared__ __align__(16) float tf32_smem[];
  const tf32::Layout<DH> sm{tf32_smem};  // fixed: q, dO; a stage: K, V, the chunk's bias
  const int q0 = blockIdx.x * tf32::kTileRows, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
  const long long rows0 = (static_cast<long long>(b) * gridDim.y + head) * s;
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
    tf32::product_rows<kHalfTiles, DH, kDpSmallApart<DH, LSE>>(dp, do_warp,
                                                               sm.tile(st, 1) + kHalf * hf * tf32::kLd<DH>);
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

  // per row of this lane (q0 + 16 warp + lane / 4 + 8 h): P = exp(s -
  // m_row) / l_row (r_row = 1 / l_row), or exp(s - m_row) with an lse
  float m_row[2], l_row[2] = {1.f, 1.f}, r_row[2] = {1.f, 1.f}, delta[2];
  if constexpr (LSE) {
    const float* o_warp = sm.tile(1, 0) + 16 * warp * tf32::kLd<DH>;
    tf32::copy_rows_async<DH>(sm.tile(1, 0), o + b * vw.o.b + head * vw.o.h, vw.o.r,
                              q0, tf32::kTileRows, s, tf32::kThreads);
    issue(0);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    // delta = dO . O: lane c of a row takes head columns c, c + 4, ...
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = lane / 4 + 8 * h;
      float d = 0.f;
#pragma unroll
      for (int j = c; j < DH; j += 4) d = fmaf(do_warp[rr * tf32::kLd<DH> + j], o_warp[rr * tf32::kLd<DH> + j], d);
      delta[h] = tf32::quad_sum(d);
      m_row[h] = q0 + 16 * warp + rr < s ? lse[rows0 + q0 + 16 * warp + rr] : 0.f;
    }
    __syncthreads();  // stage 1 takes chunk 1 next
  } else {
    // sweep 1: each row's max, denominator and delta = sum(dP P)
    // (row_stats_add, row_stats_merge: attention_bwd_tc.cuh)
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, ed[2] = {0.f, 0.f};
    issue(0);
    tc::cp_async_commit();
    for (int t = 0; t < n_chunks; ++t) {
      const int st = tf32::ring_step(t, n_chunks, issue);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x[kHalfTiles][4], dp[kHalfTiles][4];
        products(st, hf, x, dp);
        row_stats_add(x, dp, m, l, ed);
      }
      __syncthreads();
    }
    row_stats_merge(m, l, ed, m_row, l_row, r_row, delta);
    issue(0);
    tc::cp_async_commit();
  }

  // sweep 2: dS = P (dP - delta) scale, dQ += dS K
  float acc[DH / 8][4] = {};
  uint32_t comp[DH / 8][2] = {};
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
          const float ex = expf(__fsub_rn(x[n][e], m_row[e / 2]));
          const float p = LSE ? ex : tc::div_by(ex, l_row[e / 2], r_row[e / 2]);
          x[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], delta[e / 2])), scale);
        }
      tf32::accumulate_pairs<kHalfTiles, DH>(part, x, sm.tile(st, 0) + kHalf * hf * tf32::kLd<DH>);
      if (LSE || hf == 1) add_partial<true, DH>(acc, comp, part);
    }
    __syncthreads();
  }
  tf32::store_rows<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, q0 + 16 * warp, s, acc);
  if (c == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + 16 * warp + lane / 4 + 8 * h;
      if (r >= s) continue;
      if (!LSE) {
        stats[2 * (rows0 + r)] = m_row[h];
        stats[2 * (rows0 + r) + 1] = l_row[h];
      }
      delta_out[rows0 + r] = delta[h];
    }
  }
}

// pass 2: dK and dV of keys k0 .. k0 + 63 over every query chunk, P
// rebuilt with the dQ pass's expression from stats (LSE: the forward's lse
// [B, h, S]; else each row's max and denominator [B, h, S, 2]) and delta.
// Queries past S get P = dS = 0; keys past S score -inf. Each half
// chunk's partials (32 queries) are added to the sums in f32:
//   LSE false: without compensation: at S = 4352 and on a fully masked row
//     (P = 1 / S) the f32 gates hold without it.
//   LSE true: with a compensation term: a fully masked row's P is 1, so
//     its dK and dV are sums of S terms of size 1.
template <int DH, bool LSE>
__global__ void __launch_bounds__(tf32::kThreads)
    dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ d_o, const float* __restrict__ bias, const float* __restrict__ stats,
                    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, BwdViews vw,
                    int s, float scale) {
  extern __shared__ __align__(16) float tf32_smem[];
  // fixed: k, v; a stage: Q, dO, (max, denominator, 1 / denominator,
  // delta) or (lse, -, -, delta) per query
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
      if (LSE) {
        r[0] = stats[row];
      } else {
        r[0] = stats[2 * row];
        r[1] = stats[2 * row + 1];
        r[2] = __frcp_rn(r[1]);
      }
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
  uint32_t dk_comp[DH / 8][2] = {}, dv_comp[DH / 8][2] = {};  // used with LSE
  issue(0);
  tc::cp_async_commit();
  for (int t = 0; t < n_chunks; ++t) {
    const int st = tf32::ring_step(t, n_chunks, issue);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* q_rows = sm.tile(st, 0) + kHalf * hf * tf32::kLd<DH>;
      const float* do_rows = sm.tile(st, 1) + kHalf * hf * tf32::kLd<DH>;
      // scores^T (k . q), then dP^T (v . dO): rows keys, columns queries;
      // each half's partials are added to the sums before the next product
      // (with the partials of a whole chunk live, or P, dP^T and a partial
      // together, the pass spilled registers at head_dim 64)
      float p[kHalfTiles][4], ds[kHalfTiles][4];
      tf32::product_rows<kHalfTiles, DH>(p, k_warp, q_rows);
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = kHalf * hf + 8 * n + 2 * c + e % 2;
          float pe = 0.f;
          if (t * tf32::kTileRows + qi < s) {
            const float* r = sm.extra(st) + 4 * qi;
            pe = expf(__fsub_rn(scaled_score(p[n][e], scale, kb[e / 2]), r[0]));
            if (!LSE) pe = tc::div_by(pe, r[1], r[2]);
          }
          p[n][e] = pe;
        }
      {
        float part[DH / 8][4] = {};
        tf32::accumulate_pairs<kHalfTiles, DH>(part, p, do_rows);
        add_partial<LSE, DH>(dv_sum, dv_comp, part);
      }
      tf32::product_rows<kHalfTiles, DH, kDpSmallApart<DH, LSE>>(ds, v_warp, do_rows);
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = kHalf * hf + 8 * n + 2 * c + e % 2;
          ds[n][e] = t * tf32::kTileRows + qi < s
                         ? __fmul_rn(__fmul_rn(p[n][e], __fsub_rn(ds[n][e], sm.extra(st)[4 * qi + 3])), scale)
                         : 0.f;
        }
      {
        float part[DH / 8][4] = {};
        tf32::accumulate_pairs<kHalfTiles, DH>(part, ds, q_rows);
        add_partial<LSE, DH>(dk_sum, dk_comp, part);
      }
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

// The tensor-core passes' grid of 64-row tiles, and the split-TF32
// passes' opt-in to tf32::Layout's dynamic shared memory (0 on success).
dim3 tile_grid_of(int batch, int heads, int seq) {
  return dim3((seq + tf32::kTileRows - 1) / tf32::kTileRows, heads, batch);
}

template <int DH>
cudaError_t opt_in_tf32(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(tf32::Layout<DH>::kBytes));
}

// Each launcher runs f32 on the split-TF32 kernels and bf16 on the bf16
// tensor-core kernels.
template <typename T, int DH>
int launch_q_blocked(const void* q, const void* k, const void* v, const void* d_o, const void* bias, void* dq,
                     void* dk, void* dv, void* stats, void* delta, const void* strides, int batch, int heads,
                     int seq, float scale, void* stream) {
  const BwdViews vw = read_views(strides, {&BwdViews::q, &BwdViews::k, &BwdViews::v, &BwdViews::d_o,
                                           &BwdViews::dq, &BwdViews::dk, &BwdViews::dv});
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k), *tv = static_cast<const T*>(v),
          *tdo = static_cast<const T*>(d_o);
  const float* fbias = static_cast<const float*>(bias);
  float *fstats = static_cast<float*>(stats), *fdelta = static_cast<float*>(delta);
  if constexpr (std::is_same_v<T, float>) {
    for (const void* kernel : {reinterpret_cast<const void*>(dq_tf32_kernel<DH, false>),
                               reinterpret_cast<const void*>(dkv_tf32_kernel<DH, false>)}) {
      const cudaError_t err = opt_in_tf32<DH>(kernel);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid = tile_grid_of(batch, heads, seq);
    constexpr size_t kSmem = tf32::Layout<DH>::kBytes;
    dq_tf32_kernel<DH, false><<<grid, tf32::kThreads, kSmem, stm>>>(
        tq, tk, tv, nullptr, tdo, fbias, nullptr, static_cast<float*>(dq), fstats, fdelta, vw, seq, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dkv_tf32_kernel<DH, false><<<grid, tf32::kThreads, kSmem, stm>>>(
        tq, tk, tv, tdo, fbias, fstats, fdelta, static_cast<float*>(dk), static_cast<float*>(dv), vw, seq, scale);
  } else {
    const dim3 grid = tile_grid_of(batch, heads, seq);
    dq_tc_kernel<DH, false><<<grid, tc::kThreads, 0, stm>>>(tq, tk, tv, nullptr, tdo, fbias, nullptr,
                                                            static_cast<T*>(dq), fstats, fdelta, vw, seq, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dkv_tc_kernel<DH, false><<<grid, tc::kThreads, 0, stm>>>(tq, tk, tv, tdo, fbias, fstats, fdelta,
                                                             static_cast<T*>(dk), static_cast<T*>(dv), vw, seq, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dq_kv_blocked(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                         const void* bias, const void* lse, void* dq, void* delta, const void* strides, int batch,
                         int heads, int seq, float scale, void* stream) {
  const BwdViews vw = read_views(strides, {&BwdViews::q, &BwdViews::k, &BwdViews::v, &BwdViews::o,
                                           &BwdViews::d_o, &BwdViews::dq});
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k), *tv = static_cast<const T*>(v),
          *to = static_cast<const T*>(o), *tdo = static_cast<const T*>(d_o);
  const float *fbias = static_cast<const float*>(bias), *flse = static_cast<const float*>(lse);
  if constexpr (std::is_same_v<T, float>) {
    const cudaError_t err = opt_in_tf32<DH>(reinterpret_cast<const void*>(dq_tf32_kernel<DH, true>));
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_tf32_kernel<DH, true><<<tile_grid_of(batch, heads, seq), tf32::kThreads, tf32::Layout<DH>::kBytes, stm>>>(
        tq, tk, tv, to, tdo, fbias, flse, static_cast<float*>(dq), nullptr, static_cast<float*>(delta), vw, seq,
        scale);
  } else {
    dq_tc_kernel<DH, true><<<tile_grid_of(batch, heads, seq), tc::kThreads, 0, stm>>>(
        tq, tk, tv, to, tdo, fbias, flse, static_cast<T*>(dq), nullptr, static_cast<float*>(delta), vw, seq, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkv_kv_blocked(const void* q, const void* k, const void* v, const void* d_o, const void* bias,
                          const void* lse, const void* delta, void* dk, void* dv, const void* strides, int batch,
                          int heads, int seq, float scale, void* stream) {
  const BwdViews vw = read_views(strides, {&BwdViews::q, &BwdViews::k, &BwdViews::v, &BwdViews::d_o,
                                           &BwdViews::dk, &BwdViews::dv});
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k), *tv = static_cast<const T*>(v),
          *tdo = static_cast<const T*>(d_o);
  const float *fbias = static_cast<const float*>(bias), *flse = static_cast<const float*>(lse),
              *fdelta = static_cast<const float*>(delta);
  if constexpr (std::is_same_v<T, float>) {
    const cudaError_t err = opt_in_tf32<DH>(reinterpret_cast<const void*>(dkv_tf32_kernel<DH, true>));
    if (err != cudaSuccess) return static_cast<int>(err);
    dkv_tf32_kernel<DH, true><<<tile_grid_of(batch, heads, seq), tf32::kThreads, tf32::Layout<DH>::kBytes, stm>>>(
        tq, tk, tv, tdo, fbias, flse, fdelta, static_cast<float*>(dk), static_cast<float*>(dv), vw, seq, scale);
  } else {
    dkv_tc_kernel<DH, true><<<tile_grid_of(batch, heads, seq), tc::kThreads, 0, stm>>>(
        tq, tk, tv, tdo, fbias, flse, fdelta, static_cast<T*>(dk), static_cast<T*>(dv), vw, seq, scale);
  }
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
