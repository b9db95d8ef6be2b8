// The bf16 blocked attention backwards on Hopper's tensor cores, head_dim
// 32 and 64 (sm_90a): TPU kernel 9 in bf16 (_attention_bwd_q_blocked_kernel,
// dial_rag_tpu/ops/flash_attention.py:360) and kernels 10 and 11 in bf16
// (_bwd_dq_kv_blocked_kernel and _bwd_dkv_kv_blocked_kernel, :417 and
// :461), launched from flash_attention_long_bwd.cu: one pair of templates,
// dq_tc_kernel then dkv_tc_kernel, with LSE false for kernel 9 and true for
// kernels 10 and 11.
//
// The functions, as the reference computes them in bf16 (products of bf16
// operands with f32 sums): kernel 9 takes per query row the exact softmax
// P over every key, normalised in f32, and delta = rowsum(dP P); kernels 10
// and 11 take P = exp(s - lse) from the KV-blocked forward's log-sum-exp
// and delta = rowsum(dO O) from its o. Then dP = dO V^T; dS = bf16(P (dP -
// delta) scale); dQ = dS K; dV += bf16(P)^T dO; dK += dS^T Q; each
// gradient summed in f32 and cast to bf16 at the end.
//
// The design: the structure and expressions of the f32 pair
// (dq_tf32_kernel and dkv_tf32_kernel, whose notes in
// flash_attention_long_bwd.cu this follows), with each product one
// mma.sync.m16n8k16 bf16 product (tensor_core.cuh): a bf16 x bf16 product
// is exact in f32, so nothing is split. Blocks of 4 warps own 64 rows, 16
// a warp; the other side streams through a two-stage ring of 64-row bf16
// chunks ([64, DH + 8]: ldmatrix's 8 row addresses on distinct banks) by
// 16-byte cp.async copies; the block's own rows go through ring stage 1
// into registers as A fragments before the ring starts, so shared memory
// is static (38 KB at head_dim 64, 22 KB at 32). A chunk is taken in two
// halves of 32 rows, as in f32, to hold registers.
//   dQ pass (dq_tc_kernel), a block per 64-query tile. LSE false: a first
//     sweep forms Q K^T and dO V^T and keeps each lane's running max,
//     denominator and sum of e dP, rescaled as the max grows and merged
//     over the row's four lanes: the row's max and denominator (stats [B,
//     h, S, 2]) and delta = sum(dP P). LSE true: the o tile through ring
//     stage 0 before the sweep, delta = dO . O in f32 (a quad sum a row),
//     the row's lse in place of the max and no first sweep. Then a sweep
//     forms both products again, P = exp(s - max) / l (div_by; with LSE
//     exp(s - lse)), dS = P (dP - delta) scale, rounds it to bf16 straight
//     into the A fragments of dS K (two adjacent score n-tiles are one k16
//     A fragment), K read by ldmatrix.trans; each 64-key chunk's partial is
//     added to dQ in f32 on the CUDA cores. delta ([B, h, S]) is written
//     for the dK/dV pass.
//   dK/dV pass (dkv_tc_kernel), a block per 64-key tile, a loop over the
//     query chunks, each ring stage carrying its queries' statistics (or
//     lse) and delta: K Q^T and V dO^T (rows keys, so P^T and dS^T come out
//     in the A fragments' layout), P and dS rebuilt with the dQ pass's
//     expressions, dV += bf16(P)^T dO and dK += bf16(scale dS)^T Q with dO
//     and Q read by ldmatrix.trans, each half chunk's partial added in f32.
// Two launches, no atomics: a bf16 training run is reproducible bit for
// bit. The partials are added plainly: a fully masked row's P is 1 for
// every key in kernels 10 and 11, so its gradients are sums of S terms of
// size 1, but 128 f32 partials at S = 8192 drift far less than the bf16
// gates' 3e-2 of the largest gradient (PERF.md has the reading).
// Kernel 9 forms nine [S, S] products (Q K^T and dO V^T three times, dS K,
// P^T dO, dS^T Q) against the bound's five: the sweeps keep the
// reference's delta = rowsum(dP P) and the P normalised before its cast.
// Kernels 10 and 11 form the bound's three and four. Bound on an H100 SXM:
// 2 B h S^2 Dh FLOPs a product at 989 TFLOP/s; at [4, 12, 8192, 64] the
// dQ pass's 1237 GFLOP take 1.25 ms and the dK/dV pass's 1649 GFLOP 1.67
// ms, against about 300 MB of operands and gradients a pass (0.09 ms):
// bound by operations.
#pragma once

#include <cfloat>
#include <cstdint>

#include "attention_long.cuh"
#include "attention_tc.cuh"

namespace dial {
namespace tc {
namespace {

// elements of a bf16 tile row (load_rows_async's layout)
template <int DH>
constexpr int kRowLd = DH + 8;

// The warp's 16 rows (16 warp .. 16 warp + 15) of a [*, DH + 8] tile as A
// fragments, one per 16 head columns.
template <int DH>
__device__ __forceinline__ void a_fragments(uint32_t (&a)[DH / 16][4], const bf16* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(a[kk], tile + (16 * warp + lane % 16) * kRowLd<DH> + 16 * kk + (lane / 16) * 8);
}

// acc[n] = A R^T over the head width: A the warp's 16 rows (a_fragments)
// against rows 8 n .. 8 n + 7 of `rows` ([*, DH + 8]); acc in D's layout
// (row g + 8 (e / 2), column 8 n + 2 (lane % 4) + e % 2).
template <int NT, int DH>
__device__ __forceinline__ void product_rows(float (&acc)[NT][4], const uint32_t (&a)[DH / 16][4],
                                             const bf16* rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // rows 16 np .. 16 np + 15 (two n-tiles), head columns 16 kk .. + 15
      uint32_t b[4];
      ldmatrix_x4(b, rows + (16 * np + (lane / 16) * 8 + lane % 8) * kRowLd<DH> + 16 * kk + ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// out += bf16(p) R: p a D-layout tile [16, 8 NT] in f32, rounded to bf16
// into the A fragments straight from the registers, R rows 0 .. 8 NT - 1
// of `rows` ([*, DH + 8], read transposed); out[j] holds head columns
// 8 j .. 8 j + 7.
template <int NT, int DH>
__device__ __forceinline__ void accumulate_pairs(float (&out)[DH / 8][4], const float (&p)[NT][4],
                                                 const bf16* rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    // the A fragment of rows 16 kk .. 16 kk + 15 of R: p's n-tiles 2 kk and 2 kk + 1
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, rows + (16 * kk + ((lane / 8) % 2) * 8 + lane % 8) * kRowLd<DH> + 16 * dp +
                                (lane / 16) * 8);
      mma_bf16(out[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(out[2 * dp + 1], pa, bv[2], bv[3]);
    }
  }
}

// Stores the warp's rows r0 + g + 8 (e / 2) (below S), head columns 8 j +
// 2 (lane % 4) + e % 2, of a [16, DH] D-layout tile into one head of a
// bf16 view, rounded once.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* head, long long row_stride, int r0, int s,
                                           const float (&vals)[DH / 8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + lane / 4 + 8 * h;
    if (row >= s) continue;
    bf16* dst = head + row * row_stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      dst[8 * j] = __float2bfloat16_rn(vals[j][2 * h]);
      dst[8 * j + 1] = __float2bfloat16_rn(vals[j][2 * h + 1]);
    }
  }
}

}  // namespace
}  // namespace tc

namespace attn {
namespace {

struct BwdViews {
  View q, k, v, o, d_o, dq, dk, dv;
};

// The blocked backwards take a 64-row ring chunk in two halves of 32 rows,
// which keeps two [16, 32] D tiles (scores and dP) live beside the
// gradient sums.
constexpr int kHalf = 32;
constexpr int kHalfTiles = kHalf / 8;

// Shared memory of a bf16 tensor-core pass: two ring stages of two bf16
// [64, DH + 8] tiles (K and V, or Q and dO) and 4 floats a row (the
// chunk's key bias, or a query's max, denominator, 1 / denominator and
// delta).
template <int DH>
struct BwdTcSmem {
  bf16 rows[2][2][tc::kRows * tc::kRowLd<DH>];
  float extra[2][4 * tc::kRows];
};
static_assert(sizeof(BwdTcSmem<64>) <= kStaticSmemLimit, "the bf16 backward's shared memory must fit statically");

// Sweep 1 of the query-blocked dQ passes (this bf16 one and the f32
// dq_tf32_kernel), one [16, 8 NT] D tile of scores x and dP at a time:
// per row of this lane (g and g + 8), the running max m, sum(exp(s - m))
// and sum(exp(s - m) dP) over its keys, rescaled whenever m grows; m
// starts at f32.min, not -inf, so a lane none of whose keys is real yet
// rescales by exp(0) instead of exp(-inf - -inf).
template <int NT>
__device__ __forceinline__ void row_stats_add(const float (&x)[NT][4], const float (&dp)[NT][4], float (&m)[2],
                                              float (&l)[2], float (&ed)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) cm = fmaxf(cm, fmaxf(x[n][2 * h], x[n][2 * h + 1]));
    const float m_new = fmaxf(m[h], cm);
    const float corr = expf(__fsub_rn(m[h], m_new));
    float add_l = 0.f, add_ed = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
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

// The lane's statistics merged over the row's four lanes: the row max, the
// denominator l, 1 / l and delta = sum(dP exp(s - max)) / l = sum(dP P).
__device__ __forceinline__ void row_stats_merge(const float (&m)[2], const float (&l)[2], const float (&ed)[2],
                                                float (&m_row)[2], float (&l_row)[2], float (&r_row)[2],
                                                float (&delta)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_row[h] = tc::quad_max(m[h]);
    const float f = expf(__fsub_rn(m[h], m_row[h]));
    l_row[h] = tc::quad_sum(l[h] * f);
    r_row[h] = __frcp_rn(l_row[h]);
    delta[h] = __fdiv_rn(tc::quad_sum(ed[h] * f), l_row[h]);
  }
}

// pass 1: dQ of query rows q0 .. q0 + 63 and each row's delta ([B, h,
// S]) for the dK/dV pass.
//   LSE false (kernel 9): a first sweep gives each row's max and
//     denominator (written to stats [B, h, S, 2]) and delta = sum(dP P);
//     P = exp(s - max) / denominator.
//   LSE true (kernel 10): P = exp(s - lse) from the forward's lse [B, h,
//     S] and delta = dO . O from its o (staged through ring stage 0 before
//     the sweep): no first sweep, no division.
// Each 64-key chunk's dQ partial is added to the total in f32.
template <int DH, bool LSE>
__global__ void __launch_bounds__(tc::kThreads)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const bf16* __restrict__ o, const bf16* __restrict__ d_o, const float* __restrict__ bias,
                 const float* __restrict__ lse, bf16* __restrict__ dq, float* __restrict__ stats,
                 float* __restrict__ delta_out, BwdViews vw, int s, float scale) {
  constexpr int kLd = tc::kRowLd<DH>;
  __shared__ __align__(16) BwdTcSmem<DH> sm;
  const int q0 = blockIdx.x * tc::kRows, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
  const long long rows0 = (static_cast<long long>(b) * gridDim.y + head) * s;
  const bf16* k_head = k + b * vw.k.b + head * vw.k.h;
  const bf16* v_head = v + b * vw.v.b + head * vw.v.h;
  const float* bias_row = bias + static_cast<long long>(b) * s;
  const int n_chunks = (s + tc::kKeys - 1) / tc::kKeys;
  // key chunk `chunk`, K and V, and its bias (-inf past S) into its stage
  auto issue = [&](int chunk) {
    const int c0 = chunk * tc::kKeys, st = chunk % 2;
    tc::load_rows_async<tc::kKeys, DH>(sm.rows[st][0], k_head, vw.k.r, c0, s);
    tc::load_rows_async<tc::kKeys, DH>(sm.rows[st][1], v_head, vw.v.r, c0, s);
    if (threadIdx.x < tc::kKeys) sm.extra[st][threadIdx.x] = key_bias(bias_row, c0 + threadIdx.x, s);
  };

  // the block's q and dO rows through ring stage 1 into registers; with
  // LSE the o rows through stage 0 first, else the first key chunk
  tc::load_rows_async<tc::kRows, DH>(sm.rows[1][0], q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, s);
  tc::load_rows_async<tc::kRows, DH>(sm.rows[1][1], d_o + b * vw.d_o.b + head * vw.d_o.h, vw.d_o.r, q0, s);
  if (LSE)
    tc::load_rows_async<tc::kRows, DH>(sm.rows[0][0], o + b * vw.o.b + head * vw.o.h, vw.o.r, q0, s);
  else
    issue(0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[DH / 16][4], doa[DH / 16][4];
  tc::a_fragments<DH>(qa, sm.rows[1][0]);
  tc::a_fragments<DH>(doa, sm.rows[1][1]);

  // the scores (q . k * scale + bias) and dP (dO . v) of half `hf` of the chunk in stage st
  auto products = [&](int st, int hf, float (&x)[kHalfTiles][4], float (&dp)[kHalfTiles][4]) {
    tc::product_rows<kHalfTiles, DH>(x, qa, sm.rows[st][0] + kHalf * hf * kLd);
    tc::product_rows<kHalfTiles, DH>(dp, doa, sm.rows[st][1] + kHalf * hf * kLd);
    const float* key_bias_s = sm.extra[st] + kHalf * hf + 2 * c;
#pragma unroll
    for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = scaled_score(x[n][e], scale, key_bias_s[8 * n + e % 2]);
  };

  // per row of this lane (q0 + 16 warp + lane / 4 + 8 h): P = exp(s -
  // m_row) / l_row (r_row = 1 / l_row), or exp(s - m_row) with an lse
  float m_row[2], l_row[2] = {1.f, 1.f}, r_row[2] = {1.f, 1.f}, delta[2];
  if constexpr (LSE) {
    // delta = dO . O in f32 (bf16 products are exact): lane c of a row
    // takes head columns c, c + 4, ...
    const bf16* do_warp = sm.rows[1][1] + 16 * warp * kLd;
    const bf16* o_warp = sm.rows[0][0] + 16 * warp * kLd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = lane / 4 + 8 * h, row = q0 + 16 * warp + rr;
      float d = 0.f;
#pragma unroll
      for (int j = c; j < DH; j += 4) d = fmaf(to_f32(do_warp[rr * kLd + j]), to_f32(o_warp[rr * kLd + j]), d);
      delta[h] = tc::quad_sum(d);
      m_row[h] = row < s ? lse[rows0 + row] : 0.f;
    }
    __syncthreads();  // stage 0 takes chunk 0 next
  } else {
    __syncthreads();  // stage 1 takes chunk 1 next
    // sweep 1: each row's max, denominator and delta = sum(dP P)
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, ed[2] = {0.f, 0.f};
    for (int t = 0; t < n_chunks; ++t) {
      const int st = tc::ring_step(t, n_chunks, issue);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x[kHalfTiles][4], dp[kHalfTiles][4];
        products(st, hf, x, dp);
        row_stats_add(x, dp, m, l, ed);
      }
      __syncthreads();
    }
    row_stats_merge(m, l, ed, m_row, l_row, r_row, delta);
  }

  // the sweep: P, dS = P (dP - delta) scale, dQ += bf16(dS) K, each
  // chunk's partial added in f32
  float acc[DH / 8][4] = {};
  issue(0);
  tc::cp_async_commit();
  for (int t = 0; t < n_chunks; ++t) {
    const int st = tc::ring_step(t, n_chunks, issue);
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
      tc::accumulate_pairs<kHalfTiles, DH>(part, x, sm.rows[st][0] + kHalf * hf * kLd);
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
    __syncthreads();
  }
  tc::store_rows<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, q0 + 16 * warp, s, acc);
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
// chunk's partials (32 queries) are added to the sums in f32.
template <int DH, bool LSE>
__global__ void __launch_bounds__(tc::kThreads)
    dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ d_o, const float* __restrict__ bias, const float* __restrict__ stats,
                  const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, BwdViews vw, int s,
                  float scale) {
  constexpr int kLd = tc::kRowLd<DH>;
  __shared__ __align__(16) BwdTcSmem<DH> sm;
  const int k0 = blockIdx.x * tc::kRows, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
  const bf16* q_head = q + b * vw.q.b + head * vw.q.h;
  const bf16* do_head = d_o + b * vw.d_o.b + head * vw.d_o.h;
  const long long rows0 = (static_cast<long long>(b) * gridDim.y + head) * s;
  const int n_chunks = (s + tc::kRows - 1) / tc::kRows;
  // query chunk `chunk`, Q and dO, and each query's (max, denominator,
  // 1 / denominator, delta) or (lse, -, -, delta) into its stage
  auto issue = [&](int chunk) {
    const int c0 = chunk * tc::kRows, st = chunk % 2;
    tc::load_rows_async<tc::kRows, DH>(sm.rows[st][0], q_head, vw.q.r, c0, s);
    tc::load_rows_async<tc::kRows, DH>(sm.rows[st][1], do_head, vw.d_o.r, c0, s);
    if (threadIdx.x < tc::kRows && c0 + threadIdx.x < s) {
      const long long row = rows0 + c0 + threadIdx.x;
      float* r = sm.extra[st] + 4 * threadIdx.x;
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

  // the block's k and v rows through ring stage 1 into registers, with
  // the first query chunk into stage 0
  tc::load_rows_async<tc::kRows, DH>(sm.rows[1][0], k + b * vw.k.b + head * vw.k.h, vw.k.r, k0, s);
  tc::load_rows_async<tc::kRows, DH>(sm.rows[1][1], v + b * vw.v.b + head * vw.v.h, vw.v.r, k0, s);
  issue(0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  tc::a_fragments<DH>(ka, sm.rows[1][0]);
  tc::a_fragments<DH>(va, sm.rows[1][1]);
  __syncthreads();  // stage 1 takes chunk 1 next

  float dk_sum[DH / 8][4] = {}, dv_sum[DH / 8][4] = {};
  for (int t = 0; t < n_chunks; ++t) {
    const int st = tc::ring_step(t, n_chunks, issue);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const bf16* q_rows = sm.rows[st][0] + kHalf * hf * kLd;
      const bf16* do_rows = sm.rows[st][1] + kHalf * hf * kLd;
      // scores^T (k . q), then dP^T (v . dO): rows keys, columns queries;
      // each half's partials are added to the sums before the next product
      float p[kHalfTiles][4], ds[kHalfTiles][4];
      tc::product_rows<kHalfTiles, DH>(p, ka, q_rows);
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = kHalf * hf + 8 * n + 2 * c + e % 2;
          float pe = 0.f;
          if (t * tc::kRows + qi < s) {
            const float* r = sm.extra[st] + 4 * qi;
            pe = expf(__fsub_rn(scaled_score(p[n][e], scale, kb[e / 2]), r[0]));
            if (!LSE) pe = tc::div_by(pe, r[1], r[2]);
          }
          p[n][e] = pe;
        }
      {
        float part[DH / 8][4] = {};
        tc::accumulate_pairs<kHalfTiles, DH>(part, p, do_rows);
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv_sum[j][e] = __fadd_rn(dv_sum[j][e], part[j][e]);
      }
      tc::product_rows<kHalfTiles, DH>(ds, va, do_rows);
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = kHalf * hf + 8 * n + 2 * c + e % 2;
          ds[n][e] = t * tc::kRows + qi < s
                         ? __fmul_rn(__fmul_rn(p[n][e], __fsub_rn(ds[n][e], sm.extra[st][4 * qi + 3])), scale)
                         : 0.f;
        }
      {
        float part[DH / 8][4] = {};
        tc::accumulate_pairs<kHalfTiles, DH>(part, ds, q_rows);
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dk_sum[j][e] = __fadd_rn(dk_sum[j][e], part[j][e]);
      }
    }
    __syncthreads();
  }
  tc::store_rows<DH>(dk + b * vw.dk.b + head * vw.dk.h, vw.dk.r, k0 + 16 * warp, s, dk_sum);
  tc::store_rows<DH>(dv + b * vw.dv.b + head * vw.dv.h, vw.dv.r, k0 + 16 * warp, s, dv_sum);
}

}  // namespace
}  // namespace attn
}  // namespace dial
