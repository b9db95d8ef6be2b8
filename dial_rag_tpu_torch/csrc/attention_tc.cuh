// The exact-softmax attention forward on Hopper's tensor cores, bf16,
// head_dim 32 and 64 (sm_90a), and the pieces it shares with the
// KV-blocked forward: attention_tc.cu (TPU kernels 4-7 in bf16) and, on
// the packed qkv of its QKV projection, kernel 1's attention
// (encoder_tc.cuh) launch it.
//
// attention_tc_kernel computes o = softmax(q k^T * scale + bias) v with
// bias = (1 - mask) * f32.min [B, S], given in f32 (the attention
// wrappers) or formed from the int32 mask (kernel 1), the softmax exact
// per row, P normalised in f32 and cast to bf16 after the division, P . V
// accumulated in f32 and o cast to bf16 once. Every operand arrives as a
// base pointer plus (batch, head, row) element strides (View), so the
// packed [B, S, 3H] projection and head-major [B, h, S, Dh] views differ
// only in their strides; no S limit. attention_tc.cu's note gives the
// design: a block of 4 warps owns 64 query rows of one (batch row,
// head); K and V stream through shared memory in 64-key chunks,
// double-buffered by cp.async; Q K^T and P . V run on mma.sync m16n8k16
// from ldmatrix fragments; two passes, the first for each row's max and
// denominator, the second forming p = exp(s - max) / l (div_by) and
// accumulating P . V.
#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace dial {
namespace tc {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a block
constexpr int kKeys = 64;           // keys of a chunk
constexpr int kStages = 2;
constexpr int kKeyTiles = kKeys / 8;  // n-tiles of 8 keys in a chunk's score tile

// Element strides of one [B, h, S, Dh] operand; unit head-dim stride.
struct View {
  long long b, h, r;
};

struct Views {
  View q, k, v, o;
};

template <int DH>
struct Smem {
  static constexpr int kLd = DH + 8;  // bf16 row stride: 80 or 144 bytes
  bf16 q[kRows * kLd];
  bf16 k[kStages][kKeys * kLd];
  bf16 v[kStages][kKeys * kLd];
  float bias[kStages][kKeys];
};
static_assert(sizeof(Smem<64>) <= 48 * 1024, "the block's shared memory must fit statically");

// Rows [r0, r0 + ROWS) of one head (row stride `ld` elements) into a
// [ROWS, DH + 8] shared tile by cp.async, 16 bytes a copy; rows past S
// are zero-filled.
template <int ROWS, int DH>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* head, long long ld, int r0, int s) {
  constexpr int kVecs = DH / 8;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const bool valid = r0 + r < s;
    cp_async16(dst + r * (DH + 8) + c, valid ? head + (r0 + r) * ld + c : head, valid);
  }
}

// Starts the copies of key chunk `chunk` (K, V when `with_v`) into stage
// `st` and writes its bias (-inf past S) there, from the row's f32 bias or
// int32 mask (M).
template <int DH, typename M>
__device__ __forceinline__ void issue_chunk(Smem<DH>& sm, int st, int chunk, const bf16* k_head, const bf16* v_head,
                                            const M* bias_row, const Views& vw, int s, bool with_v) {
  const int c0 = chunk * kKeys;
  load_rows_async<kKeys, DH>(sm.k[st], k_head, vw.k.r, c0, s);
  if (with_v) load_rows_async<kKeys, DH>(sm.v[st], v_head, vw.v.r, c0, s);
  if (threadIdx.x < kKeys)
    sm.bias[st][threadIdx.x] = c0 + threadIdx.x < s ? bias_value(bias_row[c0 + threadIdx.x]) : -INFINITY;
  cp_async_commit();
}

// This warp's [16, 64] scores of the chunk in stage `st`: acc[n][e] is
// query row g + 8 (e / 2) (g = lane / 4) and key 8 n + 2 (lane % 4) +
// e % 2, as scores * scale + bias rounded as the reference rounds it.
template <int DH>
__device__ __forceinline__ void chunk_scores(float (&acc)[kKeyTiles][4], const uint32_t (&qa)[DH / 16][4],
                                             const Smem<DH>& sm, int st, float scale) {
  constexpr int kLd = Smem<DH>::kLd;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kKeyTiles / 2; ++np) {
      // keys 16 np .. 16 np + 15 (two n-tiles), head columns 16 kk .. + 15
      uint32_t b[4];
      ldmatrix_x4(b, sm.k[st] + (16 * np + (lane / 16) * 8 + lane % 8) * kLd + 16 * kk + ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], qa[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], qa[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], scale), sm.bias[st][8 * n + 2 * (lane % 4) + e % 2]);
}

// Waits for ring step t's copies (started by the previous call, or by an
// issue_chunk before the loop for t = 0) after starting step t + 1's --
// key chunk `next`, with V when `next_v` -- into the other stage, so they
// fly while step t is computed; returns step t's stage.
template <int DH, typename M>
__device__ __forceinline__ int next_chunk(Smem<DH>& sm, int t, int n_steps, int next, bool next_v,
                                          const bf16* k_head, const bf16* v_head, const M* bias_row,
                                          const Views& vw, int s) {
  if (t + 1 < n_steps) {
    issue_chunk(sm, (t + 1) % kStages, next, k_head, v_head, bias_row, vw, s, next_v);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return t % kStages;
}

// The warp's 16 query rows q0 + 16 warp .. + 15 of one head as A
// fragments, through the block's q tile; rows past S are zeros.
template <int DH>
__device__ __forceinline__ void q_fragments(uint32_t (&qa)[DH / 16][4], Smem<DH>& sm, const bf16* q_head,
                                            long long ld, int q0, int s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_rows_async<kRows, DH>(sm.q, q_head, ld, q0, s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(qa[kk], sm.q + (16 * warp + lane % 16) * Smem<DH>::kLd + 16 * kk + (lane / 16) * 8);
}

// oacc += bf16(p) . V for the chunk in stage `st`: p is this warp's
// [16, 64] score tile in chunk_scores' layout, cast to bf16 into the A
// fragments of the product straight from the registers.
template <int DH>
__device__ __forceinline__ void accumulate_pv(float (&oacc)[DH / 8][4], const float (&p)[kKeyTiles][4],
                                              const Smem<DH>& sm, int st) {
  constexpr int kLd = Smem<DH>::kLd;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    // the A fragment of keys 16 kk .. 16 kk + 15: score n-tiles 2 kk and 2 kk + 1
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      // V rows (keys) 16 kk .. + 15, head columns 16 dp .. + 15, transposed
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, sm.v[st] + (16 * kk + ((lane / 8) % 2) * 8 + lane % 8) * kLd + 16 * dp + (lane / 16) * 8);
      mma_bf16(oacc[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(oacc[2 * dp + 1], pa, bv[2], bv[3]);
    }
  }
}

// o rows g and g + 8 of the warp (below S), head columns 8 n + 2 (lane %
// 4) + {0, 1}: oacc[n][2 h + j], divided by l[h] (div_by) when DIVIDE,
// rounded to bf16 once.
template <int DH, bool DIVIDE>
__device__ __forceinline__ void store_o(bf16* o_head, long long ld, int q0, int s, const float (&oacc)[DH / 8][4],
                                        const float (&l)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= s) continue;
    bf16* o_row = o_head + row * ld + 2 * (lane % 4);
    const float r = DIVIDE ? __frcp_rn(l[h]) : 1.f;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      float a = oacc[n][2 * h], b = oacc[n][2 * h + 1];
      if (DIVIDE) a = div_by(a, l[h], r), b = div_by(b, l[h], r);
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * n) = __floats2bfloat162_rn(a, b);
    }
  }
}

// The max and the sum over the four lanes that hold one row's keys.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- _attention_kernel, _qkv_native_kernel, _attention_q_blocked_kernel ----
// bias: the f32 mask bias [B, S] (M = float) or the int32 mask (M = int32_t)
template <int DH, typename M>
__global__ void __launch_bounds__(kThreads)
    attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const M* __restrict__ bias, bf16* __restrict__ o, Views vw, int s, float scale) {
  constexpr int kDTiles = DH / 8;
  __shared__ __align__(16) Smem<DH> sm;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const bf16* k_head = k + b * vw.k.b + head * vw.k.h;
  const bf16* v_head = v + b * vw.v.b + head * vw.v.h;
  const M* bias_row = bias + static_cast<long long>(b) * s;

  // the warp's 16 query rows as A fragments, in registers for both passes
  uint32_t qa[DH / 16][4];
  q_fragments(qa, sm, q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, s);

  // pass 1: this lane's running max and denominator of its two rows (g
  // and g + 8) over its keys. The max starts at f32.min, not -inf, so a
  // lane none of whose keys is real yet rescales by exp(0), not exp(NaN).
  const int n_chunks = (s + kKeys - 1) / kKeys;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  issue_chunk(sm, 0, 0, k_head, v_head, bias_row, vw, s, false);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = next_chunk(sm, c, n_chunks, c + 1, false, k_head, v_head, bias_row, vw, s);
    float acc[kKeyTiles][4];
    chunk_scores(acc, qa, sm, st, scale);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cm = -INFINITY;
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) cm = fmaxf(cm, fmaxf(acc[n][2 * h], acc[n][2 * h + 1]));
      const float m_new = fmaxf(m[h], cm);
      float add = 0.f;
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
        add += expf(__fsub_rn(acc[n][2 * h], m_new)) + expf(__fsub_rn(acc[n][2 * h + 1], m_new));
      l[h] = l[h] * expf(__fsub_rn(m[h], m_new)) + add;
      m[h] = m_new;
    }
    __syncthreads();
  }
  // merged over the four lanes of each row: its max and sum(exp(s - max))
  float m_row[2], l_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_row[h] = quad_max(m[h]);
    l_row[h] = quad_sum(l[h] * expf(__fsub_rn(m[h], m_row[h])));
  }

  // pass 2: p = exp(s - max) / l cast to bf16, then o += P . V in f32
  const float r_row[2] = {__frcp_rn(l_row[0]), __frcp_rn(l_row[1])};
  float oacc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  issue_chunk(sm, 0, 0, k_head, v_head, bias_row, vw, s, true);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = next_chunk(sm, c, n_chunks, c + 1, true, k_head, v_head, bias_row, vw, s);
    float acc[kKeyTiles][4];
    chunk_scores(acc, qa, sm, st, scale);
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = div_by(expf(__fsub_rn(acc[n][e], m_row[e / 2])), l_row[e / 2], r_row[e / 2]);
    accumulate_pv(oacc, acc, sm, st);
    __syncthreads();
  }
  store_o<DH, false>(o + b * vw.o.b + head * vw.o.h, vw.o.r, q0, s, oacc, l_row);
}

Views read_views(const void* strides) {
  const long long* st = static_cast<const long long*>(strides);
  Views vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.o};
  for (int i = 0; i < 4; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return vw;
}

// Calls launch(std::integral_constant<int, DH>{}) at head_dim DH = 32 or
// 64 (else cudaErrorInvalidValue); returns cudaGetLastError()
template <class Launch>
int at_head_dim(int head_dim, const Launch& launch) {
  if (head_dim == 32)
    launch(std::integral_constant<int, 32>{});
  else if (head_dim == 64)
    launch(std::integral_constant<int, 64>{});
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// one block a 64-row query tile of one (head, batch row)
dim3 grid_of(int batch, int heads, int seq) { return dim3((seq + kRows - 1) / kRows, heads, batch); }

}  // namespace
}  // namespace tc
}  // namespace dial
