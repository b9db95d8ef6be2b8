// Single-tile attention backward (recompute P), head_dim 32 and 64, for
// Hopper (sm_90a): f32 on the tensor cores in split TF32, bf16 on the bf16
// tensor cores.
//
// Replaces: dial_rag_tpu/ops/flash_attention.py::_attention_bwd_kernel
// (pallas_call in _backward, S <= 512 or S % 256 != 0), the backward of both
// fused_qkv_attention and flash_attention. With S = scale q k^T + bias,
// P = softmax(S) and O = P V:
//   dV = cast(P)^T dO;  dP = dO V^T;  dS = P * (dP - rowsum(dP * P));
//   dQ = cast(scale dS) K;  dK = cast(scale dS)^T Q,
// with the reference's casts to the input dtype T (identities in f32): P
// before dV, scale * dS before dQ and dK; dS itself from the f32 P; the
// gradients stored in T. Operands are strided views as in
// flash_attention_fwd.cu, so the gradients of a packed [B, S, 3H] qkv are
// written straight into a packed dqkv: no head split, no stack. No
// atomics: two calls give the same bits.
//
// Bound on an H100 SXM: 10 * B * h * S^2 * Dh FLOPs (each [S, S] product
// once) against q, k, v, dO read and dq, dk, dv written. At B=32, S=128,
// 12 heads of 64: 4.03 GFLOP and, in f32, 50 MB: 0.060 ms at 67 TFLOP/s
// on the CUDA cores, 0.024 ms at 165 TFLOP/s of 3xTF32 (495 / 3), 0.015
// ms at 3.35 TB/s: bound by operations (12 heads of 32: 2.01 GFLOP,
// 0.030 / 0.012 ms; 25 MB, 0.0075 ms). In bf16 44 MB, 0.013 ms, against
// 0.004 ms at 989 TFLOP/s: bound by bytes (12 heads of 32: 22 MB, 0.0066
// ms).
//
// Both dtypes: one block per (head, batch row), one warp per 16 rows of
// the padded S. q, k, v and dO live in shared memory, copied 16 bytes at
// a time (the wrappers raise on views that are not 16-byte aligned); q
// and k are copied first and v and dO land while the scores are formed.
//
// f32 (single_tile_bwd_tf32_kernel): at most 8 warps, looping past 128
// rows. q, k, v and dO as f32 rows of DH + 4 floats beside one [S, S + 4]
// f32 tile T. Products in split TF32 (tensor_core_tf32.cuh: hi.lo + lo.hi
// + hi.hi by mma.sync.m16n8k8, about 2^-21 relative a product), every sum
// over S one partial per 64 rows added in f32 on the CUDA cores. One
// launch, nothing written to device memory between its steps:
//   1. by query tiles: Q K^T, the exact row softmax (max, exp, sum,
//      division) in place: T = P;
//   2. by key tiles: dV = P^T dO, P^T read from T's columns;
//   3. by query tiles: dP = dO V^T, delta = rowsum(dP P); dP again, dS =
//      P (dP - delta) scale in place of P, and dQ = dS K from the
//      registers;
//   4. by key tiles: dK = dS^T Q.
// Six [S, S]-by-Dh products against the bound's five: dP is formed twice,
// once for delta and once for dS, since a second [S, S] f32 tile does not
// fit. T and the four tiles bound S: dial_attention_bwd_max_seq_f32 works
// the limit out per head width (128 at both on an H100's 227 KB: 207 KB
// at head_dim 64).
//
// bf16 (single_tile_bwd_tc_kernel): products on mma.sync.m16n8k16 bf16
// with f32 accumulators (tensor_core.cuh; a bf16 x bf16 product is exact
// in f32), from ldmatrix fragments. q, k, v and dO as bf16 rows of DH + 8
// (attention_bwd_tc.cuh's layout: ldmatrix's eight row addresses on
// distinct banks) beside two bf16 [S, S + 8] tiles, bf16(P) and bf16(scale
// dS), rows queries. One launch:
//   1. by query tiles, a warp's 16 rows over every key in registers: Q K^T,
//      the exact row softmax (max, exp, sum, division) in f32; bf16(P)
//      into its tile; dP = dO V^T, delta = rowsum(dP P), dS = P (dP -
//      delta) scale in f32, bf16(dS) into its tile, and dQ = bf16(dS) K
//      from the registers (two adjacent score n-tiles are one k16 A
//      fragment);
//   2. by key tiles: dV = bf16(P)^T dO and dK = bf16(dS)^T Q, both tiles
//      read transposed by ldmatrix.trans as the A operand, dO and q by
//      ldmatrix.trans as the B operand;
//   3. dQ, dK and dV rounded to bf16 into staging tiles in place of q, k
//      and v, then written out 16 bytes a store (the wrapper raises on
//      gradient views that are not 16-byte aligned).
// Five [S, S]-by-Dh products, the bound's count: a second [S, S] tile fits
// in bf16 (two take 68 KB at S = 128). A warp holds its rows' scores and
// dP over the whole padded S in registers (2 x 64 floats a lane at S =
// 128), which caps the kernel at S = 128 (kTcMaxKeys);
// dial_attention_bwd_max_seq_bf16 gives the smaller of that and the longest
// S whose shared memory fits (on an H100: 192 at head_dim 32, 128 at 64,
// where a block takes 143872 B). At 180-182 registers a thread, one block
// of 8 warps runs on an SM at S = 128. The staging of step 3 replaced
// two-byte stores of each gradient value from its fragment, which made
// the kernel 1.4-2.9x slower (dial_rag_tpu_torch/scripts/
// bwd_single_tile_variants.py builds that variant; PERF.md has the
// reading).
//
// Past either dtype's limit the wrapper takes the query-blocked backward's
// code (flash_attention_long_bwd.cu: split TF32 in f32, attention_bwd_tc.cuh
// in bf16), two passes that compute the same gradient at any S.
#include <cfloat>

#include "attention_bwd_tc.cuh"
#include "tensor_core_tf32.cuh"

namespace dial {
namespace attn {
namespace {

// The views from a host array of (batch, head, row) element strides, in
// the order q, k, v, d_o, dq, dk, dv (attention_bwd_tc.cuh's BwdViews; o
// is not read).
BwdViews read_views(const void* strides) {
  const long long* st = static_cast<const long long*>(strides);
  BwdViews vw{};
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.d_o, &vw.dq, &vw.dk, &vw.dv};
  for (int i = 0; i < 7; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return vw;
}

// ---- bf16: the tensor-core single-tile backward ------------------------------
constexpr int kTcMaxKeys = 128;  // the longest padded S whose scores and dP a warp holds in registers

// Dynamic shared memory at sequence length s (padded to 64): q, k, v and
// dO as [padded, DH + 8] bf16 tiles, bf16(P) and bf16(scale dS) as
// [padded, padded + 8] (rows queries; a row stride of 16 bytes modulo 128
// puts ldmatrix's eight rows on distinct banks) and the bias row.
template <int DH>
size_t tile_bwd_tc_bytes(int s) {
  const size_t padded = padded_seq(s);
  return sizeof(bf16) * (4 * padded * tc::kRowLd<DH> + 2 * padded * (padded + 8)) + sizeof(float) * padded;
}

// Rows [0, padded) of one head of a bf16 view into a [padded, DH + 8]
// tile by 16-byte cp.async copies (every thread of the block takes part),
// zero-filled past s.
template <int DH>
__device__ __forceinline__ void copy_rows_bf16(bf16* dst, const bf16* head, long long row_stride, int padded,
                                               int s) {
  constexpr int kVecs = DH / 8;
  for (int i = threadIdx.x; i < padded * kVecs; i += blockDim.x) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const bool valid = r < s;
    tc::cp_async16(dst + r * tc::kRowLd<DH> + c, valid ? head + r * row_stride + c : head, valid);
  }
}

// acc += T[:rows, 16 keys at t_cols]^T R over the first `rows` queries (a
// multiple of 16): T a bf16 tile with row stride ld (rows queries: bf16(P)
// or bf16(scale dS)) and R a [*, DH + 8] bf16 tile (dO or q), both read
// transposed by ldmatrix.trans, T as the A operand (matrix j = lane / 8 of
// a fragment: queries 8 (j / 2) .., keys 8 (j % 2) ..), R as the B operand.
template <int DH>
__device__ __forceinline__ void transposed_product_tc(float (&acc)[DH / 8][4], const bf16* t_cols, int ld,
                                                      const bf16* r_rows, int rows) {
  const int lane = threadIdx.x % 32;
  for (int q0 = 0; q0 < rows; q0 += 16) {
    uint32_t a[4];
    tc::ldmatrix_x4_trans(a, t_cols + (q0 + 8 * (lane / 16) + lane % 8) * ld + 8 * ((lane / 8) % 2));
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, r_rows + (q0 + ((lane / 8) % 2) * 8 + lane % 8) * tc::kRowLd<DH> + 16 * dp +
                                   (lane / 16) * 8);
      tc::mma_bf16(acc[2 * dp], a, b[0], b[1]);
      tc::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Rows [0, s) of a [*, DH + 8] bf16 staging tile into one head of a bf16
// view, 16 bytes a store (every thread of the block takes part).
template <int DH>
__device__ __forceinline__ void store_staged(bf16* head, long long row_stride, const bf16* tile, int s) {
  constexpr int kVecs = DH / 8;
  for (int i = threadIdx.x; i < s * kVecs; i += blockDim.x) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    *reinterpret_cast<uint4*>(head + r * row_stride + c) =
        *reinterpret_cast<const uint4*>(tile + r * tc::kRowLd<DH> + c);
  }
}

// A warp's D-layout [16, 8 N] tile (x[n]: columns 8 n .. 8 n + 7) into
// rows 16 warp .. + 15 of a bf16 tile with row stride ld, rounded to bf16,
// a pair of values a store; rows at or past s are written as 0.
template <int N>
__device__ __forceinline__ void store_tile_bf16(bf16* tile, int ld, const float (&x)[N][4], int s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + lane / 4 + 8 * h;
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile + row * ld + 2 * (lane % 4));
#pragma unroll
    for (int n = 0; n < N; ++n) dst[4 * n] = row < s ? tc::pack_bf16(x[n][2 * h], x[n][2 * h + 1]) : 0u;
  }
}

// NT = padded S / 8 (8 or 16): the warps' score tiles are [16, 8 NT] over
// every key; a block has padded S / 16 warps.
template <int DH, int NT>
__global__ void __launch_bounds__(2 * kTcMaxKeys)
    single_tile_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                              const bf16* __restrict__ d_o, const float* __restrict__ bias, bf16* __restrict__ dq,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, BwdViews vw, int s, float scale) {
  constexpr int kPadded = 8 * NT, kLd = tc::kRowLd<DH>, kTileLd = kPadded + 8;
  extern __shared__ __align__(16) unsigned char bwd_tc_smem[];
  bf16* s_q = reinterpret_cast<bf16*>(bwd_tc_smem);
  bf16* s_k = s_q + kPadded * kLd;
  bf16* s_v = s_k + kPadded * kLd;
  bf16* s_do = s_v + kPadded * kLd;
  bf16* s_p = s_do + kPadded * kLd;
  bf16* s_ds = s_p + kPadded * kTileLd;
  float* s_bias = reinterpret_cast<float*>(s_ds + kPadded * kTileLd);
  const int head = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;

  // q and k in the first copy group, v and dO in the second
  copy_rows_bf16<DH>(s_q, q + b * vw.q.b + head * vw.q.h, vw.q.r, kPadded, s);
  copy_rows_bf16<DH>(s_k, k + b * vw.k.b + head * vw.k.h, vw.k.r, kPadded, s);
  tc::cp_async_commit();
  copy_rows_bf16<DH>(s_v, v + b * vw.v.b + head * vw.v.h, vw.v.r, kPadded, s);
  copy_rows_bf16<DH>(s_do, d_o + b * vw.d_o.b + head * vw.d_o.h, vw.d_o.r, kPadded, s);
  tc::cp_async_commit();
  for (int i = threadIdx.x; i < kPadded; i += blockDim.x)
    s_bias[i] = i < s ? bias[static_cast<long long>(b) * s + i] : -INFINITY;
  tc::cp_async_wait<1>();
  __syncthreads();

  // 1. the warp's 16 queries, rows g and g + 8 of its D tiles: x[n][e] is
  // key 8 n + 2c + e % 2 of row g + 8 (e / 2). P = softmax(q k^T scale +
  // bias) in place of the scores (key 0 is real, so the max is finite)
  float x[NT][4];
  {
    uint32_t qa[DH / 16][4];
    tc::a_fragments<DH>(qa, s_q);
    tc::product_rows<NT, DH>(x, qa, s_k);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, r[2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[n][e] = scaled_score(x[n][e], scale, s_bias[8 * n + 2 * c + e % 2]);
      m[e / 2] = fmaxf(m[e / 2], x[n][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = tc::quad_max(m[h]);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[n][e] = expf(__fsub_rn(x[n][e], m[e / 2]));
      l[e / 2] += x[n][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = tc::quad_sum(l[h]);
    r[h] = __frcp_rn(l[h]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = tc::div_by(x[n][e], l[e / 2], r[e / 2]);
  store_tile_bf16(s_p, kTileLd, x, s);

  tc::cp_async_wait<0>();
  __syncthreads();
  // dP = dO v^T, delta = rowsum(dP P), dS = P (dP - delta) scale in place
  // of dP; bf16(dS) into its tile and dQ = bf16(dS) k
  float dp[NT][4];
  {
    uint32_t doa[DH / 16][4];
    tc::a_fragments<DH>(doa, s_do);
    tc::product_rows<NT, DH>(dp, doa, s_v);
  }
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) delta[e / 2] = fmaf(dp[n][e], x[n][e], delta[e / 2]);
#pragma unroll
  for (int h = 0; h < 2; ++h) delta[h] = tc::quad_sum(delta[h]);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[n][e] = __fmul_rn(__fmul_rn(x[n][e], __fsub_rn(dp[n][e], delta[e / 2])), scale);
  store_tile_bf16(s_ds, kTileLd, dp, s);
  float dq_acc[DH / 8][4] = {};
  tc::accumulate_pairs<NT, DH>(dq_acc, dp, s_k);
  __syncthreads();

  // 2. the warp's 16 keys: dV = bf16(P)^T dO, dK = bf16(dS)^T q over the
  // queries below S rounded up to 16 (the tiles' rows past S are 0)
  const int rows = (s + 15) / 16 * 16;
  float dv_acc[DH / 8][4] = {}, dk_acc[DH / 8][4] = {};
  transposed_product_tc<DH>(dv_acc, s_p + 16 * warp, kTileLd, s_do, rows);
  transposed_product_tc<DH>(dk_acc, s_ds + 16 * warp, kTileLd, s_q, rows);
  __syncthreads();

  // the three gradients through staging tiles in place of q, k and v, out
  // in 16-byte stores
  store_tile_bf16(s_q, kLd, dq_acc, s);
  store_tile_bf16(s_k, kLd, dk_acc, s);
  store_tile_bf16(s_v, kLd, dv_acc, s);
  __syncthreads();
  store_staged<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, s_q, s);
  store_staged<DH>(dk + b * vw.dk.b + head * vw.dk.h, vw.dk.r, s_k, s);
  store_staged<DH>(dv + b * vw.dv.b + head * vw.dv.h, vw.dv.r, s_v, s);
}

template <int DH>
int launch_single_tile_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* d_o, const float* bias,
                          bf16* dq, bf16* dk, bf16* dv, const BwdViews& vw, int batch, int heads, int seq,
                          float scale, cudaStream_t stm) {
  const int padded = padded_seq(seq);
  if (seq < 1 || padded > kTcMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = padded == 64 ? single_tile_bwd_tc_kernel<DH, 8> : single_tile_bwd_tc_kernel<DH, 16>;
  const size_t smem = tile_bwd_tc_bytes<DH>(seq);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(heads, batch), 32 * (padded / 16), smem, stm>>>(q, k, v, d_o, bias, dq, dk, dv, vw, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: the split-TF32 single-tile backward -------------------------------
constexpr int kTileWarps = 8;   // warps a block has at most: one 16-row tile each at S = 128
constexpr int kHalfKeys = 32;   // keys of one dP product in step 3 (two make a 64-key partial)

// Dynamic shared memory at sequence length s (padded to 64): q, k, v and
// dO as [padded, kLd] tiles, T as [padded, padded + 4] (rows queries; a
// row stride of 4 modulo 16 puts load_a_pairs_t's lanes on 32 banks) and
// the bias row.
template <int DH>
size_t tile_bwd_bytes(int s) {
  const size_t padded = padded_seq(s);
  return sizeof(float) * (4 * padded * tf32::kLd<DH> + padded * (padded + 4) + padded);
}

// acc += T[:, 16 columns at t_cols]^T R over the padded rows (queries), R a
// [padded, kLd] tile (dO or q); one partial per 64 rows added in f32.
template <int DH>
__device__ __forceinline__ void transposed_product(float (&acc)[DH / 8][4], const float* t_cols, int ld,
                                                   const float* rows, int padded) {
  for (int r0 = 0; r0 < padded; r0 += 64) {
    float part[DH / 8][4] = {};
#pragma unroll 1
    for (int n = 0; n < 8; ++n) {
      tf32::FragA fa;
      tf32::load_a_pairs_t(fa, t_cols + (r0 + 8 * n) * ld, ld);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        tf32::FragB fb;
        tf32::load_b_pairs(fb, rows + (r0 + 8 * n) * tf32::kLd<DH> + 8 * j, tf32::kLd<DH>);
        tf32::mma3(part[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
  }
}

template <int DH>
__global__ void __launch_bounds__(32 * kTileWarps)
    single_tile_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ d_o,
                                const float* __restrict__ bias, float* __restrict__ dq, float* __restrict__ dk,
                                float* __restrict__ dv, BwdViews vw, int s, float scale) {
  constexpr int kL = tf32::kLd<DH>;
  extern __shared__ __align__(16) float bwd_smem[];
  const int padded = padded_seq(s), ld = padded + 4, n_tiles = padded / 16;
  float* s_q = bwd_smem;
  float* s_k = s_q + padded * kL;
  float* s_v = s_k + padded * kL;
  float* s_do = s_v + padded * kL;
  float* s_t = s_do + padded * kL;
  float* s_bias = s_t + padded * ld;
  const int head = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, n_warps = blockDim.x / 32, lane = threadIdx.x % 32, c = lane % 4;

  // q and k in the first copy group, v and dO in the second
  tf32::copy_rows_async<DH>(s_q, q + b * vw.q.b + head * vw.q.h, vw.q.r, 0, padded, s, blockDim.x);
  tf32::copy_rows_async<DH>(s_k, k + b * vw.k.b + head * vw.k.h, vw.k.r, 0, padded, s, blockDim.x);
  tc::cp_async_commit();
  tf32::copy_rows_async<DH>(s_v, v + b * vw.v.b + head * vw.v.h, vw.v.r, 0, padded, s, blockDim.x);
  tf32::copy_rows_async<DH>(s_do, d_o + b * vw.d_o.b + head * vw.d_o.h, vw.d_o.r, 0, padded, s, blockDim.x);
  tc::cp_async_commit();
  for (int i = threadIdx.x; i < padded; i += blockDim.x)
    s_bias[i] = i < s ? bias[static_cast<long long>(b) * s + i] : -INFINITY;
  tc::cp_async_wait<1>();
  __syncthreads();

  // 1. P = softmax(q k^T scale + bias) into T, by 16-query tiles. A lane
  // holds row g, columns 8 n + 2c, + 1 (t_row), and row g + 8 (t_row + 8 ld)
  for (int rt = warp; rt < n_tiles; rt += n_warps) {
    float* t_row = s_t + (16 * rt + lane / 4) * ld + 2 * c;
    float m[2] = {-INFINITY, -INFINITY};
    for (int kc = 0; kc < padded; kc += 64) {
      float x[8][4];
      tf32::product_rows<8, DH>(x, s_q + 16 * rt * kL, s_k + kc * kL);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* kb = s_bias + kc + 8 * n + 2 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) x[n][e] = scaled_score(x[n][e], scale, kb[e % 2]);
        m[0] = fmaxf(m[0], fmaxf(x[n][0], x[n][1]));
        m[1] = fmaxf(m[1], fmaxf(x[n][2], x[n][3]));
        *reinterpret_cast<float2*>(t_row + kc + 8 * n) = make_float2(x[n][0], x[n][1]);
        *reinterpret_cast<float2*>(t_row + 8 * ld + kc + 8 * n) = make_float2(x[n][2], x[n][3]);
      }
    }
    // per row: the max over its four lanes (key 0 is real, so it is
    // finite), e = exp(s - max), the sum, then p = e / sum
    float l[2] = {0.f, 0.f}, r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = tf32::quad_max(m[h]);
    for (int kk = 0; kk < padded; kk += 8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(t_row + 8 * h * ld + kk);
        float2 e = *p;
        e.x = expf(__fsub_rn(e.x, m[h]));
        e.y = expf(__fsub_rn(e.y, m[h]));
        l[h] += e.x + e.y;
        *p = e;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = tf32::quad_sum(l[h]);
      r[h] = __frcp_rn(l[h]);
    }
    for (int kk = 0; kk < padded; kk += 8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(t_row + 8 * h * ld + kk);
        float2 e = *p;
        e.x = tc::div_by(e.x, l[h], r[h]);
        e.y = tc::div_by(e.y, l[h], r[h]);
        *p = e;
      }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // 2. dV = P^T dO by 16-key tiles (a tile wholly past S has no row to store)
  for (int kt = warp; kt < n_tiles; kt += n_warps) {
    if (16 * kt >= s) continue;
    float acc[DH / 8][4] = {};
    transposed_product<DH>(acc, s_t + 16 * kt, ld, s_do, padded);
    tf32::store_rows<DH>(dv + b * vw.dv.b + head * vw.dv.h, vw.dv.r, 16 * kt, s, acc);
  }
  __syncthreads();  // every warp has read P before step 3 turns it into dS

  // 3. by 16-query tiles: delta = rowsum(dP P), then dS = P (dP - delta)
  // scale in place of P and dQ = dS k, one partial per 64 keys
  for (int rt = warp; rt < n_tiles; rt += n_warps) {
    const float* do_rows = s_do + 16 * rt * kL;
    float* t_row = s_t + (16 * rt + lane / 4) * ld + 2 * c;
    float dsum[2] = {0.f, 0.f};
    for (int kc = 0; kc < padded; kc += kHalfKeys) {
      float dp[kHalfKeys / 8][4];
      tf32::product_rows<kHalfKeys / 8, DH>(dp, do_rows, s_v + kc * kL);
#pragma unroll
      for (int n = 0; n < kHalfKeys / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 p = *reinterpret_cast<const float2*>(t_row + 8 * h * ld + kc + 8 * n);
          dsum[h] = fmaf(dp[n][2 * h + 1], p.y, fmaf(dp[n][2 * h], p.x, dsum[h]));
        }
    }
    float delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) delta[h] = tf32::quad_sum(dsum[h]);
    float acc[DH / 8][4] = {}, part[DH / 8][4] = {};
    for (int kc = 0; kc < padded; kc += kHalfKeys) {
      float ds[kHalfKeys / 8][4];
      tf32::product_rows<kHalfKeys / 8, DH>(ds, do_rows, s_v + kc * kL);
#pragma unroll
      for (int n = 0; n < kHalfKeys / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* pp = reinterpret_cast<float2*>(t_row + 8 * h * ld + kc + 8 * n);
          const float2 p = *pp;
          ds[n][2 * h] = __fmul_rn(__fmul_rn(p.x, __fsub_rn(ds[n][2 * h], delta[h])), scale);
          ds[n][2 * h + 1] = __fmul_rn(__fmul_rn(p.y, __fsub_rn(ds[n][2 * h + 1], delta[h])), scale);
          *pp = make_float2(ds[n][2 * h], ds[n][2 * h + 1]);
        }
      tf32::accumulate_pairs<kHalfKeys / 8, DH>(part, ds, s_k + kc * kL);
      if (kc % 64 == kHalfKeys) {
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
            part[j][e] = 0.f;
          }
      }
    }
    tf32::store_rows<DH>(dq + b * vw.dq.b + head * vw.dq.h, vw.dq.r, 16 * rt, s, acc);
  }
  __syncthreads();

  // 4. dK = dS^T q by 16-key tiles
  for (int kt = warp; kt < n_tiles; kt += n_warps) {
    if (16 * kt >= s) continue;
    float acc[DH / 8][4] = {};
    transposed_product<DH>(acc, s_t + 16 * kt, ld, s_q, padded);
    tf32::store_rows<DH>(dk + b * vw.dk.b + head * vw.dk.h, vw.dk.r, 16 * kt, s, acc);
  }
}

template <int DH>
int launch_single_tile_tf32(const float* q, const float* k, const float* v, const float* d_o, const float* bias,
                            float* dq, float* dk, float* dv, const BwdViews& vw, int batch, int heads, int seq,
                            float scale, cudaStream_t stm) {
  const size_t smem = tile_bwd_bytes<DH>(seq);
  const cudaError_t err = cudaFuncSetAttribute(single_tile_bwd_tf32_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = padded_seq(seq) / 16 < kTileWarps ? padded_seq(seq) / 16 : kTileWarps;
  single_tile_bwd_tf32_kernel<DH><<<dim3(heads, batch), 32 * warps, smem, stm>>>(q, k, v, d_o, bias, dq, dk, dv,
                                                                                  vw, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace attn
}  // namespace dial

// C entry points, one per dtype. Tensor arguments are device pointers: q,
// k, v, d_o (inputs) and dq, dk, dv (outputs) to [B, h, S, head_dim] views
// of the entry's dtype whose (batch, head, row) element strides are
// `strides[0..20]` (a host array, in that order), q, k, v and d_o 16-byte
// aligned with strides in whole 16 bytes (in bf16 dq, dk and dv too);
// bias: f32 [B, S]; S within the
// dtype's dial_attention_bwd_max_seq_*. Each makes one launch on `stream`
// and returns cudaGetLastError() (0 on success); an unsupported head_dim
// or S returns cudaErrorInvalidValue.
extern "C" int dial_attention_bwd_f32(const void* q, const void* k, const void* v, const void* d_o, const void* bias,
                                      void* dq, void* dk, void* dv, const void* strides, int batch, int heads,
                                      int seq, int head_dim, float scale, void* stream) {
  using namespace dial::attn;
  const BwdViews vw = read_views(strides);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fdo = static_cast<const float*>(d_o),
              *fb = static_cast<const float*>(bias);
  float *fdq = static_cast<float*>(dq), *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return launch_single_tile_tf32<32>(fq, fk, fv, fdo, fb, fdq, fdk, fdv, vw, batch, heads, seq, scale, stm);
  if (head_dim == 64)
    return launch_single_tile_tf32<64>(fq, fk, fv, fdo, fb, fdq, fdk, fdv, vw, batch, heads, seq, scale, stm);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dial_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* d_o, const void* bias,
                                       void* dq, void* dk, void* dv, const void* strides, int batch, int heads,
                                       int seq, int head_dim, float scale, void* stream) {
  using namespace dial::attn;
  using dial::bf16;
  const BwdViews vw = read_views(strides);
  const bf16 *tq = static_cast<const bf16*>(q), *tk = static_cast<const bf16*>(k), *tv = static_cast<const bf16*>(v),
             *tdo = static_cast<const bf16*>(d_o);
  const float* fb = static_cast<const float*>(bias);
  bf16 *tdq = static_cast<bf16*>(dq), *tdk = static_cast<bf16*>(dk), *tdv = static_cast<bf16*>(dv);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return launch_single_tile_tc<32>(tq, tk, tv, tdo, fb, tdq, tdk, tdv, vw, batch, heads, seq, scale, stm);
  if (head_dim == 64)
    return launch_single_tile_tc<64>(tq, tk, tv, tdo, fb, tdq, tdk, tdv, vw, batch, heads, seq, scale, stm);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry points. Write to *max_seq (an int) the longest S, a multiple of
// 64, whose dynamic shared memory (f32: tile_bwd_bytes; bf16:
// tile_bwd_tc_bytes) fits the opt-in per-block limit of the current device
// at `head_dim`, in bf16 at most kTcMaxKeys; return the CUDA error of the
// query.
extern "C" int dial_attention_bwd_max_seq_f32(int head_dim, void* max_seq) {
  using namespace dial::attn;
  int* out = static_cast<int*>(max_seq);
  if (head_dim == 32) return static_cast<int>(max_seq_for(tile_bwd_bytes<32>, out));
  if (head_dim == 64) return static_cast<int>(max_seq_for(tile_bwd_bytes<64>, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dial_attention_bwd_max_seq_bf16(int head_dim, void* max_seq) {
  using namespace dial::attn;
  int* out = static_cast<int*>(max_seq);
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 32) err = max_seq_for(tile_bwd_tc_bytes<32>, out);
  if (head_dim == 64) err = max_seq_for(tile_bwd_tc_bytes<64>, out);
  if (err == cudaSuccess && *out > kTcMaxKeys) *out = kTcMaxKeys;
  return static_cast<int>(err);
}

// C entry points. Write to *bytes (an int) the dynamic shared memory
// (f32: tile_bwd_bytes; bf16: tile_bwd_tc_bytes) a block of the dtype's
// backward is launched with at S = `seq` and `head_dim`; an unsupported
// head_dim returns cudaErrorInvalidValue.
extern "C" int dial_attention_bwd_smem_bytes_f32(int head_dim, int seq, void* bytes) {
  using namespace dial::attn;
  int* out = static_cast<int*>(bytes);
  if (head_dim == 32) *out = static_cast<int>(tile_bwd_bytes<32>(seq));
  else if (head_dim == 64) *out = static_cast<int>(tile_bwd_bytes<64>(seq));
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

extern "C" int dial_attention_bwd_smem_bytes_bf16(int head_dim, int seq, void* bytes) {
  using namespace dial::attn;
  int* out = static_cast<int*>(bytes);
  if (head_dim == 32) *out = static_cast<int>(tile_bwd_tc_bytes<32>(seq));
  else if (head_dim == 64) *out = static_cast<int>(tile_bwd_tc_bytes<64>(seq));
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}
