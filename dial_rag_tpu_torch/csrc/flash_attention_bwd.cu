// Single-tile attention backward (recompute P), head_dim 32 and 64, for
// Hopper (sm_90a): f32 on the tensor cores in split TF32, bf16 on the CUDA
// cores.
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
// once); at B=32, S=128, 12 heads of 64 that is 4.03 GFLOP, 0.060 ms at 67
// TFLOP/s in f32 on the CUDA cores, 0.024 ms at 165 TFLOP/s of 3xTF32
// (495 / 3), against 50 MB of q, k, v, dO read and dq, dk, dv written,
// 0.015 ms at 3.35 TB/s: bound by operations (12 heads of 32: 2.01 GFLOP,
// 0.030 / 0.012 ms; 25 MB, 0.0075 ms).
//
// f32 (single_tile_bwd_tf32_kernel): one block per (head, batch row), one
// warp per 16 rows of the padded S (at most 8 warps, looping past 128
// rows). q, k, v and dO live in shared memory as f32 rows of DH + 4
// floats, copied 16 bytes at a time (the wrapper raises on views that are
// not 16-byte aligned), beside one [S, S + 4] f32 tile T; q and k are
// copied first and v and dO land while the scores are formed. Products in
// split TF32 (tensor_core_tf32.cuh: hi.lo + lo.hi + hi.hi by
// mma.sync.m16n8k8, about 2^-21 relative a product), every sum over S one
// partial per 64 rows added in f32 on the CUDA cores. One launch, nothing
// written to device memory between its steps:
//   1. by query tiles: Q K^T, the exact row softmax (max, exp, sum,
//      division) in place: T = P;
//   2. by key tiles: dV = P^T dO, P^T read from T's columns;
//   3. by query tiles: dP = dO V^T, delta = rowsum(dP P); dP again, dS =
//      P (dP - delta) scale in place of P, and dQ = dS K from the
//      registers;
//   4. by key tiles: dK = dS^T Q.
// Six [S, S]-by-Dh products against the bound's five: dP is formed twice,
// once for delta and once for dS, since a second [S, S] tile does not
// fit. T and the four tiles bound S: dial_attention_bwd_max_seq_f32 works
// the limit out per head width (128 at both on an H100's 227 KB: 207 KB
// at head_dim 64); past it the wrapper takes the query-blocked backward's
// split-TF32 code (flash_attention_long_bwd.cu), two passes that compute
// the same gradient at any S.
//
// bf16 (attention_bwd_dq_kernel, then attention_bwd_dkv_kernel), products
// on the CUDA cores in f32. The TPU kernel keeps about five [S, S] f32
// tiles in VMEM (5 MB at S = 512); an H100 block has 227 KB. So two
// launches:
//   (i)  dq pass, one block per (32-query tile, head, batch row): rebuild
//        the tile's P rows in the reference's order (attention_f32.cuh's
//        probabilities), delta = rowsum(dP * P) over 64-key
//        chunks, then a second sweep that recomputes dP, forms cast(scale
//        * dS) and accumulates dQ. Writes dQ and each row's max,
//        denominator and delta to an f32 scratch [B, h, S, 3].
//   (ii) dk/dv pass, one block per (32-key tile, head, batch row): the
//        tile's k and v rows in registers (2 x head_dim floats), a loop
//        over every 32-query tile that rebuilds P from the saved max and
//        denominator with the same expression, and dV += cast(P)^T dO,
//        dK += cast(scale dS)^T Q kept in registers.
// The dq pass's [32, S] score tile bounds S (dial_attention_bwd_max_seq_bf16
// works the limit out per head width: 1472 at head_dim 32 on an H100's
// 227 KB; the wrapper takes the query-blocked backward past it).
#include <cfloat>

#include "attention_f32.cuh"
#include "tensor_core_tf32.cuh"

namespace dial {
namespace attn {
namespace {

struct BwdViews {
  View q, k, v, d_o, dq, dk, dv;
};

// The views from a host array of (batch, head, row) element strides, in
// the order q, k, v, d_o, dq, dk, dv.
BwdViews read_views(const void* strides) {
  const long long* st = static_cast<const long long*>(strides);
  BwdViews vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.d_o, &vw.dq, &vw.dk, &vw.dv};
  for (int i = 0; i < 7; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return vw;
}

constexpr int kDsLd = kChunk + 1;
constexpr int kTileLd = kRows + 1;  // [32 queries, 32 keys] tiles of the dk/dv pass

template <int DH>
size_t dq_smem_bytes(int s) {
  return sizeof(float) * (static_cast<size_t>(kRows) * score_ld(s) + (2 * kChunk + kRows) * (DH + 1) +
                          kRows * kDsLd + padded_seq(s) + 2 * kRows);
}

// ---- (i) dQ, and each row's max, denominator and delta --------------------
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            const T* __restrict__ d_o, const float* __restrict__ bias, T* __restrict__ dq,
                            float* __restrict__ rows, BwdViews vw, int s, float scale) {
  constexpr int kPadH = DH + 1, kPerThread = DH / kPhases;
  extern __shared__ __align__(16) float attn_smem[];
  const int ld = score_ld(s);
  float* s_p = attn_smem;                 // [kRows, ld] probabilities
  float* s_k = s_p + kRows * ld;          // [kChunk, kPadH]
  float* s_v = s_k + kChunk * kPadH;      // [kChunk, kPadH]
  float* s_x = s_v + kChunk * kPadH;      // [kRows, kPadH] q tile, then dO tile
  float* s_ds = s_x + kRows * kPadH;      // [kRows, kDsLd] cast(scale * dS) of one chunk
  float* s_bias = s_ds + kRows * kDsLd;   // [padded S]
  float* s_m = s_bias + padded_seq(s);
  float* s_l = s_m + kRows;

  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const T* k_head = k + b * vw.k.b + head * vw.k.h;
  const T* v_head = v + b * vw.v.b + head * vw.v.h;
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;

  load_rows<kRows, DH>(s_x, q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, s);
  for (int i = threadIdx.x; i < s; i += kThreads) s_bias[i] = bias[static_cast<long long>(b) * s + i];
  __syncthreads();
  float x_row[DH];  // this thread's q row, then its dO row
#pragma unroll
  for (int d = 0; d < DH; ++d) x_row[d] = s_x[r * kPadH + d];

  probabilities<DH>(s_p, s_k, s_bias, s_m, s_l, x_row, k_head, vw.k.r, s, scale);

  load_rows<kRows, DH>(s_x, d_o + b * vw.d_o.b + head * vw.d_o.h, vw.d_o.r, q0, s);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) x_row[d] = s_x[r * kPadH + d];

  // delta[r] = sum_c dP[r, c] P[r, c], dP[r, c] = dO[r] . v[c]
  float part = 0.f;
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    load_rows<kChunk, DH>(s_v, v_head, vw.v.r, c0, s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk / kPhases; ++i) {
      const int c = j + kPhases * i;
      if (c0 + c < s) part = fmaf(dot_dh<DH>(x_row, s_v + c * kPadH), s_p[r * ld + c0 + c], part);
    }
    __syncthreads();
  }
  // the kPhases threads of row r are neighbouring lanes of one warp
#pragma unroll
  for (int off = kPhases / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  const float delta = part;

  // dQ[r, j + 8t] = sum_c cast(scale * dS[r, c]) k[c, j + 8t]
  float acc[kPerThread] = {};
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    load_rows<kChunk, DH>(s_k, k_head, vw.k.r, c0, s);
    load_rows<kChunk, DH>(s_v, v_head, vw.v.r, c0, s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk / kPhases; ++i) {
      const int c = j + kPhases * i;
      float ds = 0.f;
      if (c0 + c < s) {
        const float p = s_p[r * ld + c0 + c];
        ds = through<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dot_dh<DH>(x_row, s_v + c * kPadH), delta)), scale));
      }
      s_ds[r * kDsLd + c] = ds;
    }
    __syncthreads();
    const int n = min(kChunk, s - c0);
    for (int c = 0; c < n; ++c) {
      const float ds = s_ds[r * kDsLd + c];
#pragma unroll
      for (int t = 0; t < kPerThread; ++t) acc[t] = fmaf(ds, s_k[c * kPadH + j + kPhases * t], acc[t]);
    }
    __syncthreads();
  }
  if (q0 + r < s) {
    T* dq_row = dq + b * vw.dq.b + head * vw.dq.h + (q0 + r) * vw.dq.r;
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) dq_row[j + kPhases * t] = from_f32<T>(acc[t]);
    if (j == 0) {
      float* saved = rows + ((static_cast<long long>(b) * heads + head) * s + q0 + r) * 3;
      saved[0] = s_m[r];
      saved[1] = s_l[r];
      saved[2] = delta;
    }
  }
}

// ---- (ii) dK and dV -------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ d_o, const float* __restrict__ bias,
                             const float* __restrict__ rows, T* __restrict__ dk, T* __restrict__ dv,
                             BwdViews vw, int s, float scale) {
  constexpr int kPadH = DH + 1, kPerThread = DH / kPhases;
  __shared__ float s_q[kRows * kPadH];      // q rows of the current query tile; k tile at first
  __shared__ float s_do[kRows * kPadH];     // dO rows of the current query tile; v tile at first
  __shared__ float s_pt[kRows * kTileLd];   // cast(P)[query, key] of the tile pair
  __shared__ float s_dst[kRows * kTileLd];  // cast(scale * dS)[query, key]
  __shared__ float s_row[3 * kRows];        // max, denominator, delta of the query tile
  __shared__ float s_bias[kRows];

  const int k0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const T* q_head = q + b * vw.q.b + head * vw.q.h;
  const T* do_head = d_o + b * vw.d_o.b + head * vw.d_o.h;
  const float* rows_head = rows + (static_cast<long long>(b) * heads + head) * s * 3;
  const int c = threadIdx.x / kPhases, j = threadIdx.x % kPhases;  // key c of the tile

  load_rows<kRows, DH>(s_q, k + b * vw.k.b + head * vw.k.h, vw.k.r, k0, s);
  load_rows<kRows, DH>(s_do, v + b * vw.v.b + head * vw.v.h, vw.v.r, k0, s);
  if (threadIdx.x < kRows) s_bias[threadIdx.x] = k0 + threadIdx.x < s ? bias[static_cast<long long>(b) * s + k0 + threadIdx.x] : 0.f;
  __syncthreads();
  float k_row[DH], v_row[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    k_row[d] = s_q[c * kPadH + d];
    v_row[d] = s_do[c * kPadH + d];
  }
  __syncthreads();
  const bool key_ok = k0 + c < s;

  float dk_acc[kPerThread] = {}, dv_acc[kPerThread] = {};
  for (int q0 = 0; q0 < s; q0 += kRows) {
    load_rows<kRows, DH>(s_q, q_head, vw.q.r, q0, s);
    load_rows<kRows, DH>(s_do, do_head, vw.d_o.r, q0, s);
    for (int i = threadIdx.x; i < 3 * kRows; i += kThreads)
      s_row[i] = q0 + i / 3 < s ? rows_head[(static_cast<long long>(q0) + i / 3) * 3 + i % 3] : 1.f;
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kRows / kPhases; ++t) {
      const int qi = j + kPhases * t;
      float p = 0.f, ds = 0.f;
      if (key_ok && q0 + qi < s) {
        const float m = s_row[3 * qi], l = s_row[3 * qi + 1], delta = s_row[3 * qi + 2];
        p = prob(scaled_score(dot_dh<DH>(s_q + qi * kPadH, k_row), scale, s_bias[c]), m, l);
        ds = through<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dot_dh<DH>(s_do + qi * kPadH, v_row), delta)), scale));
      }
      s_pt[qi * kTileLd + c] = through<T>(p);
      s_dst[qi * kTileLd + c] = ds;
    }
    __syncthreads();
    const int n = min(kRows, s - q0);
    for (int qi = 0; qi < n; ++qi) {
      const float p = s_pt[qi * kTileLd + c], ds = s_dst[qi * kTileLd + c];
#pragma unroll
      for (int t = 0; t < kPerThread; ++t) {
        dv_acc[t] = fmaf(p, s_do[qi * kPadH + j + kPhases * t], dv_acc[t]);
        dk_acc[t] = fmaf(ds, s_q[qi * kPadH + j + kPhases * t], dk_acc[t]);
      }
    }
    __syncthreads();
  }
  if (key_ok) {
    T* dk_row = dk + b * vw.dk.b + head * vw.dk.h + (k0 + c) * vw.dk.r;
    T* dv_row = dv + b * vw.dv.b + head * vw.dv.h + (k0 + c) * vw.dv.r;
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      dk_row[j + kPhases * t] = from_f32<T>(dk_acc[t]);
      dv_row[j + kPhases * t] = from_f32<T>(dv_acc[t]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_attention_bwd(const T* q, const T* k, const T* v, const T* d_o, const float* bias, T* dq, T* dk,
                                 T* dv, float* rows, const BwdViews& vw, int batch, int heads, int seq, float scale,
                                 cudaStream_t stm) {
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  const size_t smem = dq_smem_bytes<DH>(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, stm>>>(q, k, v, d_o, bias, dq, rows, vw, seq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T, DH><<<grid, kThreads, 0, stm>>>(q, k, v, d_o, bias, rows, dk, dv, vw, seq, scale);
  return cudaGetLastError();
}

// q, k, v, d_o (inputs) and dq, dk, dv (outputs): device pointers to
// [B, h, S, head_dim] views of T whose (batch, head, row) element strides
// are `strides[0..20]` (a host array, in that order); bias: f32 [B, S];
// rows: f32 scratch [B, h, S, 3].
template <typename T>
int attention_bwd(const void* q, const void* k, const void* v, const void* d_o, const void* bias, void* dq, void* dk,
                  void* dv, void* rows, const void* strides, int batch, int heads, int seq, int head_dim, float scale,
                  void* stream) {
  const BwdViews vw = read_views(strides);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k), *tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(d_o);
  T *tdq = static_cast<T*>(dq), *tdk = static_cast<T*>(dk), *tdv = static_cast<T*>(dv);
  const float* fb = static_cast<const float*>(bias);
  float* fr = static_cast<float*>(rows);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return launch_attention_bwd<T, 32>(tq, tk, tv, tdo, fb, tdq, tdk, tdv, fr, vw, batch, heads, seq, scale, stm);
  if (head_dim == 64)
    return launch_attention_bwd<T, 64>(tq, tk, tv, tdo, fb, tdq, tdk, tdv, fr, vw, batch, heads, seq, scale, stm);
  return static_cast<int>(cudaErrorInvalidValue);
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

// C entry points. Tensor arguments are device pointers: q, k, v, d_o
// (inputs) and dq, dk, dv (outputs) to [B, h, S, head_dim] views whose
// (batch, head, row) element strides are `strides[0..20]` (a host array,
// in that order); bias: f32 [B, S]. Each launches on `stream` and returns
// cudaGetLastError() (0 on success); an unsupported head_dim returns
// cudaErrorInvalidValue.
//
// f32: one launch; q, k, v and d_o 16-byte aligned with strides in whole
// 16 bytes; S within dial_attention_bwd_max_seq_f32.
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

// bf16: the dq pass, then the dk/dv pass; rows: f32 scratch [B, h, S, 3];
// S within dial_attention_bwd_max_seq_bf16.
extern "C" int dial_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* d_o, const void* bias,
                                       void* dq, void* dk, void* dv, void* rows, const void* strides, int batch,
                                       int heads, int seq, int head_dim, float scale, void* stream) {
  return dial::attn::attention_bwd<dial::bf16>(q, k, v, d_o, bias, dq, dk, dv, rows, strides, batch, heads, seq,
                                               head_dim, scale, stream);
}

// C entry points. Write to *max_seq (an int) the longest S, a multiple of
// 64, whose dynamic shared memory (f32: tile_bwd_bytes; bf16: the dq
// pass's dq_smem_bytes) fits the opt-in per-block limit of the current
// device at `head_dim`; return the CUDA error of the query.
extern "C" int dial_attention_bwd_max_seq_f32(int head_dim, void* max_seq) {
  using namespace dial::attn;
  int* out = static_cast<int*>(max_seq);
  if (head_dim == 32) return static_cast<int>(max_seq_for(tile_bwd_bytes<32>, out));
  if (head_dim == 64) return static_cast<int>(max_seq_for(tile_bwd_bytes<64>, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry point. Writes to *bytes (an int) the dynamic shared memory
// (tile_bwd_bytes) a block of dial_attention_bwd_f32 is launched with at S =
// `seq` and `head_dim`; an unsupported head_dim returns
// cudaErrorInvalidValue.
extern "C" int dial_attention_bwd_smem_bytes_f32(int head_dim, int seq, void* bytes) {
  using namespace dial::attn;
  int* out = static_cast<int*>(bytes);
  if (head_dim == 32) *out = static_cast<int>(tile_bwd_bytes<32>(seq));
  else if (head_dim == 64) *out = static_cast<int>(tile_bwd_bytes<64>(seq));
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

extern "C" int dial_attention_bwd_max_seq_bf16(int head_dim, void* max_seq) {
  using namespace dial::attn;
  int* out = static_cast<int*>(max_seq);
  if (head_dim == 32) return static_cast<int>(max_seq_for(dq_smem_bytes<32>, out));
  if (head_dim == 64) return static_cast<int>(max_seq_for(dq_smem_bytes<64>, out));
  return static_cast<int>(cudaErrorInvalidValue);
}
