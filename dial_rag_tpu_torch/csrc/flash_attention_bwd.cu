// Single-tile attention backward (recompute P), f32 and bf16, head_dim 32
// and 64, for Hopper (sm_90a).
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
// written straight into a packed dqkv: no head split, no stack.
//
// Bound on an H100 SXM: 10 * B * h * S^2 * Dh FLOPs; at B=32, S=128, 12
// heads of 32 that is 2.01 GFLOP, 0.030 ms at 67 TFLOP/s in f32, against
// 25 MB of q, k, v, dO read and dq, dk, dv written, 0.0075 ms at
// 3.35 TB/s: bound by operations (12 heads of 64: 4.03 GFLOP, 0.060 ms).
//
// Design. The TPU kernel keeps about five [S, S] f32 tiles in VMEM (5 MB
// at S = 512); an H100 block has 227 KB. So two launches, no atomics, so
// that a training run is reproducible bit for bit:
//   (i)  dq pass, one block per (32-query tile, head, batch row): rebuild
//        the tile's P rows exactly as the forward does (same code,
//        attention_f32.cuh), delta = rowsum(dP * P) over 64-key chunks,
//        then a second sweep that recomputes dP, forms cast(scale * dS)
//        and accumulates dQ. Writes dQ and each row's max, denominator
//        and delta to an f32 scratch [B, h, S, 3].
//   (ii) dk/dv pass, one block per (32-key tile, head, batch row): the
//        tile's k and v rows in registers (2 x head_dim floats), a loop
//        over every 32-query tile that rebuilds P from the saved max and
//        denominator with the same expression, and dV += cast(P)^T dO,
//        dK += cast(scale dS)^T Q kept in registers.
// The dq pass's [32, S] score tile bounds S (dial_attention_bwd_max_seq
// works the limit out per head width: 1472 at head_dim 32 on an H100's
// 227 KB; the wrapper raises beyond it). Products on the CUDA cores in
// f32 for both dtypes.
#include "attention_f32.cuh"

namespace dial {
namespace attn {
namespace {

struct BwdViews {
  View q, k, v, d_o, dq, dk, dv;
};

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
  const long long* st = static_cast<const long long*>(strides);
  BwdViews vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.d_o, &vw.dq, &vw.dk, &vw.dv};
  for (int i = 0; i < 7; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
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

}  // namespace
}  // namespace attn
}  // namespace dial

// C entry points, one per dtype. Launch the dq pass, then the dk/dv pass,
// on `stream`; return cudaGetLastError() (0 on success); an unsupported
// head_dim returns cudaErrorInvalidValue.
extern "C" int dial_attention_bwd_f32(const void* q, const void* k, const void* v, const void* d_o, const void* bias,
                                      void* dq, void* dk, void* dv, void* rows, const void* strides, int batch,
                                      int heads, int seq, int head_dim, float scale, void* stream) {
  return dial::attn::attention_bwd<float>(q, k, v, d_o, bias, dq, dk, dv, rows, strides, batch, heads, seq, head_dim,
                                          scale, stream);
}

extern "C" int dial_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* d_o, const void* bias,
                                       void* dq, void* dk, void* dv, void* rows, const void* strides, int batch,
                                       int heads, int seq, int head_dim, float scale, void* stream) {
  return dial::attn::attention_bwd<dial::bf16>(q, k, v, d_o, bias, dq, dk, dv, rows, strides, batch, heads, seq,
                                               head_dim, scale, stream);
}

// C entry point. Writes to *max_seq (an int) the longest S, a multiple of
// 64, whose dynamic shared memory (dq_smem_bytes, the same for both
// dtypes) fits the opt-in per-block limit of the current device at
// `head_dim`; returns the CUDA error of the query.
extern "C" int dial_attention_bwd_max_seq(int head_dim, void* max_seq) {
  using namespace dial::attn;
  int* out = static_cast<int*>(max_seq);
  if (head_dim == 32) return static_cast<int>(max_seq_for(dq_smem_bytes<32>, out));
  if (head_dim == 64) return static_cast<int>(max_seq_for(dq_smem_bytes<64>, out));
  return static_cast<int>(cudaErrorInvalidValue);
}
