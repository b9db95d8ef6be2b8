// Attention forward on Hopper's tensor cores, bf16, head_dim 32 and 64
// (sm_90a).
//
// Replaces, in bf16, three TPU kernels of dial_rag_tpu/ops/flash_attention.py
// that compute one function, o = softmax(q k^T * scale + bias) v with
// bias = (1 - mask) * f32.min, the softmax exact per row, P normalised in
// f32 and cast to bf16 after the division, P . V accumulated in f32 and o
// cast to bf16 once:
//   _qkv_native_kernel (pallas_call in _qkv_native_forward): q, k, v read
//     straight from the packed [B, S, 3H] projection, o written [B, S, H];
//   _attention_kernel (pallas_call in _forward, S <= 512 or S % 256 != 0):
//     head-major [B, h, S, Dh] views;
//   _attention_q_blocked_kernel (pallas_call in _forward, 512 < S <= 4096
//     or S % 512 != 0): the same per 256-query block.
// Every operand arrives as a base pointer plus (batch, head, row) element
// strides, so the three differ only in their strides: one kernel, one
// entry point, no S limit.
//
// Bound on an H100 SXM: 4 * B * h * S^2 * Dh FLOPs at 989 TFLOP/s, against
// q, k, v and o read and written once. The packed qkv [128, 256, 3H] at 12
// heads of 64 is 25.8 GFLOP (0.026 ms) against 201 MB (0.060 ms): bound by
// bytes; [1, 12, 4096, 32] is 25.8 GFLOP (0.026 ms) against 13 MB: bound
// by operations.
//
// What held the CUDA-core kernels it replaces back: every product ran in
// f32 on the CUDA cores (67 TFLOP/s at best), bf16 exactly as slow as f32,
// and the single-tile kernel kept a [32, S] f32 score tile in shared
// memory, which capped S and occupancy. The design:
//   - a block of 4 warps owns 64 query rows (16 a warp) of one (batch row,
//     head); K and V stream through shared memory in 64-key chunks,
//     double-buffered with 16-byte cp.async copies (2 stages x K and V x
//     64 rows x (Dh + 8) bf16: 36 KB at head_dim 64, 20 KB at 32, beside
//     the q tile), so several blocks share an SM and no [rows, S] tile
//     exists;
//   - Q K^T and P . V run on the tensor cores with mma.sync m16n8k16,
//     bf16 in, f32 accumulators; fragments come by ldmatrix (V by
//     ldmatrix.trans) from rows padded by 8 bf16, so the 8 row addresses
//     of each 8x8 matrix fall on distinct banks; P goes from the score
//     accumulators straight into the A fragments of P . V in registers;
//   - two passes, as the reference's exact softmax asks: pass 1 keeps each
//     row's running max and denominator (the four lanes that share a row
//     merge them by __shfl_xor_sync); pass 2 recomputes the scores, forms
//     p = exp(s - m) / l (correctly rounded, by a reciprocal and one
//     fma correction: div_by), casts it to bf16 after the division, as
//     the TPU kernels do, and accumulates P . V in f32. No online
//     rescaling of the output, which would move where bf16 rounds;
//   - the mask bias is f32.min, never -inf, so a fully masked row stays
//     finite and uniform over its S real keys; a key past S (the ragged
//     last chunk) gets a -inf bias and weight exactly 0, and a query row
//     past S is computed on zeros and never stored.
// mma.sync and not wgmma: at head_dim 32 and 64 Q K^T is only 2-4 k-steps
// deep, and wgmma's 64-row warpgroup tiles with swizzled shared-memory
// descriptors (and TMA, warp specialisation) are the next step for a
// kernel that stays far from its bound.
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dial {
namespace tc {
namespace {

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x / l correctly rounded, from r = the correctly rounded 1 / l: q = x r
// is within an ulp of x / l, and one step q + (x - l q) r with the
// residual exact by fma rounds it correctly (Markstein) for every normal
// quotient. Three instructions where __fdiv_rn takes about nine: the
// division of every probability is a large share of this kernel's
// arithmetic.
__device__ __forceinline__ float div_by(float x, float l, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, l, x), r, q);
}

// Two f32 rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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
// `st` and writes its bias (-inf past S) there.
template <int DH>
__device__ __forceinline__ void issue_chunk(Smem<DH>& sm, int st, int chunk, const bf16* k_head, const bf16* v_head,
                                            const float* bias_row, const Views& vw, int s, bool with_v) {
  const int c0 = chunk * kKeys;
  load_rows_async<kKeys, DH>(sm.k[st], k_head, vw.k.r, c0, s);
  if (with_v) load_rows_async<kKeys, DH>(sm.v[st], v_head, vw.v.r, c0, s);
  if (threadIdx.x < kKeys) sm.bias[st][threadIdx.x] = c0 + threadIdx.x < s ? bias_row[c0 + threadIdx.x] : -INFINITY;
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

// Waits for key chunk c (started by the previous call, or by the first
// issue_chunk for c = 0) after starting chunk c + 1's copies into the
// other stage, so they fly while chunk c is computed; returns c's stage.
template <int DH>
__device__ __forceinline__ int next_chunk(Smem<DH>& sm, int c, int n_chunks, const bf16* k_head, const bf16* v_head,
                                          const float* bias_row, const Views& vw, int s, bool with_v) {
  if (c + 1 < n_chunks) {
    issue_chunk(sm, (c + 1) % kStages, c + 1, k_head, v_head, bias_row, vw, s, with_v);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return c % kStages;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const float* __restrict__ bias, bf16* __restrict__ o, Views vw, int s, float scale) {
  constexpr int kLd = Smem<DH>::kLd, kSteps = DH / 16, kDTiles = DH / 8;
  __shared__ __align__(16) Smem<DH> sm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const bf16* k_head = k + b * vw.k.b + head * vw.k.h;
  const bf16* v_head = v + b * vw.v.b + head * vw.v.h;
  const float* bias_row = bias + static_cast<long long>(b) * s;

  // the warp's 16 query rows as A fragments, in registers for both passes
  load_rows_async<kRows, DH>(sm.q, q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldmatrix_x4(qa[kk], sm.q + (16 * warp + lane % 16) * kLd + 16 * kk + (lane / 16) * 8);

  // pass 1: this lane's running max and denominator of its two rows (g
  // and g + 8) over its keys. The max starts at f32.min, not -inf, so a
  // lane none of whose keys is real yet rescales by exp(0), not exp(NaN).
  const int n_chunks = (s + kKeys - 1) / kKeys;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  issue_chunk(sm, 0, 0, k_head, v_head, bias_row, vw, s, false);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = next_chunk(sm, c, n_chunks, k_head, v_head, bias_row, vw, s, false);
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
    float mx = m[h];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = l[h] * expf(__fsub_rn(m[h], mx));
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    m_row[h] = mx;
    l_row[h] = sum;
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
    const int st = next_chunk(sm, c, n_chunks, k_head, v_head, bias_row, vw, s, true);
    float acc[kKeyTiles][4];
    chunk_scores(acc, qa, sm, st, scale);
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = div_by(expf(__fsub_rn(acc[n][e], m_row[e / 2])), l_row[e / 2], r_row[e / 2]);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      // the A fragment of keys 16 kk .. 16 kk + 15: score n-tiles 2 kk and 2 kk + 1
      const uint32_t pa[4] = {pack_bf16(acc[2 * kk][0], acc[2 * kk][1]), pack_bf16(acc[2 * kk][2], acc[2 * kk][3]),
                              pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
                              pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        // V rows (keys) 16 kk .. + 15, head columns 16 dp .. + 15, transposed
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sm.v[st] + (16 * kk + ((lane / 8) % 2) * 8 + lane % 8) * kLd + 16 * dp + (lane / 16) * 8);
        mma_bf16(oacc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(oacc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  // o rows g and g + 8 of the warp, head columns 8 n + 2 (lane % 4) + {0, 1}
  bf16* o_head = o + b * vw.o.b + head * vw.o.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= s) continue;
    bf16* o_row = o_head + row * vw.o.r + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * n) = __floats2bfloat162_rn(oacc[n][2 * h], oacc[n][2 * h + 1]);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, const Views& vw, int batch,
           int heads, int seq, float scale, void* stream) {
  attention_tc_kernel<DH><<<dim3((seq + kRows - 1) / kRows, heads, batch), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(o), vw, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tc
}  // namespace dial

// C entry point. q, k, v, o: device pointers to bf16 [B, h, S, head_dim]
// views whose (batch, head, row) element strides are `strides[0..11]` (a
// host array: q, k, v, o in turn); q, k and v 16-byte aligned with strides
// that are multiples of 8 elements, o 4-byte aligned with even strides;
// bias: f32 [B, S]. Any S >= 1; head_dim 32 or 64 (else
// cudaErrorInvalidValue). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int dial_attention_tc_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                                      const void* strides, int batch, int heads, int seq, int head_dim, float scale,
                                      void* stream) {
  using namespace dial::tc;
  const long long* st = static_cast<const long long*>(strides);
  Views vw;
  View* views[] = {&vw.q, &vw.k, &vw.v, &vw.o};
  for (int i = 0; i < 4; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  if (head_dim == 32) return launch<32>(q, k, v, bias, o, vw, batch, heads, seq, scale, stream);
  if (head_dim == 64) return launch<64>(q, k, v, bias, o, vw, batch, heads, seq, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
