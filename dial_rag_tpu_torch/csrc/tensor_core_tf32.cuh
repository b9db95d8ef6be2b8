// Split-TF32 (3xTF32) building blocks for the f32 attention kernels on
// Hopper's tensor cores (sm_90a): flash_attention_long.cu's query-blocked
// forward and flash_attention_long_bwd.cu's query-blocked and KV-blocked
// backwards (TPU kernels 6, 9, 10 and 11 in f32), flash_attention_fwd.cu's
// single-tile forward and flash_attention_bwd.cu's single-tile backward
// (TPU kernels 4, 5 and 8 in f32).
//
// The method. An f32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), each rounded to nearest with ties away (cvt.rna.tf32.f32,
// 10 explicit mantissa bits; x - hi is exact in f32). hi + lo keeps about
// 22 of x's 24 bits. A product a b is taken as hi_a lo_b + lo_a hi_b +
// hi_a hi_b, three mma.sync.m16n8k8 TF32 products into one f32
// accumulator, the small terms first as CUTLASS's MmaTensorOpFastF32
// orders them; lo_a lo_b (about 2^-22 of a b) is dropped, so a product is
// good to about 2^-21 relative. The TPU reference asks for
// Precision.HIGHEST on these f32 products, itself an emulation of f32 by
// several bf16 passes on the MXU; three TF32 passes are Hopper's
// counterpart, at 495 / 3 = 165 TFLOP/s of f32-grade products against the
// CUDA cores' 67. The accumulator of one mma sums in the tensor core's own
// rounding, so the kernels keep every long sum (over the keys or the
// queries) as per-chunk partials added in f32 on the CUDA cores.
//
// Fragment layout of mma.sync.m16n8k8 .tf32 (PTX ISA), lane =
// threadIdx.x % 32, g = lane / 4, c = lane % 4:
//   A [16 x 8]: a0 (row g, k c), a1 (row g + 8, k c), a2 (row g, k c + 4),
//     a3 (row g + 8, k c + 4);
//   B [8 x 8]: b0 (k c, column g), b1 (k c + 4, column g);
//   D [16 x 8] f32: d0, d1 row g, columns 2c, 2c + 1; d2, d3 row g + 8.
// A score tile in D's layout feeds the next product's A operand with no
// shuffle by a permutation of the summed index: A's slot c holds key 2c
// and slot c + 4 key 2c + 1 (acc_to_a), and the B operand reads the rows
// of keys 2c and 2c + 1 where it asks for c and c + 4 (load_b_pairs).
//
// Shared tiles hold f32 rows of DH + 4 floats (kLd): with a row stride of
// 4 modulo 32 banks the 32 lanes of every fragment load below fall on 32
// distinct banks, and a row stays a whole number of 16-byte copies.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace dial {
namespace tf32 {

template <int DH>
constexpr int kLd = DH + 4;

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (an error of about 2^-22 |x|)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d[16x8] += a[16x8] b[8x8], TF32 in, f32 accumulators.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in split TF32: the small terms, then hi . hi.
__device__ __forceinline__ void mma3(float* d, const FragA& a, const FragB& b) {
  mma(d, a.hi, b.lo);
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.hi);
}

// A = rows 0..15, columns 0..7 of a row-major f32 tile at `t` (row stride ld).
__device__ __forceinline__ void load_a(FragA& f, const float* t, int ld) {
  const int lane = threadIdx.x % 32;
  const float* p = t + (lane / 4) * ld + lane % 4;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ld], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ld + 4], f.hi[3], f.lo[3]);
}

// B[k][n] = t[n][k], k, n < 8: the transpose of a row-major tile (K or Q
// rows against the rows of the A operand, as in q k^T).
__device__ __forceinline__ void load_b_rows(FragB& f, const float* t, int ld) {
  const int lane = threadIdx.x % 32;
  const float* p = t + (lane / 4) * ld + lane % 4;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
}

// B[slot][n] = t[key][n] with slot c <- key 2c and slot c + 4 <- key
// 2c + 1 (rows of V, K, Q or dO against an A from acc_to_a).
__device__ __forceinline__ void load_b_pairs(FragB& f, const float* t, int ld) {
  const int lane = threadIdx.x % 32;
  const float* p = t + 2 * (lane % 4) * ld + lane / 4;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[ld], f.hi[1], f.lo[1]);
}

// The A operand from an 8-column accumulator tile (rows g and g + 8,
// columns 2c and 2c + 1), its columns in load_b_pairs' slot order.
__device__ __forceinline__ void acc_to_a(FragA& f, const float* acc) {
  split(acc[0], f.hi[0], f.lo[0]);
  split(acc[2], f.hi[1], f.lo[1]);
  split(acc[1], f.hi[2], f.lo[2]);
  split(acc[3], f.hi[3], f.lo[3]);
}

// The max and the sum over the four lanes that hold one row of a D tile.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the blocked attention kernels' block --------------------------------
// A block of 4 warps owns a 64-row tile of one (head, batch row): query
// rows (the forward, the dQ pass) or keys (the dK/dV pass), 16 rows a
// warp. The other side streams through a two-stage cp.async ring in
// 64-row chunks.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kWarps;  // rows of the block's own tile and of a ring chunk
constexpr int kExtra = 4 * kTileRows;   // floats of per-row values (a bias, row statistics) a stage holds

// Rows [r0, r0 + rows) of one head (row stride `row_stride` floats) into
// a [rows, kLd<DH>] shared tile by 16-byte cp.async copies from the
// block's `threads` threads; rows past S are zero-filled. The query-blocked
// kernels pass their constant thread count (with blockDim.x there their
// forward spilled registers and kernels 6 and 9 ran 2-4% slower on an
// H100), the single-tile kernels blockDim.x (the constant cost the
// single-tile forward registers and time at head_dim 32).
template <int DH>
__device__ __forceinline__ void copy_rows_async(float* dst, const float* head, long long row_stride, int r0,
                                                int rows, int s, int threads) {
  constexpr int kVecs = DH / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += threads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    const bool valid = r0 + r < s;
    tc::cp_async16(dst + r * kLd<DH> + c, valid ? head + (r0 + r) * row_stride + c : head, valid);
  }
}

// Dynamic shared memory of a block: two fixed [64, kLd] tiles (its own
// rows), then two ring stages of two [64, kLd] tiles and kExtra floats.
template <int DH>
struct Layout {
  static constexpr int kTile = kTileRows * kLd<DH>;
  static constexpr int kStage = 2 * kTile + kExtra;
  static constexpr size_t kBytes = sizeof(float) * (2 * kTile + 2 * kStage);
  float* base;
  __device__ float* fixed(int i) const { return base + i * kTile; }
  __device__ float* tile(int stage, int i) const { return base + 2 * kTile + stage * kStage + i * kTile; }
  __device__ float* extra(int stage) const { return tile(stage, 2); }
};

// the two-stage cp.async ring's step (tensor_core.cuh), shared with the
// bf16 tensor-core kernels
using tc::ring_step;

// acc[n] = A B^T for the warp's 16 rows `a` against rows 8 n .. 8 n + 7 of
// `b` (both [*, kLd] tiles), over the head width DH. The loop over the
// head width stays rolled: unrolled, the backward passes at head_dim 64
// and the forward at head_dim 32 spilled registers (-Xptxas -v on sm_90a);
// rolled, none spills, and the kernels ran about as fast on an H100.
// With kSmallApart the small terms (hi.lo, lo.hi) of every step go to an
// accumulator of their own, added to the hi.hi sum in f32 at the end:
// added to the running sum, they lose their low bits to the tensor core's
// rounding of that sum at each step. With kStepPartials each step's three
// products go to a zeroed accumulator, added to the sum in f32 (rounded to
// nearest): the tensor core rounds the running sum toward zero at each
// product, about an ulp of the sum each time, which a score with one large
// term (|q . k| ~ 100) carries whole into the KV-blocked forward's lse =
// m + log(l) (on an H100 80GB HBM3 at 700 W, 1.1-1.3e-5 from an f64
// evaluation where |q . k| reaches 120, against the lse gate of 1e-5;
// 1.9-2.6e-6 with it, as close as the plain version:
// scripts/kv_blocked_fwd_variants.py).
template <int NT, int DH, bool kSmallApart = false, bool kStepPartials = false>
__device__ __forceinline__ void product_rows(float (&acc)[NT][4], const float* a, const float* b) {
  float small[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = small[n][e] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < DH / 8; ++ks) {
    FragA fa;
    load_a(fa, a + 8 * ks, kLd<DH>);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      FragB fb;
      load_b_rows(fb, b + 8 * n * kLd<DH> + 8 * ks, kLd<DH>);
      if (kSmallApart) {
        mma(small[n], fa.hi, fb.lo);
        mma(small[n], fa.lo, fb.hi);
        mma(acc[n], fa.hi, fb.hi);
      } else if (kStepPartials) {
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(step, fa, fb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], step[e]);
      } else {
        mma3(acc[n], fa, fb);
      }
    }
  }
  if (kSmallApart)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], small[n][e]);
}

// acc[n] = A B^T as product_rows computes it (the same order), with A the
// warp's 16 rows already split, one fragment per 8 head columns.
template <int NT, int DH>
__device__ __forceinline__ void product_frags(float (&acc)[NT][4], const FragA (&a)[DH / 8], const float* b) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      FragB fb;
      load_b_rows(fb, b + 8 * n * kLd<DH> + 8 * ks, kLd<DH>);
      mma3(acc[n], a[ks], fb);
    }
}

// out += p R: p a D-layout tile [16, 8 NT] (the warp's 16 rows by 8 NT
// keys or queries), R rows 0 .. 8 NT - 1 of `rows` ([*, kLd]); out[j]
// holds head columns 8 j .. 8 j + 7.
template <int NT, int DH>
__device__ __forceinline__ void accumulate_pairs(float (&out)[DH / 8][4], const float (&p)[NT][4],
                                                 const float* rows) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    FragA fa;
    acc_to_a(fa, p[n]);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      FragB fb;
      load_b_pairs(fb, rows + 8 * n * kLd<DH> + 8 * j, kLd<DH>);
      mma3(out[j], fa, fb);
    }
  }
}

// Stores the warp's rows r0 + g + 8 (e / 2) (below S), head columns 8 j +
// 2c + e % 2, of a [16, DH] D-layout tile into one head of a view.
template <int DH>
__device__ __forceinline__ void store_rows(float* head, long long row_stride, int r0, int s,
                                           const float (&vals)[DH / 8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + lane / 4 + 8 * h;
    if (row >= s) continue;
    float* dst = head + row * row_stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      dst[8 * j] = vals[j][2 * h];
      dst[8 * j + 1] = vals[j][2 * h + 1];
    }
  }
}

// ---- the single-tile kernels' pieces -------------------------------------
// (flash_attention_fwd.cu, flash_attention_bwd.cu: blocks of any number of
// warps, 16 rows a warp)

// A[m][slot] = t[row][m], m < 16: the transpose of 8 rows of a row-major
// f32 tile (row stride ld) against 16 of its columns, with slot c <- row
// 2c and slot c + 4 <- row 2c + 1 (load_b_pairs' order). With the rows
// queries and the columns keys, P^T or dS^T as the A operand of a product
// over the queries. For ld = 4 (mod 16) the lanes fall on 32 banks.
__device__ __forceinline__ void load_a_pairs_t(FragA& f, const float* t, int ld) {
  const int lane = threadIdx.x % 32;
  const float* p = t + 2 * (lane % 4) * ld + lane / 4;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8], f.hi[1], f.lo[1]);
  split(p[ld], f.hi[2], f.lo[2]);
  split(p[ld + 8], f.hi[3], f.lo[3]);
}

}  // namespace tf32
}  // namespace dial
