// Tensor-core building blocks shared by the bf16 kernels (sm_90a): the
// attention forwards of attention_tc.cuh and attention_tc.cu and the
// query-blocked backward of attention_bwd_tc.cuh (mma.sync), and the
// encoder blocks' products of gemm_tc.cuh (wgmma). 16-byte cp.async
// copies into shared memory (zero-filled where a row is past the data)
// and the two-stage ring step the f32 split-TF32 kernels share, ldmatrix
// fragment loads from rows padded by 8 bf16, the m16n8k16 bf16 product
// with f32 accumulators and two conversions of its results; and Hopper's
// warpgroup product, wgmma m64n128k16, on operands in 128-byte-swizzled
// shared memory.
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA), for lane = threadIdx.x
// % 32, g = lane / 4, c = 2 (lane % 4):
//   A [16 x 16]: a[0] rows g, k c..c+1; a[1] rows g + 8; a[2], a[3] the
//     same at k + 8 -- what ldmatrix_x4 gives from a row-major tile when
//     lane i addresses row i % 16, column 8 (i / 16);
//   B [16 x 8]: b0 k c..c+1 of column g, b1 at k + 8 -- what
//     ldmatrix_x4_trans gives, two 8-column tiles at once, from a
//     row-major [k, n] tile when lane i addresses row 8 ((i / 8) % 2) +
//     i % 8, column 8 (i / 16);
//   D [16 x 8] f32: d[0], d[1] row g, columns c, c + 1; d[2], d[3] row
//     g + 8.
// wgmma's m64nNk16 accumulator is warp w of the warpgroup's rows 16 w ..
// + 15, each 8-column tile j of it in D's layout above at d[4 j .. 4 j + 3].
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dial {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Ring step t of n of a two-stage cp.async ring: starts step t + 1's
// copies (issue(t + 1)) into the other stage, waits for step t's (issued
// by the previous call, or before the loop for t = 0) and returns its
// stage. The caller ends each step with __syncthreads(), before the stage
// is written again.
template <class Issue>
__device__ __forceinline__ int ring_step(int t, int n, const Issue& issue) {
  if (t + 1 < n) {
    issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return t % 2;
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
// division of every probability is a large share of the attention
// kernels' arithmetic.
__device__ __forceinline__ float div_by(float x, float l, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, l, x), r, q);
}

// Two f32 rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- wgmma ------------------------------------------------------------------
// Shared-memory operands in the 128-byte swizzle (B128): a tile of 128-byte
// rows in 1024-byte atoms of 8 rows, 16-byte chunk c of row r stored at
// chunk c ^ (r % 8) (what TMA's 128-byte swizzle writes). Element index of
// chunk c of row r of such a tile:
__device__ __forceinline__ int swizzled128(int r, int c) { return r * 64 + ((c ^ (r % 8)) * 8); }

// The matrix descriptor of a B128 operand at `p` (1024-byte aligned, plus
// the k offset within an atom): start address, leading and stride byte
// offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t b128_desc(const void* p, int lbo_bytes, int sbo_bytes) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// d[64 x 128] += A[64 x 16] B[16 x 128] for the calling warpgroup, bf16 in,
// f32 accumulators: A K-major (row-major [m, k]), B MN-major (row-major [k,
// n]: the transposed flag). Asynchronous: fence before, commit and wait
// after.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Orders the accumulators' registers around the asynchronous products: the
// compiler may not move their reads or writes across it.
__device__ __forceinline__ void fence_accumulators(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Waits until at most N of the warpgroup's committed product groups run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async
// copies that have landed) visible to the async proxy that wgmma reads by.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

}  // namespace tc
}  // namespace dial
