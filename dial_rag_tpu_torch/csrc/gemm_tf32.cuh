// The f32 products of the encoder blocks on Hopper's tensor cores in
// split TF32 (sm_90a); shared by fused_ffn.cu, fused_attention.cu and
// fused_layer.cu through encoder_tf32.cuh. gemm_tc.cuh's bf16 products
// are their counterparts.
//
// gemm_tf32_kernel<E>: out [m, n] = a [m, k] . w [k, n], f32 in and out,
// then one epilogue, each gemm_tc.cuh's without its cast:
//   kBias  . + bias               the QKV projection of kernel 1;
//   kGelu  gelu_tanh(. + bias)    the FFN's up product (kernel 2);
//   kPlain the product itself     kernel 1's output projection and the
//                                 FFN's down product.
// Products in split TF32 (tensor_core_tf32.cuh): each operand x as hi =
// tf32(x) and lo = tf32(x - hi), hi.lo + lo.hi + hi.hi by
// mma.sync.m16n8k8 into f32 accumulators, about 2^-21 relative a product.
//
// Bound on an H100 SXM: 2 m n k FLOPs at 165 TFLOP/s of 3xTF32 (495 / 3);
// at m = 32768 and K = N = 768 and more, A and the output at 3.35 TB/s
// take well under that: bound by operations.
//
// Design.
// - W is split once a call (split_kernel) into hi and lo planes laid out
//   as the products read them: for each 128-column panel and 32-deep K
//   slice one contiguous 32 KB tile, in it one 16-byte (hi, hi, lo, lo)
//   fragment a lane for each 8-deep step and 8-column tile. So a B
//   fragment is one conflict-free 16-byte shared load and no arithmetic,
//   and a slice of the panel is one contiguous copy. It costs 3 x 4 bytes
//   of traffic a weight: under 0.03 ms for a layer's four at H 768.
// - A (the activations) is split where its fragment is loaded, once a
//   warp: rows padded to 40 floats (8 mod 32 banks), so the two values a
//   lane takes from one row, read as one 8-byte load, fall on 32 distinct
//   banks a half-warp. The summed index is permuted within each 8-deep
//   step, A's slot c <- k 2c and slot c + 4 <- k 2c + 1, and W's planes
//   in the same order: a permutation of the terms of a sum.
// - A block of 8 warps owns a 128 x 128 output tile, warps 4 (rows) x 2
//   (columns), each 32 x 64: two 16-row by eight 8-column mma tiles, so a
//   split A fragment serves 24 products and a B fragment 6.
// - K walks in 32-deep slices through a 4-stage ring of 16-byte cp.async
//   copies (52 KB a stage: A [128, 40] and the panel's 32 KB), so three
//   slices fly while one is multiplied. Rows past m load as zeros and are
//   never stored.
// - Each slice's products go to a partial, added to the sum in f32
//   (rounded to nearest) on the CUDA cores: the tensor core rounds its
//   running sum toward zero at each product, and over K = 3072 (W2) the
//   errors of one long sum keep one sign, where those of the partials'
//   sums have the partials' own, random signs (PERF.md).
// - The grid walks N fastest, so the blocks in flight share their A rows
//   and the weight panel stays in L2, as gemm_tc.cuh does.
// Every product sums K in one order (ascending slices, ascending steps,
// hi.lo, lo.hi, hi.hi within a step), whatever the caller, so kernel 3
// equals kernels 1 then 2 bit for bit. No library product: cuBLAS is not
// called. Not used: wgmma (TF32 only with both operands K-major, so W
// transposed; A from registers, split there), ldmatrix, clusters.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"
#include "tensor_core_tf32.cuh"

namespace dial {
namespace gemm32 {
namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kWarpsM = 4, kWarpsN = 2, kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMTiles = kBM / kWarpsM / 16;  // 16-row mma tiles of a warp: 2
constexpr int kNTiles = kBN / kWarpsN / 8;   // 8-column mma tiles of a warp: 8
constexpr int kSteps = kBK / 8;              // 8-deep steps of a slice
constexpr int kLdA = kBK + 8;                // A rows in shared memory: 40 floats
constexpr int kTileA = kBM * kLdA;           // floats of a stage's A tile
constexpr int kTileB = kBK * kBN * 2;        // floats of a panel's slice, hi and lo
constexpr int kStageFloats = kTileA + kTileB;
constexpr int kSmemBytes = kStages * kStageFloats * static_cast<int>(sizeof(float));
static_assert(kSmemBytes <= 232448, "the ring must fit a block's shared memory");
static_assert(kBN / 8 * kSteps * 32 * 4 == kTileB, "a lane's B fragment is 4 floats");
// each K slice's products a partial added to the sum in f32 (false: all
// in the running accumulator, scripts/gemm_tf32_variants.py's reading)
constexpr bool kSlicePartials = true;

enum Epilogue { kGelu, kPlain, kBias };

// Floats of W's split planes for w [k, n]: hi and lo of every weight.
__host__ __device__ constexpr size_t split_floats(int k, int n) { return 2 * static_cast<size_t>(k) * n; }

// W [k, n] (row-major) into its split planes: for each panel p (columns
// 128 p ..), slice s (rows 32 s ..), step j and 8-column tile t, lane
// 4 g + c holds (hi, hi, lo, lo) of W[32 s + 8 j + 2 c + {0, 1}][128 p +
// 8 t + g] at float ((((p * k / 32 + s) * 4 + j) * 16 + t) * 32 + lane)
// * 4. One thread a lane's 4 floats.
__global__ void __launch_bounds__(256) split_kernel(const float* __restrict__ w, float* __restrict__ planes,
                                                     int k, int n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(k) * n / 2) return;
  const int lane = static_cast<int>(i % 32), t = static_cast<int>(i / 32 % 16);
  const int j = static_cast<int>(i / 512 % kSteps);
  const size_t slice = i / (512 * kSteps);  // p * (k / 32) + s
  const int s = static_cast<int>(slice % (k / kBK)), p = static_cast<int>(slice / (k / kBK));
  const int row = kBK * s + 8 * j + 2 * (lane % 4), col = kBN * p + 8 * t + lane / 4;
  uint32_t hi0, lo0, hi1, lo1;
  tf32::split(w[static_cast<size_t>(row) * n + col], hi0, lo0);
  tf32::split(w[static_cast<size_t>(row + 1) * n + col], hi1, lo1);
  reinterpret_cast<uint4*>(planes)[i] = make_uint4(hi0, hi1, lo0, lo1);
}

// d = a b with a zero accumulator in: a slice's first product.
__device__ __forceinline__ void mma_first(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Starts the 16-byte copies of K slice `kt` into its stage: A rows m0 ..
// m0 + 127 (zeros past m), columns 32 kt .. + 31; the panel's slice tile.
__device__ __forceinline__ void issue_slice(float* stage, const float* __restrict__ a,
                                            const float* __restrict__ panel, int m0, int m, int k, int kt) {
  constexpr int kChunks = kBK / 4;  // 16-byte chunks of an A row
  for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = m0 + r < m;
    tc::cp_async16(stage + r * kLdA + 4 * c, valid ? a + static_cast<size_t>(m0 + r) * k + kBK * kt + 4 * c : a,
                   valid);
  }
  const float* src = panel + static_cast<size_t>(kt) * kTileB;
  float* dst = stage + kTileA;
  for (int i = threadIdx.x; i < kTileB / 4; i += kThreads) tc::cp_async16(dst + 4 * i, src + 4 * i, true);
  tc::cp_async_commit();
}

// out [m, n] = a [m, k] . w [k, n] through epilogue E, w given as its
// split planes (split_kernel); bias f32 [n], unread by kPlain. n % 128 ==
// 0, k % 32 == 0.
template <Epilogue E>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_kernel(const float* __restrict__ a, const float* __restrict__ planes, const float* __restrict__ bias,
                     float* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(16) float gemm_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_slices = k / kBK;
  const float* panel = planes + static_cast<size_t>(blockIdx.x) * n_slices * kTileB;

  float acc[kMTiles][kNTiles][4], part[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int t = 0; t < kNTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  // slices 0 .. kStages - 2 in flight; one copy group a slice (empty past
  // the last), so at most kStages - 2 groups pending means slice kt landed
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < n_slices)
      issue_slice(gemm_smem + kt * kStageFloats, a, panel, m0, m, k, kt);
    else
      tc::cp_async_commit();
  }
  for (int kt = 0; kt < n_slices; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    // slice kt is in every thread's view, and every warp's products of
    // slice kt - 1 are done, so its stage takes slice kt + kStages - 1
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < n_slices)
      issue_slice(gemm_smem + (next % kStages) * kStageFloats, a, panel, m0, m, k, next);
    else
      tc::cp_async_commit();
    const float* stage = gemm_smem + (kt % kStages) * kStageFloats;
    const float* sa = stage + (wm * 16 * kMTiles + g) * kLdA + 2 * c;
    const float* sb = stage + kTileA + (wn * kNTiles * 32 + lane) * 4;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      // A: rows g and g + 8 of each 16-row tile, k 8 j + 2c, + 1 (slots c, c + 4)
      tf32::FragA fa[kMTiles];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const float2 top = *reinterpret_cast<const float2*>(sa + 16 * i * kLdA + 8 * j);
        const float2 bottom = *reinterpret_cast<const float2*>(sa + (16 * i + 8) * kLdA + 8 * j);
        tf32::split(top.x, fa[i].hi[0], fa[i].lo[0]);
        tf32::split(bottom.x, fa[i].hi[1], fa[i].lo[1]);
        tf32::split(top.y, fa[i].hi[2], fa[i].lo[2]);
        tf32::split(bottom.y, fa[i].hi[3], fa[i].lo[3]);
      }
      uint4 b[kNTiles];  // (hi, hi, lo, lo) of tile t
#pragma unroll
      for (int t = 0; t < kNTiles; ++t) b[t] = *reinterpret_cast<const uint4*>(sb + (j * 16 * 32 + t * 32) * 4);
      // the small terms, then hi.hi, each over all the warp's tiles in turn
#pragma unroll
      for (int t = 0; t < kNTiles; ++t)
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const uint32_t lo[2] = {b[t].z, b[t].w};
          if (!kSlicePartials)
            tf32::mma(acc[i][t], fa[i].hi, lo);
          else if (j == 0)
            mma_first(part[i][t], fa[i].hi, lo);
          else
            tf32::mma(part[i][t], fa[i].hi, lo);
        }
#pragma unroll
      for (int t = 0; t < kNTiles; ++t)
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const uint32_t hi[2] = {b[t].x, b[t].y};
          tf32::mma(kSlicePartials ? part[i][t] : acc[i][t], fa[i].lo, hi);
        }
#pragma unroll
      for (int t = 0; t < kNTiles; ++t)
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const uint32_t hi[2] = {b[t].x, b[t].y};
          tf32::mma(kSlicePartials ? part[i][t] : acc[i][t], fa[i].hi, hi);
        }
    }
    if (kSlicePartials)
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int t = 0; t < kNTiles; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][t][e] = __fadd_rn(acc[i][t][e], part[i][t][e]);
  }
  tc::cp_async_wait<0>();

  // rows 16 i + g and + 8 of the warp's 32, columns 8 t + 2c + {0, 1} of
  // its 64: acc[i][t][2 h + {0, 1}]; each row's 4 lanes write 32 bytes
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 16 * kMTiles + 16 * i + g + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int t = 0; t < kNTiles; ++t) {
        const int col = n0 + wn * 8 * kNTiles + 8 * t + 2 * c;
        float2 v = make_float2(acc[i][t][2 * h], acc[i][t][2 * h + 1]);
        if constexpr (E == kBias) {
          v.x += bias[col];
          v.y += bias[col + 1];
        } else if constexpr (E == kGelu) {
          v.x = gelu_tanh(v.x + bias[col]);
          v.y = gelu_tanh(v.y + bias[col + 1]);
        }
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * n + col) = v;
      }
    }
}

// Launches split_kernel for w [k, n] into `planes` (split_floats(k, n)
// floats), then gemm_tf32_kernel<E> over out [m, n], on `st`; returns the
// first CUDA error.
template <Epilogue E>
cudaError_t launch_product(const float* a, const float* w, const float* bias, float* out, float* planes, int m,
                           int n, int k, cudaStream_t st) {
  const size_t lanes = static_cast<size_t>(k) * n / 2;
  split_kernel<<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, st>>>(w, planes, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_tf32_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  gemm_tf32_kernel<E><<<dim3(n / kBN, (m + kBM - 1) / kBM), kThreads, kSmemBytes, st>>>(a, planes, bias, out, m, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemm32
}  // namespace dial
