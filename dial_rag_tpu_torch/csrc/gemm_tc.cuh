// The bf16 products of the encoder blocks on Hopper's tensor cores
// (sm_90a); shared by ffn_tc.cu, fused_attention.cu and fused_layer.cu
// through encoder_tc.cuh.
//
// gemm_kernel<E>: out [m, n] = a [m, k] . w [k, n] with f32 accumulation,
// then one epilogue:
//   kBiasBf16  bf16(. + bias)              the QKV projection of kernel 1;
//   kGeluBf16  bf16(gelu_tanh(. + bias))   the FFN's up product (kernel 2);
//   kF32       the f32 product itself      kernel 1's output projection
//                                          and the FFN's down product.
// The residual + LayerNorm pass that follows them is common.cuh's
// layernorm_kernel (one warp a row, eps 1e-12, f32).
//
// Each product: 256 x 128 output tiles, a block of 4 warpgroups each
// owning 64 rows of it, on wgmma m64n128k16 (bf16 in, f32 accumulators in
// registers, both operands read from shared memory by the tensor cores).
// K walks in 64-deep slices through a 4-stage ring of 16-byte cp.async
// copies into tiles in the 128-byte swizzle (A [256, 64] K-major, B [64,
// 128] as two MN-major [64, 64] panels), so a slice's copies fly while the
// slices before it are multiplied, and one product group stays in flight
// across the block's barrier. Why these: a 128 x 128 tile does 64 FLOPs
// per byte it reads through L2, a 256 x 128 one 85, and at the bf16 peak
// even 85 asks more of L2 than an H100's; and mma.sync from ldmatrix
// fragments reached about a quarter of the peak on these products
// (PERF.md). bf16 outputs go out through shared memory in 16-byte stores;
// the f32 output leaves the registers as whole 32-byte sectors. Rows past
// m load as zeros and are never stored. The grid walks N fastest, so the
// blocks in flight share their A rows and the weight panel stays in L2.
// Every product sums K in one order (ascending 64-deep slices, ascending
// 16-deep steps within one), whatever the caller, so kernel 3 equals
// kernels 1 then 2 bit for bit. No library product: cuBLAS is not called.
// Not used yet: TMA with mbarriers and a producer warp, clusters that
// multicast a tile to two blocks (half the L2 reads), a persistent
// schedule that overlaps one tile's epilogue with the next one's loads.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace dial {
namespace gemm {
namespace {

constexpr int kBM = 256, kBN = 128, kBK = 64, kStages = 4;
constexpr int kWarpgroups = kBM / 64, kThreads = 128 * kWarpgroups;
// product groups left in flight at a slice's end, and so the slices whose
// copies fly ahead of the one being multiplied: a stage is refilled only
// once the products that read it have finished
constexpr int kInFlight = 1, kAhead = kStages - 1 - kInFlight;
constexpr int kTileA = kBM * kBK, kTileB = kBK * kBN;  // elements of a stage's tiles
constexpr int kStageElems = kTileA + kTileB;
// the ring, plus up to 1023 bytes to align it to a 1024-byte swizzle atom
constexpr int kSmemBytes = kStages * kStageElems * static_cast<int>(sizeof(bf16)) + 1024;
constexpr int kOutLd = kBN + 8;  // the staged bf16 output tile's padded row: 272 bytes
static_assert(kSmemBytes <= 232448, "the ring must fit a block's shared memory");
static_assert(kBM * kOutLd <= kStages * kStageElems, "the output tile is staged in the ring");

enum Epilogue { kGeluBf16, kF32, kBiasBf16 };

// The value a bf16 epilogue rounds: the product plus its bias, through the
// tanh GELU for kGeluBf16.
template <Epilogue E>
__device__ __forceinline__ float biased(float v, float b) {
  if constexpr (E == kGeluBf16)
    return gelu_tanh(v + b);
  else
    return v + b;
}

// Starts the 16-byte copies of K slice `kt` into one stage: A rows m0 ..
// m0 + 255 (zeros past m), columns 64 kt .. + 63, into `sa`; B rows 64 kt
// .. + 63, columns n0 .. n0 + 127, into `sb` as two 64-column panels.
__device__ __forceinline__ void issue_slice(bf16* sa, bf16* sb, const bf16* __restrict__ a,
                                            const bf16* __restrict__ w, int m0, int n0, int m, int n, int k, int kt) {
  const int k0 = kt * kBK;
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = i % (kBK / 8);
    const bool valid = m0 + r < m;
    tc::cp_async16(sa + tc::swizzled128(r, c), valid ? a + static_cast<size_t>(m0 + r) * k + k0 + 8 * c : a, valid);
  }
  for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = i % (kBN / 8);
    tc::cp_async16(sb + (c / 8) * (kBK * 64) + tc::swizzled128(r, c % 8),
                   w + static_cast<size_t>(k0 + r) * n + n0 + 8 * c, true);
  }
  tc::cp_async_commit();
}

// out [m, n] = a [m, k] . w [k, n] through epilogue E (bias: f32 [n], unread
// by kF32). n % 128 == 0, k % 64 == 0.
template <Epilogue E>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, const float* __restrict__ bias,
                void* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem + (1024 - tc::smem_addr(smem) % 1024) % 1024);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_slices = k / kBK;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // slices 0 .. kAhead - 1 in flight; one copy group per slice (empty past
  // the last), so at most kAhead - 1 groups pending means slice kt landed
  for (int kt = 0; kt < kAhead; ++kt) {
    if (kt < n_slices) {
      bf16* st = tiles + kt * kStageElems;
      issue_slice(st, st + kTileA, a, w, m0, n0, m, n, k, kt);
    } else {
      tc::cp_async_commit();
    }
  }
  for (int kt = 0; kt < n_slices; ++kt) {
    tc::cp_async_wait<kAhead - 1>();
    tc::fence_proxy_async();
    // slice kt is in every thread's view of the async proxy, and every
    // warpgroup's products of slice kt - 1 - kInFlight have finished, so
    // their stage takes the copies of slice kt + kAhead
    __syncthreads();
    const int next = kt + kAhead;
    if (next < n_slices) {
      bf16* st = tiles + (next % kStages) * kStageElems;
      issue_slice(st, st + kTileA, a, w, m0, n0, m, n, k, next);
    } else {
      tc::cp_async_commit();
    }
    const bf16* st = tiles + (kt % kStages) * kStageElems;
    // A: this warpgroup's 64 rows, 8-row atoms 1024 bytes apart, k16 step
    // j 32 bytes on; B: panels 64 x 128 bytes apart, k16 step j 16 rows on
    const uint64_t da = tc::b128_desc(st + wg * 64 * kBK, 0, 1024);
    const uint64_t db = tc::b128_desc(st + kTileA, kBK * 128, 1024);
    tc::fence_accumulators(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) tc::wgmma_m64n128k16(acc, da + 2 * j, db + 128 * j);
    tc::wgmma_commit();
    tc::wgmma_wait<kInFlight>();
    tc::fence_accumulators(acc);
  }
  tc::wgmma_wait<0>();
  tc::fence_accumulators(acc);
  tc::cp_async_wait<0>();

  // rows 16 warp + g and + 8 (g = lane / 4) of the warpgroup's 64,
  // columns 8 j + 2 (lane % 4) + {0, 1}: acc[4 j + 2 h + {0, 1}]
  const int c2 = 2 * (lane % 4);
  if constexpr (E != kF32) {
    // through shared memory (the ring is free once every warpgroup's
    // products are done), so that the tile leaves in 16-byte stores
    __syncthreads();
    bf16* tile = tiles;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + c2;
        *reinterpret_cast<__nv_bfloat162*>(tile + r * kOutLd + col) = __floats2bfloat162_rn(
            biased<E>(acc[4 * j + 2 * h], bias[n0 + col]), biased<E>(acc[4 * j + 2 * h + 1], bias[n0 + col + 1]));
      }
    }
    __syncthreads();
    bf16* o = static_cast<bf16*>(out);
    for (int i = threadIdx.x; i < kBM * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      if (m0 + r < m)
        *reinterpret_cast<uint4*>(o + static_cast<size_t>(m0 + r) * n + n0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * kOutLd + c);
    }
  } else {
    float* y = static_cast<float*>(out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        *reinterpret_cast<float2*>(y + static_cast<size_t>(row) * n + n0 + 8 * j + c2) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Launches gemm_kernel<E> over out [m, n] on `st`; returns the first CUDA error.
template <Epilogue E>
cudaError_t launch_gemm(const bf16* a, const bf16* w, const float* bias, void* out, int m, int n, int k,
                        cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(gemm_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  gemm_kernel<E><<<dim3(n / kBN, (m + kBM - 1) / kBM), kThreads, kSmemBytes, st>>>(a, w, bias, out, m, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemm
}  // namespace dial
