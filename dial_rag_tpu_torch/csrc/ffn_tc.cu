// FFN block of a BERT encoder layer in bf16 on Hopper's tensor cores
// (sm_90a), at H 384, 768 and 1024.
//
// Replaces, in bf16: dial_rag_tpu/ops/fused_encoder.py::_ffn_kernel
// (pallas_call in _ffn_forward, wrapper fused_ffn_block). Over rows of x
// [M = B*S, H], with I the intermediate width (4H in the BERT family):
//   h   = bf16(gelu_tanh(f32(x . W1) + b1))   [M, I]: f32 accumulation,
//         GELU in f32, one cast after it;
//   y   = f32(h . W2)                          [M, H], never rounded;
//   out = bf16(LN(f32(x) + (y + b2)))          LayerNorm in f32, eps 1e-12.
//
// Bound on an H100 SXM at B=128, S=256 (M = 32768), I = 4H: 4 M H I FLOPs
// at 989 TFLOP/s, H 384 77.3 GFLOP (0.078 ms), H 768 309.2 GFLOP (0.313
// ms), H 1024 549.8 GFLOP (0.556 ms), against x in, out and both weights
// once (H 768: 106 MB, 0.032 ms at 3.35 TB/s): bound by operations.
//
// Design. LayerNorm needs whole rows, and the TPU kernel's one fused pass
// keeps a row block's [rows, H] f32 accumulator on chip while it walks I.
// Here a [128, 768] f32 accumulator is 384 KB, more than an SM's register
// file, so a fused pass holds 32-64 rows and every block streams both
// weight panels whole (fused_ffn.cu's bf16 kernel: 9.7 GB through L2 at H
// 768, B=128, S=256). So three launches behind one wrapper:
//   (1) gemm_kernel<kGeluBf16>: h = bf16(gelu_tanh(x . W1 + b1)), over
//       K = H;
//   (2) gemm_kernel<kF32>: y = h . W2 in f32, over K = I;
//   (3) layernorm_kernel: out = bf16(LN(x + (y + b2))), one warp a row
//       (residual_layernorm_rows, the fused blocks' epilogue).
// h in bf16 is what the TPU kernel rounds to, so its round trip through
// device memory changes no bit of the contract (H 768: 2 x 201 MB, ~0.12
// ms at 3.35 TB/s); y in f32 keeps the product unrounded (2 x 101 MB,
// ~0.06 ms).
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
// (PERF.md). h goes out through shared memory in 16-byte stores; y
// leaves the registers as whole 32-byte sectors. Rows past M load as
// zeros and are never stored. The grid walks N fastest, so the blocks in
// flight share their A rows and the weight panel stays in L2. No library
// product: cuBLAS is not called. Not used yet: TMA with mbarriers and a
// producer warp, clusters that multicast a tile to two blocks (half the
// L2 reads), a persistent schedule that overlaps one tile's epilogue with
// the next one's loads.
#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace dial {
namespace ffn {
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
constexpr int kLnRows = 8;       // layernorm_kernel: one warp a row
static_assert(kSmemBytes <= 232448, "the ring must fit a block's shared memory");
static_assert(kBM * kOutLd <= kStages * kStageElems, "the output tile is staged in the ring");

enum Epilogue { kGeluBf16, kF32 };

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

// out [m, n] = a [m, k] . w [k, n], E kGeluBf16: bf16(gelu_tanh(. + bias)),
// kF32: the f32 product itself. n % 128 == 0, k % 64 == 0.
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
  if constexpr (E == kGeluBf16) {
    // through shared memory (the ring is free once every warpgroup's
    // products are done), so that h leaves in 16-byte stores
    __syncthreads();
    bf16* tile = tiles;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + c2;
        *reinterpret_cast<__nv_bfloat162*>(tile + r * kOutLd + col) = __floats2bfloat162_rn(
            gelu_tanh(acc[4 * j + 2 * h] + bias[n0 + col]), gelu_tanh(acc[4 * j + 2 * h + 1] + bias[n0 + col + 1]));
      }
    }
    __syncthreads();
    bf16* h_out = static_cast<bf16*>(out);
    for (int i = threadIdx.x; i < kBM * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      if (m0 + r < m)
        *reinterpret_cast<uint4*>(h_out + static_cast<size_t>(m0 + r) * n + n0 + c) =
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

// out = bf16(LN(x + (y + b2))) for rows blockIdx.x * 8 .. + 7, one warp a
// row, in the fused blocks' epilogue arithmetic.
template <int H>
__global__ void __launch_bounds__(32 * kLnRows)
    layernorm_kernel(const float* __restrict__ y, const bf16* __restrict__ x, const float* __restrict__ b2,
                     const float* __restrict__ gamma, const float* __restrict__ beta, bf16* __restrict__ out,
                     int m) {
  const int r0 = blockIdx.x * kLnRows;
  const size_t at = static_cast<size_t>(r0) * H;
  residual_layernorm_rows<kLnRows, kLnRows, H>(y + at, x + at, H, b2, gamma, beta, out + at, m - r0);
}

template <int H>
int ffn_block(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, const void* gamma,
              const void* beta, void* out, void* h, void* y, int rows, int inter, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<kGeluBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<kF32>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (rows + kBM - 1) / kBM;
  gemm_kernel<kGeluBf16><<<dim3(inter / kBN, m_tiles), kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1), h, rows, inter, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<kF32><<<dim3(H / kBN, m_tiles), kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2), nullptr, y, rows, H, inter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layernorm_kernel<H><<<(rows + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, st>>>(
      static_cast<const float*>(y), static_cast<const bf16*>(x), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<bf16*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ffn
}  // namespace dial

// C entry point. x [rows, hidden], w1 [hidden, inter], w2 [inter, hidden]
// and out [rows, hidden]: device pointers of bf16, x, w1 and w2 16-byte
// aligned; b1 [inter], b2, gamma, beta [hidden]: f32; h: bf16 [rows,
// inter] and y: f32 [rows, hidden] device scratch, 16-byte aligned.
// hidden 384, 768 or 1024 and inter a multiple of 128 (else
// cudaErrorInvalidValue). Launches the three kernels on `stream` and
// returns the first CUDA error (0 on success).
extern "C" int dial_ffn_block_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                   const void* gamma, const void* beta, void* out, void* h, void* y, int rows,
                                   int hidden, int inter, void* stream) {
  using namespace dial::ffn;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inter % kBN || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hidden == 384) return ffn_block<384>(x, w1, b1, w2, b2, gamma, beta, out, h, y, rows, inter, st);
  if (hidden == 768) return ffn_block<768>(x, w1, b1, w2, b2, gamma, beta, out, h, y, rows, inter, st);
  if (hidden == 1024) return ffn_block<1024>(x, w1, b1, w2, b2, gamma, beta, out, h, y, rows, inter, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
