// Pieces shared by the long-sequence attention forwards and backwards
// (flash_attention_long.cu, flash_attention_long_bwd.cu, attention_bwd_tc.cuh):
// the key bias and the CUDA-core tiles of the bf16 KV-blocked backward
// passes. They are templates on the element type T (f32 or bf16: the
// loads, casts and stores; every product and sum runs in f32) and on the
// head width DH (32 or 64). S may be any length: rows past S load as
// zeros and keys past S get a -inf bias, so a ragged last key chunk or
// query tile is masked inside the kernel and a padded key's weight is
// exactly 0.
#pragma once

#include "attention_f32.cuh"

namespace dial {
namespace attn {

constexpr int kKeysPerThread = kChunk / kPhases;  // keys of a chunk a thread scores
// row stride of the [kRows, kChunk] probability tile: the 4 rows and 8
// phases of a warp land on 32 distinct banks
constexpr int kPLd = kChunk + 8;
// the opt-in shared memory of one H100 block; every block's static
// shared memory also stays under the 48 KB a static allocation may take
constexpr size_t kSmemLimit = 232448;
constexpr size_t kStaticSmemLimit = 48 * 1024;

// Rows [r0, r0 + NROWS) of one head into an f32 [NROWS, DH + 1] tile,
// zeros past S. A tile wholly below S (every tile but a ragged last one)
// takes a copy with no check per element: with the check in every copy
// the blocked backward kernels ran up to a fifth slower on an H100.
template <int NROWS, int DH, typename T>
__device__ __forceinline__ void load_tile_rows(float* dst, const T* base, long long row_stride, int r0, int s) {
  if (r0 + NROWS > s) {
    load_rows<NROWS, DH>(dst, base, row_stride, r0, s);
    return;
  }
  for (int i = threadIdx.x; i < NROWS * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 1) + d] = to_f32(base[(r0 + r) * row_stride + d]);
  }
}

// The additive bias of key `key` of a row: the mask's, or -inf past S.
__device__ __forceinline__ float key_bias(const float* bias_row, int key, int s) {
  return key < s ? bias_row[key] : -INFINITY;
}

// Rows [r0, r0 + kRows) of one head, staged through `stage` ([kRows,
// DH + 1]): this thread's row (t / 8) in registers, zeros past S.
template <int DH, typename T>
__device__ __forceinline__ void row_to_registers(float* stage, float* row, const T* head, long long row_stride,
                                                 int r0, int s) {
  load_tile_rows<kRows, DH>(stage, head, row_stride, r0, s);
  __syncthreads();
  const int r = threadIdx.x / kPhases;
#pragma unroll
  for (int d = 0; d < DH; ++d) row[d] = stage[r * (DH + 1) + d];
  __syncthreads();
}

// Stores this thread's DH / 8 values (head columns j + 8 t) of row
// r0 + t / 8 of one head, if that row is below S.
template <int DH, typename T>
__device__ __forceinline__ void store_row(T* head, long long row_stride, int r0, int s, const float* vals) {
  const int r = threadIdx.x / kPhases, j = threadIdx.x % kPhases;
  if (r0 + r >= s) return;
  T* row = head + (r0 + r) * row_stride;
#pragma unroll
  for (int t = 0; t < DH / kPhases; ++t) row[j + kPhases * t] = from_f32<T>(vals[t]);
}

}  // namespace attn
}  // namespace dial
