// Pieces shared by the long-sequence attention forwards and backwards
// (flash_attention_long.cu, flash_attention_long_bwd.cu, attention_bwd_tc.cuh):
// the key bias and the static shared-memory limit. S may be any length:
// keys past S get a -inf bias, so a ragged last key chunk is masked inside
// the kernel and a padded key's weight is exactly 0.
#pragma once

#include "attention_f32.cuh"

namespace dial {
namespace attn {

// every block's static shared memory stays under the 48 KB a static
// allocation may take
constexpr size_t kStaticSmemLimit = 48 * 1024;

// The additive bias of key `key` of a row: the mask's, or -inf past S.
__device__ __forceinline__ float key_bias(const float* bias_row, int key, int s) {
  return key < s ? bias_row[key] : -INFINITY;
}

}  // namespace attn
}  // namespace dial
