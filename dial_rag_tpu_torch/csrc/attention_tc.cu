// Attention forwards on Hopper's tensor cores, bf16, head_dim 32 and 64
// (sm_90a).
//
// Replaces, in bf16, four TPU kernels of dial_rag_tpu/ops/flash_attention.py.
// Three compute one function, o = softmax(q k^T * scale + bias) v with
// bias = (1 - mask) * f32.min, the softmax exact per row, P normalised in
// f32 and cast to bf16 after the division, P . V accumulated in f32 and o
// cast to bf16 once (attention_tc_kernel):
//   _qkv_native_kernel (pallas_call in _qkv_native_forward): q, k, v read
//     straight from the packed [B, S, 3H] projection, o written [B, S, H];
//   _attention_kernel (pallas_call in _forward, S <= 512 or S % 256 != 0):
//     head-major [B, h, S, Dh] views;
//   _attention_q_blocked_kernel (pallas_call in _forward, 512 < S <= 4096
//     or S % 512 != 0): the same per 256-query block.
// The fourth, _attention_kv_blocked_fwd_kernel (pallas_call in _forward,
// S > 4096 and S % 512 == 0), is the online softmax over 512-key blocks
// (kv_blocked_tc_kernel, below): the running max m from f32.min, per block
// m_next = max(m, the block's row max), corr = exp(m - m_next) and
// e = exp(s - m_next) in f32, l = l corr + sum(e) in f32, acc = acc corr +
// bf16(e) . V in f32; at the end o = bf16(acc / l) and lse = m + log(l),
// f32 [B, h, S], which the blocked backward reads.
// Every operand arrives as a base pointer plus (batch, head, row) element
// strides, so the layouts differ only in their strides; no S limit.
// attention_tc_kernel and the pieces both kernels use live in
// attention_tc.cuh, which kernel 1 in bf16 (encoder_tc.cuh) shares.
//
// Bound on an H100 SXM: 4 * B * h * S^2 * Dh FLOPs at 989 TFLOP/s, against
// q, k, v and o read and written once (and lse written). The packed qkv
// [128, 256, 3H] at 12 heads of 64 is 25.8 GFLOP (0.026 ms) against 201 MB
// (0.060 ms): bound by bytes; [1, 12, 4096, 32] is 25.8 GFLOP (0.026 ms)
// against 13 MB, [1, 12, 8192, 64] 206 GFLOP (0.208 ms) against 50 MB:
// bound by operations.
//
// What held the CUDA-core kernels they replace back: every product ran in
// f32 on the CUDA cores (67 TFLOP/s at best), bf16 exactly as slow as f32;
// the single-tile kernel kept a [32, S] f32 score tile in shared memory,
// which capped S and occupancy; the KV-blocked one gave a block 32 query
// rows, so K and V were read S / 32 times per head. The design:
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
//     accumulators straight into the A fragments of P . V in registers
//     (tensor_core.cuh holds these pieces, shared with ffn_tc.cu);
//   - exact softmax: two passes, as the reference asks: pass 1 keeps each
//     row's running max and denominator (the four lanes that share a row
//     merge them by __shfl_xor_sync); pass 2 recomputes the scores, forms
//     p = exp(s - m) / l (correctly rounded, by a reciprocal and one
//     fma correction: div_by), casts it to bf16 after the division, as
//     the TPU kernels do, and accumulates P . V in f32. No online
//     rescaling of the output, which would move where bf16 rounds;
//   - KV-blocked: the max moves once per 512 keys, as in the reference,
//     with no [rows, 512] score tile: each block takes two sub-passes over
//     its eight chunks, (a) Q K^T for the row max alone (K only), then,
//     after acc and l are rescaled by corr, (b) Q K^T again, e in f32 into
//     l and bf16(e) . V into acc. One ring of 16 steps per block carries
//     both, so no copy waits at a sub-pass boundary. Q K^T runs twice:
//     1.5 times the bound's operations, as the exact softmax's two passes;
//   - the mask bias is f32.min, never -inf, so a fully masked row stays
//     finite and uniform over its S real keys; a key past S (the ragged
//     last chunk) gets a -inf bias and weight exactly 0, and a query row
//     past S is computed on zeros and never stored.
// mma.sync and not wgmma: at head_dim 32 and 64 Q K^T is only 2-4 k-steps
// deep, and wgmma's 64-row warpgroup tiles with swizzled shared-memory
// descriptors (and TMA, warp specialisation) are the next step for a
// kernel that stays far from its bound.
#include "attention_tc.cuh"

namespace dial {
namespace tc {
namespace {

// ---- _attention_kv_blocked_fwd_kernel --------------------------------------
constexpr int kKvBlock = 512;                   // keys between max updates: the reference's _KV_BLOCK
constexpr int kBlockChunks = kKvBlock / kKeys;  // 64-key chunks of a 512-key block

// Ring step t of the KV-blocked kernel: 512-key block t / 16, whose first
// 8 steps (sub-pass a) bring K alone and whose last 8 (sub-pass b) bring
// K and V, of its chunks 8 (t / 16) .. + 7 in turn.
__device__ __forceinline__ int step_chunk(int t) { return t / (2 * kBlockChunks) * kBlockChunks + t % kBlockChunks; }
__device__ __forceinline__ bool step_with_v(int t) { return t / kBlockChunks % 2 == 1; }

template <int DH>
__global__ void __launch_bounds__(kThreads)
    kv_blocked_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const float* __restrict__ bias, bf16* __restrict__ o, float* __restrict__ lse, Views vw,
                         int s, float scale) {
  constexpr int kDTiles = DH / 8;
  __shared__ __align__(16) Smem<DH> sm;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const bf16* k_head = k + b * vw.k.b + head * vw.k.h;
  const bf16* v_head = v + b * vw.v.b + head * vw.v.h;
  const float* bias_row = bias + static_cast<long long>(b) * s;

  uint32_t qa[DH / 16][4];
  q_fragments(qa, sm, q + b * vw.q.b + head * vw.q.h, vw.q.r, q0, s);

  // per row (g and g + 8 of the warp): the running max, from f32.min as
  // the reference starts it and the same in the row's four lanes; this
  // lane's share of the denominator (its keys' e); and the block's max
  // over this lane's keys while sub-pass (a) runs
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, block_max[2];
  float oacc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // a ragged S (the route gives none) reads its last block's keys past S
  // as zeros with a -inf bias: weight exactly 0
  const int n_steps = 2 * kBlockChunks * ((s + kKvBlock - 1) / kKvBlock);
  issue_chunk(sm, 0, 0, k_head, v_head, bias_row, vw, s, false);
  for (int t = 0; t < n_steps; ++t) {
    const int st = next_chunk(sm, t, n_steps, step_chunk(t + 1), step_with_v(t + 1), k_head, v_head, bias_row,
                              vw, s);
    float acc[kKeyTiles][4];
    chunk_scores(acc, qa, sm, st, scale);
    if (!step_with_v(t)) {
      // (a): the block's row max; at its last chunk, m_next = max(m, it)
      // and corr = exp(m - m_next) rescale l and the accumulator, as the
      // reference does once per 512 keys
      if (t % kBlockChunks == 0) block_max[0] = block_max[1] = -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n)
          block_max[h] = fmaxf(block_max[h], fmaxf(acc[n][2 * h], acc[n][2 * h + 1]));
      if (t % kBlockChunks == kBlockChunks - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_next = fmaxf(m[h], quad_max(block_max[h]));
          const float corr = expf(__fsub_rn(m[h], m_next));
          l[h] = __fmul_rn(l[h], corr);
#pragma unroll
          for (int n = 0; n < kDTiles; ++n) {
            oacc[n][2 * h] = __fmul_rn(oacc[n][2 * h], corr);
            oacc[n][2 * h + 1] = __fmul_rn(oacc[n][2 * h + 1], corr);
          }
          m[h] = m_next;
        }
      }
    } else {
      // (b): e = exp(s - m_next) in f32, summed into l in f32; bf16(e) . V
      // accumulated in f32
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] = expf(__fsub_rn(acc[n][e], m[e / 2]));
          l[e / 2] += acc[n][e];
        }
      accumulate_pv(oacc, acc, sm, st);
    }
    __syncthreads();
  }
  // o = acc / l, cast to bf16 once; lse = m + log(l), f32 [B, h, S]
  const float l_row[2] = {quad_sum(l[0]), quad_sum(l[1])};
  store_o<DH, true>(o + b * vw.o.b + head * vw.o.h, vw.o.r, q0, s, oacc, l_row);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (lane % 4 == 0 && row < s)
      lse[(static_cast<long long>(b) * gridDim.y + head) * s + row] = m[h] + logf(l_row[h]);
  }
}

}  // namespace
}  // namespace tc
}  // namespace dial

// C entry points. q, k, v, o: device pointers to bf16 [B, h, S, head_dim]
// views whose (batch, head, row) element strides are `strides[0..11]` (a
// host array: q, k, v, o in turn); q, k and v 16-byte aligned with strides
// that are multiples of 8 elements, o 4-byte aligned with even strides;
// bias: f32 [B, S]; lse: f32 [B, h, S]. Any S >= 1; head_dim 32 or 64
// (else cudaErrorInvalidValue). Launch on `stream` and return
// cudaGetLastError() (0 on success).
extern "C" int dial_attention_tc_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                                      const void* strides, int batch, int heads, int seq, int head_dim, float scale,
                                      void* stream) {
  using namespace dial::tc;
  const Views vw = read_views(strides);
  return at_head_dim(head_dim, [&](auto dh) {
    attention_tc_kernel<decltype(dh)::value, float><<<grid_of(batch, heads, seq), kThreads, 0,
                                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(bias), static_cast<bf16*>(o), vw, seq, scale);
  });
}

// The KV-blocked forward (TPU kernel 7) in bf16; writes lse too.
extern "C" int dial_attention_kv_blocked_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                                              void* lse, const void* strides, int batch, int heads, int seq,
                                              int head_dim, float scale, void* stream) {
  using namespace dial::tc;
  const Views vw = read_views(strides);
  return at_head_dim(head_dim, [&](auto dh) {
    kv_blocked_tc_kernel<decltype(dh)::value><<<grid_of(batch, heads, seq), kThreads, 0,
                                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(bias), static_cast<bf16*>(o), static_cast<float*>(lse), vw, seq, scale);
  });
}
