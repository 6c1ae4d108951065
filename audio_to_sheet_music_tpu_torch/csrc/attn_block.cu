// Fused attention block for the cross-domain transformer (opt-in kernels).
//
// Replaces audio_to_sheet_music_tpu/ops/pallas_attn.py:attn_block (Pallas
// body _attn_kernel), which the JAX package runs through mha_residual when
// ATSM_PALLAS_ATTN=1 and the whole-layer kernel is off.  Per query row:
//
//   a   = bf16(concat_heads softmax(q_h k_hᵀ / √64, padded keys masked) v_h)
//   out = bf16(x + γ · (a @ Woᵀ + bo))
//
// with q, k, v already projected (the JAX package leaves the projections to
// XLA; here they are torch matmuls), bf16 operands and f32 accumulation.
//
// What bounds it on an H100: the products.  At a training batch of 8 x 6 s a
// freq self block is 2 x 8 x 2072 x (2 x 2072 x 512 + 512 x 512) ≈ 75 GFLOP
// against ~70 MB of operands, far above the card's ~295 FLOP/byte ridge.
//
// Design.  The Pallas kernel keeps a batch row's whole K/V (2 x 2.1 MB at
// S = 2072) resident in VMEM; a Hopper block has 227 KB.  So this is two
// launches of the building blocks layer_tail.cu uses (attn_common.cuh): the
// flash-attention launch (TMA K/V ring, wgmma for Q Kᵀ and P V, online
// softmax in the accumulator registers), one block per (query tile, head,
// batch row), into a bf16 scratch; then the GEMM (128 x 128 tiles fed by a
// TMA ring, two wgmma consumer warpgroups) with the out-projection
// epilogue (+ bo, · γ, + the bf16 residual, bf16 out).
//
// The query tile is 64 rows, one consumer warpgroup (attn_common.cuh:flash
// says why).

#include "attn_common.cuh"

// Launch on `stream`.  Returns the first CUDA error (0 on success).  Scratch
// the caller allocates: a (B, L, D) bf16.  D = heads x 64, a multiple of 64.
extern "C" int attn_block_launch(const void* q, const void* k, const void* v,
                                 const void* x, const void* wo,
                                 const void* bo, const void* g, void* a,
                                 void* out, int B, int L, int S, int D,
                                 float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = flash(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<bf16*>(a), B,
                        L, S, D, scale, st);
  if (e != cudaSuccess) return (int)e;
  return (int)gemm<EPI_RES_X>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(g), x, out,
      B * L, D, D, st);
}

