// Fused pre-LN transformer layer tail for the cross-domain transformer.
//
// Replaces audio_to_sheet_music_tpu/ops/pallas_attn.py:layer_tail (Pallas
// body _layer_kernel), which runs every self and cross layer of the HTDemucs
// crosstransformer.  Per query row it computes
//
//   q   = bf16(h @ Wqᵀ + bq)
//   a   = bf16(concat_heads softmax(q_h k_hᵀ / √64, padded keys masked) v_h)
//   y1  = x + γ1 · (a @ Woᵀ + bo)                              (f32)
//   ln  = bf16(LayerNorm(y1))                                   (f32 stats)
//   out = bf16(y1 + γ2 · (bf16(gelu_erf(ln @ W1ᵀ + b1)) @ W2ᵀ + b2))
//
// with bf16 operands and f32 accumulation in every product.  K and V arrive
// projected (the K/V projection needs the whole memory stream and stays
// outside, as it does in the JAX package).
//
// What bounds it on an H100: the products, with the bytes close behind.
// At the freq self form of a serving group (B 4, L = S = 2072) the layer is
// ~78 GFLOP (35 of attention, 43.5 of the four GEMMs): 0.079 ms at the
// bf16 tensor peak.  Its own operands and result are ~48 MB, but the six
// launches below read and write ~215 MB between them, 0.064 ms at the
// memory rate.
//
// Design.  The Pallas kernel keeps the whole K/V row (2 x 2.1 MB at S=2072)
// and all weights (~5 MB) resident in VMEM; a Hopper block has 227 KB, and
// one block per (query tile, batch row) holding a whole tile's layer leaves
// most SMs idle at the serving shapes.  So the layer is split into six
// launches, each with enough blocks to fill the card:
//   1. gemm_kernel: q = h @ Wqᵀ + bq                     -> bf16 scratch
//   2. flash_kernel: attention, one block per (query tile, head, batch
//      row); K/V tiles of 128 keys stream through a two-stage TMA ring on
//      mbarriers, Q Kᵀ and P V run on wgmma, and the online (running max /
//      running sum) softmax stays in the accumulator registers; keys at or
//      past S are zero-filled by TMA and scored -1e30, as in the Pallas mask
//   3. gemm_kernel: y1 = x + γ1 · (a @ Woᵀ + bo)          -> f32 scratch
//   4. ln_kernel: LayerNorm of y1, one warp a row          -> bf16 scratch
//   5. gemm_kernel: u = gelu_erf(ln @ W1ᵀ + b1)            -> bf16 (M, FF)
//   6. gemm_kernel: out = y1 + γ2 · (u @ W2ᵀ + b2)          -> bf16
// Every product is wgmma with f32 accumulators.  The GEMMs are 128 x 128
// output tiles fed by TMA through a three-stage ring, two consumer
// warpgroups and a producer warp (attn_common.cuh says why); the attention
// takes P from registers.  GELU is the exact erf form (the Pallas
// polynomial was a Mosaic workaround).  The unnormalised probabilities are
// rounded to bf16 before the P·V product and divided by the f32 running sum
// afterwards; the plain version rounds the normalised probabilities.  Both
// are bf16-rounding-grade.  Not done: FF1 fused into FF2 (the hidden's
// ~68 MB round trip), the LayerNorm in the out-projection's epilogue, the
// K/V projection folded in (it stays a torch matmul, as the JAX package
// leaves it to XLA).

#include "attn_common.cuh"

namespace {

constexpr int NT = 128;         // LayerNorm block: 4 warps, a row each
constexpr int MAX_D = 512;      // LayerNorm row held in registers, 16 a lane

// out (M, D) bf16 = LayerNorm(y (M, D) f32) with f32 two-pass statistics;
// one warp a row, D <= MAX_D.
__global__ void __launch_bounds__(NT)
ln_kernel(const float* __restrict__ y, const float* __restrict__ w,
          const float* __restrict__ bias, bf16* __restrict__ out, int M, int D,
          float eps) {
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* yr = y + (size_t)row * D;
  float val[MAX_D / 32];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i) {
    const int c = lane + 32 * i;
    val[i] = c < D ? yr[c] : 0.0f;
    s += val[i];
  }
  const float mean = warp_sum(s) / D;
  float var = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i) {
    const float d = lane + 32 * i < D ? val[i] - mean : 0.0f;
    var += d * d;
  }
  const float rstd = rsqrtf(warp_sum(var) / D + eps);
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < D)
      out[(size_t)row * D + c] =
          __float2bfloat16((val[i] - mean) * rstd * w[c] + bias[c]);
  }
}

}  // namespace

// Launch the layer on `stream`.  Returns cudaGetLastError() (0 on success).
// Scratch the caller allocates: qa, qb (B, L, D) bf16, y1 (B, L, D) f32,
// u (B, L, FF) bf16.  D = heads x 64 <= 512; D and FF multiples of 64.
extern "C" int layer_tail_launch(
    const void* h, const void* k, const void* v, const void* x,
    const void* wq, const void* bq, const void* wo, const void* bo,
    const void* g1, const void* lnw, const void* lnb, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* g2,
    void* qa, void* qb, void* y1, void* u, void* out, int B, int L, int S,
    int D, int FF, float scale, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * L;
  cudaError_t e = gemm<EPI_BIAS>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wq),
      static_cast<const float*>(bq), nullptr, nullptr, qa, M, D, D, st);
  if (e != cudaSuccess) return (int)e;

  e = flash(static_cast<const bf16*>(qa), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(qb), B, L, S, D,
            scale, st);
  if (e != cudaSuccess) return (int)e;

  e = gemm<EPI_RES_F32>(
      static_cast<const bf16*>(qb), static_cast<const bf16*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(g1), x, y1, M,
      D, D, st);
  if (e != cudaSuccess) return (int)e;

  ln_kernel<<<(M + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      static_cast<const float*>(y1), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<bf16*>(qa), M, D, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = gemm<EPI_GELU>(
      static_cast<const bf16*>(qa), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), nullptr, nullptr, u, M, FF, D, st);
  if (e != cudaSuccess) return (int)e;

  return (int)gemm<EPI_RES_BF16>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2), y1, out,
      M, D, FF, st);
}
