// Fused frequency HEncLayer (HTDemucs freq encoder layer 0).
//
// Replaces audio_to_sheet_music_tpu/ops/pallas_enc.py:henc_freq_fused
// (Pallas body _kernel, with the DConv math of ops/pallas_dconv.py:
// _block_body inside).  For each (batch b, output frequency row fo):
//
//   y   = gelu_erf(conv_{k=8, stride 4, pad 2 along F}(x) + bias)   (C x T)
//   2 x DConv block over the row (dconv_row.cuh)
//   out = (wr y + br)[:C] * sigmoid((wr y + br)[C:])                (C x T)
//
// Input and output are bf16, every intermediate f32; the DConv's two
// convolutions take bf16 operands with f32 sums, the JAX kernel's rule on
// bf16 input (its dot_dtype).
//
// What bounds it on an H100: bytes.  Per 6 s chunk it reads ~4.2 MB and
// writes ~12.7 MB of bf16 against ~2.4 GFLOP, under the card's ~295
// FLOP/byte ridge for bf16 tensor-core work.
//
// Design.  Three stages, each over (row, 64-frame tile) blocks, so a chunk
// of any length runs (the first version kept a whole (C + C/8, T) row in one
// block's shared memory and refused T > 1076 frames):
//   1. henc_conv_kernel: the strided conv + bias + GELU, one output per
//      thread, into an f32 scratch y laid out as (b, fo) rows of (C, T);
//   2. the DConv routine of dconv_row.cuh, both blocks in place on y (six
//      launches of bf16 mma.sync products; GroupNorm statistics merged from
//      per-tile partials);
//   3. henc_rewrite_kernel: the 1x1 C -> 2C conv and the GLU from a
//      (C x 64) tile of y in shared memory, written to the (B, C, F/4, T)
//      bf16 output.
// The conv and the rewrite are still f32 FMA loops on the CUDA cores
// (contraction depths 32 and C), which makes those two stages FMA-bound
// rather than byte-bound; moving them onto bf16 MMA tiles is the next step.
// The tile is the routine's (dconv_row.cuh says what it measured against
// 32 frames).  The s2d relayout and the VMEM block model of the Pallas
// kernel are TPU tiling artefacts and are not carried over.

#include "dconv_row.cuh"

namespace {

using dconv::bf16;
using dconv::NT;
using dconv::TT;

constexpr int KF = 8;           // conv kernel along F
constexpr int STRIDE = 4;
constexpr int PAD = 2;

// y[(b, fo)][c][t] = gelu(bc[c] + sum_ci sum_kf wc[c][ci][kf] x[b][ci][4 fo +
// kf - 2][t]).  Grid (B * Fo, ntile).
__global__ void __launch_bounds__(NT)
henc_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ wc,
                 const float* __restrict__ bc, float* __restrict__ y, int Cin,
                 int F, int T, int C) {
  const int r = blockIdx.x, Fo = F / STRIDE, b = r / Fo, fo = r % Fo;
  const int t0 = blockIdx.y * TT, len = min(TT, T - t0);
  for (int i = threadIdx.x; i < C * TT; i += NT) {
    const int co = i / TT, j = i % TT;
    if (j >= len) continue;
    float acc = __ldg(bc + co);
    for (int ci = 0; ci < Cin; ++ci) {
      const bf16* xr = x + ((size_t)b * Cin + ci) * F * T + t0 + j;
      const float* wk = wc + (co * Cin + ci) * KF;
#pragma unroll
      for (int kf = 0; kf < KF; ++kf) {
        const int fi = STRIDE * fo + kf - PAD;
        if (fi >= 0 && fi < F)
          acc += __ldg(wk + kf) * __bfloat162float(xr[(size_t)fi * T]);
      }
    }
    y[((size_t)r * C + co) * T + t0 + j] = dconv::gelu(acc);
  }
}

// out[b][c][fo][t] = GLU(wr y + br).  Grid (B * Fo, ntile); the (C x TT)
// tile of y in shared memory.
__global__ void __launch_bounds__(NT)
henc_rewrite_kernel(const float* __restrict__ y,
                    const float* __restrict__ wr,
                    const float* __restrict__ br, bf16* __restrict__ out,
                    int F, int T, int C) {
  extern __shared__ __align__(16) float ys[];
  const int r = blockIdx.x, Fo = F / STRIDE, b = r / Fo, fo = r % Fo;
  const int t0 = blockIdx.y * TT, len = min(TT, T - t0);
  for (int i = threadIdx.x; i < C * TT; i += NT) {
    const int c = i / TT, j = i % TT;
    ys[i] = j < len ? y[((size_t)r * C + c) * T + t0 + j] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * TT; i += NT) {
    const int c = i / TT, j = i % TT;
    if (j >= len) continue;
    float a = __ldg(br + c), g = __ldg(br + c + C);
    const float* wa = wr + (size_t)c * C;
    const float* wg = wr + (size_t)(c + C) * C;
    for (int k = 0; k < C; ++k) {
      const float yv = ys[k * TT + j];
      a += __ldg(wa + k) * yv;
      g += __ldg(wg + k) * yv;
    }
    out[(((size_t)b * C + c) * Fo + fo) * T + t0 + j] =
        __float2bfloat16(a * dconv::sigmoid(g));
  }
}

}  // namespace

// f32 scratch the caller allocates: y (B * F/4, C, T), u (B * F/4, C/8, T)
// and part (henc_freq_part_floats).
extern "C" size_t henc_freq_part_floats(int B, int F, int T) {
  return dconv::part_floats(B * (F / STRIDE), T);
}

// The hidden width Hp the DConv weights are padded to.
extern "C" int henc_freq_hidden_pad(int C) { return dconv::hidden_pad(C); }

// x (B, Cin, F, T) bf16 -> out (B, C, F/4, T) bf16 on `stream`, C a
// multiple of 8 up to dconv::MAX_C; wc, bc, wr, br f32.  dw holds the 18
// DConv pointers, block 0 then block 1, each in the order w1 (3, C, Hp)
// bf16, b1, g1, bt1, w2 (2C, Hp) bf16, b2, g2, bt2, scale (f32); the pad is
// zero.  Returns the first CUDA error (0 on success).
extern "C" int henc_freq_launch(const void* x, const void* wc, const void* bc,
                                const void* wr, const void* br,
                                const void* const* dw, void* y, void* u,
                                void* part, void* out, int B, int Cin, int F,
                                int T, int C, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int R = B * (F / STRIDE);
  const dim3 grid(R, dconv::n_tiles(T));
  float* yf = static_cast<float*>(y);
  henc_conv_kernel<<<grid, NT, 0, st>>>(static_cast<const bf16*>(x),
                                        static_cast<const float*>(wc),
                                        static_cast<const float*>(bc), yf,
                                        Cin, F, T, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dconv::BlockW w[2];
  dconv::unpack(dw, w);
  e = dconv::run<float, float>(yf, w, yf, static_cast<float*>(u),
                               static_cast<float*>(part), yf, R, C, T, st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)C * TT * sizeof(float);
  e = dconv::allow_smem(henc_rewrite_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  henc_rewrite_kernel<<<grid, NT, smem, st>>>(
      yf, static_cast<const float*>(wr), static_cast<const float*>(br),
      static_cast<bf16*>(out), F, T, C);
  return (int)cudaGetLastError();
}
