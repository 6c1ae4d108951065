// Framing + periodic Hann window + real FFT, unnormalised, in f32.
//
// Replaces audio_to_sheet_music_tpu/ops/pallas_stft.py:stft_pallas (Pallas
// body _kernel), which dsp.stft runs under ATSM_PALLAS_STFT=1: for each
// signal row and frame f, X[k] = sum_n x[f hop + n] w[n] e^{-2πi kn/N} for
// k = 0 .. N/2, with w[n] = 0.5 - 0.5 cos(2πn/N).  The caller pads the
// signal (reflect, centred) and scales by N^-1/2.
//
// What bounds it on an H100: bytes.  At a training batch (16 rows of
// 272384 samples, N = 4096, hop 1024, 263 frames) it reads 17.4 MB and
// writes 69 MB of complex64 against ~0.5 GFLOP of FFT work (2.5 N log2 N a
// frame), which the f32 CUDA cores (67 TFLOP/s) do in a third of the time
// the bytes take at 3.35 TB/s.
//
// Design.  The Pallas kernel does a four-step DFT as f32 (HIGHEST) MXU
// matmuls, because bf16 passes lost too much (2.7e-3 relative against
// 2e-5).  TF32 tensor cores keep 10 mantissa bits and are out for the same
// reason, so this is an FFT on the CUDA cores in f32: one block per (row,
// 4 frames).  Each frame's N real samples are windowed and packed as N/2
// complex values z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1] in bit-reversed
// order in shared memory; an iterative radix-2 decimation-in-time FFT of
// size N/2 runs on all 4 frames at once (twiddles from a table built per
// block with sincospif); the split X[k] = E[k] + e^{-2πik/N} O[k], with
// E = (Z[k] + conj Z[N/2-k]) / 2 and O = (Z[k] - conj Z[N/2-k]) / 2i, gives
// the N/2 + 1 bins.  The 4 frames of one bin are written together (32
// contiguous bytes of the (rows, N/2 + 1, frames) complex64 output).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int FB = 4;             // frames per block

// x (rows, T) f32; out (rows, M + 1, n_frames) complex64 as float2; M = N/2
// = 2^log2m.  Grid (ceil(n_frames / FB), rows).  Shared: FB frames of M
// complex values, then the M/2 twiddles e^{-2πip/M}.
__global__ void __launch_bounds__(NT)
stft_kernel(const float* __restrict__ x, float2* __restrict__ out, int T,
            int hop, int n_frames, int log2m) {
  extern __shared__ __align__(16) float2 sm[];
  const int M = 1 << log2m;
  float2* z = sm;                   // FB x M
  float2* tw = sm + FB * M;         // M / 2
  const int f0 = blockIdx.x * FB, row = blockIdx.y;
  const int nf = min(FB, n_frames - f0);
  const float* xr = x + (size_t)row * T;

  for (int p = threadIdx.x; p < M / 2; p += NT) {
    float s, c;
    sincospif(-2.0f * (float)p / (float)M, &s, &c);
    tw[p] = make_float2(c, s);
  }
  for (int i = threadIdx.x; i < FB * M; i += NT) {
    const int fl = i >> log2m, m = i & (M - 1);
    float2 v = make_float2(0.0f, 0.0f);
    if (fl < nf) {
      const float* fr = xr + (size_t)(f0 + fl) * hop + 2 * m;
      // w[n] = 0.5 - 0.5 cos(2πn/N) = 0.5 - 0.5 cospi(n/M)
      const float w0 = 0.5f - 0.5f * cospif((float)(2 * m) / (float)M);
      const float w1 = 0.5f - 0.5f * cospif((float)(2 * m + 1) / (float)M);
      v = make_float2(fr[0] * w0, fr[1] * w1);
    }
    z[(fl << log2m) + (__brev(m) >> (32 - log2m))] = v;
  }
  __syncthreads();

  // radix-2 DIT: butterflies of span 2 half, twiddle e^{-2πi pos/(2 half)}
  for (int half = 1, step = M / 2; half < M; half <<= 1, step >>= 1) {
    for (int i = threadIdx.x; i < FB * (M / 2); i += NT) {
      const int fl = i >> (log2m - 1), j = i & (M / 2 - 1);
      const int pos = j & (half - 1);
      const int i0 = (fl << log2m) + ((j - pos) << 1) + pos, i1 = i0 + half;
      const float2 t = tw[pos * step], a = z[i0], b = z[i1];
      const float2 bt = make_float2(b.x * t.x - b.y * t.y,
                                    b.x * t.y + b.y * t.x);
      z[i0] = make_float2(a.x + bt.x, a.y + bt.y);
      z[i1] = make_float2(a.x - bt.x, a.y - bt.y);
    }
    __syncthreads();
  }

  // split the packed spectrum into X[0 .. M]
  for (int i = threadIdx.x; i < (M + 1) * FB; i += NT) {
    const int k = i / FB, fl = i % FB;
    if (fl >= nf) continue;
    const float2 zk = z[(fl << log2m) + (k & (M - 1))];
    const float2 zm = z[(fl << log2m) + ((M - k) & (M - 1))];
    const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
    const float orr = 0.5f * (zk.y + zm.y), oi = -0.5f * (zk.x - zm.x);
    float s, c;
    sincospif(-(float)k / (float)M, &s, &c);      // e^{-2πik/N}
    out[((size_t)row * (M + 1) + k) * n_frames + f0 + fl] =
        make_float2(er + c * orr - s * oi, ei + c * oi + s * orr);
  }
}

}  // namespace

// x (rows, T) f32 -> out (rows, n_fft/2 + 1, n_frames) complex64 on
// `stream`; frame f reads x[f hop .. f hop + n_fft), so T >= (n_frames - 1)
// hop + n_fft.  n_fft a power of two from 4 to 2^13.  Returns the first CUDA
// error (0 on success).
extern "C" int stft_launch(const void* x, void* out, int rows, int T,
                           int n_fft, int hop, int n_frames, void* stream) {
  int log2m = 0;
  while ((2 << log2m) < n_fft) ++log2m;
  const int M = 1 << log2m;
  const size_t smem = (size_t)(FB * M + M / 2) * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  stft_kernel<<<dim3((n_frames + FB - 1) / FB, rows), NT, smem,
                reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float2*>(out), T, hop,
      n_frames, log2m);
  return (int)cudaGetLastError();
}
