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
// FB = 4 frames), one thread per radix-16 butterfly of a pass (512 threads
// at N = 4096).  At the training batch FB = 4 took 0.084 ms on the H100
// against 0.155 for FB = 2 and 0.097 for FB = 8 (1024 threads at 254
// registers, 64-byte runs of a bin's frames; chip_smoke.py --profile as it
// then stood, NVIDIA H100 80GB HBM3 at 700 W).  Each frame's N real samples are windowed and
// packed as M = N/2 complex values z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1],
// and an M-point Stockham (self-sorting) FFT runs in ceil(log2 M / 4)
// passes of radix 8 or 16 (M = 2048: 16·16·8).  In every pass each thread
// holds whole radix-R butterflies in registers: it reads R points M/R
// apart, multiplies by the pass's twiddles, does the R-point DFT in
// registers (radix-2 steps on compile-time constants) and writes R points
// Ns apart.  The first pass reads the signal and the window straight from
// device memory; shared memory only carries the data from one pass to the
// next (one write per pass, in place, between two barriers), rows padded
// by one point every 16 so the strided writes do not collide on banks.
// The split X[k] = E[k] + e^{-2πik/N} O[k], with E = (Z[k] + conj Z[M-k]) / 2
// and O = (Z[k] - conj Z[M-k]) / 2i, gives the M + 1 bins, FB frames of a
// bin written together (FB x 8 contiguous bytes of the (rows, M + 1,
// frames) complex64 output).  The window, the twiddles of passes 2.. and
// the split factors are tables the wrapper builds once per n_fft in float64
// and rounds to f32 (ops/fused_stft.py:tables, which owns their layout and
// passes a pointer to each); the kernel evaluates no transcendental
// function.

#include <cuda_runtime.h>

namespace {

constexpr int FB = 4;    // frames a block

// threads a block: one radix-16 butterfly each (FB M / 16), 64 to 1024
__host__ __device__ constexpr int block_threads(int L) {
  const int n = FB << (L - 4);
  return n < 64 ? 64 : n > 1024 ? 1024 : n;
}

// The pass schedule, the same as ops/fused_stft.py:passes (which the
// wrapper sends to the launch as its radix bits, checked against this
// one): P = ceil(L / 4) passes of radix 2^bits over M = 2^L points, the
// first L % P passes one bit wider than the rest.
__host__ __device__ constexpr int n_pass(int L) { return (L + 3) / 4; }
__host__ __device__ constexpr int pass_bits(int L, int p) {
  return L / n_pass(L) + (p < L % n_pass(L) ? 1 : 0);
}
__host__ __device__ constexpr int bits_before(int L, int p) {
  return p == 0 ? 0 : bits_before(L, p - 1) + pass_bits(L, p - 1);
}
// pass p's radix bits in bits 4p .. 4p + 3
constexpr int packed_schedule(int L) {
  int s = 0;
  for (int p = 0; p < n_pass(L); ++p) s |= pass_bits(L, p) << (4 * p);
  return s;
}

// shared-memory position of point a of a frame: one pad point every 16
__host__ __device__ constexpr int pad(int a) { return a + (a >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// e^{-2πi q/16}, q a compile-time constant after unrolling
__device__ __forceinline__ float2 w16(int q) {
  constexpr float c[16] = {
      1.0f, 0.92387953251128674f, 0.70710678118654752f,
      0.38268343236508977f, 0.0f, -0.38268343236508977f,
      -0.70710678118654752f, -0.92387953251128674f, -1.0f,
      -0.92387953251128674f, -0.70710678118654752f, -0.38268343236508977f,
      0.0f, 0.38268343236508977f, 0.70710678118654752f,
      0.92387953251128674f};
  return make_float2(c[q], -c[(q + 12) & 15]);   // sin(θ) = cos(θ - π/2)
}

__device__ __forceinline__ int rev_bits(int i, int bits) {
  int r = 0;
#pragma unroll
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// v <- its R-point DFT, v[q] = sum_r v[r] e^{-2πi rq/R}, in registers:
// radix-2 decimation in time on a bit-reversed copy, all indices constant.
template <int BITS>
__device__ __forceinline__ void dft(float2* v) {
  constexpr int R = 1 << BITS;
  float2 a[R];
#pragma unroll
  for (int i = 0; i < R; ++i) a[rev_bits(i, BITS)] = v[i];
#pragma unroll
  for (int half = 1; half < R; half <<= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & half) continue;
      const int q = (i & (half - 1)) * (8 / half);   // e^{-2πi pos/(2 half)}
      const float2 b = q == 0 ? a[i + half] : cmul(a[i + half], w16(q));
      a[i + half] = make_float2(a[i].x - b.x, a[i].y - b.y);
      a[i] = make_float2(a[i].x + b.x, a[i].y + b.y);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = a[i];
}

// Pass P of the schedule for FB frames.  Butterfly j of a frame (0 <= j <
// M/R) takes points j + r M/R (r < R), multiplies point r by
// tw[r Ns + j % Ns], tw this pass's table (not in pass 0, where Ns = 1),
// does the R-point DFT and
// writes point q to (j / Ns) Ns R + j % Ns + q Ns.  Pass 0 reads the
// windowed signal from device memory; the others read shared memory, so
// every thread loads all its butterflies before the barrier that lets the
// in-place writes start.
template <int L, int P>
__device__ __forceinline__ void fft_pass(float2* z, int zs,
                                         const float* xr, int hop, int f0,
                                         int nf, const float2* __restrict__ win,
                                         const float2* __restrict__ tw) {
  constexpr int M = 1 << L, BITS = pass_bits(L, P), R = 1 << BITS;
  constexpr int NS = 1 << bits_before(L, P);
  constexpr int NT = block_threads(L);
  constexpr int NBF = M / R;                      // butterflies a frame
  constexpr int NB = (FB * NBF + NT - 1) / NT;    // butterflies a thread
  float2 v[NB][R];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = threadIdx.x + i * NT, fl = b / NBF, j = b % NBF;
    if (NB * NT != FB * NBF && b >= FB * NBF) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = j + r * NBF;
      if constexpr (P == 0) {
        float2 p = make_float2(0.0f, 0.0f);
        if (fl < nf) {
          const float* fr = xr + (size_t)(f0 + fl) * hop + 2 * m;
          const float2 w = __ldg(win + m);
          p = make_float2(fr[0] * w.x, fr[1] * w.y);
        }
        v[i][r] = p;
      } else {
        v[i][r] = z[fl * zs + pad(m)];
      }
    }
    if constexpr (P > 0) {
      const float2* t = tw + j % NS;
#pragma unroll
      for (int r = 1; r < R; ++r) v[i][r] = cmul(v[i][r], __ldg(t + r * NS));
    }
    dft<BITS>(v[i]);
  }
  if constexpr (P > 0) __syncthreads();     // every read of this pass is done
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = threadIdx.x + i * NT, fl = b / NBF, j = b % NBF;
    if (NB * NT != FB * NBF && b >= FB * NBF) continue;
    const int dst = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int q = 0; q < R; ++q) z[fl * zs + pad(dst + q * NS)] = v[i][q];
  }
  __syncthreads();
}

// frame stride in points: ≡ 16 / FB (mod 16), so the split's FB frames of a
// bin spread over the banks
template <int L>
__host__ __device__ constexpr int zstride() {
  return pad(1 << L) + 16 / FB;
}

// x (rows, T) f32; out (rows, M + 1, n_frames) complex64 as float2; M = 2^L.
// Grid (ceil(n_frames / FB), rows).  Tables: win[m] = (w[2m], w[2m+1]),
// split[k] = e^{-2πik/N} (k <= M), tw1 and tw2 the twiddles of passes 1
// and 2, [r][k % Ns].
template <int L>
__global__ void __launch_bounds__(block_threads(L))
stft_kernel(const float* __restrict__ x, float2* __restrict__ out,
            const float2* __restrict__ win, const float2* __restrict__ split,
            const float2* __restrict__ tw1, const float2* __restrict__ tw2,
            int T, int hop, int n_frames) {
  extern __shared__ __align__(16) float2 z[];
  constexpr int M = 1 << L, ZS = zstride<L>();
  const int f0 = blockIdx.x * FB, row = blockIdx.y;
  const int nf = min(FB, n_frames - f0);
  const float* xr = x + (size_t)row * T;

  fft_pass<L, 0>(z, ZS, xr, hop, f0, nf, win, nullptr);
  if constexpr (n_pass(L) > 1) fft_pass<L, 1>(z, ZS, xr, hop, f0, nf, win, tw1);
  if constexpr (n_pass(L) > 2) fft_pass<L, 2>(z, ZS, xr, hop, f0, nf, win, tw2);
  static_assert(n_pass(L) <= 3, "at most three passes");

  // split the packed spectrum into X[0 .. M], FB frames of a bin together
  for (int i = threadIdx.x; i < (M + 1) * FB; i += block_threads(L)) {
    const int k = i / FB, fl = i % FB;
    if (fl >= nf) continue;
    const float2 zk = z[fl * ZS + pad(k & (M - 1))];
    const float2 zm = z[fl * ZS + pad((M - k) & (M - 1))];
    const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
    const float orr = 0.5f * (zk.y + zm.y), oi = -0.5f * (zk.x - zm.x);
    const float2 e = __ldg(split + k);
    out[((size_t)row * (M + 1) + k) * n_frames + f0 + fl] =
        make_float2(er + e.x * orr - e.y * oi, ei + e.x * oi + e.y * orr);
  }
}

struct Tables {
  const float2 *win, *split, *tw1, *tw2;
};

template <int L>
cudaError_t launch(const float* x, float2* out, Tables t, int schedule,
                   int rows, int T, int hop, int n_frames, cudaStream_t st) {
  // tables laid out for another schedule would give a wrong spectrum
  if (schedule != packed_schedule(L)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)FB * zstride<L>() * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      stft_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  stft_kernel<L><<<dim3((n_frames + FB - 1) / FB, rows), block_threads(L),
                   smem, st>>>(x, out, t.win, t.split, t.tw1, t.tw2, T, hop,
                               n_frames);
  return cudaGetLastError();
}

}  // namespace

// x (rows, T) f32 -> out (rows, n_fft/2 + 1, n_frames) complex64 on
// `stream`; frame f reads x[f hop .. f hop + n_fft), so T >= (n_frames - 1)
// hop + n_fft.  n_fft a power of two from 256 to 8192.  The wrapper's f32
// tables for this n_fft: window pairs, split factors, and the twiddles of
// passes 1 and 2 (tw2 unused with two passes); `schedule` the radix bits of
// the passes they were built for, 4 bits a pass.  Returns the first CUDA
// error (0 on success).
extern "C" int stft_launch(const void* x, void* out, const void* win,
                           const void* split, const void* tw1, const void* tw2,
                           int rows, int T, int n_fft, int hop, int n_frames,
                           int schedule, void* stream) {
  const float* xs = static_cast<const float*>(x);
  float2* o = static_cast<float2*>(out);
  const Tables t = {static_cast<const float2*>(win),
                    static_cast<const float2*>(split),
                    static_cast<const float2*>(tw1),
                    static_cast<const float2*>(tw2)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 256: return (int)launch<7>(xs, o, t, schedule, rows, T, hop, n_frames, st);
    case 512: return (int)launch<8>(xs, o, t, schedule, rows, T, hop, n_frames, st);
    case 1024: return (int)launch<9>(xs, o, t, schedule, rows, T, hop, n_frames, st);
    case 2048: return (int)launch<10>(xs, o, t, schedule, rows, T, hop, n_frames, st);
    case 4096: return (int)launch<11>(xs, o, t, schedule, rows, T, hop, n_frames, st);
    case 8192: return (int)launch<12>(xs, o, t, schedule, rows, T, hop, n_frames, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
