// The HTDemucs DConv residual branch over (row, channel, time) rows, for any
// number of frames.  Shared by dconv_rows.cu (the folded freq rows of encoder
// layers 1-3) and henc_freq.cu (freq encoder layer 0), as the JAX package
// shares ops/pallas_dconv.py:_block_body between its two kernels.
//
// Per row of C channels by T frames, two blocks d = 0, 1 (dilation 2^d):
//
//   u = GELU(GN1(conv_{k=3, dil}(x) + b1))               (H = C/8 channels)
//   z = GN2(w2 u + b2)                                   (2C channels)
//   x = x + scale * z[:C] * sigmoid(z[C:])
//
// GN1 / GN2 are GroupNorm(1): statistics per row over all of its (channels,
// T) positions, in f32; the dilated taps read zeros before t = 0 and past
// t = T - 1.  Everything between the input and the output is f32; the
// output is rounded once, to the output type.
//
// Why not one block per row: a row of C = 384 by T = 259 is 398 KB in f32
// (447 KB with the hidden), far over the 227 KB of shared memory a Hopper
// block has, and layer 3 of a training batch has only 8 x 8 rows.  So each
// block is three launches over a (row, 32-frame tile) grid, which fills the
// card at every layer and takes any T:
//
//   1. conv1_kernel: conv1 over the tile (a dilation halo of x in shared
//      memory) -> u in global scratch (R, H, T) f32, and the tile's mean and
//      M2 (sum of squared deviations) of u.
//   2. conv2_stats_kernel: the row's GN1 statistics, merged from the tiles'
//      (mean, M2) pairs (Chan's parallel formula, the same order in every
//      block); GN1 + GELU of the u tile; z = w2 u + b2 for the tile in shared
//      memory (2C x 32 f32, 96 KB at C = 384); the tile's mean and M2 of z.
//   3. apply_kernel: both rows' statistics merged again; z recomputed (an
//      H-deep dot per element), GN2, GLU, LayerScale and the residual, in
//      place when the input is the f32 scratch.
//
// Each tile's statistics are two-pass over values held in shared memory, and
// the merge of (count, mean, M2) pairs is exact algebra, so the statistics
// are as good as a two-pass over the whole row.  x is read from L2 between
// the passes of a block (199 KB of bf16 a row at C = 384).
//
// What bounds it on an H100: its bytes, when its operations are priced at
// the bf16 tensor-core rate, as its bf16 input allows.  This version does
// every product as f32 FMAs on the CUDA cores (3CH for conv1 and 2 x 2CH for
// conv2 per frame and block), so the FMA units bound it in fact; moving conv1
// and conv2 onto mma tiles is the next step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace dconv {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;          // threads per block
constexpr int TT = 32;           // frames per tile
constexpr float EPS = 1e-5f;

// f32 weights of one DConv block, in torch layouts:
// w1 (H, C, 3), b1 g1 bt1 (H), w2 (2C, H), b2 g2 bt2 (2C), s (C).
struct BlockW {
  const float *w1, *b1, *g1, *bt1, *w2, *b2, *g2, *bt2, *s;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }

// Sum over the block; every thread gets the same value.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                  // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) t += red[i];
  return t;
}

// Mean and M2 of the first `len` columns of a (rows x TT) tile in shared
// memory; thread 0 writes them to `part`.
__device__ __forceinline__ void tile_stats(const float* v, int rows, int len,
                                           float* red, float* part) {
  const int n = rows * len;
  float s = 0.0f;
  for (int i = threadIdx.x; i < rows * TT; i += NT)
    if (i % TT < len) s += v[i];
  const float mean = block_sum(s, red) / n;
  float q = 0.0f;
  for (int i = threadIdx.x; i < rows * TT; i += NT)
    if (i % TT < len) {
      const float d = v[i] - mean;
      q += d * d;
    }
  const float m2 = block_sum(q, red);
  if (threadIdx.x == 0) {
    part[0] = mean;
    part[1] = m2;
  }
}

// The row's mean and 1/sqrt(var + eps) from its tiles' (mean, M2) pairs,
// merged in tile order (Chan et al.); `per_t` channels per frame.
__device__ __forceinline__ void row_stats(const float* part, int ntile, int T,
                                          int per_t, float& mean,
                                          float& rstd) {
  float n = 0.0f, m = 0.0f, m2 = 0.0f;
  for (int k = 0; k < ntile; ++k) {
    const float nb = (float)(per_t * min(TT, T - k * TT));
    const float mb = part[2 * k], qb = part[2 * k + 1];
    const float tot = n + nb, d = mb - m;
    m += d * (nb / tot);
    m2 += qb + d * d * (n * nb / tot);
    n = tot;
  }
  mean = m;
  rstd = rsqrtf(m2 / n + EPS);
}

// GN1 + GELU of the row's u tile into shared memory (zeros past `len`).
__device__ __forceinline__ void load_hidden(const float* u, const BlockW& w,
                                            float mean1, float rstd1, int H,
                                            int T, int t0, int len,
                                            float* us) {
  for (int i = threadIdx.x; i < H * TT; i += NT) {
    const int h = i / TT, j = i % TT;
    us[i] = j < len ? gelu((u[(size_t)h * T + t0 + j] - mean1) * rstd1 *
                               __ldg(w.g1 + h) + __ldg(w.bt1 + h))
                    : 0.0f;
  }
}

__device__ __forceinline__ float z_at(const BlockW& w, const float* us, int o,
                                      int j, int H) {
  float acc = __ldg(w.b2 + o);
  const float* wo = w.w2 + (size_t)o * H;
  for (int h = 0; h < H; ++h) acc += __ldg(wo + h) * us[h * TT + j];
  return acc;
}

// 1. u = conv1(x) + b1 over one (row, tile); the tile's statistics of u.
// Grid (R, ntile).  Shared: x tile with halo (C x (TT + 2 dil)), u tile
// (H x TT), reduction scratch.
template <typename TIn>
__global__ void __launch_bounds__(NT)
conv1_kernel(const TIn* __restrict__ x, BlockW w, float* __restrict__ u,
             float* __restrict__ part, int C, int H, int T, int dil) {
  extern __shared__ __align__(16) float sm[];
  const int r = blockIdx.x, tile = blockIdx.y, ntile = gridDim.y;
  const int t0 = tile * TT, len = min(TT, T - t0), W = TT + 2 * dil;
  float* xs = sm;                   // C x W: frame t0 - dil + j at column j
  float* us = xs + C * W;           // H x TT
  float* red = us + H * TT;         // NT / 32
  const TIn* xr = x + (size_t)r * C * T;
  for (int i = threadIdx.x; i < C * W; i += NT) {
    const int c = i / W, t = t0 - dil + i % W;
    xs[i] = (t >= 0 && t < T) ? ld(xr + (size_t)c * T + t) : 0.0f;
  }
  __syncthreads();
  float* ur = u + (size_t)r * H * T;
  for (int i = threadIdx.x; i < H * TT; i += NT) {
    const int h = i / TT, j = i % TT;
    float acc = 0.0f;
    if (j < len) {
      acc = __ldg(w.b1 + h);
      const float* wk = w.w1 + (size_t)h * C * 3;
      for (int c = 0; c < C; ++c) {
        const float* xc = xs + c * W + j;   // taps t - dil, t, t + dil
        acc += __ldg(wk + 3 * c) * xc[0] + __ldg(wk + 3 * c + 1) * xc[dil] +
               __ldg(wk + 3 * c + 2) * xc[2 * dil];
      }
      ur[(size_t)h * T + t0 + j] = acc;
    }
    us[i] = acc;
  }
  __syncthreads();
  tile_stats(us, H, len, red, part + 2 * ((size_t)r * ntile + tile));
}

// 2. GN1 + GELU, z = w2 u + b2 over one (row, tile); the tile's statistics
// of z.  Grid (R, ntile).  Shared: u tile (H x TT), z tile (2C x TT).
__global__ void __launch_bounds__(NT)
conv2_stats_kernel(const float* __restrict__ u,
                   const float* __restrict__ part1, BlockW w,
                   float* __restrict__ part2, int C, int H, int T) {
  extern __shared__ __align__(16) float sm[];
  const int r = blockIdx.x, tile = blockIdx.y, ntile = gridDim.y;
  const int t0 = tile * TT, len = min(TT, T - t0);
  float* us = sm;                   // H x TT
  float* zs = us + H * TT;          // 2C x TT
  float* red = zs + 2 * C * TT;     // NT / 32
  float mean1, rstd1;
  row_stats(part1 + 2 * (size_t)r * ntile, ntile, T, H, mean1, rstd1);
  load_hidden(u + (size_t)r * H * T, w, mean1, rstd1, H, T, t0, len, us);
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C * TT; i += NT) {
    const int o = i / TT, j = i % TT;
    zs[i] = j < len ? z_at(w, us, o, j, H) : 0.0f;
  }
  __syncthreads();
  tile_stats(zs, 2 * C, len, red, part2 + 2 * ((size_t)r * ntile + tile));
}

// 3. out = x + s * GLU(GN2(z)) over one (row, tile), z recomputed.  `x` and
// `out` may be the same f32 buffer: each element is read and then written by
// the same thread.  Grid (R, ntile).  Shared: u tile (H x TT).
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(NT)
apply_kernel(const TIn* x, const float* __restrict__ u,
             const float* __restrict__ part1, const float* __restrict__ part2,
             BlockW w, TOut* out, int C, int H, int T) {
  extern __shared__ __align__(16) float sm[];
  const int r = blockIdx.x, tile = blockIdx.y, ntile = gridDim.y;
  const int t0 = tile * TT, len = min(TT, T - t0);
  float* us = sm;                   // H x TT
  float mean1, rstd1, mean2, rstd2;
  row_stats(part1 + 2 * (size_t)r * ntile, ntile, T, H, mean1, rstd1);
  row_stats(part2 + 2 * (size_t)r * ntile, ntile, T, 2 * C, mean2, rstd2);
  load_hidden(u + (size_t)r * H * T, w, mean1, rstd1, H, T, t0, len, us);
  __syncthreads();
  for (int i = threadIdx.x; i < C * TT; i += NT) {
    const int c = i / TT, j = i % TT;
    if (j >= len) continue;
    const float a = (z_at(w, us, c, j, H) - mean2) * rstd2 * __ldg(w.g2 + c) +
                    __ldg(w.bt2 + c);
    const float g = (z_at(w, us, c + C, j, H) - mean2) * rstd2 *
                        __ldg(w.g2 + c + C) + __ldg(w.bt2 + c + C);
    const size_t idx = ((size_t)r * C + c) * T + t0 + j;
    st(out + idx, ld(x + idx) + __ldg(w.s + c) * a * sigmoid(g));
  }
}

inline int n_tiles(int T) { return (T + TT - 1) / TT; }

// Floats of the `part` scratch `run` needs: two (R, ntile, 2) arrays.
inline size_t part_floats(int R, int T) { return 4 * (size_t)R * n_tiles(T); }

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One DConv block over (R, C, T) rows: x -> out (may alias x when both are
// f32).  u: (R, C/8, T) f32 scratch; part: part_floats(R, T) floats.
template <typename TIn, typename TOut>
inline cudaError_t run_block(const TIn* x, const BlockW& w, float* u,
                             float* part, TOut* out, int R, int C, int T,
                             int dil, cudaStream_t st) {
  const int H = C / 8, ntile = n_tiles(T);
  float* part1 = part;
  float* part2 = part + 2 * (size_t)R * ntile;
  const dim3 grid(R, ntile);
  const size_t s1 = ((size_t)C * (TT + 2 * dil) + H * TT + NT / 32) * 4;
  const size_t s2 = ((size_t)H * TT + 2 * C * TT + NT / 32) * 4;
  const size_t s3 = (size_t)H * TT * 4;
  cudaError_t e = allow_smem(conv1_kernel<TIn>, s1);
  if (e == cudaSuccess) e = allow_smem(conv2_stats_kernel, s2);
  if (e == cudaSuccess) e = allow_smem(apply_kernel<TIn, TOut>, s3);
  if (e != cudaSuccess) return e;
  conv1_kernel<TIn><<<grid, NT, s1, st>>>(x, w, u, part1, C, H, T, dil);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  conv2_stats_kernel<<<grid, NT, s2, st>>>(u, part1, w, part2, C, H, T);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  apply_kernel<TIn, TOut><<<grid, NT, s3, st>>>(x, u, part1, part2, w, out,
                                                C, H, T);
  return cudaGetLastError();
}

// Both DConv blocks: x -> mid (f32, block 0) -> out (block 1).  With f32 x,
// mid and out may all be one buffer.
template <typename TIn, typename TOut>
inline cudaError_t run(const TIn* x, const BlockW* w, float* mid, float* u,
                       float* part, TOut* out, int R, int C, int T,
                       cudaStream_t st) {
  cudaError_t e = run_block<TIn, float>(x, w[0], u, part, mid, R, C, T, 1, st);
  if (e != cudaSuccess) return e;
  return run_block<float, TOut>(mid, w[1], u, part, out, R, C, T, 2, st);
}

// The 18 weight pointers (block 0 then block 1, each w1 b1 g1 bt1 w2 b2 g2
// bt2 s) as two BlockW.
inline void unpack(const void* const* dw, BlockW* w) {
  for (int i = 0; i < 2; ++i) {
    const float* const* p = reinterpret_cast<const float* const*>(dw + 9 * i);
    w[i] = BlockW{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
  }
}

}  // namespace dconv
