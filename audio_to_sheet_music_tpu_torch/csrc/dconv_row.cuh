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
// t = T - 1.
//
// Numerics: the operands of the two convolutions (x, the GELU output and
// both weights) are rounded to bf16, and their products are summed in f32
// on the tensor cores.  That is the JAX package's rule for this routine on
// bf16 input (pallas_enc.py:219-223 passes dot_dtype into
// pallas_dconv._block_body), which the plain versions follow with
// dot_dtype=bf16.  The statistics, the GELU, the sigmoid, the residual and
// the result of block 0 stay f32; the output is rounded once.
//
// Why not one block per row: a row of C = 384 by T = 259 is 398 KB in f32,
// far over the 227 KB of shared memory a Hopper block has, and layer 3 of a
// training batch has only 8 x 8 rows.  So each block is three launches over
// (row, 64-frame tile) blocks, which fill the card at every layer and take
// any T (a 1-D grid with a row's tiles adjacent, so the blocks in flight
// read neighbouring frames).  Each launch is a GEMM over the tile with the
// frame axis as M, run as mma.sync.m16n8k16 bf16 tiles with f32
// accumulators, and an epilogue:
//
//   1. conv1_kernel: u^T [TT x H] = sum_k X_k^T [TT x C] W1_k^T [C x H] + b1,
//      the three dilated taps as three K-slices over one x tile with its
//      halo -> u in global scratch (R, T, H) f32, and the tile's mean and M2
//      (sum of squared deviations) of u.
//   2. conv2_stats_kernel: the row's GN1 statistics, merged from the tiles'
//      (mean, M2) pairs (Chan's parallel formula, in tile order, by one
//      thread from a copy in shared memory); GN1 + GELU of the u tile,
//      rounded to bf16; z^T [TT x 2C] = u^T W2^T + b2 in registers, twice
//      (the tile's mean of z, then its M2).
//   3. apply_kernel: both rows' statistics merged again; z recomputed, each
//      warp holding the `a` column c and the gate column c + C in the same
//      fragment slots, so GN2, GLU, LayerScale and the residual happen in
//      registers; in place when the input is the f32 scratch.
//
// Layouts.  The x tile is staged frame-major in shared memory (frame rows
// of Cp + 8 bf16 channels, Cp = C rounded up to 16): a tap shifts the tile
// by 1 or 2 frames, which in a channel-major tile would put ldmatrix's
// 16-byte rows off their alignment, while here a tap only moves the row
// index.  The 8 bf16 of padding a row make the eight row addresses of an
// ldmatrix phase land on eight different 16-byte bank groups for every Cp.
// The weights come from the wrapper in bf16 as the products read them: w1
// as 3 taps x (C, Hp) (read with ldmatrix.trans), w2 as (2C, Hp), Hp = H
// rounded up to 16, the MMA's k and n granularity; the pad is zero weights,
// the hidden pad is zero values, and the GN1 statistics count only the H
// real channels.  Each block stages the weights of its GEMM in shared
// memory (rows of Hp + 8) by cp.async.
//
// Widest row: C = MAX_C = 384, the model's widest.  conv1 stages all of w1
// (3 Cp (Hp + 8) bf16) beside the x tile: 202 KB at C = 384 against the 227
// KB a Hopper block may have, 251 KB at C = 392.  run() refuses a wider C,
// and so do the wrappers and the model's routing tests.
//
// Each tile's statistics are two-pass, and the merge of (count, mean, M2)
// pairs is exact algebra, so the statistics are as good as a two-pass over
// the whole row.
//
// What bounds it on an H100.  By its work, bytes: the products of a
// layer-1 form take ~0.006 ms at the bf16 tensor rate, and the three
// launches move x twice a block plus the f32 result of block 0 and u.  In
// fact it runs at 26-81x that byte bound (the times below): each (row,
// tile) block is a short chain of dependent steps (stage the weights and
// the row's statistics, load the tile, one small GEMM, reduce), and with
// 4-5 blocks an SM (one at C = 384, whose conv1 stages 129 KB of w1) too
// few loads are in flight to cover the latency.  A conv1 that loaded
// fragments four steps ahead with two accumulator sets, and kept 16 x loads
// in flight a thread, measured slower (110-118 registers: two blocks an
// SM); it is not kept.
//
// One frame tile, 64 frames.  Against a copy of this routine built with 32
// (on an H100 80GB HBM3 at its 700 W limit, CUDA events, the two builds
// timed in turns): dconv_rows at 1024 x 96 / 256 x 192 / 64 x 384 rows by
// 259 frames took 0.809 / 0.517 / 0.569 ms at 64 against 1.028 / 0.493 /
// 0.476 at 32, so 64 wins only at C = 96 and on the mean weighted as a
// training step launches them (0.631 against 0.666 ms), and loses 5-20 %
// at C = 192 / 384; henc_freq_fused (C = 48) took 2.209 / 2.486 ms (4 x 6 s,
// one 30 s chunk) at 64 against 2.643 / 3.182 at 32.  The 32-frame tile is
// not kept.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dconv {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int TT = 64;           // frames per tile
constexpr int MT = TT / 16;      // 16-frame MMA row tiles per tile
constexpr int MH = 2;            // row tiles of one z work item (32 frames)
constexpr int XB = 8;            // x loads a conv1 thread keeps in flight
constexpr int MAX_C = 384;       // widest row conv1's shared memory holds
constexpr size_t MAX_SMEM = 227 * 1024;   // a Hopper block's, opted in
constexpr float EPS = 1e-5f;

// One DConv block's weights: w1 (3, C, Hp) and w2 (2C, Hp) bf16, zero for
// h >= H; b1 g1 bt1 (H), b2 g2 bt2 (2C), s (C) f32.
struct BlockW {
  const bf16* w1;
  const float *b1, *g1, *bt1;
  const bf16* w2;
  const float *b2, *g2, *bt2, *s;
};

// The MMA's k16 (and two n8 tiles): channel and hidden counts are padded to it.
__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline int n_tiles(int T) { return (T + TT - 1) / TT; }

// conv1's output is MT x Hp/16 tiles of 16 x 16; when they are fewer than
// the warps, each tile's K (3 taps x Cp/16 steps) is split this many ways.
__host__ __device__ constexpr int k_split(int H) {
  const int ot = MT * (pad16(H) / 16);
  return ot < NWARP ? NWARP / ot : 1;
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes global -> shared without a register round trip; the copies of
// a thread are in flight together until cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d += a (16x16, row-major) * b (16x8, col-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows 0-15, columns 0-15 of a row-major tile at `p`
// with `stride` elements a row.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p,
                                       int stride, int lane) {
  ldsm_x4(a, p + (lane & 15) * stride + (lane >> 4) * 8);
}

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
  for (int i = 0; i < NWARP; ++i) t += red[i];
  return t;
}

// Mean and M2 of the n values at v (shared memory); thread 0 writes them
// to `part`.
__device__ __forceinline__ void tile_stats(const float* v, int n, float* red,
                                           float* part) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += NT) s += v[i];
  const float mean = block_sum(s, red) / n;
  float q = 0.0f;
  for (int i = threadIdx.x; i < n; i += NT) {
    const float d = v[i] - mean;
    q += d * d;
  }
  const float m2 = block_sum(q, red);
  if (threadIdx.x == 0) {
    part[0] = mean;
    part[1] = m2;
  }
}

// n floats from global to shared memory, all threads at once (the caller
// syncs): the row's (mean, M2) pairs, read once instead of by every thread
// in the merge's dependent chain.
__device__ __forceinline__ void stage(const float* src, int n, float* dst) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// The row's mean and 1/sqrt(var + eps) from its tiles' (mean, M2) pairs
// (staged in shared memory), merged in tile order (Chan et al.); `per_t`
// channels per frame.
__device__ __forceinline__ void row_stats(const float* part, int ntile, int T,
                                          int per_t, float& mean,
                                          float& rstd) {
  float n = 0.0f, m = 0.0f, m2 = 0.0f;
  for (int k = 0; k < ntile; ++k) {
    const float nb = (float)(per_t * min(TT, T - k * TT));
    const float mb = part[2 * k], qb = part[2 * k + 1];
    const float tot = n + nb, d = mb - m, f = nb / tot;
    m += d * f;
    m2 += qb + d * d * n * f;
    n = tot;
  }
  mean = m;
  rstd = rsqrtf(m2 / n + EPS);
}

// 1. u = conv1(x) + b1 over one (row, tile); the tile's statistics of u.
// One block a (row, tile).  Shared: the x tile with its halo (W = TT +
// 2 dil frame rows of XS bf16), w1 (3 Cp rows of HS bf16), the partial
// sums of the S = k_split(H) K-slices (S x TT x Hp f32), the u tile
// (len x H f32), reduction scratch.
template <typename TIn>
__global__ void __launch_bounds__(NT)
conv1_kernel(const TIn* __restrict__ x, BlockW w, float* __restrict__ u,
             float* __restrict__ part, int C, int H, int T, int dil) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntile = n_tiles(T);
  const int r = blockIdx.x / ntile, tile = blockIdx.x % ntile;
  const int t0 = tile * TT, len = min(TT, T - t0), W = TT + 2 * dil;
  const int Cp = pad16(C), Hp = pad16(H), XS = Cp + 8, HS = Hp + 8;
  const int OT = MT * (Hp / 16), S = k_split(H), KS = Cp / 16;
  bf16* xs = reinterpret_cast<bf16*>(smem);   // frame t0 - dil + f at row f
  bf16* ws = xs + W * XS;
  float* acc = reinterpret_cast<float*>(ws + 3 * Cp * HS);
  float* us = acc + S * TT * Hp;
  float* red = us + TT * H;

  const int hc = Hp / 8;            // 16-byte chunks a weight row
  for (int i = threadIdx.x; i < 3 * Cp * hc; i += NT) {
    const int row = i / hc, q = i % hc, k = row / Cp, c = row % Cp;
    if (c < C)
      cp_async16(ws + row * HS + q * 8,
                 w.w1 + ((size_t)k * C + c) * Hp + q * 8);
    else
      *reinterpret_cast<uint4*>(ws + row * HS + q * 8) = make_uint4(0, 0, 0, 0);
  }
  // x, two channels of one frame a thread, XB such loads in flight
  const TIn* xr = x + (size_t)r * C * T;
  const int nx = (Cp / 2) * W;
  for (int i0 = threadIdx.x; i0 < nx; i0 += XB * NT) {
    float v[XB][2];
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      const int i = i0 + b * NT, c = 2 * (i / W), t = t0 - dil + i % W;
      v[b][0] = v[b][1] = 0.0f;
      if (i < nx && c < C && t >= 0 && t < T) {
        v[b][0] = ld(xr + (size_t)c * T + t);
        v[b][1] = ld(xr + (size_t)(c + 1) * T + t);
      }
    }
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      const int i = i0 + b * NT;
      if (i < nx)
        *reinterpret_cast<__nv_bfloat162*>(xs + (i % W) * XS + 2 * (i / W)) =
            __floats2bfloat162_rn(v[b][0], v[b][1]);
    }
  }
  cp_async_wait();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int item = warp; item < OT * S; item += NWARP) {
    const int ot = item % OT, s = item / OT, mt = ot % MT, n0 = (ot / MT) * 16;
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int kk = s; kk < 3 * KS; kk += S) {
      const int k = kk / KS, c0 = (kk % KS) * 16;
      uint32_t a[4], b[4];
      // output frame j reads x at frame j + (k - 1) dil: tile row j + k dil
      load_a(a, xs + (mt * 16 + k * dil) * XS + c0, XS, lane);
      ldsm_x4_trans(b, ws + (k * Cp + c0 + (lane & 15)) * HS + n0 +
                           (lane >> 4) * 8);
      mma_bf16(d0, a, b[0], b[1]);
      mma_bf16(d1, a, b[2], b[3]);
    }
    float* o = acc + ((size_t)s * TT + mt * 16 + g) * Hp + n0 + 2 * q;
    *reinterpret_cast<float2*>(o) = make_float2(d0[0], d0[1]);
    *reinterpret_cast<float2*>(o + 8 * Hp) = make_float2(d0[2], d0[3]);
    *reinterpret_cast<float2*>(o + 8) = make_float2(d1[0], d1[1]);
    *reinterpret_cast<float2*>(o + 8 * Hp + 8) = make_float2(d1[2], d1[3]);
  }
  __syncthreads();

  // u is (R, T, H): the tile's valid frames are one contiguous run
  float* ur = u + ((size_t)r * T + t0) * H;
  const int n = len * H;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int j = i / H, h = i % H;
    float v = __ldg(w.b1 + h);
    for (int s = 0; s < S; ++s) v += acc[((size_t)s * TT + j) * Hp + h];
    us[i] = v;
    ur[i] = v;
  }
  __syncthreads();
  tile_stats(us, n, red, part + 2 * ((size_t)r * ntile + tile));
}

// w2 (2C, Hp) into shared memory, rows of HS, by cp.async (the caller
// waits).
__device__ __forceinline__ void load_w2(const BlockW& w, int C, int Hp,
                                        int HS, bf16* ws) {
  const int hc = Hp / 8;
  for (int i = threadIdx.x; i < 2 * C * hc; i += NT) {
    const int o = i / hc, q = i % hc;
    cp_async16(ws + o * HS + q * 8, w.w2 + (size_t)o * Hp + q * 8);
  }
}

// GN1 + GELU of the tile's u (len x H at ut), rounded to bf16, into the
// frame-major hidden tile (TT rows of HS); zeros past len and for h >= H.
__device__ __forceinline__ void load_hidden(const float* ut, const BlockW& w,
                                            float mean1, float rstd1, int H,
                                            int Hp, int HS, int len,
                                            bf16* hs) {
#pragma unroll 4
  for (int i = threadIdx.x; i < TT * Hp; i += NT) {
    const int j = i / Hp, h = i % Hp;
    float v = 0.0f;
    if (j < len && h < H)
      v = gelu((ut[j * H + h] - mean1) * rstd1 * __ldg(w.g1 + h) +
               __ldg(w.bt1 + h));
    hs[j * HS + h] = __float2bfloat16(v);
  }
}

// z = u w2^T + b2 at the `a` columns 8p..8p+7 (za) and the gate columns
// C + 8p.. (zg), for the MH row tiles from mt0: one work item of a warp.
// Fragment slot e of [i] is frame (mt0 + i)*16 + g (+8 for e >= 2), column
// 2q + (e & 1) of the eight.
__device__ __forceinline__ void z_pair(const bf16* ws, const bf16* hs,
                                       const float* b2, int p, int mt0, int C,
                                       int Hp, int HS, int lane,
                                       float (&za)[MH][4],
                                       float (&zg)[MH][4]) {
  const int n0 = 8 * p;
#pragma unroll
  for (int i = 0; i < MH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) za[i][e] = zg[i][e] = 0.0f;
  // lanes 0-15: `a` rows (k 0-7, then 8-15); lanes 16-31: gate rows
  const bf16* wrow = ws + ((lane < 16 ? n0 : n0 + C) + (lane & 7)) * HS +
                     ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < Hp; k0 += 16) {
    uint32_t b[4];
    ldsm_x4(b, wrow + k0);
#pragma unroll
    for (int i = 0; i < MH; ++i) {
      uint32_t a[4];
      load_a(a, hs + (mt0 + i) * 16 * HS + k0, HS, lane);
      mma_bf16(za[i], a, b[0], b[1]);
      mma_bf16(zg[i], a, b[2], b[3]);
    }
  }
  const int c = n0 + 2 * (lane & 3);
  const float ba0 = __ldg(b2 + c), ba1 = __ldg(b2 + c + 1);
  const float bg0 = __ldg(b2 + C + c), bg1 = __ldg(b2 + C + c + 1);
#pragma unroll
  for (int i = 0; i < MH; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      za[i][e] += ba0;
      za[i][e + 1] += ba1;
      zg[i][e] += bg0;
      zg[i][e + 1] += bg1;
    }
}

// Shared memory of conv2_stats_kernel and apply_kernel: w2, the hidden tile,
// the row's two arrays of (mean, M2) pairs, the merged statistics and the
// reduction scratch.
inline size_t z_smem(int C, int H, int ntile) {
  const int HS = pad16(H) + 8;
  return ((size_t)2 * C * HS + (size_t)TT * HS) * sizeof(bf16) +
         ((size_t)4 * ntile + 4 + NWARP) * sizeof(float);
}

// The start of both z kernels: w2 and the row's (mean, M2) pairs of `n`
// statistics (u's, then z's) into shared memory, the merge of each by one
// thread into rs (mean, rstd pairs), and the tile's hidden.
__device__ __forceinline__ void z_prologue(const float* u, const float* part1,
                                           const float* part2, int n,
                                           const BlockW& w, int C, int H,
                                           int T, bf16* ws, bf16* hs,
                                           float* ps, float* rs) {
  const int ntile = n_tiles(T);
  const int r = blockIdx.x / ntile, tile = blockIdx.x % ntile;
  const int t0 = tile * TT, len = min(TT, T - t0), Hp = pad16(H);
  const int HS = Hp + 8;
  load_w2(w, C, Hp, HS, ws);
  stage(part1 + 2 * (size_t)r * ntile, 2 * ntile, ps);
  if (n > 1) stage(part2 + 2 * (size_t)r * ntile, 2 * ntile, ps + 2 * ntile);
  __syncthreads();
  if (threadIdx.x == 0) row_stats(ps, ntile, T, H, rs[0], rs[1]);
  if (threadIdx.x == 32 && n > 1)
    row_stats(ps + 2 * ntile, ntile, T, 2 * C, rs[2], rs[3]);
  __syncthreads();
  load_hidden(u + ((size_t)r * T + t0) * H, w, rs[0], rs[1], H, Hp, HS, len,
              hs);
  cp_async_wait();
  __syncthreads();
}

// 2. GN1 + GELU, z = w2 u + b2 over one (row, tile); the tile's statistics
// of z.  One block a (row, tile).
__global__ void __launch_bounds__(NT)
conv2_stats_kernel(const float* __restrict__ u,
                   const float* __restrict__ part1, BlockW w,
                   float* __restrict__ part2, int C, int H, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntile = n_tiles(T);
  const int r = blockIdx.x / ntile, tile = blockIdx.x % ntile;
  const int len = min(TT, T - tile * TT), Hp = pad16(H), HS = Hp + 8;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hs = ws + 2 * C * HS;
  float* ps = reinterpret_cast<float*>(hs + TT * HS);
  float* rs = ps + 4 * ntile;
  float* red = rs + 4;
  z_prologue(u, part1, nullptr, 1, w, C, H, T, ws, hs, ps, rs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int items = (C / 8) * (MT / MH);
  float za[MH][4], zg[MH][4];
  float s = 0.0f;
  for (int it = warp; it < items; it += NWARP) {
    const int mt0 = (it % (MT / MH)) * MH;
    z_pair(ws, hs, w.b2, it / (MT / MH), mt0, C, Hp, HS, lane, za, zg);
#pragma unroll
    for (int i = 0; i < MH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((mt0 + i) * 16 + g + (e >> 1) * 8 < len) s += za[i][e] + zg[i][e];
  }
  const float mean = block_sum(s, red) / (2 * C * len);
  float qs = 0.0f;
  for (int it = warp; it < items; it += NWARP) {
    const int mt0 = (it % (MT / MH)) * MH;
    z_pair(ws, hs, w.b2, it / (MT / MH), mt0, C, Hp, HS, lane, za, zg);
#pragma unroll
    for (int i = 0; i < MH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((mt0 + i) * 16 + g + (e >> 1) * 8 < len) {
          const float da = za[i][e] - mean, dg = zg[i][e] - mean;
          qs += da * da + dg * dg;
        }
  }
  const float m2 = block_sum(qs, red);
  if (threadIdx.x == 0) {
    float* pt = part2 + 2 * ((size_t)r * ntile + tile);
    pt[0] = mean;
    pt[1] = m2;
  }
}

// 3. out = x + s * GLU(GN2(z)) over one (row, tile), z recomputed.  `x` and
// `out` may be the same f32 buffer: each element is read and then written by
// the same thread.  One block a (row, tile).
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(NT)
apply_kernel(const TIn* x, const float* __restrict__ u,
             const float* __restrict__ part1, const float* __restrict__ part2,
             BlockW w, TOut* out, int C, int H, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntile = n_tiles(T);
  const int r = blockIdx.x / ntile, tile = blockIdx.x % ntile;
  const int t0 = tile * TT, len = min(TT, T - t0);
  const int Hp = pad16(H), HS = Hp + 8;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hs = ws + 2 * C * HS;
  float* ps = reinterpret_cast<float*>(hs + TT * HS);
  float* rs = ps + 4 * ntile;
  z_prologue(u, part1, part2, 2, w, C, H, T, ws, hs, ps, rs);
  const float mean2 = rs[2], rstd2 = rs[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int it = warp; it < (C / 8) * (MT / MH); it += NWARP) {
    const int p = it / (MT / MH), mt0 = (it % (MT / MH)) * MH;
    // x of the item's elements first, ahead of the products: `out` may
    // alias `x`, so no load may wait behind a store
    const size_t row0 = ((size_t)r * C + 8 * p + 2 * q) * T + t0;
    float xv[2][MH][2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < MH; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = (mt0 + i) * 16 + g + 8 * hf;
          xv[e][i][hf] = j < len ? ld(x + row0 + e * (size_t)T + j) : 0.0f;
        }
    float za[MH][4], zg[MH][4];
    z_pair(ws, hs, w.b2, p, mt0, C, Hp, HS, lane, za, zg);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * p + 2 * q + e;
      const float ga = __ldg(w.g2 + c) * rstd2, ba = __ldg(w.bt2 + c);
      const float gg = __ldg(w.g2 + c + C) * rstd2, bg = __ldg(w.bt2 + c + C);
      const float sc = __ldg(w.s + c);
#pragma unroll
      for (int i = 0; i < MH; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = (mt0 + i) * 16 + g + 8 * hf;
          if (j >= len) continue;
          const float a = (za[i][2 * hf + e] - mean2) * ga + ba;
          const float gt = (zg[i][2 * hf + e] - mean2) * gg + bg;
          st(out + row0 + e * (size_t)T + j,
             xv[e][i][hf] + sc * a * sigmoid(gt));
        }
    }
  }
}

// Floats of the `part` scratch `run` needs: two (R, ntile, 2) arrays.
inline size_t part_floats(int R, int T) { return 4 * (size_t)R * n_tiles(T); }

// The hidden width the weights are padded to: C/8 rounded up to the MMA's
// k and n granularity.
inline int hidden_pad(int C) { return pad16(C / 8); }

constexpr size_t conv1_smem(int C, int dil) {
  const int Cp = pad16(C), H = C / 8, Hp = pad16(H), S = k_split(H);
  return ((size_t)(TT + 2 * dil) * (Cp + 8) + (size_t)3 * Cp * (Hp + 8)) *
             sizeof(bf16) +
         ((size_t)S * TT * Hp + (size_t)TT * H + NWARP) * sizeof(float);
}
// block 1 (dilation 2) needs the most
static_assert(conv1_smem(MAX_C, 2) <= MAX_SMEM, "MAX_C: conv1 does not fit");
static_assert(conv1_smem(MAX_C + 8, 2) > MAX_SMEM, "MAX_C is not the widest");

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One DConv block over (R, C, T) rows: x -> out (may alias x when both are
// f32).  u: R T C/8 floats; part: part_floats(R, T) floats.
template <typename TIn, typename TOut>
inline cudaError_t run_block(const TIn* x, const BlockW& w, float* u,
                             float* part, TOut* out, int R, int C, int T,
                             int dil, cudaStream_t st) {
  const int H = C / 8, ntile = n_tiles(T);
  float* part1 = part;
  float* part2 = part + 2 * (size_t)R * ntile;
  const dim3 grid(R * ntile);       // the tiles of a row adjacent
  const size_t s1 = conv1_smem(C, dil), s2 = z_smem(C, H, ntile);
  cudaError_t e = allow_smem(conv1_kernel<TIn>, s1);
  if (e == cudaSuccess) e = allow_smem(conv2_stats_kernel, s2);
  if (e == cudaSuccess) e = allow_smem(apply_kernel<TIn, TOut>, s2);
  if (e != cudaSuccess) return e;
  conv1_kernel<TIn><<<grid, NT, s1, st>>>(x, w, u, part1, C, H, T, dil);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  conv2_stats_kernel<<<grid, NT, s2, st>>>(u, part1, w, part2, C, H, T);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  apply_kernel<TIn, TOut><<<grid, NT, s2, st>>>(x, u, part1, part2, w, out,
                                                C, H, T);
  return cudaGetLastError();
}

// Both DConv blocks: x -> mid (f32, block 0) -> out (block 1).  With f32 x,
// mid and out may all be one buffer.  C must be a multiple of 8 up to MAX_C.
template <typename TIn, typename TOut>
inline cudaError_t run(const TIn* x, const BlockW* w, float* mid, float* u,
                       float* part, TOut* out, int R, int C, int T,
                       cudaStream_t st) {
  if (C < 8 || C % 8 || C > MAX_C) return cudaErrorInvalidValue;
  cudaError_t e = run_block<TIn, float>(x, w[0], u, part, mid, R, C, T, 1, st);
  if (e != cudaSuccess) return e;
  return run_block<float, TOut>(mid, w[1], u, part, out, R, C, T, 2, st);
}

// The 18 weight pointers (block 0 then block 1, each w1 b1 g1 bt1 w2 b2 g2
// bt2 s; w1 and w2 bf16, the rest f32) as two BlockW.
inline void unpack(const void* const* dw, BlockW* w) {
  for (int i = 0; i < 2; ++i) {
    const void* const* p = dw + 9 * i;
    auto f = [p](int k) { return static_cast<const float*>(p[k]); };
    w[i] = BlockW{static_cast<const bf16*>(p[0]), f(1), f(2), f(3),
                  static_cast<const bf16*>(p[4]), f(5), f(6), f(7), f(8)};
  }
}

}  // namespace dconv
