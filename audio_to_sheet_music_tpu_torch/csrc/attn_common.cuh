// Attention building blocks shared by layer_tail.cu and attn_block.cu.
//
// - gemm_kernel / gemm: out (M, N) = epilogue(a (M, K) @ wᵀ + bias) with w in
//   torch layout (N, K), bf16 operands and f32 accumulation; 64x64 block
//   tiles over 32-deep K slices double-buffered in shared memory with
//   cp.async, mma.sync m16n8k16, padded shared rows so fragment reads are
//   conflict-free.  N must be a multiple of 64 and K of 32; rows past M read
//   as zero and are not written.
// - flash_kernel: o = per head softmax(q kᵀ · scale) v with 64-wide heads,
//   one block per (64-query tile, head, batch row); K/V stream through
//   shared memory in 64-key tiles with an online (running max / running sum)
//   softmax in registers; keys at or past S are zero-filled and scored
//   -1e30, as in the Pallas kernels' mask.  Scores and output stay in the
//   mma accumulator layout, which is also the P·V operand layout, so the
//   probabilities go from the score registers straight into the product.
//   They are rounded to bf16 unnormalised and divided by the f32 running sum
//   afterwards (the plain versions round the normalised probabilities; both
//   are bf16-rounding-grade).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 128;         // 4 warps per block in every kernel
constexpr int DH = 64;          // head width
constexpr int QT = 64;          // query rows per attention block, 16 a warp
constexpr int KT = 64;          // keys per streamed tile
constexpr int KLD = DH + 8;     // padded shared row of the K / Vᵀ tiles
constexpr int BM = 64, BN = 64, BK = 32;   // GEMM block tile
constexpr int GLD = BK + 8;     // padded shared row of a GEMM tile

// bf16 out = acc + bias; bf16 out = gelu(acc + bias); f32 out = bf16 res +
// gamma (acc + bias); bf16 out = f32 res + gamma (acc + bias); bf16 out =
// bf16 res + gamma (acc + bias).
enum Epilogue { EPI_BIAS, EPI_GELU, EPI_RES_F32, EPI_RES_BF16, EPI_RES_X };

// d (16x8 f32) += a (16x16 bf16, row-major) · b (16x8 bf16, column-major)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// out (M, N) = epilogue(a (M, K) @ wᵀ + bias); w (N, K) in torch layout.
// Grid (ceil(M/BM), N/BN); 4 warps, each a 32x32 piece of the 64x64 tile.
// N is a multiple of BN and K of BK; rows of a past M read as zero.
template <int EPI>
__global__ void __launch_bounds__(NT)
gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
            const float* __restrict__ bias, const float* __restrict__ gamma,
            const void* __restrict__ res, void* __restrict__ out, int M, int N,
            int K) {
  __shared__ __align__(16) bf16 as[2][BM * GLD];
  __shared__ __align__(16) bf16 ws[2][BN * GLD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto load = [&](int stage, int k0) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r;
      cp_async16(&as[stage][r * GLD + c],
                 a + (size_t)(m < M ? m : 0) * K + k0 + c, m < M);
      cp_async16(&ws[stage][r * GLD + c], w + (size_t)(n0 + r) * K + k0 + c,
                 true);
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = K / BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* A = as[kt & 1];
    const bf16* W = ws[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* p = A + (wm + i * 16 + g) * GLD + kk + 2 * t;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * GLD);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * GLD + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* p = W + (wn + j * 8 + g) * GLD + kk + 2 * t;
        bfr[j][0] = ld32(p);
        bfr[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();                 // this stage is refilled next round
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm + i * 16 + g + hr * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        const size_t off = (size_t)m * N + n;
        float v0 = acc[i][j][2 * hr] + bias[n];
        float v1 = acc[i][j][2 * hr + 1] + bias[n + 1];
        if constexpr (EPI == EPI_BIAS) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
              __floats2bfloat162_rn(v0, v1);
        } else if constexpr (EPI == EPI_GELU) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
              __floats2bfloat162_rn(gelu_erf(v0), gelu_erf(v1));
        } else if constexpr (EPI == EPI_RES_F32) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const bf16*>(res) + off);
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
              make_float2(__bfloat162float(r.x) + gamma[n] * v0,
                          __bfloat162float(r.y) + gamma[n + 1] * v1);
        } else if constexpr (EPI == EPI_RES_BF16) {
          const float2 r = *reinterpret_cast<const float2*>(
              static_cast<const float*>(res) + off);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
              __floats2bfloat162_rn(r.x + gamma[n] * v0,
                                    r.y + gamma[n + 1] * v1);
        } else {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const bf16*>(res) + off);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
              __floats2bfloat162_rn(__bfloat162float(r.x) + gamma[n] * v0,
                                    __bfloat162float(r.y) + gamma[n + 1] * v1);
        }
      }
    }
}

// o (B, L, D) = per head softmax(q kᵀ · scale, keys past S masked) v.
// Grid (ceil(L/QT), D/DH, B); each warp owns 16 query rows.  In the mma
// accumulator layout a lane holds rows g and g+8 of its 16, columns 2t and
// 2t+1 of every 8-wide piece (g = lane/4, t = lane%4).
__global__ void __launch_bounds__(NT)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int L, int S,
             int D, float scale) {
  __shared__ __align__(16) bf16 ks[KT * KLD];   // [key][dh]
  __shared__ __align__(16) bf16 vt[DH * KLD];   // [dh][key]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int ra = blockIdx.x * QT + warp * 16 + g, rb = ra + 8;

  uint32_t qf[DH / 16][4];         // this warp's queries as mma A operands
  {
    const bf16* qa = q + ((size_t)b * L + (ra < L ? ra : 0)) * D + hh * DH;
    const bf16* qb = q + ((size_t)b * L + (rb < L ? rb : 0)) * D + hh * DH;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      const int c = kc * 16 + 2 * t;
      qf[kc][0] = ra < L ? ld32(qa + c) : 0u;
      qf[kc][1] = rb < L ? ld32(qb + c) : 0u;
      qf[kc][2] = ra < L ? ld32(qa + c + 8) : 0u;
      qf[kc][3] = rb < L ? ld32(qb + c + 8) : 0u;
    }
  }

  float oacc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.0f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};

  const int nkt = (S + KT - 1) / KT;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();                 // the last tile is consumed
    for (int i = threadIdx.x; i < KT * (DH / 8); i += NT) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      const int s = kt * KT + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (s < S) {
        const size_t off = ((size_t)b * S + s) * D + hh * DH + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * KLD + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c + e) * KLD + r] = ve[e];
    }
    __syncthreads();

    float sacc[KT / 8][4];           // scores: 16 rows x KT keys
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc)
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const bf16* p = ks + (j * 8 + g) * KLD + kc * 16 + 2 * t;
        const uint32_t bk[2] = {ld32(p), ld32(p + 8)};
        mma16816(sacc[j], qf[kc], bk);
      }

    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = kt * KT + j * 8 + 2 * t + (e & 1);
        const float val = s < S ? sacc[j][e] * scale : -1e30f;
        sacc[j][e] = val;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      tmax[hr] = fmaxf(tmax[hr], __shfl_xor_sync(0xffffffffu, tmax[hr], 1));
      tmax[hr] = fmaxf(tmax[hr], __shfl_xor_sync(0xffffffffu, tmax[hr], 2));
      const float mnew = fmaxf(mrow[hr], tmax[hr]);
      alpha[hr] = expf(mrow[hr] - mnew);
      mrow[hr] = mnew;
    }

    // probabilities -> bf16 A operands of P·V (keys 16 at a time)
    uint32_t pf[KT / 16][4];
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const float p0 = expf(sacc[j][0] - mrow[0]);
      const float p1 = expf(sacc[j][1] - mrow[0]);
      const float p2 = expf(sacc[j][2] - mrow[1]);
      const float p3 = expf(sacc[j][3] - mrow[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      psum[hr] += __shfl_xor_sync(0xffffffffu, psum[hr], 1);
      psum[hr] += __shfl_xor_sync(0xffffffffu, psum[hr], 2);
      lrow[hr] = lrow[hr] * alpha[hr] + psum[hr];
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      oacc[j][0] *= alpha[0];
      oacc[j][1] *= alpha[0];
      oacc[j][2] *= alpha[1];
      oacc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc)
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const bf16* p = vt + (j * 8 + g) * KLD + kc * 16 + 2 * t;
        const uint32_t bv[2] = {ld32(p), ld32(p + 8)};
        mma16816(oacc[j], pf[kc], bv);
      }
  }

  const float inva = 1.0f / lrow[0], invb = 1.0f / lrow[1];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = hh * DH + j * 8 + 2 * t;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * L + ra) * D + c) =
          __floats2bfloat162_rn(oacc[j][0] * inva, oacc[j][1] * inva);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * L + rb) * D + c) =
          __floats2bfloat162_rn(oacc[j][2] * invb, oacc[j][3] * invb);
  }
}

template <int EPI>
cudaError_t gemm(const bf16* a, const bf16* w, const float* bias,
                 const float* gamma, const void* res, void* out, int M, int N,
                 int K, cudaStream_t st) {
  const dim3 grid((M + BM - 1) / BM, N / BN);
  gemm_kernel<EPI><<<grid, NT, 0, st>>>(a, w, bias, gamma, res, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace
