// Attention building blocks shared by layer_tail.cu and attn_block.cu.
//
// Replaces the products of audio_to_sheet_music_tpu/ops/pallas_attn.py:
// layer_tail (_layer_kernel) and attn_block (_attn_kernel); layer_tail.cu
// and attn_block.cu say how each is composed from these two launches.
//
// - gemm_kernel / gemm: out (M, N) = epilogue(a (M, K) @ wᵀ + bias) with w in
//   torch layout (N, K), bf16 operands and f32 sums, on Hopper's
//   asynchronous units.
//   What bounds it: products and bytes about equally.  layer_tail's four
//   GEMMs at the freq self form of a serving group (M = 4 x 2072 = 8288,
//   D 512, FF 2048) are 20 M D² = 43.5 GFLOP, 0.044 ms at the bf16 tensor
//   peak, against ~157 MB that the four launches read and write once each
//   (the (M, 2048) bf16 hidden and the f32 y1 are most of it), 0.047 ms at
//   the memory rate: ~280 FLOP a byte, the card's ridge (FF1 above it, the
//   out-projection at half of it).  The first GEMM (64 x 64 tiles of
//   mma.sync over cp.async double buffers, 4 warps) ran near 11 % of the
//   tensor peak; only wgmma reaches the rest.
//   Design: one block per 128 x 128 output tile (grid ceil(M/128) x
//   ceil(N/128)), K in 64-wide slices, one 128-byte swizzle row of bf16.
//   One producer warp keeps A and W tiles in flight by TMA (the flash
//   launch's tensor maps with one batch row: K innermost, box 64 x 128, the
//   128-byte swizzle; rows past M or N and columns past K arrive
//   zero-filled) into a three-stage ring of 32 KB
//   stages on full / empty mbarriers.  Two consumer warpgroups each own 64
//   rows x 128 columns in 64 f32 registers a thread: a K slice is four
//   wgmma m64n128k16 with both operands read from shared memory through
//   the same B128 descriptors as the flash launch's S = Q Kᵀ (W (N, K) is
//   K-major as K (S, 64) is), 32 bytes further a k16 step.  One wgmma group
//   stays in flight while the next slice's wait runs; a stage goes back to
//   the producer when the group that read it is done.  Three stages (97 KB)
//   and 288 threads at ≤ 112 registers leave two blocks an SM, so one
//   block's epilogue overlaps the other's products.  The epilogue reads
//   the accumulators in mma.sync's per-warp layout (row g + 8 hr, column
//   2 t + 8 j), adds the bias and applies one of five epilogues, skipping
//   rows ≥ M and columns ≥ N: N need only be a multiple of 8 (a partial
//   128-column tile works) and K a multiple of 8 (16-byte TMA strides).
//   Not done: persistent blocks, clusters with multicast W tiles, a TMA
//   store of the result.
// - flash_kernel / flash: o = per head softmax(q kᵀ · scale) v with 64-wide
//   heads (optionally each head's row gated by a sigmoid, for
//   attn_block.cu's attn_gated_launch), on Hopper's asynchronous units.
//   One block per (64-row query
//   tile, head, batch row): one consumer warpgroup and one producer warp
//   (flash says why not two consumer warpgroups).  The producer
//   brings the block's Q tile in once by TMA and keeps 128-key K and V
//   tiles in flight by TMA into a two-stage ring, on mbarriers (a full
//   barrier per tile and stage, an empty barrier per stage that every
//   consumer thread arrives on when it is done with it).  The tensor maps
//   are 3-D (D, rows, B) with 64 x rows x 1 boxes and the 128-byte swizzle:
//   one head row is exactly 128 bytes, and rows past L or S arrive
//   zero-filled, so there is no masked load.  The consumer warpgroup
//   computes S = Q Kᵀ with four wgmma m64n128k16 (both operands from shared
//   memory through B128 descriptors), runs the online softmax on the
//   accumulator registers in base 2 (the running max kept in scaled units,
//   each probability one fma with scale · log2 e folded and one ex2.approx;
//   keys at or past S scored -1e30 as in the Pallas kernels' mask), and
//   computes O += P V with eight wgmma m64n64k16 whose A operand is P from
//   registers: the S accumulator layout of 16 keys is the A fragment
//   layout, so P goes from the score registers into the product after a
//   bf16 conversion.  V is read as it landed (N-major, "transposed B"):
//   nothing is transposed in shared memory.  P is rounded to bf16
//   unnormalised and divided by the f32 running sum at the end (the plain
//   versions round the normalised probabilities; both are
//   bf16-rounding-grade).  The tensor maps are encoded on the host per call
//   (cuTensorMapEncodeTiled through the CUDA runtime's entry-point query)
//   and passed as __grid_constant__.
//   What bounds it: the freq self form of a training batch is 70 GFLOP of
//   products against ~34 MB of q, k, v and o, so bytes are far from it.
//   The products take 0.071 ms at the tensor-core peak, and its 275 M
//   exponentials as long again on the special-function units (16 a clock
//   an SM): with 64-wide heads a score costs as much in ex2 as in products,
//   so the softmax (64 scores a thread a tile, each a max, an fma, an ex2
//   and a bf16 conversion) is as large as the products.  The products of
//   one warpgroup do not overlap its softmax; three blocks an SM (73 KB of
//   shared memory and ~127 registers a thread each) take the tensor cores
//   in turns.  The softmax as first written (exp2f, a multiply per score)
//   was slower at every form (PERF.md).  Overlapping the next tile's Q Kᵀ
//   with P V inside a warpgroup (two score buffers, ~158 registers, two
//   blocks an SM; ptxas serialised the wgmma) and 64-key tiles (four blocks
//   an SM) both measured slower on the H100.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;          // head width: one 128-byte row a head
constexpr int KT = 128;         // keys per streamed K / V tile (the S
                                // product is wgmma m64n128k16)
constexpr int STAGES = 2;       // K / V ring depth
constexpr int ROW_BYTES = DH * 2;
constexpr int GM = 128, GN = 128;   // GEMM block tile
constexpr int GK = 64;          // GEMM K slice: one 128-byte swizzle row
constexpr int GSTAGES = 3;      // GEMM ring depth
constexpr int GTILE = GM * GK * 2;  // bytes of an A or a W tile (GM == GN)
constexpr int GEMM_THREADS = 2 * 128 + 32;  // two consumer warpgroups and
                                            // one producer warp
static_assert(GK == DH && GM == GN, "the GEMM loads head_map's boxes");

// bf16 out = acc + bias; bf16 out = gelu(acc + bias); f32 out = bf16 res +
// gamma (acc + bias); bf16 out = f32 res + gamma (acc + bias); bf16 out =
// bf16 res + gamma (acc + bias).
enum Epilogue { EPI_BIAS, EPI_GELU, EPI_RES_F32, EPI_RES_BF16, EPI_RES_X };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit (2 ulp; -inf gives +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// --- Hopper primitives: mbarriers, TMA, wgmma ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and add `bytes` to the transactions this phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed; a wait past 4 s
// traps (a lost transaction would otherwise hang the card, not fail)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      const uint64_t now = global_ns();
      if (n == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

// box of the 3-D tensor map at (c0, c1, c2) -> shared dst, completing on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a tile written by TMA with the 128-byte
// swizzle (layout type 1): start address, leading and stride byte offsets in
// 16-byte units.  The stride offset is the 1024 bytes between 8-row groups.
// K-major operands (Q, K) take a 16-byte leading offset (unused inside one
// swizzle atom); V, read N-major, takes 1024, which is the 8-row group
// stride in either reading of the two fields for a 64-wide N.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accesses of r across the asynchronous mma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 128 f32) (+)= a (64 x 16 bf16, K-major, shared) · b (128 x 16
// bf16, K-major, shared)ᵀ; scale_d 0 overwrites d instead of adding.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) (+)= a (64 x 16 bf16 in registers, the mma.sync A
// fragment layout per warp) · b (16 x 64 bf16, N-major in shared memory,
// read transposed: tnspB = 1).
__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t* a,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// o (B, L, D) = per head softmax(q kᵀ · scale, keys past S masked) v;
// GATED: each head's row times σ(gate (B, L, D / DH) bf16 logits) before
// it is rounded, the gate of BS-RoFormer's attention (one sigmoid a row and
// head, in f32).  Grid (ceil(L / 64), D / DH, B); one consumer warpgroup
// (threads 0 .. 127) and one producer warp.  In the wgmma accumulator
// layout a thread of warp w4 of its warpgroup holds rows 16 w4 + g and 16 w4 + g + 8
// of the 64, columns 8 j + 2 t and 8 j + 2 t + 1 of every 8-wide piece j
// (g = lane / 4, t = lane % 4): element 4 j + e is row g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1).
template <bool GATED>
__global__ void __launch_bounds__(128 + 32)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
             const bf16* __restrict__ gate, int L, int S, int D,
             float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // TMA with the 128-byte swizzle wants 1024-byte aligned tiles
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                                  // 64 rows
  const uint32_t k_s = q_s + 64 * ROW_BYTES;                  // STAGES x KT
  const uint32_t v_s = k_s + STAGES * KT * ROW_BYTES;         // STAGES x KT
  const uint32_t bars = v_s + STAGES * KT * ROW_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hh = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * 64;
  const int nkt = (S + KT - 1) / KT;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                     // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, 64 * ROW_BYTES);
      tma_load_3d(q_s, &tq, hh * DH, q0, b, q_full);
      for (int t = 0; t < nkt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) - 1) & 1);
        mbar_expect_tx(k_full(s), KT * ROW_BYTES);
        tma_load_3d(k_s + s * KT * ROW_BYTES, &tk, hh * DH, t * KT, b,
                    k_full(s));
        mbar_expect_tx(v_full(s), KT * ROW_BYTES);
        tma_load_3d(v_s + s * KT * ROW_BYTES, &tv, hh * DH, t * KT, b,
                    v_full(s));
      }
    }
    return;
  }

  // the consumer warpgroup: 64 query rows
  const int w4 = warp, g = lane >> 2, t4 = lane & 3;
  const uint32_t qa = q_s;
  float oacc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.0f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};
  mbar_wait(q_full, 0);

  for (int t = 0; t < nkt; ++t) {
    const int s = t % STAGES, ph = (t / STAGES) & 1;
    const uint32_t ka = k_s + s * KT * ROW_BYTES;
    const uint32_t va = v_s + s * KT * ROW_BYTES;
    float sacc[KT / 2];
    mbar_wait(k_full(s), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)      // 16 head columns = 32 bytes
      wgmma_ss_n128(sacc, sw128_desc(qa + kk * 32, 16),
                    sw128_desc(ka + kk * 32, 16), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<KT / 2>(sacc);

    // online softmax in base 2 on the accumulator registers
    const bool ragged = (t + 1) * KT > S;
    float tmax[2] = {-INFINITY, -INFINITY};
    if (ragged) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * KT + 8 * j + 2 * t4 + (e & 1) >= S) sacc[4 * j + e] = -1e30f;
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tmax[e >> 1] = fmaxf(tmax[e >> 1], sacc[4 * j + e]);
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      tmax[hr] = fmaxf(tmax[hr], __shfl_xor_sync(0xffffffffu, tmax[hr], 1));
      tmax[hr] = fmaxf(tmax[hr], __shfl_xor_sync(0xffffffffu, tmax[hr], 2));
      const float mnew = fmaxf(mrow[hr], tmax[hr] * scale_log2);
      alpha[hr] = ex2(mrow[hr] - mnew);
      mrow[hr] = mnew;
      lrow[hr] *= alpha[hr];
    }
    // P as bf16 A fragments, 16 keys each: pieces j = 2 kc and 2 kc + 1
    uint32_t pf[KT / 16][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const float p0 = ex2(fmaf(sacc[4 * j], scale_log2, -mrow[0]));
      const float p1 = ex2(fmaf(sacc[4 * j + 1], scale_log2, -mrow[0]));
      const float p2 = ex2(fmaf(sacc[4 * j + 2], scale_log2, -mrow[1]));
      const float p3 = ex2(fmaf(sacc[4 * j + 3], scale_log2, -mrow[1]));
      lrow[0] += p0 + p1;              // this thread's part of the row sum
      lrow[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      oacc[4 * j] *= alpha[0];
      oacc[4 * j + 1] *= alpha[0];
      oacc[4 * j + 2] *= alpha[1];
      oacc[4 * j + 3] *= alpha[1];
    }

    mbar_wait(v_full(s), ph);
    fence_regs<DH / 2>(oacc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc)      // 16 keys = 16 V rows
      wgmma_rs_n64_tb(oacc, pf[kc], sw128_desc(va + kc * 16 * ROW_BYTES, 1024),
                      1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DH / 2>(oacc);
    mbar_arrive(empty(s));             // this thread is done with stage s
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lrow[hr] += __shfl_xor_sync(0xffffffffu, lrow[hr], 1);
    lrow[hr] += __shfl_xor_sync(0xffffffffu, lrow[hr], 2);
  }
  float inva = 1.0f / lrow[0], invb = 1.0f / lrow[1];
  const int ra = q0 + w4 * 16 + g, rb = ra + 8;
  if constexpr (GATED) {
    const int heads = D / DH;
    if (ra < L)
      inva /= 1.0f + expf(-__bfloat162float(
                         gate[((size_t)b * L + ra) * heads + hh]));
    if (rb < L)
      invb /= 1.0f + expf(-__bfloat162float(
                         gate[((size_t)b * L + rb) * heads + hh]));
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = hh * DH + j * 8 + 2 * t4;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * L + ra) * D + c) =
          __floats2bfloat162_rn(oacc[4 * j] * inva, oacc[4 * j + 1] * inva);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * L + rb) * D + c) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * invb,
                                oacc[4 * j + 3] * invb);
  }
}

// out (M, N) = epilogue(a (M, K) @ wᵀ + bias); w (N, K) in torch layout,
// both read through head_map tensor maps of one batch row, ta over (M, K)
// and tw over (N, K), with 64 x 128 boxes.  Grid (ceil(M / GM),
// ceil(N / GN)); warps 0-7 are the two consumer warpgroups (rows 64 wg ..
// 64 wg + 63 of the tile), warp 8 the producer.  Thread (w4, g, t) of a
// warpgroup holds acc[4 j + e] = row 16 w4 + g + 8 (e >> 1), column
// 8 j + 2 t + (e & 1).
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tw,
            const float* __restrict__ bias, const float* __restrict__ gamma,
            const void* __restrict__ res, void* __restrict__ out, int M, int N,
            int K) {
  extern __shared__ uint8_t smem_raw[];
  // TMA with the 128-byte swizzle wants 1024-byte aligned tiles
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto a_s = [&](int s) { return base + s * 2 * GTILE; };
  auto w_s = [&](int s) { return base + s * 2 * GTILE + GTILE; };
  const uint32_t bars = base + GSTAGES * 2 * GTILE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (GSTAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const int nk = (K + GK - 1) / GK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {                     // the producer warp
    if (lane == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % GSTAGES;
        if (t >= GSTAGES) mbar_wait(empty(s), ((t / GSTAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * GTILE);
        tma_load_3d(a_s(s), &ta, t * GK, m0, 0, full(s));
        tma_load_3d(w_s(s), &tw, t * GK, n0, 0, full(s));
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows x 128 columns
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t4 = lane & 3;
  float acc[GN / 2];
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % GSTAGES;
    mbar_wait(full(s), (t / GSTAGES) & 1);
    fence_regs<GN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)     // 16 columns of K = 32 bytes
      wgmma_ss_n128(acc, sw128_desc(a_s(s) + wg * 64 * 128 + kk * 32, 16),
                    sw128_desc(w_s(s) + kk * 32, 16), 1);
    wgmma_commit();
    wgmma_wait<1>();                   // slice t - 1's group is done
    fence_regs<GN / 2>(acc);
    if (t > 0) mbar_arrive(empty((t - 1) % GSTAGES));
  }
  wgmma_wait<0>();
  fence_regs<GN / 2>(acc);

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + wg * 64 + w4 * 16 + g + 8 * hr;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
      if (n >= N) continue;            // N is even: so is n + 1 < N
      const size_t off = (size_t)m * N + n;
      const float v0 = acc[4 * j + 2 * hr] + bias[n];
      const float v1 = acc[4 * j + 2 * hr + 1] + bias[n + 1];
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

// --- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
#endif
      return nullptr;
    return q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// 3-D map over a (B, rows, D) bf16 tensor: dims (D, rows, B), box
// (64, box_rows, 1), 128-byte swizzle, out-of-bounds rows read as zero
bool head_map(CUtensorMap* map, const void* ptr, int B, int rows, int D,
              int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {DH, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The flash-attention launch, 64 query rows a block.  A block of two
// consumer warpgroups (128-row query tiles) measured slower at every
// attn_block and layer_tail form: on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py --profile as it then stood) the freq self form took 0.174
// ms with 64-row tiles and 0.223 with 128-row ones at a training batch of
// 8, 0.093 and 0.123 at a serving group of 4, the time self form 0.065 /
// 0.080 and 0.035 / 0.045.  Two consumer warpgroups of ~124 registers (plus
// the producer warp) leave one block an SM, where 64-row tiles run three.
// A non-null `gate` (B, L, D / DH) launches the gated form.
cudaError_t flash(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                  int L, int S, int D, float scale, cudaStream_t st,
                  const bf16* gate = nullptr) {
  CUtensorMap mq, mk, mv;
  if (!head_map(&mq, q, B, L, D, 64) || !head_map(&mk, k, B, S, D, KT) ||
      !head_map(&mv, v, B, S, D, KT))
    return cudaErrorInvalidValue;
  const int smem = 1024 + (64 + 2 * STAGES * KT) * ROW_BYTES +
                   8 * (1 + 3 * STAGES);
  auto kernel = gate ? flash_kernel<true> : flash_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((L + 63) / 64, D / DH, B), 128 + 32, smem, st>>>(
      mq, mk, mv, o, gate, L, S, D, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The GEMM launch: N and K multiples of 8, any M.
template <int EPI>
cudaError_t gemm(const bf16* a, const bf16* w, const float* bias,
                 const float* gamma, const void* res, void* out, int M, int N,
                 int K, cudaStream_t st) {
  CUtensorMap ma, mw;
  if (M < 1 || N < 8 || N % 8 || K < 8 || K % 8 ||
      !head_map(&ma, a, 1, M, K, GM) || !head_map(&mw, w, 1, N, K, GN))
    return cudaErrorInvalidValue;
  const int smem = 1024 + GSTAGES * 2 * GTILE + 8 * 2 * GSTAGES;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + GM - 1) / GM, (N + GN - 1) / GN);
  gemm_kernel<EPI><<<grid, GEMM_THREADS, smem, st>>>(ma, mw, bias, gamma, res,
                                                     out, M, N, K);
  return cudaGetLastError();
}

}  // namespace
