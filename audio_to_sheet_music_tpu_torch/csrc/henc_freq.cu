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
// Numerics: the operands of every product are bf16 and every sum f32, the
// JAX kernel's rule on bf16 input: x and wc in the strided conv
// (pallas_enc.py:150), the DConv's two convolutions (its dot_dtype), wr and
// y in the rewrite (:164-165).  Biases, GELU, statistics, the GLU and y
// between the stages stay f32; the output is rounded once.
//
// What bounds it on an H100: bytes.  At a serving group (B 4, F 2048 ->
// 512, T 259, C 48) it reads 17 MB and writes 51 MB of bf16 against
// ~9.6 GFLOP (the conv 1.6, the rewrite 4.9), under the card's ~295
// FLOP/byte ridge.  Between the stages y makes f32 round trips: the conv
// writes 102 MB of it and the rewrite reads them, so the byte floor of
// those two stages is ~0.036 and ~0.046 ms.
//
// Design.  Three stages, each over (row, 64-frame tile) pairs, so a chunk
// of any length runs:
//   1. henc_conv_kernel: the strided conv as a GEMM over the tile, frames
//      as M, C as N, K = Cin x 8 (k = ci 8 + kf) padded to 16 with zero
//      weights, on mma.sync.m16n8k16 bf16 tiles with f32 sums; bias + GELU
//      in the epilogue, into an f32 scratch y laid out as (b, fo) rows of
//      (C, T);
//   2. the DConv routine of dconv_row.cuh, both blocks in place on y (six
//      launches of bf16 mma.sync products; GroupNorm statistics merged from
//      per-tile partials);
//   3. henc_rewrite_kernel: the 1x1 C -> 2C conv as a GEMM over the tile,
//      K = C, each `a` column c paired with its gate column c + C in one
//      fragment so the GLU stays in registers; written to the (B, C, F/4,
//      T) bf16 output.
// Both GEMMs stage their A tile frame-major in shared memory (rows of K +
// 8 bf16: the pad puts the eight rows of an ldmatrix phase on eight
// 16-byte bank groups, as in dconv_row.cuh) and their weights as bf16 rows
// by cp.async, both read by ldmatrix.  The conv stages x for the block's
// input rows fi = 4 fo - 2 .. 4 fo + 5 (zeros past F's edges) in 64-deep K
// chunks and its weights in 64-channel slices, so any Cin and C fit; the
// rewrite stages the whole (64 x C) tile of y and wr in slices of 64
// channel pairs (128 rows), since all of wr (2C x C bf16) is 590 KB at
// C = 384, past a block's 227 KB.  The weights come from the wrapper cast
// and zero-padded once a call.  Both stages launch as many blocks as the
// card holds at once, and each block walks (row, tile) pairs in steps of
// the grid, a row's tiles adjacent: at layer 0 (one K chunk, C <= 64) a
// block stages its weights once, where one block a tile re-read the same
// few KB of weights from L2 for each of ~10k tiles and waited on them.
// What holds the two stages now is work a tile (the staging's transposes
// and index math, the GELU, the syncs) more than bytes (PERF.md).  The
// s2d relayout and the VMEM block model
// of the Pallas kernel are TPU tiling artefacts and are not carried over;
// folding the conv into conv1 or the rewrite into the routine's last
// epilogue, which would save y's f32 round trips, is not done.

#include "dconv_row.cuh"

namespace {

using dconv::bf16;
using dconv::NT;
using dconv::NWARP;
using dconv::TT;
using dconv::MT;

constexpr int KF = 8;           // conv kernel along F
constexpr int STRIDE = 4;
constexpr int PAD = 2;
constexpr int KCH = 64;         // conv: K staged this deep at a time
constexpr int NS = 64;          // conv: output channels a slice
constexpr int SP = 64;          // rewrite: channel pairs a slice of wr

// y[(b, fo)][c][t] = gelu(bc[c] + sum_k wc[c][k] x[b][k / 8][4 fo + k % 8 -
// 2][t]), k < Cin 8; wc (C, Kp) bf16, zero for k >= Cin 8.  The block walks
// the R ntile (row, tile) pairs from blockIdx.x in steps of gridDim.x, a
// row's tiles adjacent.  Warp w computes frames 16 (w % 4) .. +16 by 32
// channels of the slice, from 32 (w / 4).
__global__ void __launch_bounds__(NT)
henc_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wc,
                 const float* __restrict__ bc, float* __restrict__ y, int R,
                 int Cin, int F, int T, int C, int Kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int XS = min(Kp, KCH) + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);   // frame j at row j
  bf16* ws = xs + TT * XS;                      // channel c0 + n at row n
  const int ntile = dconv::n_tiles(T), Fo = F / STRIDE, K = Cin * KF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, mt = warp & 3, nh = (warp >> 2) * 32;
  // one K chunk and one channel slice (layer 0): the block's first tile
  // stages the weights and they stay
  const bool keep = Kp <= KCH && C <= NS;
  for (int tile = blockIdx.x; tile < R * ntile; tile += gridDim.x) {
    const int r = tile / ntile, b = r / Fo, fo = r % Fo;
    const int t0 = (tile % ntile) * TT, len = min(TT, T - t0);
    const bool stage_w = !keep || tile == blockIdx.x;
    const bf16* xb = x + (size_t)b * Cin * F * T + t0;
    for (int c0 = 0; c0 < C; c0 += NS) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      for (int k0 = 0; k0 < Kp; k0 += KCH) {
        const int kc = min(KCH, Kp - k0), kq = kc / 8;
        __syncthreads();               // the last chunk's readers are done
        for (int i = threadIdx.x; stage_w && i < NS * kq; i += NT) {
          const int n = i / kq, p = i % kq;
          bf16* dst = ws + n * XS + p * 8;
          if (c0 + n < C)
            dconv::cp_async16(dst, wc + (size_t)(c0 + n) * Kp + k0 + p * 8);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
        // x, taps k and k + 1 (one input channel, rows fi and fi + 1) of
        // one frame a thread
        for (int i = threadIdx.x; i < (kc / 2) * TT; i += NT) {
          const int k = k0 + 2 * (i / TT), j = i % TT;
          const int fi = STRIDE * fo + k % KF - PAD;
          float v0 = 0.0f, v1 = 0.0f;
          if (k < K && j < len) {
            const bf16* xr = xb + (size_t)(k / KF) * F * T + j;
            if (fi >= 0 && fi < F) v0 = __bfloat162float(xr[(size_t)fi * T]);
            if (fi + 1 >= 0 && fi + 1 < F)
              v1 = __bfloat162float(xr[(size_t)(fi + 1) * T]);
          }
          *reinterpret_cast<__nv_bfloat162*>(xs + j * XS + 2 * (i / TT)) =
              __floats2bfloat162_rn(v0, v1);
        }
        dconv::cp_async_wait();
        __syncthreads();
        for (int kk = 0; kk < kc; kk += 16) {
          uint32_t a[4];
          dconv::load_a(a, xs + mt * 16 * XS + kk, XS, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (c0 + nh + 16 * h >= C) break;
            // lanes 0-7 / 8-15: channels n .. n + 7 at k, k + 8; 16-31:
            // n + 8 ..
            uint32_t w4[4];
            dconv::ldsm_x4(w4, ws + (nh + 16 * h + (lane & 7) +
                                     ((lane >> 4) << 3)) * XS +
                                   kk + ((lane >> 3) & 1) * 8);
            dconv::mma_bf16(acc[2 * h], a, w4[0], w4[1]);
            dconv::mma_bf16(acc[2 * h + 1], a, w4[2], w4[3]);
          }
        }
      }
      // fragment slot e: frame 16 mt + g (+8 for e >= 2), channel 2q +
      // (e & 1)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = c0 + nh + 8 * nt + 2 * q;
        if (c >= C) continue;          // C is a multiple of 8: so is c + 1
        const float b0 = __ldg(bc + c), b1 = __ldg(bc + c + 1);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = mt * 16 + g + 8 * hf;
          if (j >= len) continue;
          float* yr = y + ((size_t)r * C + c) * T + t0 + j;
          yr[0] = dconv::gelu(acc[nt][2 * hf] + b0);
          yr[T] = dconv::gelu(acc[nt][2 * hf + 1] + b1);
        }
      }
    }
  }
}

// out[b][c][fo][t] = GLU(wr y + br), y rounded to bf16; wr (2C, Cp) bf16,
// zero for k >= C.  The block walks the (row, tile) pairs as the conv does.
// The (64 x Cp) tile of y frame-major in shared memory once a tile; wr in
// slices of SP channel pairs, the `a` rows at 0 .. SP - 1 and their gate
// rows at SP ..., staged once a block when one slice holds all of it.  A
// warp's work item is 16 frames by 8 channels, `a` and gate.
__global__ void __launch_bounds__(NT)
henc_rewrite_kernel(const float* __restrict__ y, const bf16* __restrict__ wr,
                    const float* __restrict__ br, bf16* __restrict__ out,
                    int R, int F, int T, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = dconv::pad16(C), YS = Cp + 8, kq = Cp / 8;
  bf16* ys = reinterpret_cast<bf16*>(smem);   // frame j at row j
  bf16* ws = ys + TT * YS;
  const int ntile = dconv::n_tiles(T), Fo = F / STRIDE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool keep = C <= SP;
  for (int tile = blockIdx.x; tile < R * ntile; tile += gridDim.x) {
    const int r = tile / ntile, b = r / Fo, fo = r % Fo;
    const int t0 = (tile % ntile) * TT, len = min(TT, T - t0);
    const float* yr = y + (size_t)r * C * T + t0;
    __syncthreads();                   // the last tile's readers are done
    // two channels of one frame a thread; zeros past C and past len
    for (int i = threadIdx.x; i < (Cp / 2) * TT; i += NT) {
      const int c = 2 * (i / TT), j = i % TT;
      float v0 = 0.0f, v1 = 0.0f;
      if (c < C && j < len) {
        v0 = yr[(size_t)c * T + j];
        v1 = yr[(size_t)(c + 1) * T + j];
      }
      *reinterpret_cast<__nv_bfloat162*>(ys + j * YS + c) =
          __floats2bfloat162_rn(v0, v1);
    }
    for (int c0 = 0; c0 < C; c0 += SP) {
      const int np = min(SP, C - c0);  // a multiple of 8
      if (!keep || tile == blockIdx.x) {
        __syncthreads();               // the last slice's readers are done
        for (int i = threadIdx.x; i < 2 * np * kq; i += NT) {
          const int row = i / kq, p = i % kq, gate = row >= np;
          const int n = row - gate * np;
          dconv::cp_async16(ws + (gate * SP + n) * YS + p * 8,
                            wr + (size_t)(gate * C + c0 + n) * Cp + p * 8);
        }
      }
      dconv::cp_async_wait();
      __syncthreads();
      for (int it = warp; it < MT * (np / 8); it += NWARP) {
        const int mt = it % MT, n0 = (it / MT) * 8;
        float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float zg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        // lanes 0-15: `a` rows (k 0-7, then 8-15); lanes 16-31: gate rows
        const bf16* wrow = ws + ((lane < 16 ? n0 : SP + n0) + (lane & 7)) *
                                    YS + ((lane >> 3) & 1) * 8;
        for (int k0 = 0; k0 < Cp; k0 += 16) {
          uint32_t a[4], w4[4];
          dconv::load_a(a, ys + mt * 16 * YS + k0, YS, lane);
          dconv::ldsm_x4(w4, wrow + k0);
          dconv::mma_bf16(za, a, w4[0], w4[1]);
          dconv::mma_bf16(zg, a, w4[2], w4[3]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + n0 + 2 * q + e;
          const float ba = __ldg(br + c), bg = __ldg(br + C + c);
          bf16* o = out + (((size_t)b * C + c) * Fo + fo) * T + t0;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j = mt * 16 + g + 8 * hf;
            if (j < len)
              o[j] = __float2bfloat16((za[2 * hf + e] + ba) *
                                      dconv::sigmoid(zg[2 * hf + e] + bg));
          }
        }
      }
    }
  }
}

// As many blocks of `kernel` as the card holds at once (NT threads, `smem`
// bytes each), at most `tiles`: each walks its share of the tiles.
template <typename K>
cudaError_t resident_grid(K kernel, size_t smem, int tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  *grid = min(tiles, per_sm * sms);
  return e;
}

}  // namespace

// f32 scratch the caller allocates: y (B * F/4, C, T), u (B * F/4, C/8, T)
// and part (henc_freq_part_floats).
extern "C" size_t henc_freq_part_floats(int B, int F, int T) {
  return dconv::part_floats(B * (F / STRIDE), T);
}

// The hidden width Hp the DConv weights are padded to.
extern "C" int henc_freq_hidden_pad(int C) { return dconv::hidden_pad(C); }

// The columns the conv weight (Cin 8 taps) and the rewrite weight (C) are
// zero-padded to: the MMA's k granularity.
extern "C" int henc_freq_conv_depth(int Cin) { return dconv::pad16(Cin * KF); }
extern "C" int henc_freq_channel_pad(int C) { return dconv::pad16(C); }

// x (B, Cin, F, T) bf16 -> out (B, C, F/4, T) bf16 on `stream`, C a
// multiple of 8 up to dconv::MAX_C; wc (C, henc_freq_conv_depth(Cin)) and
// wr (2C, henc_freq_channel_pad(C)) bf16, zero-padded; bc, br f32.  dw
// holds the 18 DConv pointers, block 0 then block 1, each in the order w1
// (3, C, Hp) bf16, b1, g1, bt1, w2 (2C, Hp) bf16, b2, g2, bt2, scale (f32);
// the pad is zero.  Returns the first CUDA error (0 on success).
extern "C" int henc_freq_launch(const void* x, const void* wc, const void* bc,
                                const void* wr, const void* br,
                                const void* const* dw, void* y, void* u,
                                void* part, void* out, int B, int Cin, int F,
                                int T, int C, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (C < 8 || C % 8 || C > dconv::MAX_C || Cin < 1)
    return (int)cudaErrorInvalidValue;
  const int R = B * (F / STRIDE), Kp = dconv::pad16(Cin * KF);
  const int tiles = R * dconv::n_tiles(T);
  float* yf = static_cast<float*>(y);
  const size_t s1 = (size_t)(TT + NS) * (min(Kp, KCH) + 8) * sizeof(bf16);
  int grid = 0;
  cudaError_t e = resident_grid(henc_conv_kernel, s1, tiles, &grid);
  if (e != cudaSuccess) return (int)e;
  henc_conv_kernel<<<grid, NT, s1, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wc),
      static_cast<const float*>(bc), yf, R, Cin, F, T, C, Kp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dconv::BlockW w[2];
  dconv::unpack(dw, w);
  e = dconv::run<float, float>(yf, w, yf, static_cast<float*>(u),
                               static_cast<float*>(part), yf, R, C, T, st);
  if (e != cudaSuccess) return (int)e;
  const size_t s3 =
      (size_t)(TT + 2 * SP) * (dconv::pad16(C) + 8) * sizeof(bf16);
  e = dconv::allow_smem(henc_rewrite_kernel, s3);
  if (e == cudaSuccess)
    e = resident_grid(henc_rewrite_kernel, s3, tiles, &grid);
  if (e != cudaSuccess) return (int)e;
  henc_rewrite_kernel<<<grid, NT, s3, st>>>(
      yf, static_cast<const bf16*>(wr), static_cast<const float*>(br),
      static_cast<bf16*>(out), R, F, T, C);
  return (int)cudaGetLastError();
}
