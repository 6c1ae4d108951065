// GroupNorm over contiguous rows in two launches: split-row statistics,
// then normalise, affine and the activation that follows, in one pass; or,
// after the ATHT head's decoder convolutions, the statistics and then the
// whole decoder join in one pass (gn1_coefs and gn1_join, below).
//
// Replaces no TPU kernel.  The JAX package leaves GroupNorm to XLA, which
// fuses it on the TPU.  PyTorch's CUDA GroupNorm (F.group_norm) takes its
// statistics with one block a (batch, group) row (RowwiseMoments), and
// every norm of this model is GroupNorm(1, C): the decoders' norms have 16
// rows of up to 26 M elements, the time branch's DConv and the
// transformer's norm_out 4 rows of 0.5-6.4 M, so 4-16 blocks streamed the
// rows on 132 SMs, at about 2 % of the card's memory rate.  Around them the
// callers cast to f32 and back, applied the affine in f32 and ran GELU or
// GLU as separate passes, and the token norm transposed its stream twice.
//
// What bounds it on an H100: bytes.  The work needs x read once for the
// statistics, then x read again and the output written once (half of it
// for GLU): 6 bytes an element in bf16, 5 for GLU, against ~10-30 f32
// operations, far under the card's ~290 operations a byte.
//
// Design.  Rows are contiguous: row r = b G + g of a (B, C, *spatial)
// tensor is x[r n, (r + 1) n) with n = (C / G) x spatial, and the token
// form (B, L, C), G = 1, has row b = x[b n, (b + 1) n) with n = L C, since
// its statistics over (L, C) do not depend on the layout.  The channel of
// flat element i is (i / inner) % C, inner = spatial (1 for tokens).
//
//   1. gn1_moments: a grid of rows x splits blocks, each over one
//      contiguous slice of its row (the wrapper picks splits from the
//      shape so that the grid fills the card; 1 where the rows alone do).
//      16-byte loads (8 bf16 or 4 f32), UNROLL in flight a thread; each
//      batch of loaded values gives its (count, mean, M2) in two passes
//      over registers, merged into the thread's by Chan's formula, then
//      the warp's lanes by a shuffle tree and the block's warps in order.
//      One (count, mean, M2) triple a block goes to part (rows, splits, 3).
//   2. gn1_apply: a grid of segments x blocks, a segment being a row of
//      the output (for GLU with G > 1, one group's worth of output
//      channels, whose halves come from rows g and g + G / 2).  Each block
//      first merges its row's triples in a fixed order (one warp; a second
//      for GLU's partner row) to mean and rstd = 1 / sqrt(var + eps), var
//      biased, then streams its slice once: (x - mean) (rstd w[c]) + b[c]
//      in f32, GELU (exact erf), GLU (a sigmoid(b) over the
//      channel halves, both halves normalised) or SiLU (y sigmoid(y),
//      SCNet's convolution modules), one rounding to the
//      input's dtype.  The channel is tracked by increments, so the loop
//      divides only once a thread.
//
// The ATHT head's decoder join (gn1_coefs and gn1_join, after gn1_moments
// in place of gn1_apply).  Replaces no TPU kernel: the JAX package's
// _freq_layer_down4 (models/atht.py) is an XLA lowering.  After each of
// the head's 8 transposed convolutions the decoders normalised and GELU'd
// the whole output, resized one axis (two index_select gathers, two f32
// copies, the lerp, a cast back), resized the encoder skip's first C
// channels the same way, scaled it by 0.1 and added it, broadcast over the
// stems: ~10 launches a layer with f32 temporaries over the model's
// largest tensors, 25-35 GB a songs group.  The decoders compare their F
// against the encoder's T lengths, so freq layers 1-3 grow F from 259 to
// 1036 and decimate it straight back by 4: row i reads rows 4i+1 and 4i+2
// at 1/2 each.
//
// What bounds it: bytes.  The rows the taps name read once (half of the
// convolution's output on a /4 layer), the skip's named rows read once at
// their source size, the output written once: ~2 GB a songs group.  At
// freq layer 1's songs shape (16, 96, 1036, 259) -> 259 rows that is 0.19
// ms; the arithmetic is two GELUs and three lerps an output.
//
// Design.  Three launches: gn1_moments as above; gn1_coefs folds each
// plane's statistics (its row's triples merged as gn1_apply merges them)
// and its channel's affine into (mean, rstd w[c], b[c]); gn1_join.  A
// gn1_join block takes the planes that share one skip plane (a chunk's
// stems) and rounds of 512 consecutive output positions (row x trailing
// index), 4 a thread 128 apart, PyTorch's elementwise layout.  A round
// reads its positions' tap records once (a row's threads share them: the
// first elements of y's two tap rows and the skip's two, and the two
// weights, ops/fused_norm.join_table), then takes the stems in turn, each
// with its 16 loads in flight before their first use: the first stem
// reads the skip's rows from memory, the others from L1, and later rounds
// find an upsampled y's rows in L1.  The GELU is A&S 7.1.26's (below).
// Everything is f32 from the bf16 loads to one rounding of the output; no
// tensor of the convolution's size and no f32 temporary is written.
//
// It reaches 2.7x its bound there (PERF.md): the two GELUs' arithmetic
// and the reads of half of each 4-row block, which PyTorch's own strided
// copy of the same rows streams at 2 TB/s, hold it.  Its loads are of one
// element: at W = 259 the tap rows start at odd elements, and staging
// them in shared memory by 16-byte loads was slower (0.77 ms there).
//
// No atomics: every sum is taken in a fixed order, so the result is
// bitwise the same from run to run, as the serving programs' captured
// graphs and deterministic=True require.  Kernel names start with gn1_.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_NT = 256;   // threads a block at most
constexpr int UNROLL = 4;     // 16-byte loads in flight a thread
enum Act { NONE = 0, GELU = 1, GLU = 2, SILU = 3 };

typedef __nv_bfloat16 bf16;

// A 16-byte vector of T as raw bits, unpacked to f32 and packed back
// (bf16 rounded to nearest even, as PyTorch's casts round).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  __device__ static float get(const float* p) { return __ldg(p); }
  __device__ static void put(float* p, float v) { *p = v; }
};
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* v) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]),
                      pair(v[6], v[7]));
  }
  __device__ static float get(const bf16* p) {
    return __uint_as_float(
        (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  __device__ static void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ---------------------------------------------------------------------------
// (count, mean, M2) and their merges
// ---------------------------------------------------------------------------

struct Stat {
  float n, mean, m2;
};

// b into a (Chan et al.); an empty b leaves a as it is.
__device__ __forceinline__ void merge(Stat& a, const Stat& b) {
  if (b.n == 0.0f) return;
  const float n = a.n + b.n, d = b.mean - a.mean, f = b.n / n;
  a.mean += d * f;
  a.m2 += b.m2 + d * d * a.n * f;
  a.n = n;
}

// Lane 0 ends with the warp's 32 stats merged, in a fixed tree.
__device__ __forceinline__ void warp_merge(Stat& s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Stat t = {__shfl_down_sync(0xffffffffu, s.n, o),
                    __shfl_down_sync(0xffffffffu, s.mean, o),
                    __shfl_down_sync(0xffffffffu, s.m2, o)};
    if (lane + o < 32) merge(s, t);
  }
}

// Thread 0 ends with the block's stats: the warps' merged in warp order.
__device__ __forceinline__ void block_merge(Stat& s, Stat* red) {
  warp_merge(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) merge(s, red[w]);
}

// ---------------------------------------------------------------------------
// 1. Partial moments
// ---------------------------------------------------------------------------

// The thread's share of x[lo, hi) (flat indices): a head and a tail of
// under N elements, one a thread, and the 16-byte-aligned body in rounds
// of UNROLL vectors a thread, neighbouring threads on neighbouring
// vectors.
template <typename T>
__device__ __forceinline__ void slice_stats(const T* __restrict__ x,
                                            long long lo, long long hi,
                                            Stat& st) {
  constexpr int N = Vec<T>::N;
  const int t = threadIdx.x, nt = blockDim.x;
  long long a0 = (lo + N - 1) / N * N, a1 = hi / N * N;
  if (a0 > hi) a0 = hi;
  if (a1 < a0) a1 = a0;
  if (t < a0 - lo) merge(st, Stat{1.0f, Vec<T>::get(x + lo + t), 0.0f});
  if (t < hi - a1) merge(st, Stat{1.0f, Vec<T>::get(x + a1 + t), 0.0f});
  const long long nv = (a1 - a0) / N;
  const T* body = x + a0;
  for (long long v0 = t; v0 < nv; v0 += (long long)UNROLL * nt) {
    uint4 raw[UNROLL];
    int k = 0;  // vectors loaded this round (a prefix of the UNROLL)
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = v0 + (long long)u * nt;
      if (i < nv) {
        raw[u] = load16(body + i * N);
        k = u + 1;
      }
    }
    float v[UNROLL][N];
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (u < k) {
        Vec<T>::unpack(raw[u], v[u]);
#pragma unroll
        for (int j = 0; j < N; ++j) s += v[u][j];
      }
    }
    const float cnt = (float)(k * N), m = s / cnt;
    float q = 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (u < k) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float d = v[u][j] - m;
          q = fmaf(d, d, q);
        }
      }
    }
    merge(st, Stat{cnt, m, q});
  }
}

// One block a (row, split): the (count, mean, M2) of row r's slice
// [s chunk, min((s + 1) chunk, n)) to part[r][s].
template <typename T>
__global__ void __launch_bounds__(MAX_NT)
gn1_moments(const T* __restrict__ x, float* __restrict__ part, long long n,
            int splits, long long chunk) {
  __shared__ Stat red[MAX_NT / 32];
  const long long r = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const long long end = (long long)(s + 1) * chunk;
  const long long lo = r * n + (long long)s * chunk;
  const long long hi = r * n + (end < n ? end : n);
  Stat st = {0.0f, 0.0f, 0.0f};
  slice_stats(x, lo, hi, st);
  block_merge(st, red);
  if (threadIdx.x == 0) {
    float* p = part + (r * splits + s) * 3;
    p[0] = st.n;
    p[1] = st.mean;
    p[2] = st.m2;
  }
}

// ---------------------------------------------------------------------------
// 2. Normalise, affine, activation
// ---------------------------------------------------------------------------

struct Geo {
  long long n;        // elements a row: (C / G) x inner
  long long seg_len;  // output elements a segment
  long long chunk;    // output elements a block (the last of a segment fewer)
  int inner;          // elements a channel step: spatial size, 1 for tokens
  int C, G;           // channels, groups
  int splits;         // launch 1's blocks a row: triples to merge
  int bps;            // blocks a segment
  float eps;
};

// Row r's mean and rstd from its triples, merged by the calling warp in a
// fixed order (lane j takes triples j, j + 32, ... in turn, then the
// lanes' tree), to out[0..1]: every block of the row gets the same bits.
// A lane loads RS triples before it merges them, so the loads overlap.
constexpr int RS = 8;
__device__ __forceinline__ void row_stats(const float* __restrict__ part,
                                          long long r, int splits, float eps,
                                          float* out) {
  Stat s = {0.0f, 0.0f, 0.0f};
  const float* row = part + r * splits * 3;
  for (int j0 = threadIdx.x & 31; j0 < splits; j0 += 32 * RS) {
    Stat t[RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int j = j0 + 32 * i;
      t[i] = j < splits ? Stat{__ldg(row + 3 * j), __ldg(row + 3 * j + 1),
                               __ldg(row + 3 * j + 2)}
                        : Stat{0.0f, 0.0f, 0.0f};
    }
#pragma unroll
    for (int i = 0; i < RS; ++i) merge(s, t[i]);
  }
  warp_merge(s);
  if ((threadIdx.x & 31) == 0) {
    out[0] = s.mean;
    out[1] = 1.0f / sqrtf(s.m2 / s.n + eps);
  }
}

// Flat input element i -> its channel c and its place s in the channel.
__device__ __forceinline__ void locate(long long i, const Geo& g, int& c,
                                       int& s) {
  const long long t = i / g.inner;
  s = (int)(i - t * g.inner);
  c = (int)(t % g.C);
}

// (c, s) moved on by d elements, given dq = (d / inner) % C, dr = d % inner.
__device__ __forceinline__ void advance(int& c, int& s, int dq, int dr,
                                        const Geo& g) {
  s += dr;
  c += dq;
  if (s >= g.inner) {
    s -= g.inner;
    ++c;
  }
  if (c >= g.C) c -= g.C;
}

// A channel's affine folded with its row's rstd: y = (v - mean) sa + ba,
// and (GLU) the partner channel's z = (v - mean_b) sb + bb.
struct Coef {
  float sa, ba, sb, bb;
};

template <int ACT>
__device__ __forceinline__ Coef coef(const float* __restrict__ w,
                                     const float* __restrict__ bias, int c,
                                     int half, const float* rs) {
  Coef k;
  k.sa = rs[1] * __ldg(w + c);
  k.ba = __ldg(bias + c);
  if (ACT == GLU) {
    k.sb = rs[3] * __ldg(w + c + half);
    k.bb = __ldg(bias + c + half);
  }
  return k;
}

template <int ACT>
__device__ __forceinline__ float activate(float a, float b, float mean_a,
                                          float mean_b, const Coef& k) {
  const float y = fmaf(a - mean_a, k.sa, k.ba);
  if (ACT == GELU) return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
  if (ACT == GLU) return y / (1.0f + expf(-fmaf(b - mean_b, k.sb, k.bb)));
  if (ACT == SILU) return y / (1.0f + expf(-y));
  return y;
}

// One block a (segment, block): mean and rstd of its row(s), then the
// output elements [k chunk, min((k + 1) chunk, seg_len)) of the segment.
// Output element o_base + j reads x[a_base + j] (and x[b_base + j] for
// GLU).  stats, where given (act none), gets each row's (mean, rstd).
template <typename T, int ACT>
__global__ void __launch_bounds__(MAX_NT)
gn1_apply(const T* __restrict__ x, const float* __restrict__ part,
          const float* __restrict__ w, const float* __restrict__ bias,
          T* __restrict__ out, float* __restrict__ stats, Geo g) {
  constexpr int N = Vec<T>::N;
  __shared__ float rs[4];  // mean, rstd of row a, then of row b
  const long long seg = blockIdx.x / g.bps;
  const int k = blockIdx.x % g.bps;
  long long ra = seg, rb = seg, a_base = seg * g.n, b_base = a_base;
  const long long o_base = seg * g.seg_len;
  if (ACT == GLU) {
    if (g.G == 1) {
      b_base = a_base + g.n / 2;
    } else {
      const int hg = g.G / 2;
      ra = (seg / hg) * g.G + seg % hg;
      rb = ra + hg;
      a_base = ra * g.n;
      b_base = rb * g.n;
    }
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (warp == 0) row_stats(part, ra, g.splits, g.eps, rs);
  if (ACT == GLU && warp == (nw > 1 ? 1 : 0))
    row_stats(part, rb, g.splits, g.eps, rs + 2);
  __syncthreads();
  if (stats != nullptr && k == 0 && threadIdx.x == 0) {
    stats[2 * ra] = rs[0];
    stats[2 * ra + 1] = rs[1];
  }
  const float mean_a = rs[0], mean_b = ACT == GLU ? rs[2] : 0.0f;
  const int half = g.C / 2;

  const int t = threadIdx.x, nt = blockDim.x;
  const long long lo = (long long)k * g.chunk;
  const long long hi = lo + g.chunk < g.seg_len ? lo + g.chunk : g.seg_len;
  const long long ao = a_base - o_base, bo = b_base - o_base;
  const long long q0 = o_base + lo, q1 = o_base + hi;
  // the 16-byte body, where the streams share the output's alignment; a
  // scalar head and tail (everything, where they do not)
  long long v0 = q1, v1 = q1;
  if (ao % N == 0 && bo % N == 0) {
    v0 = (q0 + N - 1) / N * N;
    if (v0 > q1) v0 = q1;
    v1 = q1 / N * N;
    if (v1 < v0) v1 = v0;
  }
  for (int part_ = 0; part_ < 2; ++part_) {
    const long long from = part_ == 0 ? q0 : v1, to = part_ == 0 ? v0 : q1;
    for (long long q = from + t; q < to; q += nt) {
      int c, s;
      locate(q + ao, g, c, s);
      const Coef kc = coef<ACT>(w, bias, c, half, rs);
      const float b = ACT == GLU ? Vec<T>::get(x + q + bo) : 0.0f;
      Vec<T>::put(out + q, activate<ACT>(Vec<T>::get(x + q + ao), b, mean_a,
                                         mean_b, kc));
    }
  }

  const long long step = (long long)nt * N;
  long long q = v0 + (long long)t * N;
  if (q >= v1) return;
  int c, s;
  locate(q + ao, g, c, s);
  const int dq = (int)(step / g.inner % g.C);
  const int dr = (int)(step % g.inner);
  for (; q < v1; q += UNROLL * step) {
    uint4 ra4[UNROLL], rb4[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long qu = q + u * step;
      if (qu < v1) {
        ra4[u] = load16(x + qu + ao);
        if (ACT == GLU) rb4[u] = load16(x + qu + bo);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long qu = q + u * step;
      if (qu < v1) {
        float va[N], vb[N], y[N];
        Vec<T>::unpack(ra4[u], va);
        if (ACT == GLU) Vec<T>::unpack(rb4[u], vb);
        int ce = c, se = s;
        Coef kc = coef<ACT>(w, bias, ce, half, rs);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          y[e] = activate<ACT>(va[e], ACT == GLU ? vb[e] : 0.0f, mean_a,
                               mean_b, kc);
          if (++se == g.inner && e + 1 < N) {
            se = 0;
            ce = ce + 1 == g.C ? 0 : ce + 1;
            kc = coef<ACT>(w, bias, ce, half, rs);
          }
        }
        *reinterpret_cast<uint4*>(out + qu) = Vec<T>::pack(y);
      }
      advance(c, s, dq, dr, g);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. The decoder join
// ---------------------------------------------------------------------------

// GELU with erf by Abramowitz & Stegun 7.1.26 (|error| <= 1.5e-7 in erf),
// the form the JAX package's Pallas kernels take: ~20 instructions, where
// erff's two ranges, if-converted, take ~60 a call and would bound the
// join's arithmetic (two GELUs an output).  In f32 it errs from the exact
// GELU by at most 4.7e-7 (1.6e-5 relative where |gelu| > 0.01), under
// PyTorch's f32 GELU on the CPU (1.1e-6, 6.4e-5), 10^4 below a bf16 step.
__device__ __forceinline__ float gelu_as(float v) {
  const float x = fabsf(v) * 0.70710678118654752f;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, x, 1.0f));
  float p = fmaf(t, 1.061405429f, -1.453152027f);
  p = fmaf(t, p, 1.421413741f);
  p = fmaf(t, p, -0.284496736f);
  p = fmaf(t, p, 0.254829592f);
  const float e = fmaf(-p * t, __expf(-x * x), 1.0f);   // erf(|v| / sqrt 2)
  return 0.5f * v * (1.0f + copysignf(e, v));
}

// The join's normalise, affine and GELU of one element.
__device__ __forceinline__ float norm_gelu(float v, float mean,
                                          const Coef& k) {
  return gelu_as(fmaf(v - mean, k.sa, k.ba));
}

constexpr int JOIN_NT = 128;   // threads a block
constexpr int JOIN_U = 4;      // positions a thread a round, JOIN_NT apart

struct JoinGeo {
  long long ystride;  // elements a plane of y: a x W
  long long sstride;  // elements a plane of the skip: as x W
  int len;            // output elements a plane: output rows x W
  int W;              // elements a row (the axes after the resized one)
  int C, skip_c, b0;  // channels of y; of the skip tensor; the skip's batch
  int stems;          // B / b0: the planes that share a skip plane
  int iters;          // rounds a block
  int xr;             // y is resized (else its second tap is its first)
  float scale;
};

// Each plane's folded norm: (mean, rstd w[c], b[c]) of plane p = b C + c,
// from its batch row's triples.  A warp a plane.
__global__ void __launch_bounds__(256)
gn1_coefs(const float* __restrict__ part, const float* __restrict__ w,
          const float* __restrict__ bias, float4* __restrict__ coefs,
          long long planes, int C, int splits, float eps) {
  __shared__ float rs[8][2];
  const int warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * 8 + warp;
  if (p >= planes) return;
  const long long b = p / C;
  const int c = (int)(p - b * C);
  row_stats(part, b, splits, eps, rs[warp]);
  if ((threadIdx.x & 31) == 0)
    coefs[p] = make_float4(rs[warp][0], rs[warp][1] * __ldg(w + c),
                           __ldg(bias + c), 0.0f);
}

// Block (x, y): iters rounds of JOIN_U x JOIN_NT consecutive output
// positions (row x trailing index), in the planes that share skip plane y
// = (j, c): planes (k b0 + j) C + c, k < stems (the stems of one chunk).
// A round reads its positions' tap records once (a row's threads share
// them), then takes the stems in turn, each with all of its loads in
// flight before their first use; a stem after the first finds the skip's
// rows in L1, and a round after the first an upsampled y's rows.
template <typename T, bool NORM>
__global__ void __launch_bounds__(JOIN_NT)
gn1_join(const T* __restrict__ y, const float4* __restrict__ coefs,
         const int4* __restrict__ tab, const float2* __restrict__ frac,
         const T* __restrict__ skip, T* __restrict__ out, JoinGeo g) {
  const int j = blockIdx.y / g.C, c = blockIdx.y - j * g.C;
  const T* sp = skip + ((long long)j * g.skip_c + c) * g.sstride;
  for (int it = 0; it < g.iters; ++it) {
    const int base = (blockIdx.x * g.iters + it) * (JOIN_U * JOIN_NT) +
                     (int)threadIdx.x;
    if (base >= g.len) break;
    // positions past the plane's end read the last one and store nothing
    int4 t[JOIN_U];
    float2 f[JOIN_U];
#pragma unroll
    for (int u = 0; u < JOIN_U; ++u) {
      const int q = min(base + u * JOIN_NT, g.len - 1);
      const int r = q / g.W, col = q - r * g.W;
      t[u] = __ldg(tab + r);
      t[u].x += col;
      t[u].y += col;
      t[u].z += col;
      t[u].w += col;
      f[u] = __ldg(frac + r);
    }
    for (int k = 0; k < g.stems; ++k) {
      const long long p = ((long long)k * g.b0 + j) * g.C + c;
      const T* yp = y + p * g.ystride;
      T* op = out + p * g.len;
      float va[JOIN_U], vb[JOIN_U], sa[JOIN_U], sb[JOIN_U];
#pragma unroll
      for (int u = 0; u < JOIN_U; ++u) {
        va[u] = Vec<T>::get(yp + t[u].x);
        vb[u] = Vec<T>::get(yp + t[u].y);
        sa[u] = Vec<T>::get(sp + t[u].z);
        sb[u] = Vec<T>::get(sp + t[u].w);
      }
      const float4 kf = NORM ? __ldg(coefs + p) : make_float4(0, 0, 0, 0);
      const Coef kc = {kf.y, kf.z, 0.0f, 0.0f};
#pragma unroll
      for (int u = 0; u < JOIN_U; ++u) {
        const int q = base + u * JOIN_NT;
        if (q < g.len) {
          float ha = va[u], hb = vb[u];
          if (NORM) {
            ha = norm_gelu(ha, kf.x, kc);
            hb = g.xr ? norm_gelu(hb, kf.x, kc) : ha;
          }
          Vec<T>::put(op + q,
                      fmaf(g.scale, sa[u] * (1.0f - f[u].y) + sb[u] * f[u].y,
                           ha * (1.0f - f[u].x) + hb * f[u].x));
        }
      }
    }
  }
}

int threads_for(long long chunk) {
  long long t = (chunk / 16 + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : t > MAX_NT ? MAX_NT : t);
}

template <typename T, int ACT>
cudaError_t run(const void* x, const float* w, const float* b, void* out,
                float* part, float* stats, long long rows, const Geo& g,
                long long chunk1, long long segments, cudaStream_t stream) {
  gn1_moments<T><<<(unsigned)(rows * g.splits), threads_for(chunk1), 0,
                   stream>>>(static_cast<const T*>(x), part, g.n, g.splits,
                             chunk1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn1_apply<T, ACT><<<(unsigned)(segments * g.bps), threads_for(g.chunk), 0,
                      stream>>>(static_cast<const T*>(x), part, w, b,
                                static_cast<T*>(out), stats, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_act(int act, const void* x, const float* w, const float* b,
                    void* out, float* part, float* stats, long long rows,
                    const Geo& g, long long chunk1, long long segments,
                    cudaStream_t stream) {
  if (act == GELU)
    return run<T, GELU>(x, w, b, out, part, stats, rows, g, chunk1, segments,
                        stream);
  if (act == GLU)
    return run<T, GLU>(x, w, b, out, part, stats, rows, g, chunk1, segments,
                       stream);
  if (act == SILU)
    return run<T, SILU>(x, w, b, out, part, stats, rows, g, chunk1, segments,
                        stream);
  return run<T, NONE>(x, w, b, out, part, stats, rows, g, chunk1, segments,
                      stream);
}

template <typename T>
cudaError_t run_join(const void* y, const float* w, const float* b,
                     float* part, float4* coefs, long long n, int splits,
                     long long chunk1, float eps, const int4* tab,
                     const float2* frac, const void* skip, void* out,
                     long long planes, const JoinGeo& g, cudaStream_t stream) {
  const T* yt = static_cast<const T*>(y);
  const bool norm = w != nullptr;
  if (norm) {
    gn1_moments<T><<<(unsigned)(planes / g.C * splits), threads_for(chunk1),
                     0, stream>>>(yt, part, n, splits, chunk1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gn1_coefs<<<(unsigned)((planes + 7) / 8), 256, 0, stream>>>(
        part, w, b, coefs, planes, g.C, splits, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long per = (long long)g.iters * JOIN_U * JOIN_NT;
  const dim3 grid((unsigned)((g.len + per - 1) / per),
                  (unsigned)(g.b0 * g.C));
  const auto kernel = norm ? gn1_join<T, true> : gn1_join<T, false>;
  kernel<<<grid, JOIN_NT, 0, stream>>>(yt, coefs, tab, frac,
                                       static_cast<const T*>(skip),
                                       static_cast<T*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// x -> out on `stream`, both contiguous and 16-byte aligned, dtype 0 f32,
// 1 bf16; act 0 none, 1 GELU, 2 GLU, 3 SiLU.  rows = B G rows of n elements each,
// C channels a batch item, inner elements a channel step.  Launch 1 cuts a
// row into `splits` slices of chunk1 elements (the last fewer); launch 2
// cuts each of `segments` output segments of seg_len elements into `bps`
// blocks of chunk2 (the wrapper's partition, ops/fused_norm.py).  part is
// f32 scratch (rows, splits, 3); stats, if not null, gets (rows, 2) mean
// and rstd (act none only).  w, b: the (C,) affine in f32.  Returns the
// first CUDA error (0 on success).
extern "C" int gn1_launch(const void* x, int dtype, int act, const float* w,
                          const float* b, void* out, float* part,
                          float* stats, long long rows, long long n, int C,
                          int G, int inner, int splits,
                          long long chunk1, long long segments,
                          long long seg_len, int bps, long long chunk2,
                          float eps, void* stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
      15)
    return (int)cudaErrorMisalignedAddress;
  if (rows < 1 || n < 1 || C < 1 || G < 1 || inner < 1 ||
      inner > (1 << 29) || splits < 1 ||
      bps < 1 || act < NONE || act > SILU ||
      (stats != nullptr && act != NONE) ||
      (act == GLU && (C % 2 || (G > 1 && G % 2))))
    return (int)cudaErrorInvalidValue;
  Geo g = {n, seg_len, chunk2, inner, C, G, splits, bps, eps};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? run_act<bf16>(act, x, w, b, out, part, stats, rows, g,
                                 chunk1, segments, s)
                 : run_act<float>(act, x, w, b, out, part, stats, rows, g,
                                  chunk1, segments, s);
  return (int)err;
}

// The decoder join on `stream`.  y (B, C, a, W) and skip (b0 dividing B,
// skip_c >= C channels, as rows, W) contiguous, dtype 0 f32, 1 bf16; y
// 16-byte aligned where it is normalised.  out (B, C, rows, W) gets
// gelu(norm(y)) (y itself where w is null), resized along the rows, plus
// scale x the skip's channels [0, C) of batch item b mod b0, resized the
// same way.  tab (rows, 4) int32 holds each output row's tap rows x W (y's
// two, the skip's two), frac (rows, 2) f32 the weights of the second taps
// (y's, the skip's); xr says whether y is resized.  w, b: the (C,) affine
// in f32, or null; then launch 1 (the statistics, part f32 scratch (B,
// splits, 3), rows of n = C a W cut into splits slices of chunk1) and the
// planes' folded norms (coefs, (B C) float4 scratch) run first.  A block
// of the join takes iters rounds.  Returns the first CUDA error.
extern "C" int gn1_join_launch(const void* y, int dtype, const float* w,
                               const float* b, float* part, float* coefs,
                               long long n, int splits, long long chunk1,
                               const int* tab, const float* frac, int xr,
                               const void* skip, void* out, long long B,
                               int C, long long a, long long rows,
                               long long W, int skip_c, int b0, long long as,
                               int iters, float eps, float scale,
                               void* stream) {
  const long long planes = B * C;
  if (B < 1 || C < 1 || a < 1 || rows < 1 || W < 1 || as < 1 || b0 < 1 ||
      B % b0 || skip_c < C || (long long)b0 * C > 65535 || iters < 1 ||
      rows * W > INT_MAX - (long long)iters * JOIN_U * JOIN_NT ||
      a * W > INT_MAX || as * W > INT_MAX || tab == nullptr ||
      frac == nullptr || (w == nullptr) != (b == nullptr) ||
      (w != nullptr && (splits < 1 || coefs == nullptr || part == nullptr ||
                        n != (long long)C * a * W)))
    return (int)cudaErrorInvalidValue;
  if (w != nullptr && (reinterpret_cast<uintptr_t>(y) & 15))
    return (int)cudaErrorMisalignedAddress;
  JoinGeo g;
  g.ystride = a * W;
  g.sstride = as * W;
  g.len = (int)(rows * W);
  g.W = (int)W;
  g.C = C;
  g.skip_c = skip_c;
  g.b0 = b0;
  g.stems = (int)(B / b0);
  g.iters = iters;
  g.xr = xr;
  g.scale = scale;
  const int4* t4 = reinterpret_cast<const int4*>(tab);
  const float2* f2 = reinterpret_cast<const float2*>(frac);
  float4* c4 = reinterpret_cast<float4*>(coefs);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? run_join<bf16>(y, w, b, part, c4, n, splits, chunk1, eps,
                                  t4, f2, skip, out, planes, g, s)
                 : run_join<float>(y, w, b, part, c4, n, splits, chunk1, eps,
                                   t4, f2, skip, out, planes, g, s);
  return (int)err;
}
