// Rotary position embedding of BS-RoFormer's queries and keys, with the
// values split off, in one pass over the packed projection.
//
// Replaces no TPU kernel (the JAX package has no BS-RoFormer).  The model's
// to_qkv product gives qkv (rows, 3 D) bf16, rows = B L of L positions;
// the flash launch wants q, k and v as three contiguous (B, L, D) tensors,
// q and k turned by RoPE: in every head of dh columns, pair j = (x[2j],
// x[2j + 1]) at position p turns by the angle p θ^(-2j / dh).  In PyTorch
// ops that is a strided copy to f32, a complex product and a rounding for
// each of q and k, and a copy for v: ~5 passes of 0.2-0.4 GB a transformer
// at a serving group of four 8 s chunks.
//
// What bounds it on an H100: bytes.  qkv read once and q, k, v written
// once, 12 bytes a row and column of D, against 6 f32 operations a pair.
//
// Design.  One block a row, one thread a 16-byte piece (8 bf16) of it:
// 3 D / 8 threads.  A piece of q or k holds four pairs of one head (dh is
// a multiple of 8), turned in f32 by (cos, sin) from the table rot (L,
// dh / 2) that nn.core.rope_rotation makes (torch.polar of f32 angles, as
// the plain version uses), as the plain version's complex product does:
// (x0 c - x1 s, x0 s + x1 c), then rounded to bf16 once.  A piece of v is
// copied.  Loads and stores are 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__global__ void rope_qkv_kernel(const bf16* __restrict__ qkv,
                                const float2* __restrict__ rot,
                                bf16* __restrict__ q, bf16* __restrict__ k,
                                bf16* __restrict__ v, int L, int D, int dh) {
  const size_t r = blockIdx.x;
  const int c = threadIdx.x * 8;              // column in [0, 3 D)
  const int part = c / D, col = c - part * D;
  uint4 raw = *reinterpret_cast<const uint4*>(qkv + r * 3 * D + c);
  if (part < 2) {
    const int p = (int)(r % L);
    const float2* cs = rot + (size_t)p * (dh / 2) + (col % dh) / 2;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(h[e]);
      const float2 t = cs[e];
      h[e] = __floats2bfloat162_rn(x.x * t.x - x.y * t.y,
                                   x.x * t.y + x.y * t.x);
    }
  }
  bf16* dst = part == 0 ? q : (part == 1 ? k : v);
  *reinterpret_cast<uint4*>(dst + r * D + col) = raw;
}

}  // namespace

// Launch on `stream`: qkv (rows, 3 D) bf16, rows = B L; rot (L, dh / 2)
// complex64 as (cos, sin) pairs; q, k, v (rows, D) bf16.  D and dh
// multiples of 8, 3 D / 8 <= 1024.  Returns the first CUDA error.
extern "C" int rope_qkv_launch(const void* qkv, const void* rot, void* q,
                               void* k, void* v, long long rows, int L,
                               int D, int dh, void* stream) {
  if (rows < 1 || D % 8 || dh % 8 || D % dh || 3 * D / 8 > 1024)
    return (int)cudaErrorInvalidValue;
  rope_qkv_kernel<<<(unsigned)rows, 3 * D / 8, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float2*>(rot),
      static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v), L,
      D, dh);
  return (int)cudaGetLastError();
}
