// The DConv residual branch over folded (b * f) frequency rows.
//
// Replaces audio_to_sheet_music_tpu/ops/pallas_dconv.py:dconv_rows (Pallas
// body _kernel over _block_body), which the JAX package runs at the freq
// encoder layers that henc_freq_fused does not take (layers 1-3 under the
// opt-in kernels): rows B x {128, 32, 8} of C {96, 192, 384} channels by T
// frames, bf16 in and out.
//
// The Pallas kernel keeps a block of rows, lane-padded to a multiple of 128
// frames, resident in VMEM and masks the pad for the GroupNorm statistics
// and between the dilated blocks.  A Hopper block cannot hold one row at
// C = 384 (398 KB in f32), so the work is the shared routine of
// dconv_row.cuh: per block three launches over (row, 64-frame tile) blocks,
// each a bf16 mma.sync product with its epilogue, the row's GroupNorm
// statistics merged from per-tile partials, no padding (a ragged last tile
// is masked), and the f32 result of block 0 kept in a scratch for block 1.
// What bounds it and what the design does about it is in that header.

#include "dconv_row.cuh"

// f32 scratch the caller allocates: mid (R, C, T), u (R, C/8, T) and part
// (dconv_rows_part_floats).
extern "C" size_t dconv_rows_part_floats(int R, int T) {
  return dconv::part_floats(R, T);
}

// The hidden width Hp the weights are padded to.
extern "C" int dconv_rows_hidden_pad(int C) { return dconv::hidden_pad(C); }

// x (R, C, T) bf16 -> out (R, C, T) bf16 on `stream`, C a multiple of 8 up
// to dconv::MAX_C.  dw holds the 18 weight pointers, block 0 then block 1,
// each w1 (3, C, Hp) bf16, b1, g1, bt1, w2 (2C, Hp) bf16, b2, g2, bt2,
// scale (f32); the pad is zero.  Returns the first CUDA error (0 on
// success).
extern "C" int dconv_rows_launch(const void* x, const void* const* dw,
                                 void* mid, void* u, void* part, void* out,
                                 int R, int C, int T, void* stream) {
  dconv::BlockW w[2];
  dconv::unpack(dw, w);
  return (int)dconv::run<dconv::bf16, dconv::bf16>(
      static_cast<const dconv::bf16*>(x), w, static_cast<float*>(mid),
      static_cast<float*>(u), static_cast<float*>(part),
      static_cast<dconv::bf16*>(out), R, C, T,
      reinterpret_cast<cudaStream_t>(stream));
}
