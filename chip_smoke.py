#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; a failed phase exits non-zero and prints no result:

1. Preflight: the card's name and power limit (``nvidia-smi``), then all
   seven kernel libraries built with ``nvcc`` from ``audio_to_sheet_music_tpu_torch/
   csrc``, one process per source, all at once; each kernel's registers
   and spills (``ptxas -v``), the count of ``HGMMA`` (wgmma) instructions
   in the flash-attention launch (both its forms, plain and gated) and in
   every GEMM launch of the ``attn_block`` and ``layer_tail`` libraries, and of ``HMMA`` (mma.sync)
   instructions in each launch of the DConv routine (``conv1_kernel``,
   ``conv2_stats_kernel``, ``apply_kernel``) of the ``dconv_rows`` and
   ``henc_freq`` libraries and in ``henc_freq``'s ``henc_conv_kernel`` and
   ``henc_rewrite_kernel`` (``cuobjdump -sass``); a count of 0, a missing
   or failing ``cuobjdump``, or a library without the launch fails the
   phase.
2. Kernels against their plain PyTorch versions, at the shapes their path
   gives them: ``layer_tail`` in its four forms for one group of four 6 s
   serving chunks (freq self 2072/2072, time self 1034/1034, freq cross
   2072/1034, time cross 1034/2072) plus a ragged 1000/777;
   ``henc_freq_fused`` at (4, 4, 2048, 259) and at a 30 s chunk (T = 1292,
   past the first design's limit of 1076); and for a training batch of
   8 x 6 s, ``dconv_rows`` at freq layers 1-3 (1024 x 96, 256 x 192,
   64 x 384 rows by 259 frames), ``attn_block`` in the four forms at B = 8
   plus a ragged one, and the STFT kernel at (16, 272384).  Then each at
   the eval path's shapes (phase 5: a forward of 16 chunks of 7.8 s):
   ``layer_tail`` and ``attn_block`` in the four forms at B = 16 (freq
   self 2688/2688, time self 1344/1344 and the two cross forms),
   ``henc_freq_fused`` at (16, 4, 2048, 336), ``dconv_rows`` at the freq
   encoder layers' and decoders' 128 x 384, 512 x 192, 2048 x 96 and
   8192 x 48 rows by 336 frames, and the STFT at (32, 351232).  Then the
   GroupNorm pair (``ops/fused_norm``) at the main path's four norm shapes
   in bf16 and f32, timed by the profiler's device time, and at
   SCNet-large's: every form one eager group of four 11 s chunks runs
   (its launch counter checked against the calls) held to the plain
   version in bf16, six of them (the convolution modules' plain and SiLU
   norms, the dual-path token norms at 256 and 512 wide) timed in bf16
   and f32 with their launches in that group; then the ATHT
   head's decoder join (``fused_norm.decoder_join``) at each of a songs
   group's 8 layers and a stream block's freq layer 1 (skip batch = y's)
   against its plain version on f32 operands; at freq layers 0 and 1 the
   call (statistics and join), the ``gn1_join`` launch alone, the plain
   chain and the chain the card ran before, by device time.  Then
   BS-RoFormer's two launches at its serving group's axes (four 8 s
   chunks: 248 sequences of 801 frames, 3,204 of 62 bands, width 512):
   ``attn_gated`` (the gated flash launch and the out-projection GEMM)
   against ``attn_gated_plain`` and ``scaled_dot_product_attention`` with
   cuBLAS, and ``rope_qkv`` against ``rope_qkv_plain`` (q, k and v each;
   v equal bit for bit), with CUDA-event times and their bounds from
   ``port_bench/roformer_work``.  Each prints
   its max and rms error against the stated tolerance, and CUDA-event times
   for the kernel, the plain version and a PyTorch library call (or
   composition) computing the same function.
3. The full path: the full-width model (``atht.init(0)`` drawn on the card,
   the JAX package's ``atht.init(PRNGKey(0))``, with the committed trained
   head grafted on) in a ``Separator`` on ``cuda``.  Before the graft, the
   draw's seconds are printed and every leaf is held to the JAX package's
   seed-0 fingerprint (``models/seed0_fingerprint.json``: count, f64 sum
   and sum of squares, and the hash of every uniform leaf).  With bf16
   compute it serves a seeded 60 s stereo song, all 4 stems, through
   ``separate_all_pcm``: once to warm up (which captures its group
   programs, ``infer.programs``), then once with the kernels' launch
   counters set to 0 just before and read just after (the replays count
   them; 8 ``dec_join`` launches a group, one a ``henc_freq_fused``), with
   the peak device memory of both calls.  Then one 6 s chunk
   goes through ``forward_with_text_emb`` with the kernels and with the
   per-op path; their rms difference must be below 1e-3.
4. Training: the same full-width model (seeded init + trained head) trains
   its head with ``train.trainer.train`` on synthetic tracks written to a
   temporary directory (batch 8 x 6 s, bf16, the CLAP text tower every
   step, one epoch of a few steps, a validation pass, checkpoints) under the
   opt-in kernels, with every launch counter set to 0 just before and read
   just after; then a resume from the checkpoint.  It checks the loss is
   finite, the towers' parameters are unchanged, the resumed head equals the
   saved one, the opt-in 6 s forward is within 1e-3 rms of the per-op one,
   and the opt-in loss equals the per-op loss on one batch within what that
   threshold allows; then times warm train steps under the opt-in, default
   and per-op selections.
5. The eval path: the full-width tower (seeded init, seed 0; the model
   carries the committed trained head) in an ``HTDemucsBaseline`` on
   ``cuda`` in bf16 separates the same 60 s song into 4 sources (16 chunks
   of 7.8 s, 25 % overlap) under each selection (default, opt-in, per-op):
   once warm, then once timed with every launch counter set to 0 just
   before and read just after.  ``layer_tail`` and ``henc_freq_fused`` must
   run under the default selection; under the opt-in one ``dconv_rows``
   must run in the freq decoders (their launches: an opt-in forward's less
   its encode's).  The 16-chunk batch through ``htdemucs.forward`` under
   the default and opt-in selections must be within 1e-3 rms of the per-op
   one.  Then ``cli benchmark --synthetic --synthetic-tracks 5 --models ours
   ours-random htdemucs clapsep`` under the default selection, the command
   that wrote the JAX package's ``results/synthetic/evaluation_results.json``
   (on a TPU, bf16): every aggregate SDR and SI-SDR row (each stem and the
   average) within 0.25 dB of that file's, and Ours above Ours-random on
   every stem's SDR.  Then ``cli benchmark`` on two synthetic 12 s tracks
   with "ours", "ours-random" and "htdemucs" per op: both runs must have
   the reference schema, every aggregate a number within the ±30 dB clamp,
   and each stem's SDR on those two tracks within the loss-gap rule of the
   per-op one.

6. The serving apps: ``apps.serve.build_separator(None, "config.yaml",
   device="cuda")`` (the same seeded towers and committed head; bf16; the
   app protocol's 6 s chunks with 0.1 s overlap) behind a
   ``SeparationService``; ``autotune_stream_block`` (its two timed block
   steps, the fitted floor and per-chunk time, the chosen block and its
   predicted first audio) and the peak memory of one block of the chosen
   size, which must fit.  Then ``separate_pcm`` twice (the app separator
   takes cuDNN's deterministic algorithms: the two must repeat), and the
   server on ``127.0.0.1`` in a thread, with the 60 s song as an int16
   WAV: ``/api/separate`` within
   one int16 step of ``separate_pcm``; ``/api/separate/stream`` at
   ``block=auto`` and ``block=8``, each exactly ``44 + 4 T`` bytes and
   within 1e-3 rms of ``separate`` away from the edge samples, with the
   seconds to the first audio byte, the wall and the rate, and at ``auto``
   the launch counters set to 0 just before and read just after
   (``layer_tail`` 10 and ``henc_freq_fused`` 1 a block step);
   ``/api/separate_all`` within one step of ``separate_all_pcm`` a stem,
   ``scales.json`` equal to its scales, and its wall against the direct
   call's; ``/api/separate?format=json`` (spectrograms only where
   matplotlib imports); ``/api/health`` and ``/api/metrics`` counting the
   requests sent, and the device lock's busy share.  Then
   ``layer_tail`` (the four forms) and ``henc_freq_fused`` against their
   plain versions at the stream's blocks (the chosen block and 8 chunks of
   6 s) and at ``/api/separate``'s whole-song batch, with the times of
   phase 2.  Last, ``spectrogram_db`` on the card against the CPU within
   1e-2 dB.

7. Reference checkpoints, the segment loader and the towers of the eval
   path (after phase 6; numbers under ``checkpoints_towers``):
   ``export_atht_checkpoint`` of phase 3's model to a ``.pt`` (size, write
   and read seconds), ``atht.load_params(atht.init(1), path)`` equal to it
   in every tensor and marked pretrained; a ``Separator`` on it refuses to
   start without a BPE vocabulary, then, with ``ATSM_TOKENIZER_DIR`` at a
   ``vocab.json`` + ``merges.txt`` the phase writes, serves the 60 s song
   (a call that captures its programs, then one timed) with phase 3's
   launch counts (set to 0 just before the timed call, read just after);
   ``train`` with ``training.resume_from`` at the ``.pt``, given the model
   it would convert from there so that its towers can be read after, takes
   2 steps and a validation batch (finite loss, towers unchanged).  The C++
   segment loader built by g++ (its seconds), ``train`` with
   ``num_workers=4`` for an epoch of phase 4's tracks, a native batch's
   items checked as slices of the tracks, and for each loader (C++,
   Python) its batches/s and, from one traced run of the default train
   steps it feeds (``torch.profiler``, device activity only), their steps/s
   and the device's busy share.  The full-width CLAP audio
   tower (HTSAT, f32) on phase 3's 4 stems at 48 kHz: features unit-norm,
   the 4 x 4 similarity finite, one stem on the card within 1e-4 of max|ref|
   of the CPU, ms a call.  CLAPSep at full width (``CLAPSepModel``, f32) on
   the 60 s song, each stem's wall, its chunks and the peak memory; one
   10 s chunk on the card within 1e-4 of rms(ref) of the CPU; ``cli
   benchmark`` with "ours" and "clapsep" (the reference schema, the ±30 dB
   clamp).  Last, the embedding tool's ``embed_prompts`` and
   ``analyze_clustering`` on the card against the CPU within 1e-4, and its
   Word2Vec leg.

8. The kernel gate and several devices (after phase 7; numbers under
   ``parallel_gate``): the gate's result from phase 3's ``Separator`` (rms
   below 1e-3), the gate at the opt-in selection, and a pair whose kernel
   pass is off by 1e-2, which must raise ``KernelParityError``.  Then
   ``separate_all_pcm`` of the 60 s song, 4 stems, on ``make_mesh()``
   (every visible card) and on two replicas of ``cuda:0`` (each group
   split in two), warm, then timed with the launch counters set to 0 just
   before and read just after (``layer_tail`` and ``henc_freq_fused`` must
   run): the int16 difference from phase 3's PCM, the rms against
   ``separate_all`` (below 1e-3), the wall, the rate and the schedule; the
   places where the host waits for the card inside one group's
   ``_heads`` on the 2-replica mesh (``torch.cuda.set_sync_debug_mode``);
   a ``StreamingSeparator`` on that mesh at ``block_chunks=3`` (rounded
   to 4) within 1e-3 rms of ``separate``.  Then ``cli train
   --data-parallel`` (one NCCL process a card; 2 steps of 8 x 6 s and the
   validation batch on phase 4's synthetic tracks: finite losses, rank 0's
   checkpoint) beside one opt-in train step of 8 x 6 s over 2 gloo ranks
   that share ``cuda:0``, against the single-device step: head and loss
   within 1e-3.  Last, ``Separator.sweep_flops`` of the song and the
   tensor-core share it gives phase 3's wall.
9. The learning proof (after phase 8; numbers under ``learning_proof``):
   ``apps.learning_proof.run`` on the card, the port of the JAX
   ``scripts/learning_proof.py``: the seed-0 full-width model with its
   random head trains 240 default-selection steps of 8 x 6 s on 4
   synthetic 24 s tracks, with the launch counters set to 0 just before
   and read just after (``layer_tail`` and ``henc_freq_fused`` must run);
   eval SDR on a held-out 12 s track before within 0.1 dB of the JAX
   record's -4.37 dB, after at least +4.0 dB and at least +8 dB above
   before (the JAX record: +6.10, +10.47); the steps/s.
10. The captured programs (after phase 9; numbers under ``programs``):
   every ``Separator`` above on one card already ran its sweeps through
   ``infer.programs`` (one CUDA graph per chunk geometry); here, on phase
   3's model drawn again, a ``deterministic=True`` separator's
   ``separate_all_pcm`` of the 60 s song: the warm-up (captures included),
   each group program's capture seconds, the graph pool's bytes and the
   peak device memory above the model, beside an eager sweep's allocated
   and reserved peaks on a fresh separator; a warm call with the launch
   counters set to 0 just before and read just after (phase 3's counts,
   through replays), its PCM equal bit for bit to the same pipeline with
   each group run by the eager ``_group``; both paths' walls in turn
   (programs, eager, eager, programs); the host's CUDA calls in one call
   under ``torch.profiler`` (one ``cudaGraphLaunch`` a group and no kernel
   launched from the host, against the eager path's launches); the places
   where the host waits for the card in it before its last group is
   enqueued (``torch.cuda.set_sync_debug_mode``: none).  Then a default separator's
   PCM against its ``separate_all`` (the whole-song program) within 1e-3
   rms; a deterministic ``opt_in`` one's group programs, which must launch
   ``henc_freq_fused``, ``dconv_rows``, ``attn_block`` and the STFT
   through replays and equal their eager body bit for bit (their rms
   against the default is printed: the head's divide by the signed CaC
   plane magnifies the STFT kernel's last-bit differences from cuFFT);
   and ``opt_in`` without the STFT kernel within 1e-3 rms of the
   default.  Last, the
   app separator: ``autotune_stream_block`` eager and then with programs
   (floor and per-chunk seconds of a block step), and the 60 s song
   streamed at ``block=8`` and at the autotuned block through the server's
   feed loop without HTTP: first audio, wall, rate, and 1e-3 rms against
   ``separate``; the card's ``nvidia-smi`` name and power limit.
11. BS-RoFormer (after phase 10; numbers under ``bs_roformer``): the
   published widths (``models.bs_roformer.PUBLISHED``, seed 0) in a
   deterministic ``Separator`` at the ``bs_roformer.songs-vocals`` cell's
   8 s chunks and 6 s overlap: its kernel gate must have run one layer's
   ``attn_gated`` and ``rope_qkv`` (two each), a stem it does not have
   must raise; the 60 s song's vocals through ``separate_all_pcm`` in
   groups of four, warm (captures included), then with the launch
   counters set to 0 just before and read just after: exactly
   ``attn_gated`` and ``rope_qkv``, 24 each a group, through replays;
   int16, not silent; the wall, the rate and the peak device memory.

``python3 chip_smoke.py --profile`` adds, in phase 2, how each
``layer_tail`` form's device time splits between its six launches (Q GEMM,
flash, out-projection GEMM, LayerNorm, FF1, FF2, each with its rate and
bound), how each ``attn_block`` form's splits between its flash launch and
its out-projection GEMM, and each ``henc_freq_fused`` and ``dconv_rows``
form's between the DConv routine's three launches and
``henc_freq_fused``'s conv and rewrite (profiler kernel names), and
for ``layer_tail``'s eval forms its six launches beside its library
call's attention kernels and matrix products; after phase 3, one more
``separate_all_pcm`` under ``torch.profiler`` (device time by kernel group
and the device's busy share) and one timed sweep on the per-op path
(``Separator(kernels=False)``), the rate the kernels have to beat; and in
phase 4 one opt-in train step under the profiler, and in phase 5 one
default ``HTDemucsBaseline`` sweep under the profiler; and the cost of
cuDNN's deterministic algorithms, which only the serving app's separator
takes: a default train step (phase 4) and a default eval sweep (phase 5)
timed with the flag off and on (off, on, on, off), and in phase 6 two
``separate_pcm`` calls with it off, whose int16 difference shows why the
app takes it.

The last three lines of standard output are the card (as ``nvidia-smi``
prints it), one JSON object with the numbers of every kernel (``launches``
from the path that runs it: the serving sweep for ``layer_tail`` and
``henc_freq_fused``, the training run for the other three; ``eval_*`` the
same numbers at the eval path's shapes, with ``eval_launches`` from its
default sweep for the first two and its opt-in sweep for the others;
``stream_launches`` from phase 6's streaming request at ``block=auto``;
``learn_launches`` from phase 9's training and evaluation; for
``attn_gated`` and ``rope_qkv`` ``launches`` from phase 11's call;
``stream_*`` for ``layer_tail`` and ``henc_freq_fused`` the numbers at the
stream's block shapes, means per launch over phase 6's two streams), and
``{"ok": true, "device": {...}}``.  The same numbers, with each form's and
the training, eval, serving and phase 7's (and the profile, when asked),
are written to ``build/chip_smoke.json``.

Rates for the bounds are the H100 SXM data sheet's dense peaks: the bf16
tensor-core peak from ``utils/profiling.peak_tflops`` (989 TFLOP/s, keyed on
the card's name), 67 TFLOP/s f32 outside the tensor cores, and 3.35 TB/s of
memory.  The kernels that take bf16 in and give bf16 out have their
operations priced at the bf16 tensor rate, whatever units the kernel itself
uses; the f32 STFT at the f32 rate, counting an FFT's 2.5 N log2 N
operations a frame.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# the benchmark's yardstick, one copy: peaks, work, kernel groups, launches
from port_bench.common import (HENC_KERNELS, HOST_LAUNCHES,
                               LAYER_TAIL_KERNELS, MEMORY_BYTES_PER_S,
                               busy_union, henc_work, kernel_group,
                               layer_work)
from port_bench.common import bound as _bound_s

BF16_TENSOR_FLOPS = 0.0            # set in main: profiling.peak_tflops()
F32_FLOPS = 67e12
SEED = 0
SAMPLE_RATE = 44100
SONG_SECONDS = 60.0
STEMS4 = ("drums", "bass", "other", "vocals")   # text.prompts.STEM_NAMES
CHUNK_SECONDS = 6.0
PATH_RMS_LIMIT = 1e-3      # the JAX package's kernel gate threshold
D, FF, HEADS = 512, 2048, 8

# layer_tail forms in one group program of 4 chunks: (name, L, S, launches);
# attn_block takes the same forms once per train step of batch TRAIN_B
LAYER_FORMS = [("freq_self", 2072, 2072, 3), ("time_self", 1034, 1034, 3),
               ("freq_cross", 2072, 1034, 2), ("time_cross", 1034, 2072, 2)]
RAGGED = ("ragged", 1000, 777, 0)
TRAIN_B = 8
TRAIN_T = 259                      # spectrogram frames of a 6 s segment
# dconv_rows at freq encoder layers 1-3 of a training batch: (rows, C)
DCONV_FORMS = [(TRAIN_B * 128, 96), (TRAIN_B * 32, 192), (TRAIN_B * 8, 384)]
# the STFT of a training batch: 2 x 8 rows, 6 s padded for 263 frames
STFT_ROWS, STFT_T, NFFT, HOP, STFT_FRAMES = 2 * TRAIN_B, 272384, 4096, 1024, 263
# the eval path (phase 5): the HTDemucs baseline's 7.8 s chunks, 16 of them
# for a 60 s song (plan_chunks, bucket 8): 8 x 336 freq tokens, 1344 time
# tokens; layer forms (name, L, S, launches a forward)
EVAL_SECONDS, EVAL_OVERLAP = 7.8, 0.25
EVAL_B, EVAL_T = 16, 336
EVAL_LAYER_FORMS = [("freq_self", 2688, 2688, 3),
                    ("time_self", 1344, 1344, 3),
                    ("freq_cross", 2688, 1344, 2),
                    ("time_cross", 1344, 2688, 2)]
# dconv_rows in an opt-in forward, (rows, C, launches): freq encoder layers
# 1-3 and freq decoders 0-2 share three shapes, decoder 3 adds a fourth
EVAL_DCONV_FORMS = [(EVAL_B * 8, 384, 2), (EVAL_B * 32, 192, 2),
                    (EVAL_B * 128, 96, 2), (EVAL_B * 512, 48, 1)]
# the STFT of a chunk batch: 2 x 16 rows, 7.8 s padded for 340 frames
EVAL_STFT = (2 * EVAL_B, 351232, 340)

# bf16 outputs: one step is 2^-8 of the value.
LAYER_TOL = {"max_rel": 4 * 2.0 ** -8, "rms_rel": 2.0 ** -8, "reason": (
    "4 bf16 steps of max|ref|, 1 of rms(ref): the kernel rounds q, the "
    "probabilities, the attention output, the LayerNorm and the GELU to bf16 "
    "as the plain version does, but sums in another order and rounds the "
    "probabilities before normalising them")}
HENC_TOL = {"max_rel": 2 * 2.0 ** -8, "rms_rel": 2.0 ** -9, "reason": (
    "2 bf16 steps of max|ref|, 1/2 of rms(ref): both round the operands of "
    "their products to bf16 and work in f32 otherwise; the f32 summation "
    "order differs, which can flip the bf16 rounding of an operand near a "
    "boundary (a hidden value, y before the rewrite, or block 1's input: "
    "~0.4 output steps at most, tests/test_torch_fused_dconv.py), and so "
    "can the final bf16 rounding")}
STFT_TOL = {"max_rel": 1e-4, "rms_rel": 1e-5, "reason": (
    "1e-4 of max|ref|, 1e-5 of rms(ref): both are f32 FFTs (radix-16/8 "
    "Stockham here, cuFFT in the plain version), whose rounding grows as "
    "eps x log2 N; 27x below the 2.7e-3 that made the JAX kernel refuse bf16 "
    "passes")}

GN_TOL = {torch.bfloat16: {"max_rel": 2.0 ** -7, "rms_rel": 2.0 ** -9},
          torch.float32: {"max_rel": 1e-5, "rms_rel": 1e-5},
          "reason": (
    "bf16: 1 output step of max|ref|, 1/2 of rms(ref): both round one f32 "
    "value once, whose statistics differ in their summation order; f32: "
    "1e-5 of max|ref| and rms(ref), that order alone")}
# the main path's GroupNorm shapes: the freq decoder's widest norm (GELU),
# the time DConv's widest GLU, a transformer norm_out's token stream, the
# freq DConv's narrowest hidden norm over folded rows (GELU)
GN_FORMS = [((16, 96, 1036, 259), "gelu", "channels"),
            ((4, 96, 66150), "glu", "channels"),
            ((4, 2072, 512), "none", "tokens"),
            ((2048, 6, 259), "gelu", "channels")]
# SCNet-large's (models.scnet, published widths) in a group of 4 chunks of
# 11 s (476 frames): the convolution modules' first norm (none) and second
# (SiLU, C/4 wide) over the widest band's rows of SD blocks 0 and 2 (4 x 462
# rows of 64 channels, 4 x 55 of 256), and the dual-path layers' token norms
# at 256 and 512 wide (85 band rows x 476 frames, x 239 after the rfft);
# each is timed, and every GroupNorm form of one eager SCNet group is held
# to its plain version (check_scnet_group_norm)
SCNET_CHUNK, SCNET_GROUP = 485100, 4
SCNET_GN_FORMS = [((4 * 462, 64, 476), "none", "channels"),
                  ((4 * 462, 16, 476), "silu", "channels"),
                  ((4 * 55, 256, 476), "none", "channels"),
                  ((4 * 55, 64, 476), "silu", "channels"),
                  ((4, 85 * 476, 256), "none", "tokens"),
                  ((4, 85 * 239, 512), "none", "tokens")]



def join_layers(b: int, b0: int) -> list:
    """The ATHT head's 8 decoder joins of ``b`` rows over skips at batch
    ``b0``: (layer, y shape, skip shape, size, norm?).  Freq layer 0
    upsamples F from 32 rows; 1-3 decimate it by exactly 4 (taps 4i+1 and
    4i+2); 3 has no norm.  The time layers resize the contiguous axis;
    time layer 3 has no norm and leaves y's length as it is."""
    return [
        ("freq0", (b, 192, 32, 259), (b0, 384, 8, 259), 259, True),
        ("freq1", (b, 96, 1036, 259), (b0, 192, 32, 259), 259, True),
        ("freq2", (b, 48, 1036, 259), (b0, 96, 128, 259), 259, True),
        ("freq3", (b, 4, 1036, 259), (b0, 48, 512, 259), 259, False),
        ("time0", (b, 192, 4136), (b0, 384, 1034), 4135, True),
        ("time1", (b, 96, 16540), (b0, 192, 4135), 16538, True),
        ("time2", (b, 48, 66152), (b0, 96, 16538), 66150, True),
        ("time3", (b, 4, 264600), (b0, 48, 66150), 264600, False),
    ]


# the decoder join against its plain version: every layer of a songs group
# (16 head rows over skips at the encoder's batch of 4), and a stream
# block's freq layer 1 (8 chunks of one stem: the skip's batch is y's);
# the songs group's two largest, freq layers 0 and 1, are timed
JOIN_FORMS = ([(f"songs {c[0]}",) + c[1:] for c in join_layers(16, 4)]
              + [(f"stream {c[0]}",) + c[1:] for c in join_layers(8, 8)
                 if c[0] == "freq1"])
JOIN_TIMED = ("songs freq0", "songs freq1")
JOIN_TOL = {"max_rel": 2.0 ** -7, "rms_rel": 2.0 ** -9, "reason": (
    "1 output step of max|ref|, 1/2 of rms(ref), against the plain version "
    "on f32 copies of the operands: the kernel rounds that f32 algebra "
    "once")}

# BS-RoFormer (models.bs_roformer, published widths) on the serving path of
# bs_roformer.songs-vocals: 8 s chunks at hop 2 s in groups of four; each
# axis of a group as (form, B, L): 4 x 62 band sequences of 801 frames, and
# 4 x 801 frame sequences of 62 bands; each kernel launches once an axis a
# layer (12 layers)
ROFORMER_SEGMENT, ROFORMER_OVERLAP, ROFORMER_GROUP = 8.0, 6.0, 4
ROFORMER_FORMS = [("time", 4 * 62, 801, 12), ("band", 4 * 801, 62, 12)]
ROPE_TOL = {"max_rel": 2.0 ** -7, "rms_rel": 2.0 ** -9, "reason": (
    "1 bf16 step of max|ref|, 1/2 of rms(ref): both turn each pair by the "
    "same f32 angle and round once; the kernel's product may contract to a "
    "fused multiply-add")}


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict
            ) -> dict:
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise SmokeFailure(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    max_abs = float(err.max())
    rms = float(err.pow(2).mean().sqrt())
    scale_max = float(w.abs().max())
    scale_rms = float(w.pow(2).mean().sqrt())
    ok = (max_abs <= tol["max_rel"] * scale_max
          and rms <= tol["rms_rel"] * scale_rms)
    print(f"  {name}: max_abs_err {max_abs:.4g} (tol {tol['max_rel']:.4g} x "
          f"max|ref| {scale_max:.4g}), rms_err {rms:.4g} (tol "
          f"{tol['rms_rel']:.4g} x rms(ref) {scale_rms:.4g}) -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: kernel disagrees with its plain version")
    return {"max_abs_err": max_abs, "rms_err": rms}


def bound(flops: float, nbytes: float, flop_rate: float) -> dict:
    """``port_bench.common.bound`` in ms, the unit of this smoke's rows."""
    row = _bound_s(flops, nbytes, flop_rate)
    return {"bound_ms": row.pop("bound_s") * 1e3, **row}


def _print_times(row: dict) -> None:
    print(f"    ms {row['ms']:.4f}  plain_ms {row['plain_ms']:.4f}  "
          f"library_ms {row['library_ms']:.4f}  bound_ms "
          f"{row['bound_ms']:.4f} ({row['bound_by']})")


def demangle(names: list) -> list:
    """Kernel symbols as ``cu++filt -p`` (beside ``nvcc``) prints them, for
    labels; the symbols themselves where it is missing or fails."""
    from audio_to_sheet_music_tpu_torch.ops import build

    tool = Path(build.nvcc_path()).with_name("cu++filt")
    if not names or not tool.exists():
        return list(names)
    out = subprocess.run([str(tool), "-p"], input="\n".join(names),
                         capture_output=True, text=True, timeout=60)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or len(lines) != len(names):
        return list(names)
    return lines


def ptxas_entries(log: str) -> list:
    """Each kernel entry of a ``ptxas -v`` log: its name, registers and
    spilled bytes."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None,
                   "spill_stores": None, "spill_loads": None}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    for e, label in zip(out, demangle([e["kernel"] for e in out])):
        e["kernel"] = label
    return out


def sass_counts(name: str, pick: str, instr: str) -> dict:
    """How many ``instr`` instructions each kernel whose symbol contains
    ``pick`` has in the SASS of the built library ``name`` (``cuobjdump
    -sass``), by demangled name.  Fails if ``cuobjdump`` is missing or
    fails, or the library has no such kernel."""
    from audio_to_sheet_music_tpu_torch.ops import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        raise SmokeFailure(f"{name}: no cuobjdump beside nvcc ({tool}): "
                           f"{instr} cannot be checked")
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise SmokeFailure(f"{name}: cuobjdump -sass exited "
                           f"{out.returncode}: {out.stderr.strip()[:500]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if pick in m.group(1) else None
            if cur is not None:
                counts[cur] = 0
        elif cur is not None and re.search(rf"\b{instr}\b", line):
            counts[cur] += 1
    if not counts:
        raise SmokeFailure(f"{name}: cuobjdump -sass shows no {pick} kernel")
    return dict(zip(demangle(list(counts)), counts.values()))


# the DConv routine's three launches (csrc/dconv_row.cuh), each a product
# on mma.sync tiles
DCONV_LAUNCHES = ("conv1_kernel", "conv2_stats_kernel", "apply_kernel")


# henc_freq_fused's own stages, each a product on mma.sync tiles
HENC_LAUNCHES = ("henc_conv_kernel", "henc_rewrite_kernel")

# the launches a DConv form's device time is split into under --profile:
# the routine's, then henc_freq_fused's own conv and rewrite
SPLIT_LAUNCHES = DCONV_LAUNCHES + HENC_LAUNCHES

# layer_tail's six launches in order (csrc/layer_tail.cu), by the profiler's
# kernel name: each GEMM is its own epilogue's instance of gemm_kernel
TAIL_LAUNCHES = [("q_gemm", "gemm_kernel<0>"), ("flash", "flash_kernel"),
                 ("out_proj_gemm", "gemm_kernel<2>"),
                 ("layernorm", "ln_kernel"), ("ff1_gemm", "gemm_kernel<1>"),
                 ("ff2_gemm", "gemm_kernel<3>")]


def check_build(sources: list) -> dict:
    """Registers and spills of every kernel; wgmma in the flash launch of
    both libraries that run it, and mma.sync in each launch of the DConv
    routine in both libraries that run it."""
    from audio_to_sheet_music_tpu_torch.ops import build

    ptxas = {}
    for name in sources:
        ptxas[name] = ptxas_entries(build.build_log(name))
        for e in ptxas[name]:
            print(f"  {name}: {e['kernel']}: {e['registers']} registers, "
                  f"{e['spill_stores']}/{e['spill_loads']} bytes spill "
                  "stores/loads")
    hgmma = {}
    for name in ("attn_block", "layer_tail"):
        hgmma[name] = {}
        for launch, what in (("flash_kernel", "flash launch"),
                             ("gemm_kernel", "GEMM launch")):
            counts = sass_counts(name, launch, "HGMMA")
            print(f"  {name}: HGMMA (wgmma) instructions in the {what}: "
                  f"{counts}")
            if min(counts.values()) == 0:
                raise SmokeFailure(f"{name}: a {what} issues no wgmma")
            hgmma[name].update(counts)
    hmma = {}
    for name, pick, launches in (
            ("dconv_rows", "dconv", DCONV_LAUNCHES),
            ("henc_freq", "dconv", DCONV_LAUNCHES),
            ("henc_freq", "henc_", HENC_LAUNCHES)):
        counts = sass_counts(name, pick, "HMMA")
        print(f"  {name}: HMMA (mma.sync) instructions in "
              f"{'the DConv routine' if pick == 'dconv' else 'its own stages'}"
              f": {counts}")
        for launch in launches:
            found = [c for n, c in counts.items() if launch in n]
            if not found or min(found) == 0:
                raise SmokeFailure(f"{name}: a {launch} issues no mma.sync "
                                   "(or there is none)")
        hmma.setdefault(name, {}).update(counts)
    return {"ptxas": ptxas, "hgmma": hgmma, "hmma": hmma}


def device_ms_by_kernel(calls: list, reps: int = 3, tries: int = 3) -> list:
    """For each function of ``calls``, the device milliseconds a call spends
    in each kernel it launches, from one ``torch.profiler`` session over
    ``reps`` calls of each in turn: the session's kernels, in launch order,
    are cut into one run per function (each call must launch the same
    number of kernels).  A session that recorded no kernel, or a count that
    does not divide, is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a session can miss its first kernel's record: give it one to
            # miss that is not counted
            torch.cuda._sleep(1000)
            for fn in calls:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and "spin_kernel" not in e.name),
                      key=lambda e: e.time_range.start)
        if not kern or len(kern) % (len(calls) * reps):
            continue
        n = len(kern) // len(calls)
        out = []
        for i in range(len(calls)):
            ms: dict = {}
            for e in kern[i * n:(i + 1) * n]:
                ms[e.name] = ms.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / reps
            out.append(ms)
        return out
    names = sorted({e.name for e in kern})
    raise SmokeFailure(f"the profiler saw no device time, or an uneven count "
                       f"of kernels: {len(kern)} over {len(calls)} x {reps} "
                       f"calls in the last of {tries} sessions ({names})")


def launch_split(calls: list, labels: list, forms: list) -> None:
    """Each call's device ms by launch of ``SPLIT_LAUNCHES`` (anything else,
    such as the weights' casts, as "other"), printed and stored in its
    form's ``launch_ms``.  One profiler session a call: the weights' casts
    launch more kernels at some widths than at others."""
    for label, row, call in zip(labels, forms, calls):
        by = device_ms_by_kernel([call])[0]
        split: dict = {}
        for kernel, ms in by.items():
            key = next((n for n in SPLIT_LAUNCHES if n in kernel), "other")
            split[key] = split.get(key, 0.0) + ms
        row["launch_ms"] = split
        print(f"  {label}: device ms by launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))


# ---------------------------------------------------------------------------
# Phase 2: the kernels against their plain versions
# ---------------------------------------------------------------------------

def _layer_inputs(b: int, l: int, s: int, gen: torch.Generator) -> list:
    """Activations at unit scale, weights at their init scale, LayerScales
    at 0.5 so both residual branches show in the output."""
    def n(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale
    bf = lambda t: t.to("cuda", torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda t: t.to("cuda", torch.float32).contiguous()  # noqa: E731
    return [bf(n(b, l, D)), bf(n(b, s, D)), bf(n(b, s, D)), bf(n(b, l, D)),
            bf(n(D, D, scale=D ** -0.5)), f32(n(D, scale=0.1)),
            bf(n(D, D, scale=D ** -0.5)), f32(n(D, scale=0.1)),
            f32(0.5 + 0.1 * n(D)), f32(1.0 + 0.1 * n(D)), f32(n(D, scale=0.1)),
            bf(n(FF, D, scale=D ** -0.5)), f32(n(FF, scale=0.1)),
            bf(n(D, FF, scale=FF ** -0.5)), f32(n(D, scale=0.1)),
            f32(0.5 + 0.1 * n(D))]


def _layer_library(h, k, v, x, wq, bq, wo, bo, g1, lnw, lnb, w1, b1, w2, b2,
                   g2):
    """The layer tail as PyTorch library calls in bf16 (cuBLAS products,
    ``scaled_dot_product_attention``): the yardstick, used nowhere else."""
    bsz, l, _ = h.shape
    dt = h.dtype
    heads = lambda t: t.view(bsz, -1, HEADS, D // HEADS).transpose(1, 2)  # noqa: E731
    q = F.linear(h, wq, bq.to(dt))
    a = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
    a = a.transpose(1, 2).reshape(bsz, l, D)
    y1 = x + g1.to(dt) * F.linear(a, wo, bo.to(dt))
    ln = F.layer_norm(y1, (D,), lnw.to(dt), lnb.to(dt), 1e-5)
    f = F.linear(F.gelu(F.linear(ln, w1, b1.to(dt))), w2, b2.to(dt))
    return y1 + g2.to(dt) * f


def _tail_launch_work(b: int, l: int, s: int) -> dict:
    """Operations and bytes (each input read once, each output written
    once) of each of layer_tail's six launches."""
    m = b * l
    return {"q_gemm": (2.0 * m * D * D, 2.0 * (2 * m * D + D * D)),
            "flash": (4.0 * b * l * s * D, 2.0 * (2 * m * D + 2 * b * s * D)),
            "out_proj_gemm": (2.0 * m * D * D,
                              2.0 * (2 * m * D + D * D) + 4.0 * m * D),
            "layernorm": (8.0 * m * D, 4.0 * m * D + 2.0 * m * D),
            "ff1_gemm": (2.0 * m * D * FF, 2.0 * (m * D + D * FF + m * FF)),
            "ff2_gemm": (2.0 * m * D * FF,
                         2.0 * (m * FF + D * FF + m * D) + 4.0 * m * D)}


def tail_split(forms: list, inputs: list) -> None:
    """Each layer_tail form's device ms by launch (``TAIL_LAUNCHES``), with
    each launch's rate and bound, printed and stored in the form's
    ``launch_ms``; one profiler session over all forms (every call launches
    the same six kernels)."""
    from audio_to_sheet_music_tpu_torch.ops import fused_attn

    with torch.inference_mode():
        per_form = device_ms_by_kernel(
            [lambda a=a: fused_attn.layer_tail(*a, HEADS) for a in inputs])
    for row, by in zip(forms, per_form):
        split: dict = {}
        for kernel, ms in by.items():
            key = next((n for n, frag in TAIL_LAUNCHES if frag in kernel),
                       "other")
            split[key] = split.get(key, 0.0) + ms
        work = _tail_launch_work(row["B"], row["L"], row["S"])
        row["launch_ms"] = split
        row["launch_bound_ms"] = {k: bound(*work[k], BF16_TENSOR_FLOPS)[
            "bound_ms"] for k in work}
        print(f"  {row['form']}: device ms by launch: " + ", ".join(
            f"{k} {v:.4f}" + (f" ({work[k][0] / v / 1e9:.0f} TFLOP/s, bound "
                              f"{row['launch_bound_ms'][k]:.4f})"
                              if k in work and k != "layernorm" else "")
            for k, v in split.items()))


def _layer_tail_rows(gen: torch.Generator, b: int, forms: list,
                     weight: str) -> tuple:
    """``layer_tail`` against its plain version and its library call in
    each form ``(name, L, S, launches)`` at batch ``b``: the rows, and the
    inputs for the launch split."""
    from audio_to_sheet_music_tpu_torch.ops import fused_attn

    rows, inputs = [], []
    for name, l, s, n in forms:
        args = _layer_inputs(b, l, s, gen)
        with torch.inference_mode():
            got = fused_attn.layer_tail(*args, HEADS)
            torch.cuda.synchronize()
            want = fused_attn.layer_tail_plain(*args, HEADS)
            err = compare(f"{name} B={b} L={l} S={s}", got, want, LAYER_TOL)
            iters = 10 if l * s > 1e6 else 20
            row = {"form": name, "B": b, "L": l, "S": s, weight: n, **err,
                   "ms": cuda_ms(lambda: fused_attn.layer_tail(*args, HEADS),
                                 iters),
                   "plain_ms": cuda_ms(
                       lambda: fused_attn.layer_tail_plain(*args, HEADS),
                       iters),
                   "library_ms": cuda_ms(lambda: _layer_library(*args), iters),
                   **bound(*layer_work(b, l, s, D, FF), BF16_TENSOR_FLOPS)}
        _print_times(row)
        rows.append(row)
        inputs.append(args)
    return rows, inputs


def check_layer_tail(gen: torch.Generator, profile: bool, b: int = 4) -> dict:
    print(f"layer_tail (B={b}, D=512, FF=2048, 8 heads, bf16):")
    print(f"  tolerance: {LAYER_TOL['reason']}")
    forms, inputs = _layer_tail_rows(gen, b, LAYER_FORMS + [RAGGED],
                                     "launches_per_group")
    if profile:
        tail_split(forms, inputs)
    return _kernel_entry(
        "layer_tail", "audio_to_sheet_music_tpu_torch/csrc/layer_tail.cu",
        "audio_to_sheet_music_tpu/ops/pallas_attn.py:269", forms,
        "launches_per_group", BF16_TENSOR_FLOPS,
        "mean per launch over one group program's 10 launches")


def library_split(forms: list, inputs: list) -> None:
    """Each form's library composition (``_layer_library``) by device ms
    of its attention kernels, its matrix products and the rest, printed
    and stored in the form's ``library_launch_ms``; one profiler session a
    form."""
    for row, args in zip(forms, inputs):
        with torch.inference_mode():
            by = device_ms_by_kernel([lambda: _layer_library(*args)])[0]
        split: dict = {}
        for kernel, ms in by.items():
            low = kernel.lower()
            key = ("attention" if any(k in low for k in ("flash", "fmha",
                                                         "attention"))
                   else "matrix products" if any(k in low for k in (
                       "gemm", "xmma", "cutlass", "nvjet"))
                   else "other")
            split[key] = split.get(key, 0.0) + ms
        row["library_launch_ms"] = split
        print(f"  {row['form']}: the library's device ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()))


def eval_layer_tail(gen: torch.Generator, profile: bool) -> dict:
    print("layer_tail, the eval path's forms (a baseline forward of "
          f"{EVAL_B} chunks of {EVAL_SECONDS} s):")
    rows, inputs = _layer_tail_rows(gen, EVAL_B, EVAL_LAYER_FORMS,
                                    "launches_per_forward")
    if profile:
        tail_split(rows, inputs)
        library_split(rows, inputs)
    return _eval_entry(rows, BF16_TENSOR_FLOPS)


def _henc_form(layer, b: int, t: int, weight: str, n: int,
               gen: torch.Generator) -> tuple:
    from audio_to_sheet_music_tpu_torch.models import htdemucs
    from audio_to_sheet_music_tpu_torch.ops import fused_enc

    cin, f, c = 4, 2048, 48
    x = torch.randn((b, cin, f, t), generator=gen).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        got = fused_enc.henc_freq_fused(layer, x)
        torch.cuda.synchronize()
        want = fused_enc.henc_freq_plain(layer, x)
        err = compare(f"B={b} F={f} T={t}", got, want, HENC_TOL)
        # the per-op layer in bf16 (cuDNN convolutions): the yardstick
        library = lambda: htdemucs.henc_layer_apply(layer, x, kernels=False)  # noqa: E731
        row = {"B": b, "T": t, weight: n, **err,
               "ms": cuda_ms(lambda: fused_enc.henc_freq_fused(layer, x), 20),
               "plain_ms": cuda_ms(lambda: fused_enc.henc_freq_plain(layer, x),
                                   20),
               "library_ms": cuda_ms(library, 20)}
    row.update(bound(*henc_work(b, t, cin, f, c), BF16_TENSOR_FLOPS))
    _print_times(row)
    return row, x


def _henc_layer():
    from audio_to_sheet_music_tpu_torch.models import htdemucs
    from audio_to_sheet_music_tpu_torch.nn import prng

    layer = htdemucs.HEncLayer(4, 48, freq=True,
                               key=prng.PRNGKey(SEED, "cuda"))
    for blk in layer.dconv.layers:      # raise the 1e-3 LayerScale init
        blk.scale.scale.data.fill_(0.5)
    return layer.to("cuda").requires_grad_(False)


def check_henc(gen: torch.Generator, profile: bool) -> dict:
    from audio_to_sheet_music_tpu_torch.ops import fused_enc

    print("henc_freq_fused (B, 4, 2048, T) -> C=48, bf16:")
    print(f"  tolerance: {HENC_TOL['reason']}")
    layer = _henc_layer()
    group = "launches_per_group"
    forms, inputs = zip(_henc_form(layer, 4, 259, group, 1, gen),  # a group
                        _henc_form(layer, 1, 1292, group, 0, gen))  # 30 s
    forms = list(forms)
    if profile:
        with torch.inference_mode():
            launch_split([lambda x=x: fused_enc.henc_freq_fused(layer, x)
                          for x in inputs],
                         [f"B={f['B']} T={f['T']}" for f in forms], forms)
    return _kernel_entry(
        "henc_freq_fused", "audio_to_sheet_music_tpu_torch/csrc/henc_freq.cu",
        "audio_to_sheet_music_tpu/ops/pallas_enc.py:173", forms,
        "launches_per_group", BF16_TENSOR_FLOPS,
        "one launch (one group of 4 chunks)")


def eval_henc(gen: torch.Generator) -> dict:
    print("henc_freq_fused, the eval path's form:")
    row, _ = _henc_form(_henc_layer(), EVAL_B, EVAL_T,
                        "launches_per_forward", 1, gen)
    return _eval_entry([row], BF16_TENSOR_FLOPS)


def _weighted(forms: list, key: str, weight: str) -> float:
    n = sum(f[weight] for f in forms)
    return sum(f[key] * f[weight] for f in forms if f[weight]) / n


def _kernel_entry(name: str, source: str, replaces: str, forms: list,
                  weight: str, flop_rate: float, per: str) -> dict:
    """One entry of the kernels line: times and bound as means per launch
    over the path's mix of forms (a form of weight 0, such as the ragged
    one, counts only in ``max_abs_err``)."""
    t_ops = _weighted(forms, "flops", weight) / flop_rate * 1e3
    t_bytes = _weighted(forms, "bytes", weight) / MEMORY_BYTES_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(f["max_abs_err"] for f in forms),
            "ms": _weighted(forms, "ms", weight),
            "plain_ms": _weighted(forms, "plain_ms", weight),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": _weighted(forms, "library_ms", weight),
            "per": per, "forms": forms}


def _path_entry(prefix: str, forms: list, weight: str,
                flop_rate: float) -> dict:
    """A kernel's numbers at another path's forms, as ``<prefix>_*``:
    means per launch over that path's launches (``weight``)."""
    entry = _kernel_entry("", "", "", forms, weight, flop_rate, "")
    return {f"{prefix}_forms": forms, **{
        f"{prefix}_{k}": entry[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}}


def _eval_entry(forms: list, flop_rate: float) -> dict:
    """A kernel's numbers at the eval path's forms (phase 5), as
    ``eval_*``: means per launch over one baseline forward's launches."""
    return _path_entry("eval", forms, "launches_per_forward", flop_rate)


def _dconv_rows(gen: torch.Generator, forms: list, t: int, weight: str
                ) -> tuple:
    """``dconv_rows`` against its plain version and the per-op DConv in
    each form ``(rows, C, launches)`` at ``t`` frames."""
    from audio_to_sheet_music_tpu_torch.models import htdemucs
    from audio_to_sheet_music_tpu_torch.nn import prng
    from audio_to_sheet_music_tpu_torch.ops import fused_dconv

    rows_out, inputs = [], []
    for rows, c, n in forms:
        d = htdemucs.DConv(c, prng.PRNGKey(SEED + c, "cuda"))
        for blk in d.layers:            # raise the 1e-3 LayerScale init
            blk.scale.scale.data.fill_(0.5)
            blk.norm1.bias.data.normal_(generator=gen)
            blk.norm2.bias.data.normal_(generator=gen)
        d = d.to("cuda").requires_grad_(False)
        x = torch.randn((rows, c, t), generator=gen).to("cuda", torch.bfloat16)
        with torch.inference_mode():
            got = fused_dconv.dconv_rows(d, x)
            torch.cuda.synchronize()
            want = fused_dconv.dconv_rows_plain(d, x)
            err = compare(f"rows={rows} C={c} T={t}", got, want, HENC_TOL)
            # the per-op DConv in bf16 (cuDNN convolutions, GroupNorm)
            row = {"rows": rows, "C": c, "T": t, weight: n, **err,
                   "ms": cuda_ms(lambda: fused_dconv.dconv_rows(d, x), 20),
                   "plain_ms": cuda_ms(
                       lambda: fused_dconv.dconv_rows_plain(d, x), 20),
                   "library_ms": cuda_ms(
                       lambda: htdemucs.dconv_apply(d, x), 20)}
        h = c // 8
        flops = 2.0 * rows * t * 2 * (3 * c * h + 2 * c * h)
        nbytes = 2.0 * 2 * rows * c * t
        row.update(bound(flops, nbytes, BF16_TENSOR_FLOPS))
        _print_times(row)
        rows_out.append(row)
        inputs.append((d, x))
    return rows_out, inputs


def check_dconv(gen: torch.Generator, profile: bool) -> dict:
    from audio_to_sheet_music_tpu_torch.ops import fused_dconv

    print(f"dconv_rows (rows, C, T={TRAIN_T}) at freq layers 1-3 of a "
          f"batch of {TRAIN_B}, bf16:")
    print(f"  tolerance: {HENC_TOL['reason']}")
    forms, inputs = _dconv_rows(gen, [(r, c, 1) for r, c in DCONV_FORMS],
                                TRAIN_T, "launches_per_step")
    if profile:
        with torch.inference_mode():
            launch_split([lambda d=d, x=x: fused_dconv.dconv_rows(d, x)
                          for d, x in inputs],
                         [f"rows={f['rows']} C={f['C']}" for f in forms],
                         forms)
    return _kernel_entry(
        "dconv_rows", "audio_to_sheet_music_tpu_torch/csrc/dconv_rows.cu",
        "audio_to_sheet_music_tpu/ops/pallas_dconv.py:199", forms,
        "launches_per_step", BF16_TENSOR_FLOPS,
        "mean per launch over one train step's 3 launches")


def eval_dconv(gen: torch.Generator) -> dict:
    print(f"dconv_rows, the eval path's forms (T={EVAL_T}; freq encoder "
          "layers 1-3 and freq decoders 0-3 of an opt-in baseline forward):")
    rows, _ = _dconv_rows(gen, EVAL_DCONV_FORMS, EVAL_T,
                          "launches_per_forward")
    return _eval_entry(rows, BF16_TENSOR_FLOPS)


def _block_library(q, k, v, x, wo, bo, g):
    """The attention block as PyTorch library calls in bf16
    (``scaled_dot_product_attention``, cuBLAS): the yardstick only."""
    bsz, l, _ = q.shape
    dt = q.dtype
    heads = lambda t: t.view(bsz, -1, HEADS, D // HEADS).transpose(1, 2)  # noqa: E731
    a = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
    a = a.transpose(1, 2).reshape(bsz, l, D)
    return x + g.to(dt) * F.linear(a, wo, bo.to(dt))


def _attn_block_rows(gen: torch.Generator, b: int, forms: list,
                     weight: str) -> tuple:
    """``attn_block`` against its plain version and its library calls in
    each form ``(name, L, S, launches)`` at batch ``b``."""
    from audio_to_sheet_music_tpu_torch.ops import fused_attn

    rows, inputs = [], []
    for name, l, s, n in forms:
        full = _layer_inputs(b, l, s, gen)
        args = [full[0], full[1], full[2], full[3], full[6], full[7], full[8]]
        del full
        with torch.inference_mode():
            got = fused_attn.attn_block(*args, HEADS)
            torch.cuda.synchronize()
            want = fused_attn.attn_block_plain(*args, HEADS)
            err = compare(f"{name} B={b} L={l} S={s}", got, want, LAYER_TOL)
            iters = 5 if l * s > 1e6 else 10
            row = {"form": name, "B": b, "L": l, "S": s, weight: n, **err,
                   "ms": cuda_ms(lambda: fused_attn.attn_block(*args, HEADS),
                                 iters),
                   "plain_ms": cuda_ms(
                       lambda: fused_attn.attn_block_plain(*args, HEADS),
                       iters),
                   "library_ms": cuda_ms(lambda: _block_library(*args), iters)}
        flops = 2.0 * b * l * (2 * s * D + D * D)
        nbytes = float(2 * (2 * b * l * D + 2 * b * s * D) + 2 * D * D
                       + 4 * 2 * D + 2 * b * l * D)
        row.update(bound(flops, nbytes, BF16_TENSOR_FLOPS))
        _print_times(row)
        rows.append(row)
        inputs.append(args)
    return rows, inputs


def check_attn_block(gen: torch.Generator, profile: bool) -> dict:
    from audio_to_sheet_music_tpu_torch.ops import fused_attn

    print(f"attn_block (B={TRAIN_B}, D=512, 8 heads, bf16):")
    print(f"  tolerance: {LAYER_TOL['reason']}")
    forms, inputs = _attn_block_rows(gen, TRAIN_B, LAYER_FORMS + [RAGGED],
                                     "launches_per_step")
    if profile:
        with torch.inference_mode():
            per_form = device_ms_by_kernel(
                [lambda a=a: fused_attn.attn_block(*a, HEADS) for a in inputs])
        for row, by in zip(forms, per_form):
            row["flash_ms"] = sum(v for n, v in by.items() if "flash" in n)
            row["gemm_ms"] = sum(v for n, v in by.items() if "gemm" in n)
            print(f"  {row['form']}: device time: flash launch "
                  f"{row['flash_ms']:.4f} ms, out-projection GEMM "
                  f"{row['gemm_ms']:.4f} ms")
        split = {k: _weighted(forms, k, "launches_per_step")
                 for k in ("flash_ms", "gemm_ms")}
        print(f"  a train step's mean launch: flash {split['flash_ms']:.4f} "
              f"ms, GEMM {split['gemm_ms']:.4f} ms ("
              f"{split['flash_ms'] / sum(split.values()):.1%} flash)")
    return _kernel_entry(
        "attn_block", "audio_to_sheet_music_tpu_torch/csrc/attn_block.cu",
        "audio_to_sheet_music_tpu/ops/pallas_attn.py:113", forms,
        "launches_per_step", BF16_TENSOR_FLOPS,
        "mean per launch over one train step's 10 launches")


def eval_attn_block(gen: torch.Generator) -> dict:
    print("attn_block, the eval path's forms (an opt-in baseline forward of "
          f"{EVAL_B} chunks):")
    rows, _ = _attn_block_rows(gen, EVAL_B, EVAL_LAYER_FORMS,
                               "launches_per_forward")
    return _eval_entry(rows, BF16_TENSOR_FLOPS)


def _stft_row(gen: torch.Generator, n_rows: int, t: int, frames: int,
              weight: str) -> dict:
    from audio_to_sheet_music_tpu_torch.ops import fused_stft

    x = torch.randn((n_rows, t), generator=gen).cuda()
    win = fused_stft.hann(NFFT, "cuda")
    # the per-op path's call (cuFFT), unnormalised: the yardstick
    library = lambda: torch.stft(x, NFFT, HOP, window=win, win_length=NFFT,  # noqa: E731
                                 center=False, normalized=False,
                                 return_complex=True)
    with torch.inference_mode():
        got = fused_stft.stft(x, NFFT, HOP, frames)
        torch.cuda.synchronize()
        want = fused_stft.stft_plain(x, NFFT, HOP, frames)
        err = compare(f"rows={n_rows} T={t}", torch.view_as_real(got),
                      torch.view_as_real(want), STFT_TOL)
        row = {"rows": n_rows, "T": t, "frames": frames, **err, weight: 1,
               "ms": cuda_ms(lambda: fused_stft.stft(x, NFFT, HOP, frames),
                             20),
               "plain_ms": cuda_ms(lambda: fused_stft.stft_plain(
                   x, NFFT, HOP, frames), 20),
               "library_ms": cuda_ms(library, 20)}
    flops = 2.5 * NFFT * math.log2(NFFT) * n_rows * frames
    nbytes = 4.0 * n_rows * t + 8.0 * n_rows * (NFFT // 2 + 1) * frames
    row.update(bound(flops, nbytes, F32_FLOPS))
    _print_times(row)
    return row


def check_stft(gen: torch.Generator) -> dict:
    print(f"stft ({STFT_ROWS}, {STFT_T}) f32, n_fft {NFFT}, hop {HOP}, "
          f"{STFT_FRAMES} frames:")
    print(f"  tolerance: {STFT_TOL['reason']}")
    row = _stft_row(gen, STFT_ROWS, STFT_T, STFT_FRAMES, "launches_per_step")
    return _kernel_entry(
        "stft", "audio_to_sheet_music_tpu_torch/csrc/stft.cu",
        "audio_to_sheet_music_tpu/ops/pallas_stft.py:105", [row],
        "launches_per_step", F32_FLOPS, "one launch (one train step)")


def _group_norm_row(gen: torch.Generator, shape: tuple, act: str,
                    layout: str, dtype: torch.dtype,
                    launches_per_group: int = 1) -> dict:
    from audio_to_sheet_music_tpu_torch.ops import fused_norm

    c = shape[-1] if layout == "tokens" else shape[1]
    x = (0.7 + 2.0 * torch.randn(shape, generator=gen)).to("cuda", dtype)
    w = (1.0 + 0.2 * torch.randn(c, generator=gen)).cuda()
    b = (0.3 * torch.randn(c, generator=gen)).cuda()
    tokens = layout == "tokens"

    # the path before the kernel: F.group_norm on f32 (through transposes
    # for the token form), rounded back, then the activation
    def library():
        xc = x.transpose(1, 2) if tokens else x
        y = F.group_norm(xc.float(), 1, w, b, fused_norm.EPS).to(dtype)
        y = y.transpose(1, 2) if tokens else y
        return (F.gelu(y) if act == "gelu" else F.glu(y, dim=1)
                if act == "glu" else F.silu(y) if act == "silu" else y)

    kernel = lambda: fused_norm.group_norm(x, w, b, 1, act=act,  # noqa: E731
                                           layout=layout)
    plain = lambda: fused_norm.group_norm_plain(  # noqa: E731
        x, w, b, 1, act=act, layout=layout)
    iters = 10 if x.numel() > 1e8 else 50
    with torch.inference_mode():
        got = kernel()
        torch.cuda.synchronize()
        err = compare(f"{shape} {act} {layout} {dtype}", got, plain(),
                      GN_TOL[dtype])
        # device time (the profiler's kernels): what a captured graph pays;
        # a host-timed call at these sizes times the wrapper's Python
        by_kernel = device_ms_by_kernel([kernel], 5)[0]
        by_library = device_ms_by_kernel([library], 5)[0]
        row = {"shape": list(shape), "act": act, "layout": layout,
               "dtype": str(dtype), **err,
               "launches_per_group": launches_per_group,
               "ms": sum(by_kernel.values()), "launch_ms": by_kernel,
               "eager_ms": cuda_ms(kernel, iters),
               "plain_ms": cuda_ms(plain, max(2, iters // 5)),
               "library_ms": sum(by_library.values()),
               "library_eager_ms": cuda_ms(library, iters)}
    # bytes: x read once, the output written once (the pair reads x twice:
    # pair_bound_ms)
    nbytes = x.numel() * x.element_size() + got.numel() * got.element_size()
    row.update(bound(0.0, nbytes, F32_FLOPS))
    row["pair_bound_ms"] = ((nbytes + x.numel() * x.element_size())
                            / MEMORY_BYTES_PER_S * 1e3)
    _print_times(row)
    print(f"    pair_bound_ms {row['pair_bound_ms']:.4f} (x read twice); "
          f"host-timed: kernel {row['eager_ms']:.4f}, library "
          f"{row['library_eager_ms']:.4f}; launches "
          + ", ".join(f"{k.split('(')[0]} {v:.4f}"
                      for k, v in by_kernel.items()))
    return row


def check_group_norm(gen: torch.Generator) -> dict:
    """The GroupNorm kernel pair at the main path's shapes, bf16 (the
    serving path's type) and f32, against its plain version; times in
    bf16."""
    print("group_norm at the main path's shapes:")
    print(f"  tolerance: {GN_TOL['reason']}")
    forms = []
    for shape, act, layout in GN_FORMS:
        for dtype in (torch.bfloat16, torch.float32):
            row = _group_norm_row(gen, shape, act, layout, dtype)
            if dtype == torch.bfloat16:
                forms.append(row)
            torch.cuda.empty_cache()
    entry = _kernel_entry(
        "group_norm", "audio_to_sheet_music_tpu_torch/csrc/group_norm.cu",
        "none: PyTorch's GroupNorm, one block a row", forms,
        "launches_per_group", F32_FLOPS, "one launch a form (bf16)")
    entry.update(check_scnet_group_norm(gen))
    return entry


def _scnet_group_norm_calls() -> Counter:
    """The GroupNorm calls of one eager SCNet-large forward over a group
    of ``SCNET_GROUP`` chunks, by (shape, act, layout), counted as the
    calls reach ``fused_norm.group_norm``; the launches the kernel counts
    meanwhile (on the module's ``group_norm``, the stand-in) must be as
    many, and are booked on the wrapper's counter after."""
    from audio_to_sheet_music_tpu_torch.models import scnet
    from audio_to_sheet_music_tpu_torch.ops import fused_norm

    model = scnet.init(scnet.PUBLISHED, seed=SEED, device="cuda")
    chunks = 0.1 * torch.randn((SCNET_GROUP, 2, SCNET_CHUNK),
                               generator=torch.Generator().manual_seed(SEED))
    calls, real = Counter(), fused_norm.group_norm

    def counted(x, weight, bias, num_groups, eps=fused_norm.EPS,
                act="none", layout="channels"):
        calls[(tuple(x.shape), act, layout)] += 1
        return real(x, weight, bias, num_groups, eps, act, layout)

    counted.launches = 0
    fused_norm.group_norm = counted
    try:
        with torch.inference_mode():
            scnet.forward(model, chunks.cuda(), torch.bfloat16)
        torch.cuda.synchronize()
    finally:
        fused_norm.group_norm = real
    real.launches += counted.launches
    if counted.launches != sum(calls.values()):
        raise SmokeFailure(f"SCNet: {sum(calls.values())} GroupNorm calls "
                           f"but {counted.launches} launches counted")
    del model
    torch.cuda.empty_cache()
    return calls


def check_scnet_group_norm(gen: torch.Generator) -> dict:
    """SCNet's GroupNorm forms: every form of one eager SCNet-large group
    held to the plain version in bf16 (the serving path's type), and the
    timed forms (``SCNET_GN_FORMS``, bf16 and f32) weighted by their
    launches in that group, as ``scnet_*``."""
    from audio_to_sheet_music_tpu_torch.ops import fused_norm

    print("group_norm at SCNet-large's shapes (a group of "
          f"{SCNET_GROUP} chunks):")
    calls = _scnet_group_norm_calls()
    missing = [f for f in SCNET_GN_FORMS if f not in calls]
    if missing:
        raise SmokeFailure(f"SCNet ran none of the forms {missing}; "
                           f"its forms: {sorted(calls)}")
    print(f"  {sum(calls.values())} launches in {len(calls)} forms "
          f"({sum(n for (_, a, _), n in calls.items() if a == 'silu')} "
          "with SiLU)")
    for (shape, act, layout), n in sorted(calls.items()):
        if (shape, act, layout) in SCNET_GN_FORMS:
            continue
        c = shape[-1] if layout == "tokens" else shape[1]
        x = (0.7 + 2.0 * torch.randn(shape, generator=gen)).to(
            "cuda", torch.bfloat16)
        w = (1.0 + 0.2 * torch.randn(c, generator=gen)).cuda()
        b = (0.3 * torch.randn(c, generator=gen)).cuda()
        with torch.inference_mode():
            compare(f"{shape} {act} {layout} x{n}",
                    fused_norm.group_norm(x, w, b, 1, act=act, layout=layout),
                    fused_norm.group_norm_plain(x, w, b, 1, act=act,
                                                layout=layout),
                    GN_TOL[torch.bfloat16])
    forms = []
    for shape, act, layout in SCNET_GN_FORMS:
        for dtype in (torch.bfloat16, torch.float32):
            row = _group_norm_row(gen, shape, act, layout, dtype,
                                  calls[(shape, act, layout)])
            if dtype == torch.bfloat16:
                forms.append(row)
            torch.cuda.empty_cache()
    return {**_path_entry("scnet", forms, "launches_per_group", F32_FLOPS),
            "scnet_launches_per_group": sum(calls.values()),
            "scnet_group_forms": len(calls)}


def _join_row(gen: torch.Generator, label: str, y_shape: tuple,
              skip_shape: tuple, size: int, norm: bool, timed: bool) -> dict:
    """The join at one shape against its plain version on f32 copies of
    the operands; where ``timed``, the device times and bounds of the
    call (``gn1_moments``, ``gn1_coefs``, ``gn1_join``) and of ``gn1_join``
    alone, of the plain version and of the chain the card ran before."""
    from audio_to_sheet_music_tpu_torch.ops import fused_norm

    c = y_shape[1]
    y = (0.7 + 2.0 * torch.randn(y_shape, generator=gen)).to(
        "cuda", torch.bfloat16)
    skip = torch.randn(skip_shape, generator=gen).to("cuda", torch.bfloat16)
    w = (1.0 + 0.2 * torch.randn(c, generator=gen)).cuda()
    b = (0.3 * torch.randn(c, generator=gen)).cuda()
    if not norm:
        w = b = None
    kernel = lambda: fused_norm.decoder_join(  # noqa: E731
        y, w, b, skip, size, 0.1)
    plain = lambda: fused_norm.decoder_join_plain(  # noqa: E731
        y, w, b, skip, size, 0.1)

    # the chain the card ran before: the GroupNorm pair with its GELU, then
    # PyTorch's gathers, f32 lerps, casts, the skip's scaling and the add
    def library():
        h = y if w is None else fused_norm.group_norm(y, w, b, 1, act="gelu")
        return fused_norm.decoder_join_plain(h, None, None, skip, size, 0.1)

    with torch.inference_mode():
        got = kernel()
        torch.cuda.synchronize()
        err = compare(f"{label} {tuple(y_shape)} -> {size} rows, skip "
                      f"{tuple(skip_shape)}{'' if norm else ', no norm'}",
                      got, fused_norm.decoder_join_plain(
                          y.float(), w, b, skip.float(), size, 0.1), JOIN_TOL)
        del got
        row = {"form": label, "y": list(y_shape), "skip": list(skip_shape),
               "size": size, "norm": norm, **err,
               "launches_per_group": int(timed)}
        if not timed:
            return row
        by_kernel = device_ms_by_kernel([kernel], 5)[0]
        by_library = device_ms_by_kernel([library], 5)[0]
        join = [k for k in by_kernel if "gn1_join" in k]
        if len(join) != 1:
            raise SmokeFailure(f"decoder_join launched {sorted(by_kernel)}")
        row.update({"ms": sum(by_kernel.values()),
                    "join_ms": by_kernel[join[0]], "launch_ms": by_kernel,
                    "plain_ms": cuda_ms(plain, 3),
                    "library_ms": sum(by_library.values()),
                    "library_launches": len(by_library)})

    # bytes of gn1_join: the rows the taps name read once, the skip's rows
    # its taps name (its first C channels) read once, the output written
    # once; of the call, besides, the statistics' read of all of y
    def named(n):  # the source rows the taps name, of n
        taps = fused_norm.lerp_taps(n, size, torch.device("cpu"))
        return len(torch.unique(torch.cat(taps[:2])))

    rows, srows = named(y_shape[2]), named(skip_shape[2])
    plane = math.prod(y_shape[3:])
    join_bytes = 2 * plane * (y_shape[0] * c * (rows + size)
                              + skip_shape[0] * c * srows)
    row.update(bound(0.0, join_bytes + 2 * y.numel(), F32_FLOPS))
    row["join_bound_ms"] = join_bytes / MEMORY_BYTES_PER_S * 1e3
    _print_times(row)
    print(f"    gn1_join alone {row['join_ms']:.4f} ms = "
          f"{row['join_bound_ms'] / row['join_ms']:.1%} of its bound "
          f"{row['join_bound_ms']:.4f} ({rows} of {y_shape[2]} rows of y "
          f"read); the call = {row['bound_ms'] / row['ms']:.1%} of its "
          f"bound (with the statistics' read of y); the chain before: "
          f"{row['library_launches']} kernels")
    return row


def check_dec_join(gen: torch.Generator) -> dict:
    """The decoder join at every layer of a songs group and a stream
    block's freq layer 1, bf16, against its plain version in f32; at the
    songs group's freq layers 0 and 1 the device times of the call (the
    entry's ``ms``: statistics and join), of ``gn1_join`` alone
    (``join_ms``), of the plain version (the old chain with
    ``F.group_norm``) and of the chain the card ran before."""
    print("dec_join at a songs group's 8 layers and a stream block's freq "
          "layer 1:")
    print(f"  tolerance: {JOIN_TOL['reason']}")
    forms = []
    for label, y_shape, skip_shape, size, norm in JOIN_FORMS:
        forms.append(_join_row(gen, label, y_shape, skip_shape, size, norm,
                               label in JOIN_TIMED))
        torch.cuda.empty_cache()
    entry = _kernel_entry(
        "dec_join", "audio_to_sheet_music_tpu_torch/csrc/group_norm.cu",
        "none: the JAX package's _freq_layer_down4 is an XLA lowering",
        forms, "launches_per_group", F32_FLOPS,
        "mean per call (statistics and join) at freq layers 0 and 1 (bf16)")
    for key in ("join_ms", "join_bound_ms"):
        entry[key] = _weighted(forms, key, "launches_per_group")
    return entry


def _gated_library(q, k, v, gate, x, wo):
    """BS-RoFormer's gated attention block as PyTorch library calls in bf16
    (``scaled_dot_product_attention``, cuBLAS): the yardstick only."""
    bsz, l, _ = q.shape
    heads = lambda t: t.view(bsz, l, HEADS, D // HEADS).transpose(1, 2)  # noqa: E731
    a = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
    a = a * torch.sigmoid(gate.float()).to(q.dtype).transpose(1, 2)[..., None]
    return x + F.linear(a.transpose(1, 2).reshape(bsz, l, D), wo)


def check_attn_gated(gen: torch.Generator) -> dict:
    """``attn_gated`` (the gated flash launch, then the out-projection
    GEMM with the residual) against its plain version at the BS-RoFormer
    cell's two axes; CUDA-event times (a launch takes ~1 ms here, far more
    than the wrapper's host time)."""
    from audio_to_sheet_music_tpu_torch.ops import fused_attn
    from port_bench import roformer_work

    print("attn_gated at BS-RoFormer's serving group (4 chunks of 8 s), "
          "D=512, 8 heads, bf16:")
    print(f"  tolerance: {LAYER_TOL['reason']}")
    forms = []
    for name, b, l, n in ROFORMER_FORMS:
        def bf(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).to(
                "cuda", torch.bfloat16).contiguous()
        args = [bf(b, l, D), bf(b, l, D), bf(b, l, D), bf(b, l, HEADS),
                bf(b, l, D), bf(D, D, scale=D ** -0.5)]
        kernel = lambda: fused_attn.attn_gated(*args, HEADS)  # noqa: E731
        with torch.inference_mode():
            got = kernel()
            torch.cuda.synchronize()
            err = compare(f"{name} B={b} L={l}", got,
                          fused_attn.attn_gated_plain(*args, HEADS), LAYER_TOL)
            row = {"form": name, "B": b, "L": l, "launches_per_group": n,
                   **err, "ms": cuda_ms(kernel, 10),
                   "plain_ms": cuda_ms(lambda: fused_attn.attn_gated_plain(
                       *args, HEADS), 3),
                   "library_ms": cuda_ms(lambda: _gated_library(*args), 10)}
        row.update(bound(*roformer_work.gated_attn_work(b, l, D, HEADS),
                         BF16_TENSOR_FLOPS))
        _print_times(row)
        forms.append(row)
        del args, got
        torch.cuda.empty_cache()
    return _kernel_entry(
        "attn_gated", "audio_to_sheet_music_tpu_torch/csrc/attn_block.cu",
        "none: models.bs_roformer has no JAX counterpart", forms,
        "launches_per_group", BF16_TENSOR_FLOPS,
        "mean per launch over one group's 24 launches")


def check_rope_qkv(gen: torch.Generator) -> dict:
    """``rope_qkv`` (RoPE on q and k and the split of the packed
    projection, one pass) against its plain version at the BS-RoFormer
    cell's two axes; CUDA-event times (a launch takes ~0.4 ms)."""
    from audio_to_sheet_music_tpu_torch.ops import fused_rope
    from port_bench import roformer_work

    print("rope_qkv at BS-RoFormer's serving group (4 chunks of 8 s), "
          "D=512, 8 heads, bf16:")
    print(f"  tolerance: {ROPE_TOL['reason']}")
    forms = []
    for name, b, l, n in ROFORMER_FORMS:
        qkv = torch.randn((b, l, 3 * D), generator=gen).to("cuda",
                                                            torch.bfloat16)
        kernel = lambda: fused_rope.rope_qkv(qkv, HEADS)  # noqa: E731
        plain = lambda: fused_rope.rope_qkv_plain(qkv, HEADS)  # noqa: E731
        with torch.inference_mode():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            errs = [compare(f"{name} B={b} L={l} {part}", g, w, ROPE_TOL)
                    for part, g, w in zip("qkv", got, want)]
            if not torch.equal(got[2], want[2]):
                raise SmokeFailure("rope_qkv: v is not copied as it is")
            row = {"form": name, "B": b, "L": l, "launches_per_group": n,
                   "max_abs_err": max(e["max_abs_err"] for e in errs),
                   "rms_err": max(e["rms_err"] for e in errs),
                   "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 5)}
        # no library call computes it: the plain version's PyTorch ops are
        # the path the kernel replaced
        row["library_ms"] = row["plain_ms"]
        row.update(bound(*roformer_work.rope_work(b, l, D), F32_FLOPS))
        _print_times(row)
        forms.append(row)
        del qkv, got, want
        torch.cuda.empty_cache()
    return _kernel_entry(
        "rope_qkv", "audio_to_sheet_music_tpu_torch/csrc/rope.cu",
        "none: models.bs_roformer has no JAX counterpart", forms,
        "launches_per_group", F32_FLOPS,
        "mean per launch over one group's 24 launches")


def eval_stft(gen: torch.Generator) -> dict:
    rows, t, frames = EVAL_STFT
    print(f"stft, the eval path's form ({rows}, {t}), {frames} frames:")
    return _eval_entry([_stft_row(gen, rows, t, frames,
                                  "launches_per_forward")], F32_FLOPS)


# ---------------------------------------------------------------------------
# Phase 3: the full path
# ---------------------------------------------------------------------------

def _device_busy_us(prof) -> float:
    """The union of the device intervals a profiler saw, in us."""
    from torch.autograd import DeviceType

    return busy_union((e.time_range.start, e.time_range.end)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA)


def device_busy(fn) -> dict:
    """Wall and device-busy ms of one call of ``fn``, traced with the device
    activity only: without the host ops ``profile_device`` records, the
    trace is read back in a fraction of the time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = _device_busy_us(prof)
    if not busy:
        raise SmokeFailure("the profiler saw no device time")
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e3}


def profile_device(fn, label: str) -> dict:
    """Device time by kernel over one call of ``fn``, and the share of the
    wall time in which some kernel or copy ran on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = _device_busy_us(prof)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    if not rows:
        raise SmokeFailure("the profiler saw no device time")
    total = sum(r[1] for r in rows)
    print(f"profile of {label}: wall {wall_ms:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms ({busy / 1e3 / wall_ms:.1%}), kernel "
          f"time {total:.1f} ms")
    groups: dict = {}
    for key, ms, _ in rows:
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + ms
    for group, ms in sorted(groups.items(), key=lambda g: -g[1]):
        print(f"  {ms:9.3f} ms {ms / total:6.1%}  {group}")
    print("  top kernels:")
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.3f} ms {ms / total:6.1%} x{count:<5d} {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e3, "kernel_ms": total,
            "groups": groups, "kernels": [
                {"name": k, "ms": ms, "count": c} for k, ms, c in rows]}


def _song(rng: np.random.Generator) -> np.ndarray:
    """The seeded 60 s stereo song: sines at 55/220/880 Hz + 0.05 noise."""
    n = int(SONG_SECONDS * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    tones = sum(0.1 * np.sin(2 * np.pi * f0 * t) for f0 in (55.0, 220.0, 880.0))
    return (tones + 0.05 * rng.standard_normal((2, n))).astype(np.float32)


def seed_fingerprint(model) -> dict:
    """The seed-0 draw on the card against the JAX package's fingerprint
    (``models/seed0_fingerprint.json``): every leaf's count and sums, and
    the hash of every uniform one.  Fails on any difference."""
    from audio_to_sheet_music_tpu_torch.models import fingerprint

    t0 = time.perf_counter()
    want = fingerprint.load()
    bad = fingerprint.mismatches(fingerprint.fingerprint(model.state_dict()),
                                 want)
    check_s = time.perf_counter() - t0
    n = sum(v["count"] for v in want.values())
    hashed = sum("sha256" in v for v in want.values())
    print(f"seed-{SEED} model drawn on the card against the JAX package's "
          f"fingerprint: {len(want)} leaves ({hashed} hashed), {n} values, "
          f"{len(bad)} differ ({check_s:.2f} s)")
    if bad:
        raise SmokeFailure(f"the seed-{SEED} draw is not the JAX model's: "
                           f"{bad[:5]}")
    return {"leaves": len(want), "hashed": hashed, "values": n,
            "check_s": check_s}


def run_path(profile: bool) -> dict:
    from audio_to_sheet_music_tpu_torch.infer.session import Separator
    from audio_to_sheet_music_tpu_torch.models import atht

    from audio_to_sheet_music_tpu_torch.ops import kernel_gate

    t0 = time.perf_counter()
    model = atht.init(SEED, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    seeded = seed_fingerprint(model)
    atht.load_params(model)                             # + trained head
    sep = Separator(model, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gate = kernel_gate.last_result()
    if sep.compute_dtype != torch.bfloat16:
        raise SmokeFailure(f"compute dtype {sep.compute_dtype}, want bf16")
    print(f"full-width model on {sep.device} in {sep.compute_dtype}: set-up "
          f"{setup_s:.2f} s (the seed-{SEED} draw {draw_s:.3f} s)")

    rng = np.random.default_rng(SEED)
    song = _song(rng)
    n = song.shape[-1]

    # the warm-up captures the group programs: their working set is
    # allocated there, and a replay allocates nothing
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sep.separate_all_pcm(song)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    _zero_counters()
    t0 = time.perf_counter()
    pcm, scales = sep.separate_all_pcm(song)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_counters().items()
                if k in ("layer_tail", "henc_freq_fused", "group_norm",
                         "dec_join")}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gib = torch.cuda.memory_reserved() / 2 ** 30
    rate = 4 * SONG_SECONDS / wall
    print(f"separate_all_pcm: warm-up {warm_s:.2f} s (captures included), "
          f"run {wall:.3f} s, {rate:.2f} audio-sec/sec (4 stems x "
          f"{SONG_SECONDS:.0f} s), peak device memory {peak_gib:.2f} GiB "
          f"allocated over both, {reserved_gib:.2f} GiB reserved, launches "
          f"{launches}")
    if pcm.dtype != np.int16 or pcm.shape != (4, 2, n):
        raise SmokeFailure(f"pcm {pcm.dtype} {pcm.shape}, want int16 (4, 2, {n})")
    if not np.all(np.isfinite(scales)) or np.abs(pcm).max() == 0:
        raise SmokeFailure("output is silent or its scale is not finite")
    stem_rms = np.sqrt(np.mean(pcm.astype(np.float64) ** 2, axis=(1, 2)))
    print(f"  stem rms (int16 steps): {np.round(stem_rms, 1).tolist()}")
    for name, count in launches.items():
        if count <= 0:
            raise SmokeFailure(f"{name} was not launched on the main path")
    if launches["dec_join"] != 8 * launches["henc_freq_fused"]:
        raise SmokeFailure(f"{launches['dec_join']} decoder joins for "
                           f"{launches['henc_freq_fused']} groups, want 8 "
                           "a group")

    wav = torch.from_numpy((0.1 * rng.standard_normal(
        (1, 2, int(CHUNK_SECONDS * SAMPLE_RATE)))).astype(np.float32)).cuda()
    emb = torch.from_numpy((rng.standard_normal((1, 512)) / np.sqrt(512)
                            ).astype(np.float32)).cuda()
    with torch.inference_mode():
        ker = atht.forward_with_text_emb(model, wav, emb, torch.bfloat16,
                                         kernels=True).float()
        ref = atht.forward_with_text_emb(model, wav, emb, torch.bfloat16,
                                         kernels=False).float()
    rms = float((ker - ref).pow(2).mean().sqrt())
    ref_rms = float(ref.pow(2).mean().sqrt())
    print(f"6 s forward, kernels vs per-op: rms diff {rms:.3e} (limit "
          f"{PATH_RMS_LIMIT:.0e}), ref rms {ref_rms:.3e}")
    if not (math.isfinite(rms) and rms < PATH_RMS_LIMIT):
        raise SmokeFailure("kernel path diverges from the per-op path")
    result = {"launches": launches, "warmup_s": warm_s, "wall_s": wall,
              "audio_sec_per_sec": rate, "setup_s": setup_s,
              "draw_s": draw_s, "fingerprint": seeded,
              "peak_mem_gib": peak_gib, "reserved_gib": reserved_gib,
              "path_rms": rms,
              "path_ref_rms": ref_rms, "stem_rms_lsb": stem_rms.tolist(),
              "gate": gate}
    if profile:
        result["profile"] = profile_device(lambda: sep.separate_all_pcm(song),
                                           "one separate_all_pcm")
        result["per_op_audio_sec_per_sec"] = per_op_rate(model, song)
    stems = pcm.astype(np.float32) * (scales[:, None, None] / 32767.0)
    return result, model, stems, pcm


def per_op_rate(model, song: np.ndarray) -> float:
    """audio-sec/sec of a warm sweep on the per-op path (no kernels)."""
    from audio_to_sheet_music_tpu_torch.infer.session import Separator

    sep = Separator(model, device="cuda", kernels=False)
    sep.separate_all_pcm(song)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sep.separate_all_pcm(song)
    wall = time.perf_counter() - t0
    rate = 4 * SONG_SECONDS / wall
    print(f"separate_all_pcm on the per-op path: run {wall:.3f} s, "
          f"{rate:.2f} audio-sec/sec")
    return rate


# ---------------------------------------------------------------------------
# Phase 4: training
# ---------------------------------------------------------------------------

NEW_KERNELS = ("stft", "henc_freq_fused", "dconv_rows", "attn_block")


def _zero_counters() -> None:
    from audio_to_sheet_music_tpu_torch.ops.select import zero_launch_counts
    zero_launch_counts()


def _read_counters() -> dict:
    from audio_to_sheet_music_tpu_torch.ops.select import launch_counts
    return launch_counts()


def _train_config(root: Path):
    from audio_to_sheet_music_tpu_torch.config import (Config, DataConfig,
                                                       TrainingConfig,
                                                       WandbConfig)

    return Config(
        data=DataConfig(train_dir=str(root / "train"),
                        test_dir=str(root / "test"),
                        segment_seconds=CHUNK_SECONDS),
        training=TrainingConfig(batch_size=TRAIN_B, num_epochs=1),
        wandb=WandbConfig(log_every=1, validate_every=1, save_every=1,
                          checkpoint_dir=str(root / "ckpt"),
                          output_dir=str(root / "out")))


def deterministic_cost(run, label: str) -> dict:
    """``run()`` -> ms, timed with ``torch.backends.cudnn.deterministic``
    off, on, on, off (the app separator's setting against everyone
    else's); the flag is off again after."""
    ms: dict = {"off": [], "on": []}
    try:
        for on in (False, True, True, False):
            torch.backends.cudnn.deterministic = on
            ms["on" if on else "off"].append(run())
    finally:
        torch.backends.cudnn.deterministic = False
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"  {label}, cuDNN deterministic off / on: "
          f"{', '.join(f'{x:.2f}' for x in ms['off'])} / "
          f"{', '.join(f'{x:.2f}' for x in ms['on'])} ms: "
          f"{mean['on'] / mean['off'] - 1:+.2%}")
    return {"ms": ms, "cost": mean["on"] / mean["off"] - 1}


def _time_steps(model, batch: dict, kernels, n: int, profile: bool) -> dict:
    """Warm train steps of the head under one selection on a fresh
    optimizer (the towers do not change, the head does); with ``profile``,
    one more step under the profiler."""
    from audio_to_sheet_music_tpu_torch.train import step as tstep

    state = tstep.TrainState.create(model, lambda p: tstep.make_optimizer(p))
    step = tstep.make_train_step({}, torch.bfloat16, kernels)
    step(state, batch)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    for _ in range(n):
        metrics = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"steps_per_s": n / wall, "step_ms": wall / n * 1e3,
           "loss": float(metrics["loss/total"]),
           "launches_per_step": {k: v / n for k, v in _read_counters().items()}}
    if profile:
        out["profile"] = profile_device(lambda: step(state, batch),
                                        f"one {kernels} train step")
    return out


def run_training(profile: bool) -> dict:
    import tempfile

    from audio_to_sheet_music_tpu_torch.data import synthetic_tracks
    from audio_to_sheet_music_tpu_torch.models import atht
    from audio_to_sheet_music_tpu_torch.ops import losses as tlosses
    from audio_to_sheet_music_tpu_torch.train.trainer import put_batch, train

    model = atht.load_params(atht.init(SEED, device="cuda"))  # + trained head
    towers = {k: v.detach().clone() for k, v in model.state_dict().items()
              if not k.startswith("head.")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        synthetic_tracks(4, seconds=12.0, cache_dir=root / "train", seed=SEED)
        synthetic_tracks(1, seconds=12.0, cache_dir=root / "test",
                         seed=SEED + 1)
        cfg = _train_config(root)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        t0 = time.perf_counter()
        result = train(cfg, model=model, device="cuda", kernels="opt_in")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        logs = [json.loads(x) for x in
                (root / "out" / "metrics.jsonl").read_text().splitlines()]
        steps = [r for r in logs if "train/loss/total" in r]
        print(f"train (opt_in, batch {TRAIN_B} x {CHUNK_SECONDS:.0f} s, "
              f"bf16): {len(steps)} steps + validation in {wall:.2f} s, "
              f"{result['steps_per_s']:.3f} steps/s over the epoch, peak "
              f"device memory {peak_gib:.2f} GiB, val SDR "
              f"{result['best_sdr']:.3f} dB")
        for r in steps:
            print(f"  step {r['step']}: loss {r['train/loss/total']:.5f}, "
                  f"grad norm {r['train/grad_norm']:.5f}")
        print(f"  launches {launches}")
        if not steps or not all(math.isfinite(r["train/loss/total"])
                                and math.isfinite(r["train/grad_norm"])
                                for r in steps):
            raise SmokeFailure("training logged no step or a non-finite loss")
        for name in NEW_KERNELS:
            if launches[name] <= 0:
                raise SmokeFailure(f"{name} was not launched on the "
                                   "training path")
        for name in ("latest", "best", "epoch_0000"):
            if not (root / "ckpt" / name / "state.pt").exists():
                raise SmokeFailure(f"no {name} checkpoint was written")
        changed = [k for k, v in model.state_dict().items()
                   if not k.startswith("head.") and not torch.equal(v, towers[k])]
        if changed:
            raise SmokeFailure(f"training changed tower weights: {changed[:3]}")

        saved = {k: v.clone() for k, v in model.head.state_dict().items()}
        with torch.no_grad():
            for p in model.head.parameters():
                p.zero_()
        again = train(cfg, model=model, device="cuda", kernels="opt_in")
        resumed = all(torch.equal(v, saved[k])
                      for k, v in model.head.state_dict().items())
        print(f"resume from latest: head restored {resumed}, final epoch "
              f"{again['final_epoch']}")
        if not resumed:
            raise SmokeFailure("the resumed head differs from the saved one")

        from audio_to_sheet_music_tpu_torch.data import (BatchLoader,
                                                         StemSegmentDataset,
                                                         discover_tracks)
        from audio_to_sheet_music_tpu_torch.text.tokenizer import (
            default_tokenizer)

        ds = StemSegmentDataset(discover_tracks(root / "train"),
                                cfg.data.segment_samples)
        raw = next(iter(BatchLoader(ds, TRAIN_B, default_tokenizer(),
                                    shuffle=False)))
        batch = put_batch(raw, torch.device("cuda"))

    # one batch, one head: the opt-in loss against the per-op loss
    with torch.no_grad():
        losses = {}
        for sel in ("opt_in", None):
            est = atht.forward(model, batch["mixture"], batch["input_ids"],
                               batch["attention_mask"], torch.bfloat16, sel)
            losses[sel] = float(tlosses.combined_loss(
                est, batch["target"])[0])
        resid = float((batch["target"] - est.float()).pow(2).mean().sqrt())
    # a stem difference of PATH_RMS_LIMIT (rms) moves an SDR by at most
    # 20 log10(1 + limit / rms(target - estimate)) dB
    loss_tol = 20 * math.log10(1 + PATH_RMS_LIMIT / resid)
    dloss = abs(losses["opt_in"] - losses[None])
    print(f"loss on one batch: opt_in {losses['opt_in']:.6f}, per-op "
          f"{losses[None]:.6f}, |diff| {dloss:.3e} dB (limit {loss_tol:.3e})")
    if not dloss <= loss_tol:
        raise SmokeFailure("the opt-in loss diverges from the per-op loss")

    wav = torch.from_numpy((0.1 * np.random.default_rng(SEED).standard_normal(
        (1, 2, int(CHUNK_SECONDS * SAMPLE_RATE)))).astype(np.float32)).cuda()
    emb = torch.from_numpy((np.random.default_rng(SEED).standard_normal(
        (1, 512)) / np.sqrt(512)).astype(np.float32)).cuda()
    with torch.inference_mode():
        ker = atht.forward_with_text_emb(model, wav, emb, torch.bfloat16,
                                         kernels="opt_in").float()
        ref = atht.forward_with_text_emb(model, wav, emb, torch.bfloat16,
                                         kernels=False).float()
    rms = float((ker - ref).pow(2).mean().sqrt())
    print(f"6 s forward, opt_in kernels vs per-op: rms diff {rms:.3e} (limit "
          f"{PATH_RMS_LIMIT:.0e})")
    if not (math.isfinite(rms) and rms < PATH_RMS_LIMIT):
        raise SmokeFailure("the opt-in path diverges from the per-op path")

    timed = {}
    for label, sel in (("opt_in", "opt_in"), ("default", True),
                       ("none", False)):
        timed[label] = _time_steps(model, batch, sel, 3,
                                   profile and label == "opt_in")
        print(f"warm train step, {label}: {timed[label]['step_ms']:.1f} ms "
              f"({timed[label]['steps_per_s']:.3f} steps/s), loss "
              f"{timed[label]['loss']:.5f}")
    print(f"  launches per opt_in step: {timed['opt_in']['launches_per_step']}")
    if profile:
        timed["deterministic_cost"] = deterministic_cost(
            lambda: _time_steps(model, batch, True, 3, False)["step_ms"],
            "warm train step, default")
    return {"launches": launches, "wall_s": wall,
            "epoch_steps_per_s": result["steps_per_s"], "peak_mem_gib": peak_gib,
            "steps": steps, "val_sdr": result["best_sdr"],
            "loss_opt_in": losses["opt_in"], "loss_per_op": losses[None],
            "loss_tol": loss_tol, "path_rms_opt_in": rms, "timed": timed}


# ---------------------------------------------------------------------------
# Phase 5: the eval path
# ---------------------------------------------------------------------------

EVAL_SELECTIONS = ("default", "opt_in", "none")
EVAL_TRACKS = 2                    # synthetic 12 s tracks, per-op benchmark
EVAL_MODELS = ("AudioTextHTDemucs (Ours)",
               "AudioTextHTDemucs (Ours, random head)",
               "HTDemucs (random init)")
# the JAX package's committed results (its benchmark.py on a TPU, bf16):
# the default benchmark reruns that command and holds each aggregate row
# to it
RESULTS = Path(__file__).resolve().parent / "results" / "synthetic" / \
    "evaluation_results.json"
RESULTS_TRACKS = 5
RESULTS_MODELS = ("ours", "ours-random", "htdemucs", "clapsep")
RESULTS_NAMES = EVAL_MODELS + ("CLAPSep (random init)",)
RESULTS_TOL_DB = 0.25              # a stem's aggregate SDR or SI-SDR


def _timed_sweep(base, song: np.ndarray) -> tuple:
    """One warm ``separate_all``, then one timed with every launch counter
    set to 0 just before and read just after."""
    base.separate_all(song)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    stems = base.separate_all(song)
    wall = time.perf_counter() - t0
    return stems, wall, _read_counters()


def _decoder_dconv_launches(ht, chunks: torch.Tensor) -> dict:
    """Which freq decoders' DConvs ``fused_dconv.supports`` sends to
    ``dconv_rows``, and the launches of an opt-in forward less those of
    its encode: the decoders' own."""
    from audio_to_sheet_music_tpu_torch.models import htdemucs
    from audio_to_sheet_music_tpu_torch.ops import fused_dconv, select

    routes = {}
    for idx, layer in enumerate(ht.decoder):
        c = layer.dconv.layers[0].conv1.weight.shape[1]
        f = 2048 // 4 ** (len(ht.decoder) - idx)
        routes[f"decoder {idx} C={c} F={f}"] = (
            "dconv_rows" if fused_dconv.supports(chunks.shape[0] * f, EVAL_T,
                                                 c) else "per-op")
    print(f"  freq decoders' DConv under opt_in: {routes}")
    sel = select.resolve("opt_in")
    with torch.inference_mode():
        _zero_counters()
        _, _, x, xt, *_ = htdemucs.normalize_inputs(chunks, sel.stft)
        htdemucs.encode(ht, x.to(torch.bfloat16), xt.to(torch.bfloat16), sel)
        enc = fused_dconv.dconv_rows.launches
        _zero_counters()
        htdemucs.forward(ht, chunks, torch.bfloat16, sel)
        total = fused_dconv.dconv_rows.launches
    print(f"  dconv_rows launches in one opt-in forward: {total}, of which "
          f"the encoder {enc} and the decoders {total - enc}")
    if total - enc != sum(r == "dconv_rows" for r in routes.values()):
        raise SmokeFailure("the freq decoders did not route their DConv as "
                           "fused_dconv.supports decides")
    return {"routes": routes, "decoder_launches": total - enc,
            "encoder_launches": enc}


def _benchmark_cli(out_dir: Path, kernels: str,
                   models=("ours", "ours-random", "htdemucs"),
                   names=EVAL_MODELS, tracks: int = EVAL_TRACKS) -> dict:
    """``cli benchmark`` on ``tracks`` synthetic tracks with ``models`` (by
    default the three of phase 5), whose results must be ``names``."""
    from audio_to_sheet_music_tpu_torch import cli

    cli.main(["benchmark", "--synthetic", "--synthetic-tracks",
              str(tracks), "--models", *models,
              "--output-dir", str(out_dir), "--kernels", kernels])
    payload = json.loads((out_dir / "evaluation_results.json").read_text())
    if set(payload) != set(names):
        raise SmokeFailure(f"benchmark models {sorted(payload)}")
    for name, entry in payload.items():
        if (set(entry) != {"per_track", "aggregate"}
                or len(entry["per_track"]) != tracks
                or set(entry["aggregate"]) != {"sdr", "sisdr"}):
            raise SmokeFailure(f"{name}: results not in the reference schema")
        for metric, vals in entry["aggregate"].items():
            if not all(isinstance(v, float) and -30.0 <= v <= 30.0
                       for v in vals.values()):
                raise SmokeFailure(f"{name}: aggregate {metric} {vals} is "
                                   "not a number within the ±30 dB clamp")
    return payload


def _against_results(payload: dict) -> dict:
    """Every aggregate SDR and SI-SDR row (each stem and the average) of
    ``payload`` against the JAX package's committed results within
    ``RESULTS_TOL_DB``, and Ours above Ours-random on every stem's SDR.
    Prints every row before it fails."""
    want = json.loads(RESULTS.read_text())
    rows, worst = {}, 0.0
    for name in RESULTS_NAMES:
        for metric in ("sdr", "sisdr"):
            got = payload[name]["aggregate"][metric]
            ref = want[name]["aggregate"][metric]
            gaps = {k: got[k] - ref[k] for k in ref}
            worst = max(worst, max(abs(g) for g in gaps.values()))
            rows[f"{name} {metric}"] = {"port": got, "results": ref}
            print(f"  {name} {metric}: " + ", ".join(
                f"{k} {got[k]:.3f} ({gaps[k]:+.3f})" for k in ref))
    ours = payload["AudioTextHTDemucs (Ours)"]["aggregate"]["sdr"]
    rand = payload["AudioTextHTDemucs (Ours, random head)"]["aggregate"]["sdr"]
    print(f"  largest gap to {RESULTS.name}: {worst:.3f} dB (limit "
          f"{RESULTS_TOL_DB} dB)")
    if not worst <= RESULTS_TOL_DB:
        raise SmokeFailure(f"a benchmark row is {worst:.3f} dB from the JAX "
                           f"package's results (limit {RESULTS_TOL_DB} dB)")
    if not all(ours[s] > rand[s] for s in STEMS4):
        raise SmokeFailure(f"Ours does not beat Ours-random on every stem: "
                           f"{ours} against {rand}")
    return {"worst_gap_db": worst, "limit_db": RESULTS_TOL_DB, "rows": rows}


def _sdr_gaps(kernel: dict, per_op: dict, root: Path) -> dict:
    """Per model, track and stem: |SDR(kernels) - SDR(per-op)| against the
    loss-gap rule, 20 log10(1 + 1e-3 / rms(ref - est)), with rms(ref - est)
    = rms(ref) 10^(-SDR/20) from the per-op run (SDR is a ratio of sums).
    The tracks are written again from the benchmark's seed."""
    from audio_to_sheet_music_tpu_torch.data import synthetic_tracks
    from audio_to_sheet_music_tpu_torch.text.prompts import STEM_NAMES

    refs = {t.name: t.load(mmap=False) for t in synthetic_tracks(
        EVAL_TRACKS, seconds=12.0, cache_dir=root / "tracks")}
    worst = {}
    for name in EVAL_MODELS:
        gaps = []
        for tk, tn in zip(kernel[name]["per_track"], per_op[name]["per_track"]):
            arr = refs[tn["track"]]
            for i, stem in enumerate(STEM_NAMES):
                ref_rms = float(np.sqrt(np.mean(arr[1 + i].astype(
                    np.float64) ** 2)))
                resid = ref_rms * 10 ** (-tn["sdr"][stem] / 20)
                tol = 20 * math.log10(1 + PATH_RMS_LIMIT / resid)
                gap = abs(tk["sdr"][stem] - tn["sdr"][stem])
                gaps.append((gap, tol))
                if not gap <= tol:
                    raise SmokeFailure(
                        f"{name} {tn['track']} {stem}: SDR gap {gap:.3e} dB "
                        f"past the loss-gap limit {tol:.3e}")
        gap, tol = max(gaps, key=lambda g: g[0] / g[1])
        worst[name] = {"gap_db": gap, "limit_db": tol}
        print(f"  {name}: largest SDR gap default vs per-op {gap:.3e} dB "
              f"(limit there {tol:.3e})")
    return worst


def run_eval(profile: bool) -> dict:
    import tempfile

    from audio_to_sheet_music_tpu_torch.eval.models import HTDemucsBaseline
    from audio_to_sheet_music_tpu_torch.infer import chunked
    from audio_to_sheet_music_tpu_torch.models import atht, htdemucs
    from audio_to_sheet_music_tpu_torch.text.prompts import STEM_NAMES

    t0 = time.perf_counter()
    model = atht.load_params(atht.init(SEED, device="cuda"))  # + trained head
    bases = {sel: HTDemucsBaseline(model.htdemucs, EVAL_SECONDS, EVAL_OVERLAP,
                                   kernels=sel) for sel in EVAL_SELECTIONS}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if bases["default"].compute_dtype != torch.bfloat16:
        raise SmokeFailure(f"compute dtype {bases['default'].compute_dtype}, "
                           "want bf16")
    song = _song(np.random.default_rng(SEED))
    n = song.shape[-1]
    grid = chunked.plan_chunks(n, bases["default"].segment,
                               bases["default"].overlap, 8)
    if grid.n_chunks != EVAL_B:
        raise SmokeFailure(f"{grid.n_chunks} chunks, want {EVAL_B}")
    print(f"HTDemucsBaseline, the full-width tower on cuda in bf16: set-up "
          f"{setup_s:.2f} s; {grid.n_chunks} chunks of {EVAL_SECONDS} s")

    sweeps = {}
    torch.cuda.reset_peak_memory_stats()
    for sel, base in bases.items():
        stems, wall, launches = _timed_sweep(base, song)
        rate = 4 * SONG_SECONDS / wall
        used = {k: v for k, v in launches.items() if v}
        print(f"separate_all, {sel}: run {wall:.3f} s, {rate:.2f} "
              f"audio-sec/sec (4 stems x {SONG_SECONDS:.0f} s), launches "
              f"{used}")
        if set(stems) != set(STEM_NAMES) or any(
                v.shape != (2, n) or not np.isfinite(v).all()
                or not np.abs(v).max() > 0 for v in stems.values()):
            raise SmokeFailure(f"{sel}: stems not finite (2, {n}) or silent")
        sweeps[sel] = {"wall_s": wall, "audio_sec_per_sec": rate,
                       "launches": launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  peak device memory {peak_gib:.2f} GiB")
    for sel, names in (("default", ("layer_tail", "henc_freq_fused")),
                       ("opt_in", ("henc_freq_fused", "dconv_rows",
                                   "attn_block", "stft"))):
        for name in names:
            if sweeps[sel]["launches"][name] <= 0:
                raise SmokeFailure(f"{name} was not launched on the {sel} "
                                   "eval path")

    chunks = chunked.frame_song(torch.from_numpy(song).cuda(), grid)
    with torch.inference_mode():
        ref = htdemucs.forward(model.htdemucs, chunks, torch.bfloat16, "none")
        ref_rms = float(ref.pow(2).mean().sqrt())
        path_rms = {}
        for sel in ("default", "opt_in"):
            got = htdemucs.forward(model.htdemucs, chunks, torch.bfloat16, sel)
            path_rms[sel] = float((got - ref).pow(2).mean().sqrt())
            print(f"{EVAL_B} x {EVAL_SECONDS} s chunks through "
                  f"htdemucs.forward, {sel} vs per-op: rms diff "
                  f"{path_rms[sel]:.3e} (limit {PATH_RMS_LIMIT:.0e}), ref rms "
                  f"{ref_rms:.3e}")
            if not (math.isfinite(path_rms[sel])
                    and path_rms[sel] < PATH_RMS_LIMIT):
                raise SmokeFailure(f"the {sel} eval path diverges from the "
                                   "per-op path")
        del got, ref
    decoders = _decoder_dconv_launches(model.htdemucs, chunks)
    if decoders["decoder_launches"] <= 0:
        raise SmokeFailure("no freq decoder's DConv went through dconv_rows")
    del chunks

    result = {"setup_s": setup_s, "sweeps": sweeps, "peak_mem_gib": peak_gib,
              "path_rms": path_rms, "path_ref_rms": ref_rms,
              "dconv_decoders": decoders}
    if profile:
        result["profile"] = profile_device(
            lambda: bases["default"].separate_all(song),
            "one HTDemucsBaseline.separate_all (default)")
        result["deterministic_cost"] = deterministic_cost(
            lambda: _timed_sweep(bases["default"], song)[1] * 1e3,
            "HTDemucsBaseline.separate_all, default")
    del model, bases

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        runs = {"default": _benchmark_cli(
                    root / "default", "default", RESULTS_MODELS,
                    RESULTS_NAMES, RESULTS_TRACKS),
                "none": _benchmark_cli(root / "none", "none")}
        result["benchmark_s"] = time.perf_counter() - t0
        result["against_results"] = _against_results(runs["default"])
        # the per-op run's tracks are the first EVAL_TRACKS of the default's
        result["sdr_gap"] = _sdr_gaps(runs["default"], runs["none"], root)
    result["benchmark"] = {sel: {name: entry["aggregate"]
                                 for name, entry in payload.items()}
                           for sel, payload in runs.items()}
    print(f"  two benchmark runs in {result['benchmark_s']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# Phase 6: the serving apps
# ---------------------------------------------------------------------------

STREAM_FIXED_BLOCK = 8             # the JAX package's static ?block default
SPEC_DB_LIMIT = 1e-2               # dB, spectrogram_db on the card vs the CPU
FIRST_AUDIO = 45                   # bytes: the WAV header and one more


def _wav_bytes(pcm: np.ndarray) -> bytes:
    import io

    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, SAMPLE_RATE, np.ascontiguousarray(pcm.T))
    return buf.getvalue()


def _request(port: int, method: str, path: str, body: bytes | None = None
             ) -> dict:
    """One request to the local server -> status, body, wall seconds and
    the seconds to the first byte after a WAV header (``first_s``)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "audio/wav"} if body else {})
        resp = conn.getresponse()
        head = resp.read(FIRST_AUDIO)
        first_s = time.perf_counter() - t0
        data = head + resp.read()
        wall = time.perf_counter() - t0
        length = resp.getheader("Content-Length")
    finally:
        conn.close()
    if resp.status != 200:
        raise SmokeFailure(f"{method} {path}: HTTP {resp.status}: "
                           f"{data[:200]!r}")
    return {"body": data, "wall_s": wall, "first_s": first_s,
            "length": None if length is None else int(length)}


def _pcm_diff(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def stream_kernels(blocks: dict, n_sep: int) -> dict:
    """``layer_tail`` and ``henc_freq_fused`` against their plain versions
    and library calls at phase 6's shapes: each stream block size (6 s
    chunks; weighted by the launches of its steps, ``blocks``: size ->
    steps) and ``/api/separate``'s whole-song batch of ``n_sep`` chunks
    (weight 0: checked and timed, outside the stream's means).  ->
    ``{kernel: {"stream_*": ...}}``."""
    gen = torch.Generator().manual_seed(SEED)
    weight = "launches_on_streams"
    sizes = dict(blocks)
    sizes.setdefault(n_sep, 0)
    print(f"layer_tail and henc_freq_fused at phase 6's batches "
          f"(stream blocks {sorted(blocks)}, /api/separate {n_sep} chunks):")
    tails, hencs = [], []
    layer = _henc_layer()
    for b, steps in sorted(sizes.items()):
        forms = [(name, l, s_, n * steps) for name, l, s_, n in LAYER_FORMS]
        rows, _ = _layer_tail_rows(gen, b, forms, weight)
        tails += rows
        row, x = _henc_form(layer, b, TRAIN_T, weight, steps, gen)
        hencs.append(row)
        del x
        torch.cuda.empty_cache()
    return {"layer_tail": _path_entry("stream", tails, weight,
                                      BF16_TENSOR_FLOPS),
            "henc_freq_fused": _path_entry("stream", hencs, weight,
                                           BF16_TENSOR_FLOPS)}


def run_serving(profile: bool) -> dict:
    import io
    import threading
    import zipfile

    from audio_to_sheet_music_tpu_torch.apps import serve, serve_http
    from audio_to_sheet_music_tpu_torch.infer import chunked, streaming
    from audio_to_sheet_music_tpu_torch.ops import dsp
    from audio_to_sheet_music_tpu_torch.text.prompts import STEM_NAMES

    t_phase = t0 = time.perf_counter()
    sep = serve.build_separator(None, "config.yaml", device="cuda")
    service = serve_http.SeparationService(
        sep, pretrained=sep.pretrained, spectrograms=serve._has_matplotlib())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if sep.compute_dtype != torch.bfloat16 or sep.overlap != int(
            0.1 * SAMPLE_RATE):
        raise SmokeFailure(f"app separator: {sep.compute_dtype}, overlap "
                           f"{sep.overlap}; want bf16 and 0.1 s")
    hop = sep.segment - sep.overlap
    print(f"app separator (config.yaml: {sep.segment / SAMPLE_RATE:.1f} s "
          f"chunks, {sep.overlap / SAMPLE_RATE:.1f} s overlap, hop "
          f"{hop / SAMPLE_RATE:.2f} s) on {sep.device} in "
          f"{sep.compute_dtype}: set-up {setup_s:.2f} s; spectrograms "
          f"{'on' if service.spectrograms else 'off (no matplotlib)'}")

    t0 = time.perf_counter()
    tune = service.autotune_stream_block()
    tune_s = time.perf_counter() - t0
    block = tune["block"]
    print(f"autotune ({tune_s:.2f} s): block steps {tune['measured_s']} s "
          f"-> floor_s {tune['floor_s']}, per_chunk_s {tune['per_chunk_s']}; "
          f"chosen block {block}, predicted first audio "
          f"{tune['first_audio_s']} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        stream = streaming.StreamingSeparator(sep, stems=("vocals",),
                                              block_chunks=block)
        stream.feed(np.zeros((2, stream._span), np.float32))
    except torch.cuda.OutOfMemoryError as e:
        raise SmokeFailure(f"a block of {block} chunks does not fit: {e}")
    block_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gib = torch.cuda.memory_reserved() / 2 ** 30
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    print(f"  one block of {block} chunks (its program captured by the "
          f"autotune): peak device memory {block_gib:.2f} GiB allocated, "
          f"{reserved_gib:.2f} GiB reserved (the programs' pool included) of "
          f"{total_gib:.2f} GiB")
    del stream

    steps = {"n": 0}
    block_fn = sep._run_stream_block

    def counted(*args, **kwargs):
        steps["n"] += 1
        return block_fn(*args, **kwargs)

    sep._run_stream_block = counted

    song = _song(np.random.default_rng(SEED))
    n = song.shape[-1]
    pcm16 = (np.clip(song, -1.0, 1.0) * 32767.0).astype(np.int16)
    wav = _wav_bytes(pcm16)
    decoded = serve_http.decode_wav_bytes(wav)      # what the stream reads

    httpd = serve_http.make_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    result = {"setup_s": setup_s, "autotune": tune, "autotune_s": tune_s,
              "block_peak_gib": block_gib, "reserved_gib": reserved_gib}
    try:
        sent = {"separate": 0, "separate_stream": 0, "separate_all": 0}
        # two direct calls on the app separator's deterministic cuDNN
        # algorithms; with --profile two more with them off
        repeat = {}
        for det in (True, False) if profile else (True,):
            sep.deterministic = det
            a, b = (sep.separate_pcm(pcm16, "vocals") for _ in range(2))
            repeat["deterministic" if det else "free"] = _pcm_diff(a, b)
        sep.deterministic = True
        print("separate_pcm twice: max diff "
              + ", ".join(f"{v} int16 steps with cuDNN's {k} algorithms"
                          for k, v in repeat.items()))
        if repeat["deterministic"] > 1:
            raise SmokeFailure("separate_pcm does not repeat")
        result["repeat_lsb"] = repeat

        # /api/separate, int16 in and out
        got = _request(port, "POST", "/api/separate?prompt=vocals", wav)
        sent["separate"] += 1
        body = np.frombuffer(got["body"][44:], "<i2").reshape(n, 2).T
        direct = sep.separate_pcm(pcm16, "vocals")
        diff = _pcm_diff(body, direct)
        print(f"/api/separate: {got['wall_s']:.3f} s, {len(got['body'])} "
              f"bytes, max diff to separate_pcm {diff} int16 steps")
        if len(got["body"]) != 44 + 4 * n or diff > 1:
            raise SmokeFailure("/api/separate disagrees with separate_pcm")
        result["separate_s"] = got["wall_s"]

        # /api/separate/stream at block=auto (counted) and block=8
        stem = np.clip(sep.separate(decoded, "vocals"), -1.0, 1.0)
        streams = {}
        for name, arg in (("auto", "auto"),
                          (str(STREAM_FIXED_BLOCK), str(STREAM_FIXED_BLOCK))):
            counting = name == "auto"
            steps["n"] = 0
            torch.cuda.synchronize()
            if counting:
                _zero_counters()
            got = _request(port, "POST", "/api/separate/stream?prompt="
                           f"vocals&block={arg}", wav)
            if counting:
                launches = _read_counters()
            sent["separate_stream"] += 1
            if len(got["body"]) != 44 + 4 * n or got["length"] != 44 + 4 * n:
                raise SmokeFailure(f"stream block={arg}: {len(got['body'])} "
                                   f"bytes, want {44 + 4 * n}")
            out = np.frombuffer(got["body"][44:], "<i2").reshape(n, 2).T
            rms = float(np.sqrt(np.mean(
                (out[:, 1:-1] / 32767.0 - stem[:, 1:-1]) ** 2)))
            rate = SONG_SECONDS / got["wall_s"]
            streams[name] = {"block": block if arg == "auto" else int(arg),
                             "first_audio_s": got["first_s"],
                             "wall_s": got["wall_s"],
                             "audio_sec_per_sec": rate, "steps": steps["n"],
                             "rms_vs_separate": rms}
            print(f"/api/separate/stream block={arg}: first audio "
                  f"{got['first_s']:.3f} s, wall {got['wall_s']:.3f} s, "
                  f"{rate:.2f} audio-sec/sec (1 stem x "
                  f"{SONG_SECONDS:.0f} s), {steps['n']} block steps, rms "
                  f"vs separate {rms:.3e} (limit {PATH_RMS_LIMIT:.0e})")
            if not (math.isfinite(rms) and rms < PATH_RMS_LIMIT):
                raise SmokeFailure(f"stream block={arg} diverges from "
                                   "separate")
            if counting:
                used = {k: v for k, v in launches.items() if v}
                streams[name]["launches"] = launches
                print(f"  launches on the stream: {used} over "
                      f"{steps['n']} steps")
                if (launches["layer_tail"] != 10 * steps["n"]
                        or launches["henc_freq_fused"] != steps["n"]
                        or launches["dec_join"] != 8 * steps["n"]
                        or steps["n"] <= 0):
                    raise SmokeFailure("the stream did not run layer_tail "
                                       "10, henc_freq_fused once and "
                                       "dec_join 8 times a step")
        result["stream"] = streams

        # /api/separate_all, 4 stems, against a direct separate_all_pcm
        # (run once before, so neither side pays a first call)
        sep.separate_all_pcm(pcm16, stems=STEM_NAMES)
        got = _request(port, "POST", "/api/separate_all", wav)
        sent["separate_all"] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pcm, scales = sep.separate_all_pcm(pcm16, stems=STEM_NAMES)
        direct_s = time.perf_counter() - t0
        with zipfile.ZipFile(io.BytesIO(got["body"])) as zf:
            saved = json.loads(zf.read("scales.json"))
            worst = 0
            for i, name in enumerate(STEM_NAMES):
                entry = f"extracted_{name}.wav"
                data = zf.read(entry)
                part = np.frombuffer(data[44:], "<i2").reshape(n, 2).T
                worst = max(worst, _pcm_diff(part, pcm[i]))
                if saved[entry] != float(scales[i]):
                    raise SmokeFailure(f"scales.json {entry}: "
                                       f"{saved[entry]} != {scales[i]}")
        overhead = got["wall_s"] - direct_s
        print(f"/api/separate_all: {got['wall_s']:.3f} s against "
              f"{direct_s:.3f} s for separate_all_pcm: server overhead "
              f"{overhead * 1e3:.1f} ms; max diff {worst} int16 steps")
        if worst > 1:
            raise SmokeFailure("/api/separate_all disagrees with "
                               "separate_all_pcm")
        result.update(separate_all_s=got["wall_s"], direct_s=direct_s,
                      overhead_s=overhead,
                      separate_all_bytes=len(got["body"]))

        # JSON mode
        got = _request(port, "POST", "/api/separate?prompt=vocals"
                       "&format=json", wav)
        sent["separate"] += 1
        payload = json.loads(got["body"])
        with_png = bool(payload["spec_in_png_b64"])
        if not payload["stem_wav_b64"] or with_png != service.spectrograms:
            raise SmokeFailure("JSON mode: no stem, or spectrograms "
                               f"{with_png} with the service's "
                               f"{service.spectrograms}")
        print(f"/api/separate?format=json: {got['wall_s']:.3f} s, "
              f"spectrograms {'carried' if with_png else 'empty'}")
        result["json_spectrograms"] = with_png

        health = json.loads(_request(port, "GET", "/api/health")["body"])
        metrics = json.loads(_request(port, "GET", "/api/metrics?format=json"
                                      )["body"])
        counted_eps = {k: v["requests"] for k, v in
                       metrics["endpoints"].items()}
        busy = metrics["device_busy_seconds"] / metrics["uptime_seconds"]
        print(f"/api/health: requests_served {health['requests_served']}, "
              f"stream_block {health['stream_block']}; /api/metrics: "
              f"{counted_eps}, device lock busy "
              f"{metrics['device_busy_seconds']:.2f} s of "
              f"{metrics['uptime_seconds']:.2f} s ({busy:.1%})")
        if (counted_eps != sent or health["requests_served"] != sum(
                sent.values()) or health["stream_block"] != block):
            raise SmokeFailure(f"request counts {counted_eps} / "
                               f"{health['requests_served']}, sent {sent}")
        server_s = metrics["endpoints"]["separate_all"]["seconds"]
        print(f"  /api/separate_all split: {server_s:.3f} s in the server "
              f"(WAV decode, separate_all_pcm, zip), "
              f"{result['separate_all_s'] - server_s:.3f} s in transport "
              f"and the client (upload, "
              f"{result['separate_all_bytes'] / 1e6:.1f} MB of zip over "
              "loopback, HTTP parsing)")
        result.update(requests=sent, busy_share=busy, metrics=metrics,
                      separate_all_server_s=server_s)
    finally:
        sep._run_stream_block = block_fn
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    blocks = {}                    # block size -> its steps on the streams
    for s_ in streams.values():
        blocks[s_["block"]] = blocks.get(s_["block"], 0) + s_["steps"]
    n_sep = chunked.plan_chunks(n, sep.segment, sep.overlap,
                                sep.bucket).n_chunks
    result["kernels"] = stream_kernels(blocks, n_sep)

    mono = torch.from_numpy(song.mean(axis=0))
    with torch.inference_mode():
        on_card = dsp.spectrogram_db(mono.cuda()).cpu()
        on_cpu = dsp.spectrogram_db(mono)
    err = float((on_card - on_cpu).abs().max())
    print(f"spectrogram_db {tuple(on_card.shape)} on the card vs the CPU: "
          f"max diff {err:.3e} dB (limit {SPEC_DB_LIMIT:.0e})")
    if not err <= SPEC_DB_LIMIT:
        raise SmokeFailure("spectrogram_db on the card disagrees with the CPU")
    result["spectrogram_db_err"] = err
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 6 in {result['phase_s']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# Phase 7: reference checkpoints, the segment loader, the CLAP audio tower,
# CLAPSep and the embedding tool
# ---------------------------------------------------------------------------

CLAP_TOL = 1e-4            # f32 on the card against f32 on the CPU, no TF32
LOADER_STEPS = 4           # train steps a loader feeds in the A/B


def _replace(cfg, **sections):
    """``cfg`` with some fields of some sections replaced."""
    import dataclasses

    return dataclasses.replace(cfg, **{
        name: dataclasses.replace(getattr(cfg, name), **fields)
        for name, fields in sections.items()})


def _pt_round_trip(card: str, model, song: np.ndarray, launches3: dict,
                   root: Path) -> dict:
    """Export, re-import, serve and train from a reference-style ``.pt``."""
    import os

    from audio_to_sheet_music_tpu_torch.convert.torch_import import (
        export_atht_checkpoint)
    from audio_to_sheet_music_tpu_torch.infer.session import Separator
    from audio_to_sheet_music_tpu_torch.models import atht
    from audio_to_sheet_music_tpu_torch.text.prompts import STEM_PROMPTS
    from audio_to_sheet_music_tpu_torch.text.tokenizer import write_bpe_vocab
    from audio_to_sheet_music_tpu_torch.train import trainer

    path = root / "model.pt"
    t0 = time.perf_counter()
    export_atht_checkpoint(model, path, epoch=1, metrics={"val_sdr": 0.0})
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = atht.load_params(atht.init(1, device="cuda"), path)
    read_s = time.perf_counter() - t0
    size_mb = path.stat().st_size / 1e6
    want = model.state_dict()
    unequal = [k for k, v in loaded.state_dict().items()
               if not torch.equal(v, want[k].to(v.device))]
    print(f".pt round trip at full width: {size_mb:.1f} MB, write "
          f"{write_s:.2f} s, read + convert {read_s:.2f} s, "
          f"{len(want)} tensors, unequal {len(unequal)}, pretrained "
          f"{loaded.pretrained}")
    if unequal or not loaded.pretrained:
        raise SmokeFailure(f"the .pt round trip changed {unequal[:3]}")

    saved_env = os.environ.pop("ATSM_TOKENIZER_DIR", None)
    try:
        Separator(loaded, device="cuda")
    except RuntimeError as e:
        refused = str(e).split(".")[0]
    else:
        raise SmokeFailure("a pretrained Separator took the hash tokenizer")
    print(f"  pretrained Separator without a vocabulary: refused "
          f"({refused})")
    vocab = write_bpe_vocab([p for ps in STEM_PROMPTS.values() for p in ps],
                            root / "vocab")
    os.environ["ATSM_TOKENIZER_DIR"] = str(vocab)
    try:
        sep = Separator(loaded, device="cuda")
        sep.separate_all_pcm(song)          # captures the group programs
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.perf_counter()
        pcm, _ = sep.separate_all_pcm(song)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _read_counters().items()
                    if k in launches3}
        rate = 4 * SONG_SECONDS / wall
        print(f"  separate_all_pcm of the 60 s song from the .pt with the BPE "
              f"tokenizer: {wall:.3f} s, {rate:.2f} audio-sec/sec, launches "
              f"{launches} (phase 3: {launches3})")
        if launches != launches3 or np.abs(pcm).max() == 0:
            raise SmokeFailure("serving from the .pt did not run the "
                               "kernels as phase 3 did")
        del sep

        # the model train() converts from resume_from without one, made
        # here so that its towers can be read after the steps
        cfg = _replace(_train_config(root), training={"resume_from": str(
            path)}, wandb={"checkpoint_dir": str(root / "ckpt_pt"),
                           "output_dir": str(root / "out_pt")})
        trained = atht.load_params(atht.init(0, device="cuda"), path)
        t0 = time.perf_counter()
        res = trainer.train(cfg, model=trained, max_steps_per_epoch=2,
                            device="cuda")
        train_s = time.perf_counter() - t0
    finally:
        os.environ.pop("ATSM_TOKENIZER_DIR", None)
        if saved_env is not None:
            os.environ["ATSM_TOKENIZER_DIR"] = saved_env
    changed = [k for k, v in trained.state_dict().items()
               if not k.startswith("head.") and not torch.equal(
                   v.cpu(), want[k].cpu())]
    print(f"  train(resume_from=.pt): 2 steps + validation in {train_s:.2f} s, "
          f"loss {res['final_loss']:.5f}, val SDR {res['best_sdr']:.3f} dB, "
          f"pretrained {trained.pretrained}, towers changed {len(changed)}")
    if (not math.isfinite(res["final_loss"]) or changed
            or not trained.pretrained or not math.isfinite(res["best_sdr"])):
        raise SmokeFailure("training from the .pt failed its checks")
    del trained
    return {"size_mb": size_mb, "write_s": write_s, "read_s": read_s,
            "tensors": len(want), "serve_s": wall, "audio_sec_per_sec": rate,
            "launches": launches, "train_s": train_s,
            "train_loss": res["final_loss"], "train_val_sdr": res["best_sdr"]}


def _loader_ab(model, root: Path) -> dict:
    """The C++ segment loader against the Python one: build, the epoch
    through ``train``, batches/s, and the steps/s and device busy share of
    one traced run of the train steps each feeds."""
    from audio_to_sheet_music_tpu_torch.data import (BatchLoader,
                                                     StemSegmentDataset,
                                                     discover_tracks,
                                                     native_loader)
    from audio_to_sheet_music_tpu_torch.text.tokenizer import HashTokenizer
    from audio_to_sheet_music_tpu_torch.train import step as tstep
    from audio_to_sheet_music_tpu_torch.train.trainer import put_batch, train

    fresh = not native_loader.library_path().exists()
    t0 = time.perf_counter()
    native_loader.load_library()
    built = time.perf_counter() - t0
    print(f"segment loader {native_loader.library_path().name}: "
          + ("g++ build and load" if fresh else "load (built before)")
          + f" {built:.2f} s")
    tracks = discover_tracks(root / "train")
    cfg = _replace(_train_config(root), training={"num_workers": 4},
                   wandb={"checkpoint_dir": str(root / "ckpt_native"),
                          "output_dir": str(root / "out_native")})
    res = train(cfg, model=model, device="cuda")
    steps = [json.loads(x) for x in (root / "out_native" / "metrics.jsonl"
                                     ).read_text().splitlines()]
    losses = [r["train/loss/total"] for r in steps if "train/loss/total" in r]
    print(f"  train() with num_workers=4: {len(losses)} steps, "
          f"{res['steps_per_s']:.3f} steps/s over the epoch, losses "
          f"{[round(x, 4) for x in losses]}")
    if not losses or not all(map(math.isfinite, losses)):
        raise SmokeFailure("training on the segment loader failed")

    seg = cfg.data.segment_samples
    loaders = {
        "native": lambda: native_loader.NativeBatchLoader(
            [t.path for t in tracks], seg, TRAIN_B, HashTokenizer(),
            n_threads=4),
        "python": lambda: BatchLoader(StemSegmentDataset(tracks, seg),
                                      TRAIN_B, HashTokenizer())}
    arrs = [t.load(mmap=False) for t in tracks]
    first = next(iter(loaders["native"]()))
    for i in range(TRAIN_B):
        stem = int(first["stem_index"][i]) + 1
        if not any(np.array_equal(first["mixture"][i], a[0, :, s:s + seg])
                   and np.array_equal(first["target"][i], a[stem, :, s:s + seg])
                   for a in arrs for s in range(0, a.shape[-1] - seg + 1, seg)):
            raise SmokeFailure(f"native batch item {i} is not a segment of a "
                               "track")
    out = {"build_s": built, "built_here": fresh,
           "train_steps_per_s": res["steps_per_s"], "train_losses": losses}
    for name, make in loaders.items():
        loader = make()
        t0 = time.perf_counter()
        n = sum(1 for _ in range(2) for _ in loader)
        bps = n / (time.perf_counter() - t0)
        state = tstep.TrainState.create(model, lambda p: tstep.make_optimizer(p))
        step = tstep.make_train_step({}, torch.bfloat16, True)

        def steps_from(loader=loader, step=step, state=state):
            done = 0
            while done < LOADER_STEPS:
                for raw in loader:
                    step(state, put_batch(raw, torch.device("cuda")))
                    done += 1
                    if done == LOADER_STEPS:
                        break
            torch.cuda.synchronize()

        t0 = time.perf_counter()
        prof = device_busy(steps_from)
        prof_s = time.perf_counter() - t0
        sps = LOADER_STEPS / prof["wall_ms"] * 1e3
        busy = prof["busy_ms"] / prof["wall_ms"]
        print(f"  {name} loader: {bps:.2f} batches/s ({n} batches of "
              f"{TRAIN_B} x {CHUNK_SECONDS:.0f} s); {LOADER_STEPS} default "
              f"train steps it feeds, traced: {sps:.3f} steps/s, device "
              f"busy {busy:.1%} ({prof['busy_ms']:.1f} of "
              f"{prof['wall_ms']:.1f} ms; the traced call took "
              f"{prof_s:.2f} s)")
        out[name] = {"batches_per_s": bps, "steps_per_s": sps,
                     "busy_share": busy, "busy_ms": prof["busy_ms"],
                     "wall_ms": prof["wall_ms"], "profile_s": prof_s}
    return out


def _clap_audio(card: str, text_tower, stems: np.ndarray) -> dict:
    """The full-width CLAP audio tower on the 4 stems, f32."""
    from audio_to_sheet_music_tpu_torch.models import clap, clap_audio
    from audio_to_sheet_music_tpu_torch.nn import prng
    from audio_to_sheet_music_tpu_torch.ops import mel
    from audio_to_sheet_music_tpu_torch.text.prompts import STEM_NAMES
    from audio_to_sheet_music_tpu_torch.text.tokenizer import HashTokenizer
    from audio_to_sheet_music_tpu_torch.utils import audio_io

    audio = clap_audio.ClapAudio(key=prng.PRNGKey(SEED, "cuda"))
    model = clap.Clap(text_tower, audio).cuda()
    mono48 = audio_io.resample(stems.mean(axis=1), SAMPLE_RATE,
                               mel.SAMPLE_RATE)                  # (4, T)
    feats = torch.cat([mel.prepare_input_features(m, device="cuda")
                       for m in mono48])                         # (4,1,1001,64)
    ids, mask = HashTokenizer()(list(STEM_NAMES))
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    with torch.inference_mode():
        emb = clap.get_audio_features(model, feats)
        per_audio, per_text = clap.similarity(model, ids, mask, feats)
        one = clap_audio.audio_embeds(model.audio, feats[:1]).cpu()
        ms1 = cuda_ms(lambda: clap_audio.audio_embeds(model.audio, feats[:1]),
                      5)
        ms4 = cuda_ms(lambda: clap.get_audio_features(model, feats), 5)
    with torch.inference_mode():
        ref = clap_audio.audio_embeds(audio.cpu(), feats[:1].cpu())
    err = float((one - ref).abs().max())
    scale = float(ref.abs().max())
    norms = emb.float().norm(dim=-1)
    print(f"CLAP audio tower (HTSAT, {sum(p.numel() for p in audio.parameters()) / 1e6:.2f} M, f32) on {card}: "
          f"get_audio_features of 4 stems {ms4:.2f} ms, audio_embeds of 1 "
          f"{ms1:.2f} ms; |feature| - 1 max {float((norms - 1).abs().max()):.2e}; "
          f"logits {tuple(per_audio.shape)} finite "
          f"{bool(torch.isfinite(per_audio).all())}; card vs CPU max err "
          f"{err:.3e} (limit {CLAP_TOL:.0e} x {scale:.3e})")
    if not (torch.isfinite(per_audio).all() and torch.isfinite(per_text).all()
            and float((norms - 1).abs().max()) <= 1e-5
            and err <= CLAP_TOL * scale):
        raise SmokeFailure("the CLAP audio tower failed its checks")
    return {"ms_1": ms1, "ms_4": ms4, "max_err": err, "ref_max": scale,
            "logits_per_audio": per_audio.cpu().tolist()}


def _clapsep(card: str, song: np.ndarray, root: Path) -> dict:
    """CLAPSep at full width on the 60 s song, a chunk against the CPU, and
    ``cli benchmark`` with it."""
    from audio_to_sheet_music_tpu_torch.eval.models import CLAPSepModel
    from audio_to_sheet_music_tpu_torch.infer import chunked
    from audio_to_sheet_music_tpu_torch.models import clapsep
    from audio_to_sheet_music_tpu_torch.text.prompts import STEM_NAMES

    m = CLAPSepModel(device="cuda")
    n_params = clapsep.param_count(m.model)
    m.separate(song, "vocals")                                   # warm
    seg = int(m.chunk_seconds * clapsep.SAMPLE_RATE)
    n32 = int(math.ceil(song.shape[-1] * clapsep.SAMPLE_RATE / SAMPLE_RATE))
    chunks = chunked.plan_chunks(n32, seg, int(
        m.overlap_seconds * clapsep.SAMPLE_RATE), bucket=2).n_chunks
    walls = {}
    torch.cuda.reset_peak_memory_stats()
    for stem in STEM_NAMES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.separate(song, stem)
        walls[stem] = time.perf_counter() - t0
        if out.shape != song.shape or not np.isfinite(out).all():
            raise SmokeFailure(f"CLAPSep {stem}: {out.shape}, finite "
                               f"{np.isfinite(out).all()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"CLAPSep ({n_params / 1e6:.2f} M, f32) on {card}: 60 s song, "
          f"{chunks} chunks of 10 s a stem: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; peak device memory {peak:.2f} GiB")

    r = np.random.default_rng(SEED)
    wav = torch.from_numpy((0.1 * r.standard_normal((1, seg))).astype(
        np.float32))
    ep = torch.from_numpy(r.standard_normal((1, 512)).astype(np.float32))
    en = torch.from_numpy(r.standard_normal((1, 512)).astype(np.float32))
    with torch.inference_mode():
        got = clapsep.forward(m.model, wav.cuda(), ep.cuda(), en.cuda()).cpu()
        ms = cuda_ms(lambda: clapsep.forward(m.model, wav.cuda(), ep.cuda(),
                                             en.cuda()), 3)
        ref = clapsep.forward(m.model.cpu(), wav, ep, en)
    rms = float((got - ref).pow(2).mean().sqrt())
    ref_rms = float(ref.pow(2).mean().sqrt())
    print(f"  one 10 s chunk: {ms:.2f} ms on the card; card vs CPU rms err "
          f"{rms:.3e} (limit {CLAP_TOL:.0e} x rms(ref) {ref_rms:.3e})")
    if not rms <= CLAP_TOL * ref_rms:
        raise SmokeFailure("CLAPSep on the card disagrees with the CPU")
    del m
    t0 = time.perf_counter()
    payload = _benchmark_cli(root / "bench_clapsep", "default",
                             ("ours", "clapsep"),
                             ("AudioTextHTDemucs (Ours)",
                              "CLAPSep (random init)"))
    bench_s = time.perf_counter() - t0
    agg = {k: v["aggregate"]["sdr"]["average"] for k, v in payload.items()}
    print(f"  cli benchmark --models ours clapsep ({EVAL_TRACKS} tracks): "
          f"{bench_s:.2f} s, average SDR {agg}")
    return {"params_m": n_params / 1e6, "chunks": chunks, "wall_s": walls,
            "peak_mem_gib": peak, "chunk_ms": ms, "chunk_rms_err": rms,
            "chunk_ref_rms": ref_rms, "bench_s": bench_s, "bench_sdr": agg}


def _embedding_tool(card: str, model) -> dict:
    """``embed_prompts`` and ``analyze_clustering`` on the card against
    the CPU (a copy of the text tower), and the Word2Vec leg."""
    import copy
    import types

    from audio_to_sheet_music_tpu_torch.apps import embedding_tool as tool
    from audio_to_sheet_music_tpu_torch.text import word2vec

    prompts, cats = tool.collect_prompts()
    t0 = time.perf_counter()
    got = tool.embed_prompts(prompts, model=model, device="cuda")
    card_s = time.perf_counter() - t0
    on_cpu = types.SimpleNamespace(clap=copy.deepcopy(model.clap).cpu(),
                                   pretrained=model.pretrained)
    ref = tool.embed_prompts(prompts, model=on_cpu, device="cpu")
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    a, b = tool.analyze_clustering(got, cats), tool.analyze_clustering(ref,
                                                                       cats)
    w2v = word2vec.load_or_train()
    w_emb, kept, idx = word2vec.embed_texts(w2v, prompts)
    w_stats = tool.analyze_clustering(w_emb, [cats[i] for i in idx])
    diff = max(abs(a[k] - b[k]) for k in a)
    print(f"embedding tool on {card}: {len(prompts)} prompts in {card_s:.3f} s, "
          f"card vs CPU max err {err:.3e} (limit {CLAP_TOL:.0e} x "
          f"{scale:.3e}), clustering diff {diff:.2e}, CLAP separation "
          f"{a['separation']:.4f}, word2vec ({w2v.backend}, {len(kept)} "
          f"prompts) separation {w_stats['separation']:.4f}")
    if not (err <= CLAP_TOL * scale and diff <= CLAP_TOL and len(kept) >= 2):
        raise SmokeFailure("the embedding tool on the card disagrees with "
                           "the CPU")
    return {"max_err": err, "clustering": a, "word2vec": w_stats}


def run_checkpoints_towers(card: str, model, stems: np.ndarray,
                           launches3: dict) -> dict:
    import tempfile

    from audio_to_sheet_music_tpu_torch.data import synthetic_tracks

    t_phase = time.perf_counter()
    print(f"phase 7 on {card}")
    song = _song(np.random.default_rng(SEED))
    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p7_") as tmp:
        root = Path(tmp)
        synthetic_tracks(4, seconds=12.0, cache_dir=root / "train", seed=SEED)
        synthetic_tracks(1, seconds=12.0, cache_dir=root / "test",
                         seed=SEED + 1)
        parts = (("pt", lambda: _pt_round_trip(card, model, song, launches3,
                                               root)),
                 ("loader", lambda: _loader_ab(model, root)),
                 ("clap_audio", lambda: _clap_audio(card, model.clap, stems)),
                 ("clapsep", lambda: _clapsep(card, song, root)),
                 ("embedding", lambda: _embedding_tool(card, model)))
        for name, run in parts:
            t0 = time.perf_counter()
            result[name] = run()
            result[name]["part_s"] = time.perf_counter() - t0
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 7 in {result['phase_s']:.1f} s: "
          + ", ".join(f"{k} {v['part_s']:.1f} s" for k, v in result.items()
                      if isinstance(v, dict)))
    return result


# ---------------------------------------------------------------------------
# Phase 8: the kernel gate and several devices
# ---------------------------------------------------------------------------

def _stem_rms(pcm: np.ndarray, scales: np.ndarray, ref: dict,
              stems) -> float:
    """Largest per-stem rms of (dequantised PCM - the float stem)."""
    dq = pcm.astype(np.float32) * (scales[:, None, None] / 32767.0)
    return max(float(np.sqrt(np.mean((dq[i] - ref[s]) ** 2)))
               for i, s in enumerate(stems))


def _sync_points(fn) -> dict:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: each
    place where the host waited for the card, as "the innermost line of
    the port -> the line that made the call", with its count."""
    import traceback
    import warnings
    from collections import Counter

    found: Counter = Counter()

    def short(path: str) -> str:
        return "/".join(Path(path).parts[-3:])

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack
                if "audio_to_sheet_music_tpu_torch" in f.filename]
        where = port[-1] if port else stack[-1]
        found[f"{short(where.filename)}:{where.lineno} -> "
              f"{short(filename)}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(found)


def _mesh_sweep(label: str, model, mesh, song: np.ndarray, pcm3: np.ndarray,
                ref_all: dict) -> dict:
    """``separate_all_pcm`` of the song on ``mesh``: warm, then timed with
    the launch counters set to 0 just before and read just after."""
    from audio_to_sheet_music_tpu_torch.infer import chunked
    from audio_to_sheet_music_tpu_torch.infer.session import Separator

    sep = Separator(model, mesh=mesh)
    grid = chunked.plan_chunks(song.shape[-1], sep.segment, sep.overlap,
                               sep.bucket)
    schedule = sep._group_schedule(grid, 4)
    sep.separate_all_pcm(song)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    pcm, scales = sep.separate_all_pcm(song)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    diff = _pcm_diff(pcm, pcm3)
    rms = _stem_rms(pcm, scales, ref_all, STEMS4)
    rate = 4 * SONG_SECONDS / wall
    print(f"  {label} ({mesh.size} slices on "
          f"{[str(d) for d in mesh.devices]}): schedule {schedule}, wall "
          f"{wall:.3f} s, {rate:.2f} audio-sec/sec, int16 diff vs phase 3 "
          f"{diff}, rms vs separate_all {rms:.3e} (limit "
          f"{PATH_RMS_LIMIT:.0e}), launches {launches}")
    for name in ("layer_tail", "henc_freq_fused"):
        if launches[name] <= 0:
            raise SmokeFailure(f"{label}: {name} was not launched")
    if not (math.isfinite(rms) and rms < PATH_RMS_LIMIT):
        raise SmokeFailure(f"{label}: the sharded sweep differs from the "
                           "single-device one")
    return {"devices": [str(d) for d in mesh.devices], "schedule": schedule,
            "wall_s": wall, "audio_sec_per_sec": rate, "pcm_diff_lsb": diff,
            "rms_vs_separate_all": rms, "launches": launches,
            "separator": sep}


def _cli_train_dp(root: Path) -> subprocess.Popen:
    """``cli train --data-parallel`` (every visible card, NCCL) on phase
    4's synthetic tracks: 2 steps of 8 x 6 s and the validation batch."""
    from audio_to_sheet_music_tpu_torch.data import synthetic_tracks

    synthetic_tracks(4, seconds=12.0, cache_dir=root / "train", seed=SEED)
    synthetic_tracks(1, seconds=12.0, cache_dir=root / "test", seed=SEED + 1)
    cfg = root / "dp.yaml"
    cfg.write_text(
        f"data:\n  train_dir: {root / 'train'}\n  test_dir: {root / 'test'}\n"
        f"  segment_seconds: {CHUNK_SECONDS}\n"
        f"training:\n  batch_size: {TRAIN_B}\n  num_epochs: 1\n"
        f"wandb:\n  log_every: 1\n  validate_every: 1\n  save_every: 1\n"
        f"  checkpoint_dir: {root / 'ckpt'}\n  output_dir: {root / 'out'}\n")
    return subprocess.Popen(
        [sys.executable, "-m", "audio_to_sheet_music_tpu_torch.cli", "train",
         "--config", str(cfg), "--data-parallel", "--max-steps-per-epoch",
         "2"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run_parallel_gate(card: str, path: dict, pcm3: np.ndarray) -> dict:
    import tempfile

    from audio_to_sheet_music_tpu_torch.models import atht
    from audio_to_sheet_music_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    print(f"phase 8 on {card}")
    # phase 3's model as it was: phase 7 trained that one's head
    model = atht.load_params(atht.init(SEED, device="cuda"))
    out = _gate_and_mesh(model, path, pcm3)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p8_") as tmp:
        t0 = time.perf_counter()
        cli = _cli_train_dp(Path(tmp))     # runs beside the DP step
        try:
            batch = dryrun.make_batch(TRAIN_B, CHUNK_SECONDS)
            dp = dryrun.dp_step(2, [batch], ["cuda:0", "cuda:0"], "gloo",
                                "trained", torch.bfloat16, "opt_in")
            out["dp_step"] = {k: dp[k] for k in (
                "head_delta", "loss_delta", "ranks_agree", "dp_seconds",
                "single_seconds")}
            out["dp_step"]["loss"] = dp["dp"]["metrics"]["loss/total"]
            out["dp_step"]["rank0_launches"] = dp["dp"]["launches"]
            print(f"  2 gloo ranks on cuda:0, one opt-in step of "
                  f"{TRAIN_B} x {CHUNK_SECONDS:.0f} s: loss "
                  f"{out['dp_step']['loss']:.5f}, head delta "
                  f"{dp['head_delta']:.3e}, loss delta {dp['loss_delta']:.3e}"
                  f" (limits 1e-3), ranks agree {dp['ranks_agree']}, rank 0 "
                  f"launches {dp['dp']['launches']}, {dp['dp_seconds']:.1f} s")
            if not (dp["head_delta"] < 1e-3 and dp["loss_delta"] < 1e-3
                    and dp["ranks_agree"]):
                raise SmokeFailure("the data-parallel step differs from the "
                                   "single-device step")
            log, _ = cli.communicate(timeout=300)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.communicate()
        out["cli_train"] = _check_cli_train(Path(tmp), cli.returncode, log,
                                            time.perf_counter() - t0)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 8 in {out['phase_s']:.1f} s")
    return out


def _check_cli_train(root: Path, rc: int, log: str, seconds: float) -> dict:
    lines = [json.loads(x) for x in (root / "out" / "metrics.jsonl")
             .read_text().splitlines()] if rc == 0 else []
    steps = [r["train/loss/total"] for r in lines if "train/loss/total" in r]
    val = [r["val/sdr"] for r in lines if "val/sdr" in r]
    ckpt = (root / "ckpt" / "latest" / "state.pt").exists()
    print(f"  cli train --data-parallel ({torch.cuda.device_count()} NCCL "
          f"rank(s)): exit {rc}, losses {steps}, val SDR {val}, rank 0 "
          f"checkpoint {ckpt}, done {seconds:.1f} s after the DP step began")
    if rc != 0 or len(steps) != 2 or not all(map(math.isfinite, steps)) \
            or not ckpt:
        raise SmokeFailure("cli train --data-parallel failed:\n" + log[-3000:])
    return {"losses": steps, "val_sdr": val, "checkpoint": ckpt}


def _gate_and_mesh(model, path: dict, pcm3: np.ndarray) -> dict:
    """Phase 8's legs in this process: the gate, the mesh sweeps, the
    host's waits in ``_heads``, the mesh stream, ``sweep_flops``."""
    from audio_to_sheet_music_tpu_torch.infer.session import Separator
    from audio_to_sheet_music_tpu_torch.infer.streaming import (
        StreamingSeparator)
    from audio_to_sheet_music_tpu_torch.ops import kernel_gate
    from audio_to_sheet_music_tpu_torch.ops.select import (NONE,
                                                           KernelSelection)
    from audio_to_sheet_music_tpu_torch.parallel import make_mesh
    from audio_to_sheet_music_tpu_torch.utils import profiling

    out: dict = {}
    gate = path["gate"]
    print(f"  gate of phase 3's Separator: {gate}")
    if gate is None or not gate["ok"] or not gate["rms"] < PATH_RMS_LIMIT:
        raise SmokeFailure("phase 3's gate did not run or did not pass")
    if not all(gate["launches"].get(k) for k in ("layer_tail",
                                                  "henc_freq_fused")):
        raise SmokeFailure("phase 3's gate did not launch layer_tail and "
                           "henc_freq_fused in its kernel pass")
    out["gate_default"] = gate
    _zero_counters()
    opt_in = kernel_gate.ensure_layer_parity(model, torch.bfloat16,
                                             kernels="opt_in")
    out["gate_opt_in_launches"] = _read_counters()
    print(f"  gate at opt_in: {opt_in}, launches "
          f"{out['gate_opt_in_launches']}")
    if opt_in is None or not opt_in["ok"]:
        raise SmokeFailure("the opt-in gate did not run or did not pass")
    out["gate_opt_in"] = opt_in
    fwd, args = model.gate_pair(torch.bfloat16)

    def diverging(sel, *a):
        y = fwd(sel, *a)
        return y if sel == NONE else y + 1e-2

    try:
        kernel_gate.ensure_layer_parity(model, torch.bfloat16,
                                        kernels=KernelSelection(layer=True),
                                        forward=diverging, args=args)
    except kernel_gate.KernelParityError as e:
        print(f"  injected divergence raised: {e}")
        out["gate_injected"] = kernel_gate.last_result()
    else:
        raise SmokeFailure("an injected divergence did not raise")

    song = _song(np.random.default_rng(SEED))
    single = Separator(model)
    ref_all = single.separate_all(song)
    for label, mesh in (("mesh_all_cards", make_mesh()),
                        ("mesh_2_replicas",
                         make_mesh(["cuda:0", "cuda:0"]))):
        out[label] = _mesh_sweep(label, model, mesh, song, pcm3, ref_all)
    sep2 = out["mesh_2_replicas"].pop("separator")
    out["mesh_all_cards"].pop("separator")

    with torch.inference_mode():
        grid_song = torch.from_numpy(song[:, :4 * sep2.segment]).cuda()
        chunks = torch.stack([grid_song[:, i * sep2.segment:
                                        (i + 1) * sep2.segment]
                              for i in range(4)])
        embs = sep2.serving.stem_inputs(STEMS4)
        sep2._heads(chunks, embs)
        torch.cuda.synchronize()
        out["sync_points"] = _sync_points(lambda: sep2._heads(chunks, embs))
    print(f"  host waits in one 4-chunk group on the 2-replica mesh "
          f"(file:line: count): {out['sync_points']}")
    if out["sync_points"]:
        raise SmokeFailure("_heads makes the host wait for the card between "
                           "the replicas' launches")

    stream = StreamingSeparator(sep2, stems=("vocals",), block_chunks=3)
    want = single.separate(song, "vocals")
    t0 = time.perf_counter()
    pieces = stream.feed(song)
    pieces.append(stream.flush())
    wall = time.perf_counter() - t0
    got = np.concatenate([p[0] for p in pieces], axis=-1)
    rms = float(np.sqrt(np.mean((got[:, 1:-1] - want[:, 1:-1]) ** 2)))
    print(f"  stream on the 2-replica mesh: block 3 -> "
          f"{stream.block_chunks}, {wall:.3f} s, rms vs separate {rms:.3e}")
    if stream.block_chunks != 4 or got.shape != song.shape \
            or not rms < PATH_RMS_LIMIT:
        raise SmokeFailure("the mesh stream differs from separate")
    out["stream"] = {"block_chunks": stream.block_chunks, "wall_s": wall,
                     "rms_vs_separate": rms}

    t0 = time.perf_counter()
    flops = single.sweep_flops(song.shape[-1], 4)
    count_s = time.perf_counter() - t0
    share = flops / (path["wall_s"] * profiling.peak_tflops() * 1e12)
    print(f"  sweep_flops(60 s, 4 stems) {flops:.4e} ({count_s:.2f} s): "
          f"{flops / path['wall_s'] / 1e12:.2f} TFLOP/s over phase 3's "
          f"wall {path['wall_s']:.3f} s, {share:.2%} of the "
          f"{profiling.peak_tflops():.0f} TFLOP/s bf16 peak")
    if not flops > 0:
        raise SmokeFailure("sweep_flops is not positive")
    out["sweep_flops"] = {"flops": flops, "phase3_wall_s": path["wall_s"],
                          "tensor_share": share}
    return out


# ---------------------------------------------------------------------------
# Phase 9: the learning proof
# ---------------------------------------------------------------------------

LEARN_STEPS = 240
# the JAX record (scripts/learning_proof.py, a TPU v5e): -4.37 -> +6.10 dB
LEARN_BEFORE_DB, LEARN_BEFORE_TOL = -4.37, 0.1
LEARN_AFTER_MIN_DB, LEARN_GAIN_MIN_DB = 4.0, 8.0


def run_learning_proof(card: str) -> dict:
    """``apps.learning_proof`` at full width: the seed-0 model with its
    random head, 240 default-selection steps, eval SDR before and after,
    with every launch counter set to 0 just before and read just after."""
    import tempfile

    from audio_to_sheet_music_tpu_torch.apps import learning_proof

    t_phase = time.perf_counter()
    print(f"phase 9 on {card}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p9_") as tmp:
        _zero_counters()
        res = learning_proof.run(steps=LEARN_STEPS, device="cuda",
                                 data_dir=tmp)
        launches = {k: v for k, v in _read_counters().items() if v}
    res.update(launches=launches, phase_s=time.perf_counter() - t_phase)
    print(f"  learning proof: {res['before_db']:.3f} -> {res['after_db']:.3f} "
          f"dB ({res['improvement_db']:+.3f}) after {res['steps']} steps at "
          f"{res['steps_per_s']:.2f} steps/s on {res['card']}; launches "
          f"{launches}; phase 9 in {res['phase_s']:.1f} s")
    if res["steps"] != LEARN_STEPS:
        raise SmokeFailure(f"{res['steps']} steps, want {LEARN_STEPS}")
    if not abs(res["before_db"] - LEARN_BEFORE_DB) <= LEARN_BEFORE_TOL:
        raise SmokeFailure(f"before training {res['before_db']:.3f} dB, the "
                           f"JAX record {LEARN_BEFORE_DB} +- "
                           f"{LEARN_BEFORE_TOL}")
    if not (res["after_db"] >= LEARN_AFTER_MIN_DB
            and res["improvement_db"] >= LEARN_GAIN_MIN_DB):
        raise SmokeFailure(f"after training {res['after_db']:.3f} dB "
                           f"({res['improvement_db']:+.3f}): want >= "
                           f"{LEARN_AFTER_MIN_DB} and >= +{LEARN_GAIN_MIN_DB}")
    for name in ("layer_tail", "henc_freq_fused"):
        if launches.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched by the learning "
                               "proof")
    return res


# ---------------------------------------------------------------------------
# Phase 10: the captured programs
# ---------------------------------------------------------------------------

# the eager port's record on the H100 before the programs: phase 3's peak
# memory, phase 6's stream step model
EAGER_PEAK_GIB = 4.94
EAGER_STREAM_FLOOR_S, EAGER_STREAM_PER_CHUNK_S = 0.0575, 0.0074


class _eager:
    """Inside the block ``sep`` runs each program's function eagerly (the
    group program's ``_group``, the stream's ``_stream_block``), on the
    same inputs moved to the card and with the same pipeline around them:
    the path the programs replace, for a comparison in one process."""

    def __init__(self, sep):
        self.sep = sep

    def __enter__(self):
        dev = self.sep.device

        def run(key, fn, *args):
            return fn(*(a.to(dev, non_blocking=True) for a in args))

        self.sep._run = run
        return self.sep

    def __exit__(self, *exc):
        del self.sep._run


def _pool_bytes(pool) -> int:
    """Bytes of device memory the caching allocator holds for the graph
    memory pool ``pool`` (a ``torch.cuda.graph_pool_handle()``)."""
    want = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == want)


def _programs_of(sep) -> dict:
    """Each program's key (as text) -> its capture seconds."""
    return {"/".join(map(str, key)): prog.capture_s
            for key, prog in sep._programs.items()}


# the device kernels each wrapper of the default path launches, by name
DEVICE_KERNELS = {"layer_tail": LAYER_TAIL_KERNELS,
                  "henc_freq_fused": HENC_KERNELS}


def _host_calls(fn) -> tuple:
    """``fn()`` then a synchronise under ``torch.profiler``: the CUDA
    runtime and driver API calls the host made, by name, and the device
    kernels of each ``DEVICE_KERNELS`` wrapper the card ran (a graph's
    kernels too: CUPTI traces each node of a replay)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = Counter(e.name for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith(("cuda", "cu")))
    device = Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA:
            for k, parts in DEVICE_KERNELS.items():
                if any(part in e.name for part in parts):
                    device[k] += 1
    return dict(host), {k: device[k] for k in DEVICE_KERNELS}


def _launches_from_host(calls: dict) -> int:
    return sum(n for name, n in calls.items() if name.startswith(HOST_LAUNCHES))


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _serving_programs(model, song: np.ndarray, path: dict) -> dict:
    """The group programs on a deterministic separator: capture, memory,
    launches through replays, bit-equality with the eager body, rates of
    both (programs, eager, eager, programs), host launches and waits."""
    from audio_to_sheet_music_tpu_torch.infer import chunked
    from audio_to_sheet_music_tpu_torch.infer.session import Separator

    # what the eager sweep holds: the caching allocator's segments (reserved)
    # are what a graph pool keeps for its programs' lifetime
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    eager_sep = Separator(model, device="cuda", deterministic=True)
    base, base_res = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    with _eager(eager_sep):
        eager_sep.separate_all_pcm(song)
    eager_mem = {"allocated_gib": (torch.cuda.max_memory_allocated() - base)
                 / 2 ** 30, "reserved_gib": (torch.cuda.max_memory_reserved()
                                             - base_res) / 2 ** 30}
    del eager_sep
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    sep = Separator(model, device="cuda", deterministic=True)
    t0 = time.perf_counter()
    first, scales = sep.separate_all_pcm(song)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 - base_gib
    reserved_gib = torch.cuda.memory_reserved() / 2 ** 30
    pool_gib = _pool_bytes(sep._pool) / 2 ** 30
    captured = _programs_of(sep)
    grid = chunked.plan_chunks(song.shape[-1], sep.segment, sep.overlap,
                               sep.bucket)
    schedule = sep._group_schedule(grid, 4)
    print(f"  separate_all_pcm, deterministic: warm-up (captures included) "
          f"{warm_s:.3f} s; {len(captured)} group programs for schedule "
          f"{schedule}, capture s {captured}; graph pool {pool_gib:.3f} GiB "
          f"reserved; peak device memory allocated above the model "
          f"{peak_gib:.3f} GiB (phase 3 eager, whole process: "
          f"{EAGER_PEAK_GIB} GiB); the process reserves {reserved_gib:.3f} "
          f"GiB; an eager sweep's first call on a fresh separator: peak "
          f"{eager_mem['allocated_gib']:.3f} GiB allocated, "
          f"{eager_mem['reserved_gib']:.3f} GiB reserved")
    if len(captured) != len(set(schedule)):
        raise SmokeFailure(f"{len(captured)} group programs for the "
                           f"schedule {schedule}")

    _zero_counters()
    pcm, _ = sep.separate_all_pcm(song)
    launches = {k: v for k, v in _read_counters().items() if v}
    with _eager(sep):
        t0 = time.perf_counter()
        eager, _ = sep.separate_all_pcm(song)
        torch.cuda.synchronize()
        eager_first_s = time.perf_counter() - t0
    diff = _pcm_diff(pcm, eager)
    print(f"  launches through {len(schedule)} replays {launches} (phase 3: "
          f"{path['launches']}); PCM against the eager _group: max diff "
          f"{diff} int16 steps (first call {_pcm_diff(first, eager)})")
    if launches != path["launches"]:
        raise SmokeFailure("the replays did not count phase 3's launches")
    if diff != 0 or _pcm_diff(first, eager) != 0:
        raise SmokeFailure("the programs' PCM is not the eager body's")

    walls = {"programs": [], "eager": []}
    for label in ("programs", "eager", "eager", "programs"):
        if label == "eager":
            with _eager(sep):
                walls[label].append(_timed(lambda: sep.separate_all_pcm(song)))
        else:
            walls[label].append(_timed(lambda: sep.separate_all_pcm(song)))
    rates = {k: 4 * SONG_SECONDS / (sum(v) / len(v)) for k, v in walls.items()}
    print(f"  separate_all_pcm walls (programs, eager, eager, programs) "
          f"{walls['programs'][0]:.4f}, {walls['eager'][0]:.4f}, "
          f"{walls['eager'][1]:.4f}, {walls['programs'][1]:.4f} s: "
          f"{rates['programs']:.2f} against {rates['eager']:.2f} "
          f"audio-sec/sec; the eager path's first call here "
          f"{eager_first_s:.3f} s")

    busy = device_busy(lambda: sep.separate_all_pcm(song))
    with _eager(sep):
        eager_busy = device_busy(lambda: sep.separate_all_pcm(song))
    print(f"  device busy in one separate_all_pcm: programs "
          f"{busy['busy_ms']:.1f} of {busy['wall_ms']:.1f} ms "
          f"({busy['busy_ms'] / busy['wall_ms']:.1%}), eager "
          f"{eager_busy['busy_ms']:.1f} of {eager_busy['wall_ms']:.1f} ms "
          f"({eager_busy['busy_ms'] / eager_busy['wall_ms']:.1%})")
    _zero_counters()
    calls, traced = _host_calls(lambda: sep.separate_all_pcm(song))
    booked = {k: v for k, v in _read_counters().items() if v}
    _zero_counters()
    with _eager(sep):
        eager_calls, eager_traced = _host_calls(
            lambda: sep.separate_all_pcm(song))
    counted = {k: v for k, v in _read_counters().items() if v}
    graphs = calls.get("cudaGraphLaunch", 0)
    kernels = _launches_from_host(calls) - graphs     # launches but replays
    print(f"  host calls in one separate_all_pcm: cudaGraphLaunch {graphs}, "
          f"kernel launches {kernels}, cudaMemcpyAsync "
          f"{calls.get('cudaMemcpyAsync', 0)} (eager: kernel launches "
          f"{_launches_from_host(eager_calls)}, cudaMemcpyAsync "
          f"{eager_calls.get('cudaMemcpyAsync', 0)})")
    if graphs != len(schedule) or kernels != 0:
        raise SmokeFailure(f"a replayed sweep made {graphs} graph launches "
                           f"for {len(schedule)} groups and {kernels} kernel "
                           f"launches from the host: {calls}")
    # the replays' launch counts are booked, not seen by a wrapper: hold
    # them against the kernels the card ran, which the eager body's
    # wrappers count as they launch
    print(f"  device kernels traced in that call, by wrapper: replays "
          f"{traced}, eager {eager_traced}; launches booked for the "
          f"replays {booked}, counted by the eager body's wrappers "
          f"{counted}")
    if (booked != counted or traced != eager_traced
            or any(traced[k] < counted.get(k, 0) or not counted.get(k)
                   for k in DEVICE_KERNELS)):
        raise SmokeFailure("the launches booked for the replays are not "
                           "what the card ran")

    waits = _sync_points(lambda: sep._enqueue_all_pcm(song, STEMS4, 4,
                                                      False))
    sep._copy_stream.synchronize()
    print(f"  host waits in separate_all_pcm before its last group is "
          f"enqueued (file:line: count): {waits}")
    if waits:
        raise SmokeFailure("separate_all_pcm makes the host wait for the "
                           "card before its last group is enqueued")
    return {"warmup_s": warm_s, "programs": captured, "pool_gib": pool_gib,
            "peak_gib_above_model": peak_gib, "reserved_gib": reserved_gib,
            "eager_memory": eager_mem, "launches": launches,
            "pcm_diff_lsb": diff, "walls_s": walls, "rates": rates,
            "eager_first_s": eager_first_s, "busy": busy,
            "eager_busy": eager_busy, "host_calls": calls,
            "eager_host_calls": eager_calls, "device_kernels": traced,
            "eager_device_kernels": eager_traced, "host_waits": waits,
            "scales": scales.tolist()}


def _stem_rms_each(pcm: np.ndarray, scales: np.ndarray, ref: dict) -> dict:
    dq = pcm.astype(np.float32) * (scales[:, None, None] / 32767.0)
    return {s: float(np.sqrt(np.mean((dq[i] - ref[s]) ** 2)))
            for i, s in enumerate(STEMS4)}


def _default_and_opt_in(model, song: np.ndarray) -> dict:
    """A default separator's programs against its own ``separate_all``
    (the whole-song program); the group programs under ``opt_in``, which
    hold rows 3-5 of the kernel table, against the eager body bit for bit
    and against the default; and ``opt_in`` without the STFT kernel."""
    from audio_to_sheet_music_tpu_torch.infer.session import Separator
    from audio_to_sheet_music_tpu_torch.ops.select import KernelSelection

    out = {}
    sep = Separator(model, device="cuda")
    pcm, scales = sep.separate_all_pcm(song)
    ref = sep.separate_all(song)
    rms = _stem_rms(pcm, scales, ref, STEMS4)
    out["default"] = {"rms_vs_separate_all": rms,
                      "programs": _programs_of(sep)}
    print(f"  default separator: separate_all_pcm against separate_all "
          f"(both programs) rms {rms:.3e} (limit {PATH_RMS_LIMIT:.0e}); "
          f"programs {out['default']['programs']}")
    if not (math.isfinite(rms) and rms < PATH_RMS_LIMIT):
        raise SmokeFailure("the default separator's programs disagree")
    del sep

    sep = Separator(model, device="cuda", kernels="opt_in",
                    deterministic=True)
    sep.separate_all_pcm(song)
    _zero_counters()
    pcm, scales = sep.separate_all_pcm(song)
    launches = {k: v for k, v in _read_counters().items() if v}
    with _eager(sep):
        eager, _ = sep.separate_all_pcm(song)
    diff = _pcm_diff(pcm, eager)
    vs_default = _stem_rms_each(pcm, scales, ref)
    out["opt_in"] = {"launches": launches, "pcm_diff_lsb": diff,
                     "rms_vs_default": vs_default,
                     "programs": _programs_of(sep)}
    print(f"  opt_in separator (deterministic): launches through replays "
          f"{launches}; PCM against the eager _group: max diff {diff} int16 "
          f"steps; rms against the default's separate_all per stem "
          f"{vs_default}; programs {out['opt_in']['programs']}")
    if (set(launches) != {"henc_freq_fused", "dconv_rows", "attn_block",
                          "stft", "group_norm", "dec_join"} or diff != 0):
        raise SmokeFailure("the opt-in group programs did not run rows 2-6 "
                           "and 9 or differ from the eager body")
    del sep

    # the head divides by the mixture's signed CaC plane + 1e-8, so the
    # STFT kernel's last-bit differences from cuFFT can show in a stem;
    # the other opt-in kernels are held to the default path
    sep = Separator(model, device="cuda", kernels=KernelSelection(
        enc=True, attn=True, dconv=True))
    pcm, scales = sep.separate_all_pcm(song)
    no_stft = _stem_rms_each(pcm, scales, ref)
    out["opt_in_no_stft"] = {"rms_vs_default": no_stft}
    print(f"  opt_in without the STFT kernel: rms against the default's "
          f"separate_all per stem {no_stft} (limit {PATH_RMS_LIMIT:.0e})")
    if not max(no_stft.values()) < PATH_RMS_LIMIT:
        raise SmokeFailure("opt_in without the STFT kernel disagrees with "
                           "the default")
    return out


def _stream(service, song: np.ndarray, block: int) -> dict:
    """The server's stream loop without HTTP: feed steps of ``block``
    hops, first audio at the first emitted piece."""
    from audio_to_sheet_music_tpu_torch.infer import streaming

    sep = service.separator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = streaming.StreamingSeparator(sep, stems=("vocals",),
                                          block_chunks=block)
    step = stream.hop * block
    pieces, first = [], None
    for start in range(0, song.shape[-1], step):
        pieces += stream.feed(song[:, start:start + step])
        if pieces and first is None:
            first = time.perf_counter() - t0
    pieces.append(stream.flush())
    wall = time.perf_counter() - t0
    if first is None:           # a block longer than the song: all in flush
        first = wall
    out = np.concatenate([p[0] for p in pieces], axis=-1)
    return {"block": block, "first_audio_s": first, "wall_s": wall,
            "audio_sec_per_sec": SONG_SECONDS / wall, "out": out}


def _stream_programs(song: np.ndarray) -> dict:
    """The app separator's stream: the autotune with programs and eager,
    then block 8 and ``auto`` through the programs against ``separate``."""
    from audio_to_sheet_music_tpu_torch.apps import serve, serve_http
    from audio_to_sheet_music_tpu_torch.infer import streaming

    sep = serve.build_separator(None, "config.yaml", device="cuda")
    service = serve_http.SeparationService(sep, pretrained=sep.pretrained,
                                           spectrograms=False)
    with _eager(sep):
        eager_tune = serve_http.SeparationService(sep).autotune_stream_block()
    t0 = time.perf_counter()
    tune = service.autotune_stream_block()
    tune_s = time.perf_counter() - t0
    print(f"  autotune with programs ({tune_s:.2f} s, captures included): "
          f"steps {tune['measured_s']} s -> floor_s {tune['floor_s']}, "
          f"per_chunk_s {tune['per_chunk_s']}, block {tune['block']}; eager "
          f"here: steps {eager_tune['measured_s']} s -> floor_s "
          f"{eager_tune['floor_s']}, per_chunk_s {eager_tune['per_chunk_s']}"
          f", block {eager_tune['block']} (the eager port's record: "
          f"{EAGER_STREAM_FLOOR_S}, {EAGER_STREAM_PER_CHUNK_S})")
    out = {"autotune": tune, "autotune_s": tune_s, "eager_autotune":
           eager_tune}
    for block in (2, 8):        # the autotune's steps, now replays
        stream = streaming.StreamingSeparator(sep, stems=("vocals",),
                                              block_chunks=block)
        silence = np.zeros((2, stream._span), np.float32)
        out[f"step_{block}_profile"] = profile_device(
            lambda: stream.feed(silence), f"one {block}-chunk stream step "
            "(its program's replay, the carry, the piece to the host)")
    stem = sep.separate(song, "vocals")
    for name, block in (("8", STREAM_FIXED_BLOCK), ("auto", tune["block"])):
        run = _stream(service, song, block)
        got = run.pop("out")
        rms = float(np.sqrt(np.mean((got[:, 1:-1] - stem[:, 1:-1]) ** 2)))
        run["rms_vs_separate"] = rms
        out[name] = run
        print(f"  stream block={name} ({block}): first audio "
              f"{run['first_audio_s']:.4f} s, wall {run['wall_s']:.4f} s, "
              f"{run['audio_sec_per_sec']:.2f} audio-sec/sec (1 stem x "
              f"{SONG_SECONDS:.0f} s), rms vs separate {rms:.3e} (limit "
              f"{PATH_RMS_LIMIT:.0e})")
        if got.shape != song.shape or not rms < PATH_RMS_LIMIT:
            raise SmokeFailure(f"the stream at block {block} differs from "
                               "separate")
    out["programs"] = _programs_of(sep)
    print(f"  app separator's programs {out['programs']}")
    out["server_memory"] = _server_lengths(service, song)
    return out


SERVER_SECONDS = (5, 12, 20, 33, 47, 60, 75, 90, 120, 150, 180, 5, 12, 20, 60)


def _server_lengths(service, song: np.ndarray) -> dict:
    """The HTTP server's device memory over songs of many lengths: one
    ``/api/separate`` (``separate_pcm``, a whole-song program per chunk
    bucket) a length of ``SERVER_SECONDS``, the first ones again at the
    end, on the app separator after its streams."""
    import threading

    from audio_to_sheet_music_tpu_torch.apps import serve_http
    from audio_to_sheet_music_tpu_torch.infer import chunked, session

    sep = service.separator
    pcm16 = (np.clip(np.tile(song, 3), -1.0, 1.0) * 32767.0).astype(np.int16)
    httpd = serve_http.make_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    rows = []
    try:
        for seconds in SERVER_SECONDS:
            n = int(seconds * SAMPLE_RATE)
            got = _request(port, "POST", "/api/separate?prompt=vocals",
                           _wav_bytes(pcm16[:, :n]))
            if len(got["body"]) != 44 + 4 * n:
                raise SmokeFailure(f"/api/separate at {seconds} s: "
                                   f"{len(got['body'])} bytes")
            last = (got["body"], n)
            sweeps = [k[0] for k in sep._programs if isinstance(k[0], int)]
            rows.append({
                "seconds": seconds, "wall_s": got["wall_s"],
                "n_chunks": chunked.plan_chunks(n, sep.segment, sep.overlap,
                                                sep.bucket).n_chunks,
                "sweep_programs": sweeps, "programs": len(sep._programs),
                "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
                "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
                "pool_gib": _pool_bytes(sep._pool) / 2 ** 30})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    # the last song's program was dropped and captured again: hold its
    # answer to the eager body
    body, n = last
    with _eager(sep):
        eager = sep.separate_pcm(pcm16[:, :n], "vocals")
    diff = _pcm_diff(np.frombuffer(body[44:], "<i2").reshape(n, 2).T, eager)
    print(f"  the last song, its program captured again: max diff to the "
          f"eager body {diff} int16 steps")
    if diff > 1:
        raise SmokeFailure("a program captured again disagrees with the "
                           "eager body")
    print(f"  HTTP server, /api/separate over {len(rows)} songs (s, chunks, "
          f"wall s, whole-song programs kept, reserved / allocated / pool "
          f"GiB):")
    for r in rows:
        print(f"    {r['seconds']:4d} {r['n_chunks']:3d} {r['wall_s']:7.3f} "
              f"{r['sweep_programs']} {r['reserved_gib']:.3f} / "
              f"{r['allocated_gib']:.3f} / {r['pool_gib']:.3f}")
    if any(len(r["sweep_programs"]) > session.SWEEP_PROGRAMS for r in rows):
        raise SmokeFailure("the server kept more whole-song programs than "
                           f"{session.SWEEP_PROGRAMS}")
    return {"rows": rows, "limit": session.SWEEP_PROGRAMS,
            "recaptured_diff_lsb": diff}


def _stft_witness(model, song: np.ndarray, opt_in: dict) -> dict:
    """Is the opt-in stems' distance from the default (``opt_in``: rms a
    stem) the head's divide by its signed CaC plane + 1e-8 magnifying the
    STFT kernel's rounding?  On a deterministic default separator, run
    eagerly: the kernel's difference from cuFFT on the song's own frames
    (rms ``sigma`` a real component, max, and how many values of the
    divisor's planes lie within that max of the pole at -1e-8, and how
    many are 0, as cuFFT leaves a real frame's DC bin); then the
    stems' rms movement when cuFFT's output is moved by (a) seeded noise
    of rms ``sigma``, (b) the same noise where |value| >= 1e-6 only, away
    from the pole, (c) one ulp, up or down at random; and (d) nothing,
    the same run again."""
    from audio_to_sheet_music_tpu_torch.infer.session import Separator
    from audio_to_sheet_music_tpu_torch.ops import dsp

    orig = dsp.stft
    sep = Separator(model, device="cuda", deterministic=True)
    mode = {"what": None}
    acc = {"sq": 0.0, "n": 0, "max": 0.0, "near_pole": 0, "planes": 0}
    gen = torch.Generator(device="cuda")

    def stft(x, n_fft=4096, hop=1024, kernel=False, normalized=True):
        z = orig(x, n_fft, hop, kernel=kernel, normalized=normalized)
        if kernel or mode["what"] is None or z.dim() != 4:
            return z
        r = torch.view_as_real(z)
        if mode["what"] == "measure":
            d = torch.view_as_real(orig(x, n_fft, hop, kernel=True,
                                        normalized=normalized)) - r
            acc["sq"] += float((d.double() ** 2).sum())
            acc["n"] += d.numel()
            acc["max"] = max(acc["max"], float(d.abs().max()))
            return z
        if mode["what"] == "ulp":
            up = torch.rand(r.shape, generator=gen, device=r.device) < 0.5
            inf = torch.full_like(r, math.inf)
            moved = torch.nextafter(r, torch.where(up, inf, -inf))
        else:
            noise = torch.randn(r.shape, generator=gen,
                                device=r.device) * mode["sigma"]
            if mode["what"] == "far":
                noise = torch.where(r.abs() >= 1e-6, noise, 0.0)
            moved = r + noise
        return torch.view_as_complex(moved.contiguous())

    def stems() -> dict:
        gen.manual_seed(SEED)
        with _eager(sep):
            return sep.separate_all(song)

    dsp.stft = stft
    try:
        base = stems()
        mode["what"] = "measure"
        stems()
        sigma = math.sqrt(acc["sq"] / acc["n"])
        out = {"sigma": sigma, "max_abs": acc["max"]}
        mode["what"] = None
        # the divisor's planes: channel 0's real and imaginary parts
        grabbed = []

        def grab(x, n_fft=4096, hop=1024, kernel=False, normalized=True):
            z = orig(x, n_fft, hop, kernel=kernel, normalized=normalized)
            if z.dim() == 4:
                plane = torch.view_as_real(z[:, 0])
                near = ((plane + 1e-8).abs() < acc["max"]) & (plane != 0)
                grabbed.append((int(near.sum()), int((plane == 0).sum()),
                                plane.numel()))
            return z

        dsp.stft = grab
        stems()
        out["near_pole"] = sum(g[0] for g in grabbed)
        out["divisor_zeros"] = sum(g[1] for g in grabbed)
        out["divisor_values"] = sum(g[2] for g in grabbed)
        dsp.stft = stft
        for what in ("repeat", "noise", "far", "ulp"):
            mode.update(what=None if what == "repeat" else what, sigma=sigma)
            got = stems()
            out[what] = {s: float(np.sqrt(np.mean((got[s] - base[s]) ** 2)))
                         for s in STEMS4}
    finally:
        dsp.stft = orig
    out["opt_in"] = opt_in
    out["stem_rms"] = {s: float(np.sqrt(np.mean(base[s] ** 2)))
                       for s in STEMS4}
    print(f"  STFT witness: the kernel against cuFFT on the song's frames: "
          f"rms {sigma:.3e}, max {out['max_abs']:.3e}; of "
          f"{out['divisor_values']} divisor values {out['near_pole']} lie "
          f"within that max of -1e-8 and are not 0, {out['divisor_zeros']} "
          f"are 0; stem rms {out['stem_rms']}")
    for what, label in (("repeat", "running again unmoved"),
                        ("noise", "noise of that rms"),
                        ("far", "that noise where |value| >= 1e-6"),
                        ("ulp", "one ulp"), ("opt_in", "the opt-in path")):
        print(f"    stems moved by {label}: "
              + ", ".join(f"{s} {v:.3e}" for s, v in out[what].items()))
    return out


def run_programs(card: str, path: dict) -> dict:
    """Phase 10: the Separator's captured programs (``infer.programs``),
    on phase 3's model as it was (phase 7 trained that one's head)."""
    from audio_to_sheet_music_tpu_torch.models import atht

    t_phase = time.perf_counter()
    print(f"phase 10 on {card}")
    model = atht.load_params(atht.init(SEED, device="cuda"))
    song = _song(np.random.default_rng(SEED))
    out = {"serving": _serving_programs(model, song, path)}
    torch.cuda.empty_cache()
    out.update(_default_and_opt_in(model, song))
    torch.cuda.empty_cache()
    out["stft_witness"] = _stft_witness(model, song,
                                        out["opt_in"]["rms_vs_default"])
    torch.cuda.empty_cache()
    out["stream"] = _stream_programs(song)
    torch.cuda.empty_cache()
    out["card"] = card_line()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 10 in {out['phase_s']:.1f} s on {out['card']}")
    return out


def run_roformer(card: str) -> dict:
    """Phase 11: BS-RoFormer at its published widths through the serving
    path of ``bs_roformer.songs-vocals`` (``separate_all_pcm``, vocals,
    8 s chunks at hop 2 s in groups of four), with the launch counters set
    to 0 just before a warm call and read just after."""
    from audio_to_sheet_music_tpu_torch.infer import chunked
    from audio_to_sheet_music_tpu_torch.infer.session import Separator
    from audio_to_sheet_music_tpu_torch.models import bs_roformer
    from audio_to_sheet_music_tpu_torch.ops import kernel_gate

    t_phase = time.perf_counter()
    print(f"phase 11 on {card}")
    cfg = bs_roformer.PUBLISHED
    model = bs_roformer.init(cfg, seed=SEED, device="cuda")
    sep = Separator(model, device="cuda", segment_seconds=ROFORMER_SEGMENT,
                    overlap_seconds=ROFORMER_OVERLAP, deterministic=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    # the gate runs again for this model class: one BS-RoFormer layer
    gate = kernel_gate.last_result()
    if gate["launches"] != {"attn_gated": 2, "rope_qkv": 2}:
        raise SmokeFailure(f"BS-RoFormer: the kernel gate did not run its "
                           f"layer's launches: {gate}")
    try:
        sep.separate_all_pcm(np.zeros((2, 44100), np.float32), ["drums"])
    except ValueError:
        pass
    else:
        raise SmokeFailure("BS-RoFormer: a stem it does not have was served")

    song = _song(np.random.default_rng(SEED))
    n = song.shape[-1]
    grid = chunked.plan_chunks(n, sep.segment, sep.overlap, sep.bucket)
    # the groups that run: the schedule may over-cover the song
    schedule, start = [], 0
    for g in sep._group_schedule(grid, ROFORMER_GROUP):
        if start < n:
            schedule.append(g)
        start += g * grid.hop
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sep.separate_all_pcm(song, ["vocals"], group_chunks=ROFORMER_GROUP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _zero_counters()
    t0 = time.perf_counter()
    pcm, scales = sep.separate_all_pcm(song, ["vocals"],
                                       group_chunks=ROFORMER_GROUP)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_counters().items() if v}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = SONG_SECONDS / wall
    print(f"  separate_all_pcm, vocals, groups {schedule}: gate rms "
          f"{gate['rms']:.3e}, set-up {setup_s:.2f} s, warm-up {warm_s:.2f} "
          f"s (captures included), run {wall:.3f} s, {rate:.2f} "
          f"audio-sec/sec, peak device memory {peak_gib:.2f} GiB, launches "
          f"{launches}")
    want = {k: 2 * cfg.depth * len(schedule)
            for k in ("attn_gated", "rope_qkv")}
    if launches != want:
        raise SmokeFailure(f"BS-RoFormer's path launched {launches}, want "
                           f"{want} (one of each a transformer a group)")
    if pcm.dtype != np.int16 or pcm.shape != (1, 2, n):
        raise SmokeFailure(f"pcm {pcm.dtype} {pcm.shape}, want int16 "
                           f"(1, 2, {n})")
    if not np.all(np.isfinite(scales)) or np.abs(pcm).max() == 0:
        raise SmokeFailure("BS-RoFormer's output is silent or its scale is "
                           "not finite")
    del sep, model
    torch.cuda.empty_cache()
    return {"launches": launches, "schedule": schedule, "gate": gate,
            "setup_s": setup_s, "warmup_s": warm_s, "wall_s": wall,
            "audio_sec_per_sec": rate, "peak_mem_gib": peak_gib,
            "phase_s": time.perf_counter() - t_phase}


def main(argv: list) -> int:
    profile = argv == ["--profile"]
    if argv and not profile:
        print("usage: python3 chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    try:
        from audio_to_sheet_music_tpu_torch.ops import build
        from audio_to_sheet_music_tpu_torch.utils import profiling
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(f"card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}")
        global BF16_TENSOR_FLOPS
        BF16_TENSOR_FLOPS = profiling.peak_tflops() * 1e12
        sources = ["layer_tail", "henc_freq", "dconv_rows", "attn_block",
                   "stft", "group_norm", "rope"]
        build_s = build.build_all(sources)
        print(f"kernels built in {build_s:.2f} s")
        compiled = check_build(sources)

        gen = torch.Generator().manual_seed(SEED)
        kernels = [check_layer_tail(gen, profile), check_henc(gen, profile),
                   check_dconv(gen, profile), check_attn_block(gen, profile),
                   check_stft(gen), check_group_norm(gen),
                   check_dec_join(gen)]
        k_eval = [eval_layer_tail(gen, profile), eval_henc(gen),
                  eval_dconv(gen), eval_attn_block(gen), eval_stft(gen)]
        for k, at_eval in zip(kernels, k_eval):
            k.update(at_eval)
        k_roformer = [check_attn_gated(gen), check_rope_qkv(gen)]
        path, model, stems, pcm = run_path(profile)
        training = run_training(profile)
        evaluation = run_eval(profile)
        serving = run_serving(profile)
        slice9 = run_checkpoints_towers(card, model, stems, path["launches"])
        parallel = run_parallel_gate(card, path, pcm)
        learning = run_learning_proof(card)
        graphs = run_programs(card, path)
        roformer = run_roformer(card)
        for k in kernels:
            counts = (path["launches"] if k["name"] in path["launches"]
                      else training["launches"])
            k["launches"] = counts[k["name"]]
            sel = "default" if k["name"] in path["launches"] else "opt_in"
            k["eval_launches"] = evaluation["sweeps"][sel]["launches"][
                k["name"]]
            k["stream_launches"] = serving["stream"]["auto"]["launches"][
                k["name"]]
            k.update(serving["kernels"].get(k["name"], {}))
            k["learn_launches"] = learning["launches"].get(k["name"], 0)
        for k in k_roformer:
            k["launches"] = roformer["launches"][k["name"]]
        kernels += k_roformer
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    out = Path("build")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "compiled": compiled,
         "kernels": kernels, "path": path, "training": training,
         "eval": evaluation, "serving": serving,
         "checkpoints_towers": slice9, "parallel_gate": parallel,
         "learning_proof": learning, "programs": graphs,
         "bs_roformer": roformer},
        indent=1, default=str))
    summary = [{k: v for k, v in kern.items()
                if k in ("name", "route", "source", "replaces", "launches",
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "stream_launches",
                         "learn_launches", "join_ms", "join_bound_ms")
                or k.startswith(("eval_", "stream_"))
                and not k.endswith("_forms")}
               for kern in kernels]
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
