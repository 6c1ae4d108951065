"""The ``Separator``'s captured programs on the card: CUDA graphs against
the eager functions they capture.

Marked ``cuda``: each test skips without a card (decided in a fixture, not
at import).  On a machine with one, run them without the JAX test
configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_programs.py

The full-width seed-0 model with the committed head, on a
``deterministic=True`` separator (cuDNN's deterministic algorithms), so the
graph and the eager body must agree bit for bit; a 20 s song is the
[2, 4] schedule, so the carry crosses from one group program to the other.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu_torch.infer import (Separator,
                                                  StreamingSeparator, chunked,
                                                  programs)
from audio_to_sheet_music_tpu_torch.models import atht
from audio_to_sheet_music_tpu_torch.ops import select
from audio_to_sheet_music_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
STEMS = ("drums", "bass", "other", "vocals")
SR = 44100


@pytest.fixture(scope="module")
def sep():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    model = atht.load_params(atht.init(0, device="cuda"))
    return Separator(model, device="cuda", deterministic=True)


def _song(seconds: float, seed: int = 0) -> np.ndarray:
    n = int(seconds * SR)
    return (0.3 * np.random.default_rng(seed).standard_normal((2, n))
            ).astype(np.float32)


def eager_all_pcm(sep: Separator, song: np.ndarray, stems) -> np.ndarray:
    """``separate_all_pcm``'s schedule through the eager ``_group``, with
    the same device scalars a program takes."""
    n = song.shape[-1]
    grid = chunked.plan_chunks(n, sep.segment, sep.overlap, sep.bucket)
    hop, seg, dev = grid.hop, grid.segment, sep.device
    scale = max(2.0 * float(np.abs(song).max()), 1e-8)
    embs = sep.serving.stem_inputs(stems)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    length_t = torch.tensor(n, dtype=torch.int64, device=dev)
    acc = torch.zeros((len(stems) * 2, seg - hop), device=dev)
    w = torch.zeros((seg - hop,), device=dev)
    out = np.empty((len(stems) * 2, n), np.int16)
    start = 0
    with torch.inference_mode():
        for g in sep._group_schedule(grid, 4):
            take = min(g * hop, n - start)
            if take <= 0:
                break
            span = (g - 1) * hop + seg
            piece = np.zeros((2, span), np.float32)
            got = song[:, start:start + span]
            piece[:, :got.shape[-1]] = got
            q, acc, w = sep._group(
                torch.from_numpy(piece).to(dev), embs, g, hop,
                torch.tensor(start, dtype=torch.int64, device=dev), length_t,
                scale_t, acc, w)
            out[:, start:start + take] = q.cpu().numpy()[:, :take]
            start += g * hop
    return out.reshape(len(stems), 2, n)


def test_group_programs_equal_the_eager_body_bit_for_bit(sep):
    song = _song(20.0)
    grid = chunked.plan_chunks(song.shape[-1], sep.segment, sep.overlap,
                               sep.bucket)
    assert sep._group_schedule(grid, 4) == [2, 4]
    first, _ = sep.separate_all_pcm(song, stems=STEMS)
    progs = [p for k, p in sep._programs.items() if k[0] == "group"]
    assert len(progs) == 2 and all(p.graph is not None for p in progs)
    saved = select.launch_counts()
    select.zero_launch_counts()
    try:
        second, _ = sep.separate_all_pcm(song, stems=STEMS)
        counts = select.launch_counts()
    finally:
        select.zero_launch_counts()
        select.add_launch_counts(saved)
    # two replays: 10 crosstransformer layers, freq layer 0 and the head's
    # 8 decoder joins each
    assert counts["layer_tail"] == 20 and counts["henc_freq_fused"] == 2
    assert counts["dec_join"] == 16
    want = eager_all_pcm(sep, song, STEMS)
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)


def test_sweep_and_stream_programs_equal_the_eager_bodies(sep):
    song = _song(13.0, seed=1)
    got = sep.separate(song, "vocals")
    grid = chunked.plan_chunks(song.shape[-1], sep.segment, sep.overlap,
                               sep.bucket)
    grid = chunked.ChunkGrid(grid.segment, grid.hop, grid.n_chunks,
                             grid.padded_length)
    padded = np.zeros((2, grid.padded_length), np.float32)
    padded[:, :song.shape[-1]] = song
    embs = sep.serving.stem_inputs(("vocals",))
    with torch.inference_mode():
        want = sep._sweep_body(
            torch.from_numpy(padded).cuda(), embs,
            torch.tensor(song.shape[-1], device="cuda"), grid)
    np.testing.assert_array_equal(got,
                                  want[:, :song.shape[-1]].cpu().numpy())

    stream = StreamingSeparator(sep, stems=("vocals",), block_chunks=2)
    block = (0.3 * np.random.default_rng(2).standard_normal(
        (2, stream._span))).astype(np.float32)
    acc, wsum = sep._run_stream_block(block, embs, 2, stream.hop)
    acc, wsum = acc.clone(), wsum.clone()
    with torch.inference_mode():
        e_acc, e_wsum = sep._stream_block(torch.from_numpy(block).cuda(),
                                          embs, 2, stream.hop)
    assert torch.equal(acc, e_acc) and torch.equal(wsum, e_wsum)


def test_pieces_fill_while_later_groups_run(sep):
    """A 60 s song is 12 chunks, run as groups [2, 4, 4, 4]: four pieces.
    Filled a piece at a time, the output holds the bytes the pieces give
    after one whole-stream synchronise; every piece but the last (and one
    spare) starts its fill while the song's last copy is still to come, and
    the card runs during the fills."""
    song = _song(60.0, seed=2)
    n = song.shape[-1]
    grid = chunked.plan_chunks(n, sep.segment, sep.overlap, sep.bucket)
    assert sep._group_schedule(grid, 4) == [2, 4, 4, 4]
    sep.separate_all_pcm(song, stems=STEMS)          # every program captured
    pieces, _ = sep._enqueue_all_pcm(song, STEMS, 4, False)
    sep._copy_stream.synchronize()
    want = np.empty((len(STEMS) * 2, n), np.int16)
    for s0, host, take, _ in pieces:
        want[:, s0:s0 + take] = host.numpy()[:, :take]
    del pieces

    before = profiling.counts()
    got, _ = sep.separate_all_pcm(song, stems=STEMS)
    after = profiling.counts()
    np.testing.assert_array_equal(got.reshape(len(STEMS) * 2, n), want)
    filled = after["pcm.pieces"] - before.get("pcm.pieces", 0)
    early = after["pcm.pieces_early"] - before.get("pcm.pieces_early", 0)
    assert filled == 4 and early >= filled - 2, (filled, early)

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        again, _ = sep.separate_all_pcm(song, stems=STEMS)
    np.testing.assert_array_equal(again, got)
    events = list(prof.profiler.kineto_results.events())

    def on_card(e) -> bool:
        return str(e.device_type()).endswith("CUDA")

    # the spans' host ranges; kernels and copies, not the spans' projections
    # onto the card's timeline
    fills = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
             if e.name() == "atsm.pcm.assemble" and not on_card(e)]
    work = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if on_card(e) and not e.name().startswith("atsm.")]
    assert len(fills) == 4 and work
    assert any(a < d and c < b for a, b in fills for c, d in work)


def test_program_outputs_are_static_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.arange(4.0).pin_memory()
    prog = programs.Program(lambda t: (t * 2, t + 1), [x], "cuda")
    assert prog.graph is not None and prog.capture_s > 0
    a = prog(x)
    b = prog(torch.full((4,), 5.0, device="cuda"))
    assert all(p is q for p, q in zip(a, b))
    assert b[0].tolist() == [10.0] * 4 and b[1].tolist() == [6.0] * 4


def test_a_pageable_copy_fails_the_capture_and_nothing_falls_back():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    host = np.ones(4, np.float32)

    def pageable(t):
        return t + torch.from_numpy(host).to(t.device)

    made = []
    with pytest.raises(RuntimeError):
        made.append(programs.Program(pageable, [torch.zeros(4).cuda()],
                                     "cuda"))
    assert not made
    torch.cuda.synchronize()
    ok = programs.Program(lambda t: t + 1, [torch.zeros(4).cuda()], "cuda")
    assert ok(torch.ones(4, device="cuda")).tolist() == [2.0] * 4
