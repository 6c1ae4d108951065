"""Tiny cells for the CPU tests: each real cell of ``BENCHMARK.json`` with
its configuration cut to test widths (the port's ``init_tiny`` widths, f32)
and its traffic to seconds of audio, run through the same drivers."""

from __future__ import annotations

import itertools

import torch

from port_bench import harness

ATHT = {"model": "atht", "channels": [8, 16, 24, 32], "bottom_channels": 64,
        "transformer_layers": 2, "transformer_heads": 1, "transformer_ff": 256,
        "nfft": 4096, "hop": 1024, "sample_rate": 44100, "text_layers": 2,
        "text_hidden": 128, "text_heads": 2, "text_ff": 512,
        "text_vocab": 50265, "projection_dim": 512, "model_dim": 32,
        "decoder_channels": [32, 16, 8, 8, 4], "compute_dtype": "float32"}
SEED = 2 ** 31 + 12345


def cell(name: str) -> harness.Cell:
    """The cell ``name`` at test size."""
    c = harness.find_cell(harness.load_benchmark(), name)
    c.config = dict(ATHT)
    tr = dict(c.traffic)
    tr["segment_seconds"] = 1.0
    if "song_seconds" in tr:
        tr.update(song_seconds=[2.0, 4.0], distinct_songs=3)
    if "clip_seconds" in tr:
        tr.update(clip_seconds=[2.0, 3.0], distinct_clips=3, block_chunks=2,
                  max_sessions=16)
    if "track_seconds" in tr:
        # a window of two steps: the reference follows both
        tr.update(track_seconds=3, batch=2, tracks=2,
                  window_follow={"within": 1, "steps": 2})
    c.traffic = tr
    return c


def clock(step: float = 0.5):
    """A stand-in clock that advances ``step`` seconds a reading."""
    ticks = itertools.count()
    return lambda: next(ticks) * step


CPU = torch.device("cpu")
