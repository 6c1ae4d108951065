"""The port's spans and counters (``utils.profiling``) on the CPU.

With no profiler recording, ``span`` is one shared no-op.  Under
``torch.profiler`` each layer boundary leaves its ``atsm.`` span in the
trace, nested as the calls nest, and the counters follow the known
schedules: a 0.25 s segment with 0.05 s overlap (hop 8820) makes a 2 s song
a 10-chunk grid that ``separate_all_pcm`` runs as groups of [2, 4, 4], and
a 75,000-sample song the same groups with its last chunk past the end; a
stream at block 2 fed 1 s runs two blocks in ``feed`` and one in ``flush``.
The tiny model is the port's own seeded draw: no JAX here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_to_sheet_music_tpu_torch.data import musdb, synthetic_tracks
from audio_to_sheet_music_tpu_torch.infer import Separator, StreamingSeparator
from audio_to_sheet_music_tpu_torch.models import atht
from audio_to_sheet_music_tpu_torch.text.tokenizer import HashTokenizer
from audio_to_sheet_music_tpu_torch.train import step as train_step
from audio_to_sheet_music_tpu_torch.train.trainer import put_batch
from audio_to_sheet_music_tpu_torch.utils import profiling

SR = 44100
STEMS = ("drums", "bass", "other", "vocals")
KW = dict(segment_seconds=0.25, overlap_seconds=0.05)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs, as the suite runs several
    workers on the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    return atht.init_tiny(0)


@pytest.fixture
def sep(model):
    return Separator(model, device="cpu", **KW)


def _song(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((2, n))).astype(np.float32)


def _spans(prof) -> list:
    """The trace's ``atsm.`` spans as (name, start_ns, end_ns, thread),
    in start order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("atsm.")), key=lambda s: s[1])


def _names(spans) -> list:
    return [s[0] for s in spans]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_is_the_shared_noop_without_a_profiler():
    assert profiling.span("atsm.a") is profiling.OFF
    assert profiling.span("atsm.b") is profiling.OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("atsm.a") is not profiling.OFF
    assert profiling.span("atsm.a") is profiling.OFF


def test_counts_carry_the_launch_counters_and_reset():
    profiling.reset_counts()
    profiling.count("test.events")
    profiling.count("test.events", 2)
    got = profiling.counts()
    assert got["test.events"] == 3
    assert {"launches.layer_tail", "launches.henc_freq_fused",
            "launches.dconv_rows", "launches.attn_block",
            "launches.stft", "launches.group_norm", "launches.dec_join",
            "launches.attn_gated", "launches.rope_qkv"} <= set(got)
    profiling.reset_counts()
    assert "test.events" not in profiling.counts()
    assert all(v == 0 for v in profiling.counts().values())


def test_separate_all_pcm_spans_and_counters(sep):
    profiling.reset_counts()
    sep.separate_all_pcm(_song(2 * SR), STEMS, group_chunks=4)
    first = profiling.counts()
    assert first["program.captures"] == 2           # groups of 2 and of 4
    assert first["program.replays"] == 3
    assert first["text.tower_runs"] == 4
    assert first["chunks.computed"] == 10 and first["chunks.padded"] == 0

    profiling.reset_counts()
    _, spans = _traced(lambda: sep.separate_all_pcm(_song(75_000, 1), STEMS,
                                                    group_chunks=4))
    got = profiling.counts()
    assert got.get("program.captures", 0) == 0
    assert got["program.replays"] == 3
    assert got.get("text.tower_runs", 0) == 0 and got["text.cache_hits"] == 4
    # chunk 9 starts at 79,380, past the song's end
    assert got["chunks.computed"] == 10 and got["chunks.padded"] == 1
    # a piece a group, none of them waiting on a copy on the CPU
    assert got["pcm.pieces"] == 3 and got["pcm.pieces_early"] == 0

    top = [s for s in spans if s[0] == "atsm.separate_all_pcm"]
    assert len(top) == 1
    kids = [s for s in spans if s[0].startswith("atsm.pcm.")]
    assert _names(kids) == ["atsm.pcm.scale"] + ["atsm.pcm.group"] * 3 + [
        "atsm.pcm.wait", "atsm.pcm.assemble"] * 3
    assert all(_inside(k, top[0]) for k in kids)
    groups = [s for s in kids if s[0] == "atsm.pcm.group"]
    replays = [s for s in spans if s[0] == "atsm.program.replay"]
    assert len(replays) == 3
    assert all(_inside(r, g) for r, g in zip(replays, groups))
    assert "atsm.model.text_tower" not in _names(spans)


def test_text_tower_runs_only_on_a_new_prompt(sep):
    profiling.reset_counts()
    _, spans = _traced(lambda: [sep.text_embedding("a new phrase"),
                                sep.text_embedding("a new phrase")])
    assert _names(spans).count("atsm.model.text_tower") == 1
    got = profiling.counts()
    assert got["text.tower_runs"] == 1 and got["text.cache_hits"] == 1
    _, spans = _traced(lambda: sep.text_embedding("a new phrase"))
    assert "atsm.model.text_tower" not in _names(spans)


def test_stream_session_spans_one_block_each(sep):
    clip = _song(SR, 2)

    def session():
        stream = StreamingSeparator(sep, stems=("vocals",), block_chunks=2)
        pieces = stream.feed(clip)
        return pieces, stream.flush()

    profiling.reset_counts()
    (pieces, tail), spans = _traced(session)
    names = _names(spans)
    assert len(pieces) == 2 and tail.shape[-1] == SR - 2 * 2 * 8820
    assert [n for n in names if n.startswith("atsm.stream.")] == [
        "atsm.stream.open", "atsm.stream.feed", "atsm.stream.block",
        "atsm.stream.block", "atsm.stream.flush", "atsm.stream.block"]
    got = profiling.counts()
    assert got["stream.blocks"] == 3
    assert got["program.captures"] == 1 and got["program.replays"] == 3
    assert got["text.tower_runs"] == 1              # "vocals", first seen
    feed = next(s for s in spans if s[0] == "atsm.stream.feed")
    flush = next(s for s in spans if s[0] == "atsm.stream.flush")
    blocks = [s for s in spans if s[0] == "atsm.stream.block"]
    assert _inside(blocks[0], feed) and _inside(blocks[1], feed)
    assert _inside(blocks[2], flush)
    tower = next(s for s in spans if s[0] == "atsm.model.text_tower")
    assert _inside(tower, next(s for s in spans
                               if s[0] == "atsm.stream.open"))


def test_train_step_spans(model):
    rng = np.random.default_rng(3)
    mix = rng.standard_normal((1, 2, 11025)).astype(np.float32)
    ids = np.array([[0, 9, 11, 13, 8, 2]], np.int32)
    raw = {"mixture": mix, "target": 0.5 * mix, "input_ids": ids,
           "attention_mask": (ids != 1).astype(np.int32),
           "stem_index": np.zeros((1,), np.int32)}
    state = train_step.TrainState.create(
        model, lambda p: train_step.make_optimizer(p, 1e-4))
    step = train_step.make_train_step({}, torch.float32, True)
    try:
        profiling.reset_counts()
        _, spans = _traced(lambda: step(state, put_batch(raw, "cpu")))
    finally:
        model.requires_grad_(False)
    names = _names(spans)
    assert names.count("atsm.train.put_batch") == 1
    top = [s for s in spans if s[0] == "atsm.train.step"]
    assert len(top) == 1
    kids = [s for s in spans if s[0] in ("atsm.train.forward",
                                         "atsm.train.backward",
                                         "atsm.train.optimizer")]
    assert _names(kids) == ["atsm.train.forward", "atsm.train.backward",
                            "atsm.train.optimizer"]
    assert all(_inside(k, top[0]) for k in kids)
    assert _inside(next(s for s in spans if s[0] == "atsm.model.text_tower"),
                   kids[0])
    assert profiling.counts()["text.tower_runs"] == 1


def test_loader_wait_and_producer_spans(tmp_path):
    """``atsm.data.wait`` on the consuming thread; ``atsm.data.make_batch``
    on the producer's, which the profiler follows when asked to follow
    every thread."""
    from torch._C._profiler import _ExperimentalConfig

    tracks = synthetic_tracks(2, seconds=1.0, cache_dir=tmp_path, seed=3)
    ds = musdb.StemSegmentDataset(tracks, 11025, random_segments=True,
                                  augment=True, seed=0)
    loader = musdb.BatchLoader(ds, 2, HashTokenizer(), seed=0)
    n = len(loader)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        batches = list(loader)
    assert len(batches) == n >= 2
    spans = _spans(prof)
    waits = [s for s in spans if s[0] == "atsm.data.wait"]
    makes = [s for s in spans if s[0] == "atsm.data.make_batch"]
    assert len(waits) == n + 1                      # the last gets the end
    assert len(makes) == n
    assert {s[3] for s in makes}.isdisjoint({s[3] for s in waits})
