"""The port's data pipeline against the JAX package's.

Both are pure numpy over the same files, so the same tracks and seeds must
give identical arrays: the synthetic tracks, every ``StemSegmentDataset``
item (random segments and augmentation included) and every ``BatchLoader``
batch, tokenised prompts included.
"""

from __future__ import annotations

import numpy as np
import pytest

from audio_to_sheet_music_tpu.data import musdb as JM
from audio_to_sheet_music_tpu.data import synth as JS
from audio_to_sheet_music_tpu.text.tokenizer import default_tokenizer as jax_tok
from audio_to_sheet_music_tpu_torch.data import musdb as TM
from audio_to_sheet_music_tpu_torch.data import synth as TS
from audio_to_sheet_music_tpu_torch.text.tokenizer import default_tokenizer as port_tok


@pytest.fixture(scope="module")
def tracks(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_tracks")
    tdir = tmp_path_factory.mktemp("port_tracks")
    return (JS.synthetic_tracks(2, seconds=1.0, cache_dir=jdir, seed=3),
            TS.synthetic_tracks(2, seconds=1.0, cache_dir=tdir, seed=3))


def test_synthetic_tracks_are_identical(tracks):
    jt, tt = tracks
    assert [t.name for t in jt] == [t.name for t in tt]
    for a, b in zip(jt, tt):
        assert b.kind == "npy"
        np.testing.assert_array_equal(a.load(), b.load())


def test_discover_tracks_agrees(tracks):
    jt, tt = tracks
    root = tt[0].path.parent
    assert [(t.name, t.kind) for t in TM.discover_tracks(root)] == [
        (t.name, t.kind) for t in JM.discover_tracks(root)]


@pytest.mark.parametrize("random_segments,augment", [(False, False),
                                                     (True, True)])
def test_dataset_items_are_identical(tracks, random_segments, augment):
    _, tt = tracks
    seg = 11025
    jd = JM.StemSegmentDataset(tt, seg, random_segments=random_segments,
                               augment=augment, seed=5)
    td = TM.StemSegmentDataset(tt, seg, random_segments=random_segments,
                               augment=augment, seed=5)
    assert td.index_map == jd.index_map and len(td) == len(jd)
    for i in range(len(td)):
        a, b = jd[i], td[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_batch_loader_gives_identical_batches(tracks):
    _, tt = tracks
    make = lambda M, tok: M.BatchLoader(  # noqa: E731
        M.StemSegmentDataset(tt, 11025, random_segments=True, augment=True,
                             seed=7), 3, tok(), seed=9)
    jl, tl = make(JM, jax_tok), make(TM, port_tok)
    assert len(jl) == len(tl) > 0
    for _ in range(2):                     # two epochs: the rng carries over
        batches = list(zip(jl, tl))
        assert len(batches) == len(tl)
        for a, b in batches:
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
