"""The port's StreamingSeparator and ``separate_pcm`` against the JAX
package's (f32, CPU, the same tiny weights in both).

0.25 s chunks with 0.05 s overlap (hop 8820 samples), block 4; the song is
white noise at 0.3 rms, the level ``test_torch_session.py`` explains.  The
port's stream must give the JAX stream's pieces, piece for piece, in the
same shapes and within 1e-4 of the peak, and equal the port's offline
``separate_all`` away from the two edge samples.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_to_sheet_music_tpu.infer import Separator as JaxSeparator
from audio_to_sheet_music_tpu.infer.streaming import (
    StreamingSeparator as JaxStreamingSeparator)
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.infer import (Separator,
                                                  StreamingSeparator)
from audio_to_sheet_music_tpu_torch.models import atht as TA

KW = dict(segment_seconds=0.25, overlap_seconds=0.05)
FEED = 13_337


@pytest.fixture(scope="module")
def separators():
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    port = Separator(model, device="cpu", **KW)
    jf32 = JaxSeparator(params, compute_dtype=jnp.float32,
                        wire_dtype=np.float32, **KW)
    jpcm = JaxSeparator(params, compute_dtype=jnp.float32, **KW)
    return port, jf32, jpcm


def _song(seed: int, n: int) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal((2, n))
            ).astype(np.float32)


def _stream(cls, sep, song, stems, block, feed=FEED):
    stream = cls(sep, stems=stems, block_chunks=block)
    pieces = []
    for start in range(0, song.shape[-1], feed):
        pieces.extend(stream.feed(song[:, start:start + feed]))
    pieces.append(stream.flush())
    return [np.asarray(p) for p in pieces]


def test_stream_matches_the_jax_stream_piece_for_piece(separators):
    port, jf32, _ = separators
    song = _song(0, 80000)      # two blocks in feed, the rest in flush
    stems = ("drums", "vocals")
    got = _stream(StreamingSeparator, port, song, stems, 4)
    want = _stream(JaxStreamingSeparator, jf32, song, stems, 4)
    assert [p.shape for p in got] == [p.shape for p in want]
    assert len(got) > 2                       # blocks in feed, then flush
    peak = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-4 * peak, rtol=0)


def test_stream_matches_offline(separators):
    port, _, _ = separators
    song = _song(0, 80000)
    stems = ("drums", "vocals")
    offline = port.separate_all(song, stems=stems)
    out = np.concatenate(_stream(StreamingSeparator, port, song, stems, 4),
                         axis=-1)
    assert out.shape == (2, 2, song.shape[-1])
    peak = max(np.abs(v).max() for v in offline.values())
    for i, stem in enumerate(stems):
        np.testing.assert_allclose(out[i, :, 1:-1], offline[stem][:, 1:-1],
                                   atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("n", [7000, 1, 8820])
def test_short_stream_flush_only(separators, n):
    port, jf32, _ = separators
    song = _song(1, n)
    got = _stream(StreamingSeparator, port, song, ("bass",), 4, feed=n)
    want = _stream(JaxStreamingSeparator, jf32, song, ("bass",), 4, feed=n)
    assert len(got) == 1 and got[0].shape == (1, 2, n)
    assert np.isfinite(got[0]).all()
    peak = np.abs(want[0]).max()
    np.testing.assert_allclose(got[0], want[0], atol=1e-4 * peak, rtol=0)


def test_flush_runs_a_tail_of_several_blocks(separators):
    """With block 2 the buffered tail can hold more chunk starts than one
    block takes; ``flush`` then runs several zero-padded blocks, and the
    stream still covers the whole song and equals the offline separation
    and the JAX stream."""
    port, jf32, _ = separators
    song = _song(2, 36000)
    stream = StreamingSeparator(port, stems=("vocals",), block_chunks=2)
    pieces = stream.feed(song)
    n = stream._buf.shape[-1]
    assert (n - 1) // stream.hop + 1 > stream.block_chunks
    pieces.append(stream.flush())
    got = np.concatenate(pieces, axis=-1)
    assert got.shape == (1, 2, 36000)
    offline = port.separate(song, "vocals")
    peak = np.abs(offline).max()
    np.testing.assert_allclose(got[0, :, 1:-1], offline[:, 1:-1],
                               atol=1e-5 * peak, rtol=0)
    want = np.concatenate(_stream(JaxStreamingSeparator, jf32, song,
                                  ("vocals",), 2, feed=36000), axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-4 * peak, rtol=0)


def test_overlap_is_clamped_below_the_segment(separators):
    port, _, _ = separators
    sep = Separator(port.model, device="cpu", segment_seconds=0.25,
                    overlap_seconds=0.5)
    stream = StreamingSeparator(sep, stems=("bass",), block_chunks=2)
    assert stream.overlap == sep.segment - 1 and stream.hop == 1
    assert stream._span == sep.segment + 1


def test_carry_stays_on_the_device(separators):
    port, _, _ = separators
    stream = StreamingSeparator(port, stems=("bass",), block_chunks=2)
    stream.feed(_song(3, stream._span + 10))
    assert stream._acc.device == port.device
    assert stream._acc.shape == (2, stream.overlap)
    assert stream._wsum.shape == (stream.overlap,)


def test_separate_pcm_matches_jax_to_one_step(separators):
    port, _, jpcm = separators
    song = _song(4, 30000)
    got = port.separate_pcm(song, "vocals")
    want = np.asarray(jpcm.separate_pcm(song, "vocals"))
    assert got.dtype == np.int16 and got.shape == (2, 30000)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    # absolute level: pcm / 32767 is the float stem
    stem = port.separate(song, "vocals")
    np.testing.assert_allclose(got / 32767.0, np.clip(stem, -1, 1),
                               atol=0.5 / 32767 + 1e-6)


def test_separate_pcm_takes_int16_and_clips(separators):
    """A loud int16 song whose stem peaks above 1: the port clips at
    ±32767.  The JAX path first rounds to its shared scale (the stem's
    peak ``p``), which moves a sample by up to ``p / 2`` absolute steps
    before its second rounding, so here the two agree within ``1 + p / 2``
    steps; below a peak of 1 that is the one step of the test above."""
    port, _, jpcm = separators
    pcm16 = (np.clip(_song(5, 20000) * 4, -1, 1) * 32767).astype(np.int16)
    got = port.separate_pcm(pcm16, "drums")
    want = np.asarray(jpcm.separate_pcm(pcm16, "drums"))
    stem = port.separate(pcm16, "drums")
    peak = np.abs(stem).max()
    assert peak > 1.0
    assert np.abs(got).max() == 32767
    np.testing.assert_array_equal(got[stem >= 1.0], 32767)
    np.testing.assert_array_equal(got[stem <= -1.0], -32767)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
    assert diff <= 1 + 0.5 * peak, (diff, peak)
