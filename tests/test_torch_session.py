"""The port's Separator and chunking against the JAX package's (f32, CPU).

Both Separators hold the same seeded ``init_tiny`` weights and use 0.25 s
chunks with 0.05 s overlap, so a 2 s song is a 10-chunk grid: the PCM path
runs it as groups of [2, 4, 4] with the overlap-add carry between them.
``separate_all`` must agree to 1e-4 of the stems' peak and
``separate_all_pcm`` to one int16 step.

The song is white noise at 0.3 rms, the level of a mastered mix.  The head
divides the mixture spectrum by its signed CaC plane + 1e-8 (a quirk of the
reference the trained head depends on), so at a bin where that plane is
within ~1e-8 of zero, the STFT's last-bit rounding (which differs between
torch's and XLA's FFTs) is multiplied into a visible error.  Its size
relative to the output falls as the input gets louder: at 0.1 rms one bin
of a 10-chunk song moved the port's stem by 3e-4 of its peak, at 0.3 rms the
largest such move over four seeds was 1.5e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.infer import Separator as JaxSeparator
from audio_to_sheet_music_tpu.infer import chunked as JC
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.text import tokenizer as JT
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.infer import chunked as TC
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.text import tokenizer as TT

STEMS = ("drums", "bass", "other", "vocals")
KW = dict(segment_seconds=0.25, overlap_seconds=0.05)


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


@pytest.fixture(scope="module")
def song():
    return (0.3 * np.random.default_rng(0).standard_normal((2, 88200))
            ).astype(np.float32)


def test_defaults_follow_the_device(separators):
    port, _, _ = separators
    assert port.device == torch.device("cpu")
    assert port.compute_dtype == torch.float32


def test_text_embedding_matches_and_is_cached(separators):
    port, jf32, _ = separators
    got = port.text_embedding("vocals")
    assert port.text_embedding("vocals") is got
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jf32.text_embedding("vocals")),
                               atol=1e-5, rtol=1e-5)


def test_separate_all_matches_jax(separators, song):
    port, jf32, _ = separators
    got = port.separate_all(song, stems=STEMS)
    want = jf32.separate_all(song, stems=STEMS)
    peak = max(np.abs(w).max() for w in want.values())
    for stem in STEMS:
        assert got[stem].shape == song.shape and got[stem].dtype == np.float32
        np.testing.assert_allclose(got[stem], want[stem], atol=1e-4 * peak,
                                   rtol=0)


def test_separate_all_within_one_step_of_the_jax_default(separators, song):
    """The JAX default wire is pcm16: its ``separate_all`` returns the
    stems quantised against one scale shared by every stem and channel.
    The port returns exact f32.  The gap is the wire's rounding (half a
    step) plus the two packages' f32 difference, which on this song
    reaches 0.94 of a step at a few samples (the CaC divide above; the f32
    test holds it to 1e-4 of the peak).  So all but 0.5 % of the samples
    lie within one step of the shared scale and every sample within 1.5."""
    port, jf32, jpcm = separators
    assert jpcm.wire_pcm16
    got = port.separate_all(song, stems=STEMS)
    want = jpcm.separate_all(song, stems=STEMS)
    exact = jf32.separate_all(song, stems=STEMS)
    step = max(np.abs(w).max() for w in want.values()) / 32767.0
    for stem in STEMS:
        assert got[stem].dtype == np.float32
        # the JAX default is its f32 stems rounded on the shared scale
        assert np.abs(exact[stem] - want[stem]).max() <= 0.51 * step
        diff = np.abs(got[stem] - want[stem])
        assert diff.max() <= 1.5 * step, diff.max() / step
        assert np.mean(diff > step) < 5e-3, np.mean(diff > step)


@pytest.mark.parametrize("wire", ["pcm16", np.float16, "bfloat16x"])
def test_other_wire_dtypes_are_refused(separators, wire):
    port, _, _ = separators
    assert port.wire_dtype == np.float32
    assert Separator(port.model, device="cpu", wire_dtype="float32",
                     **KW).wire_dtype == np.float32
    with pytest.raises(ValueError, match="wire_dtype"):
        Separator(port.model, device="cpu", wire_dtype=wire, **KW)


def test_separate_matches_separate_all(separators, song):
    port, _, _ = separators
    one = port.separate(song[:, :30000], "bass")
    all_ = port.separate_all(song[:, :30000], stems=("drums", "bass"))
    np.testing.assert_allclose(one, all_["bass"], atol=1e-5)


def test_separate_all_pcm_matches_jax_to_one_lsb(separators, song):
    port, _, jpcm = separators
    grid = TC.plan_chunks(song.shape[-1], port.segment, port.overlap)
    assert port._group_schedule(grid, 4) == [2, 4, 4]
    pcm, scales = port.separate_all_pcm(song, stems=STEMS)
    want, want_scales = jpcm.separate_all_pcm(song, stems=STEMS)
    assert pcm.dtype == np.int16 and pcm.shape == (4, 2, song.shape[-1])
    np.testing.assert_allclose(scales, want_scales, rtol=1e-6)
    diff = np.abs(pcm.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()


def test_per_op_separator_matches_the_kernel_path(separators, song):
    port, _, _ = separators
    per_op = Separator(port.model, device="cpu", kernels=False, **KW)
    want = port.separate_all(song[:, :30000], stems=("drums", "vocals"))
    got = per_op.separate_all(song[:, :30000], stems=("drums", "vocals"))
    peak = max(np.abs(w).max() for w in want.values())
    for stem in want:
        np.testing.assert_allclose(got[stem], want[stem], atol=1e-5 * peak,
                                   rtol=0)


def test_int16_song_and_absolute_scale(separators, song):
    port, _, jpcm = separators
    pcm16 = (np.clip(song[:, :40000], -1, 1) * 32767).astype(np.int16)
    got, scales = port.separate_all_pcm(pcm16, stems=("vocals",),
                                        absolute=True)
    want, _ = jpcm.separate_all_pcm(pcm16, stems=("vocals",), absolute=True)
    assert np.all(scales == 1.0)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def _one_shot_pcm(sep, song, stems):
    """``separate_all_pcm``'s int16 output filled the way it was before the
    per-piece fill: every piece enqueued and landed, then all copied in at
    once.  Returns the output and the number of pieces."""
    pieces, _ = sep._enqueue_all_pcm(song, stems, 4, False)
    out = np.empty((len(stems) * 2, song.shape[-1]), np.int16)
    for s0, host, take, copied in pieces:
        assert copied is None                   # no copy to wait on here
        out[:, s0:s0 + take] = host.numpy()[:, :take]
    return out.reshape(len(stems), 2, -1), len(pieces)


@pytest.mark.parametrize("length,schedule,n_pieces", [
    # [2, 4, 4]: the last group clipped, its last chunk past the end
    (75_000, [2, 4, 4], 3),
    # 17 chunks bucketed to 24: the schedule covers 26 and its last two
    # groups start past the end, so 5 pieces, the last one clipped
    (145_000, [2, 4, 4, 4, 4, 4, 4], 5),
    # a 4-chunk grid is one group
    (30_000, [4], 1),
])
def test_per_piece_fill_gives_the_one_shot_bytes(separators, length,
                                                 schedule, n_pieces):
    port, _, _ = separators
    song = (0.3 * np.random.default_rng(length).standard_normal(
        (2, length))).astype(np.float32)
    grid = TC.plan_chunks(length, port.segment, port.overlap)
    assert port._group_schedule(grid, 4) == schedule
    want, pieces = _one_shot_pcm(port, song, ("drums", "vocals"))
    assert pieces == n_pieces
    got, _ = port.separate_all_pcm(song, stems=("drums", "vocals"))
    assert got.dtype == np.int16 and got.shape == (2, 2, length)
    np.testing.assert_array_equal(got, want)


def test_separate_all_pcm_returns_an_array_of_its_own(separators, song):
    port, _, _ = separators
    first, _ = port.separate_all_pcm(song[:, :75_000], stems=("vocals",))
    kept = first.copy()
    root = first
    while isinstance(root.base, np.ndarray):
        root = root.base
    # numpy's own allocation, not a view of a piece's tensor
    assert root.base is None and root.flags.owndata
    second, _ = port.separate_all_pcm(song[:, ::-1][:, :75_000].copy(),
                                      stems=("vocals",))
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(first, second)


@pytest.mark.parametrize("length,bucket", [(1, "auto"), (88200, "auto"),
                                           (400000, "auto"), (50000, 4)])
def test_plan_chunks_matches(length, bucket):
    assert TC.plan_chunks(length, 11025, 2205, bucket) == \
        TC.ChunkGrid(**vars(JC.plan_chunks(length, 11025, 2205, bucket)))


@pytest.mark.parametrize("segment,overlap", [(100, 30), (100, 70), (50, 1)])
def test_fade_weights_match(segment, overlap):
    np.testing.assert_array_equal(TC.fade_weights(segment, overlap).numpy(),
                                  np.asarray(JC.fade_weights(segment, overlap)))


def test_frame_and_overlap_add_match():
    r = np.random.default_rng(1)
    grid = TC.plan_chunks(1000, 300, 80)
    jgrid = JC.plan_chunks(1000, 300, 80)
    x = r.standard_normal((2, 1000)).astype(np.float32)
    frames = TC.frame_song(torch.from_numpy(x), grid)
    np.testing.assert_array_equal(frames.numpy(),
                                  np.asarray(JC.frame_song(jnp.asarray(x),
                                                           jgrid)))
    chunks = r.standard_normal((grid.n_chunks, 3, 300)).astype(np.float32)
    valid = np.arange(grid.n_chunks) * grid.hop < 700
    got = TC.overlap_add_weighted(torch.from_numpy(chunks), grid, 80,
                                  torch.from_numpy(valid))
    want = JC.overlap_add_weighted(jnp.asarray(chunks), jgrid, 80,
                                   jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    acc, wsum = TC.overlap_add_weighted(torch.from_numpy(chunks), grid, 80,
                                        normalize=False)
    jacc, jwsum = JC.overlap_add_weighted(jnp.asarray(chunks), jgrid, 80,
                                          normalize=False)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=1e-6)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(jwsum), atol=1e-6)


@pytest.mark.parametrize("prompt", ["vocals", "a solo jazz saxophone",
                                    "DRUMS and percussion!"])
def test_tokenizer_matches(prompt):
    got = TT.default_tokenizer()([prompt, "bass"])
    want = JT.default_tokenizer()([prompt, "bass"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pretrained_refuses_the_hash_fallback(monkeypatch, tmp_path):
    monkeypatch.delenv("ATSM_TOKENIZER_DIR", raising=False)
    assert isinstance(TT.default_tokenizer(), TT.HashTokenizer)
    with pytest.raises(RuntimeError, match="no real RoBERTa BPE"):
        TT.default_tokenizer(vocab_path=tmp_path, require_real=True)
