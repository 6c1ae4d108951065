"""The port's captured programs (``infer.programs``) on the CPU, against the
JAX package's ``Separator`` and its ``_sweep_cache`` (f32, tiny width).

On the CPU a ``Program`` runs its function on static input buffers and
copies the results into static outputs, the data flow of a CUDA-graph
replay, so these tests hold the buffer protocol the card runs: every
input copied in at each call (a baked-in ``start``, ``length`` or
``scale`` would show as a wrong second song), outputs that the next call
rewrites (a stale carry or PCM would show), and one program per JAX key.

Both Separators hold the same seeded ``init_tiny`` weights and use 0.25 s
chunks with 0.05 s overlap (hop 8820), so a 2 s song is a 10-chunk grid,
run by ``separate_all_pcm`` as groups of [2, 4, 4].  The bounds are those
of ``test_torch_session.py`` and ``test_torch_streaming.py``: one int16
step for the PCM, 1e-4 of the stems' peak for f32 stems (that file's
notes say why the JAX and PyTorch FFTs leave that much).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.infer import Separator as JaxSeparator
from audio_to_sheet_music_tpu.infer import chunked as JC
from audio_to_sheet_music_tpu.infer.streaming import (
    StreamingSeparator as JaxStreamingSeparator)
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.infer import (Separator,
                                                  StreamingSeparator, chunked,
                                                  programs)
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.ops import fused_attn, select

STEMS = ("drums", "bass", "other", "vocals")
KW = dict(segment_seconds=0.25, overlap_seconds=0.05)
FEED = 13_337


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    workers on the host's cores, and each taking all of them slows every
    worker several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    return params, model


@pytest.fixture(scope="module")
def jax_seps(tiny):
    params, _ = tiny
    jf32 = JaxSeparator(params, compute_dtype=jnp.float32,
                        wire_dtype=np.float32, **KW)
    jpcm = JaxSeparator(params, compute_dtype=jnp.float32, **KW)
    return jf32, jpcm


def _fresh(tiny) -> Separator:
    return Separator(tiny[1], device="cpu", **KW)


def _song(seed: int, n: int, rms: float = 0.3) -> np.ndarray:
    return (rms * np.random.default_rng(seed).standard_normal((2, n))
            ).astype(np.float32)


def _group_keys(sep: Separator) -> list:
    return sorted(k for k in sep._programs if k[0] == "group")


# -- parity through the programs ------------------------------------------

def test_separate_all_pcm_through_programs_matches_jax(tiny, jax_seps):
    _, jpcm = jax_seps
    sep = _fresh(tiny)
    song = _song(0, 88200)
    pcm, scales = sep.separate_all_pcm(song, stems=STEMS)
    want, want_scales = jpcm.separate_all_pcm(song, stems=STEMS)
    assert len(_group_keys(sep)) == 2
    assert all(p.replays >= 1 for p in sep._programs.values())
    np.testing.assert_allclose(scales, want_scales, rtol=1e-6)
    diff = np.abs(pcm.astype(np.int32) - want.astype(np.int32))
    assert pcm.shape == (4, 2, 88200) and diff.max() <= 1, diff.max()


def test_separate_all_through_the_sweep_program_matches_jax(tiny, jax_seps):
    jf32, _ = jax_seps
    sep = _fresh(tiny)
    song = _song(0, 88200)
    got = sep.separate_all(song, stems=STEMS)
    want = jf32.separate_all(song, stems=STEMS)
    assert [k[:4] for k in sep._programs] == [(10, sep.segment, 8820, 4)]
    peak = max(np.abs(w).max() for w in want.values())
    for stem in STEMS:
        assert got[stem].shape == song.shape
        np.testing.assert_allclose(got[stem], want[stem], atol=1e-4 * peak,
                                   rtol=0)


def _stream(cls, sep, song, stems, block):
    stream = cls(sep, stems=stems, block_chunks=block)
    pieces = []
    for start in range(0, song.shape[-1], FEED):
        pieces.extend(stream.feed(song[:, start:start + FEED]))
    pieces.append(stream.flush())
    return [np.asarray(p) for p in pieces]


def test_stream_through_the_block_program_matches_jax(tiny, jax_seps):
    jf32, _ = jax_seps
    sep = _fresh(tiny)
    song = _song(4, 80000)
    stems = ("drums", "vocals")
    got = _stream(StreamingSeparator, sep, song, stems, 4)
    want = _stream(JaxStreamingSeparator, jf32, song, stems, 4)
    assert list(sep._programs) == [
        ("stream", 4, sep.segment, 8820, 2, "default", "float32", False)]
    prog = sep._programs[("stream", 4, sep.segment, 8820, 2, "default",
                          "float32", False)]
    assert prog.replays > 2                    # feed's blocks, then flush's
    assert [p.shape for p in got] == [p.shape for p in want]
    peak = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * peak, rtol=0)


# -- two songs through one Separator ---------------------------------------

def test_two_songs_in_turn_equal_fresh_separators(tiny):
    """88200 and 85000 samples share the 10-chunk grid, the [2, 4, 4]
    schedule and so every program; the second song is quieter (another
    scale).  A stale carry or PCM, or a ``start`` / ``length`` / ``scale``
    baked in at the first call, would make the second song differ from the
    same song on a fresh Separator."""
    a, b = _song(5, 88200), _song(6, 85000, rms=0.1)
    sep = _fresh(tiny)
    pcm_a, sc_a = sep.separate_all_pcm(a, stems=STEMS)
    pcm_b, sc_b = sep.separate_all_pcm(b, stems=STEMS)
    all_a = sep.separate_all(a, stems=STEMS)
    all_b = sep.separate_all(b, stems=STEMS)
    assert len(_group_keys(sep)) == 2 and len(sep._programs) == 3
    fresh_b = _fresh(tiny)
    want_pcm, want_sc = fresh_b.separate_all_pcm(b, stems=STEMS)
    want_all = fresh_b.separate_all(b, stems=STEMS)
    np.testing.assert_array_equal(pcm_b, want_pcm)
    np.testing.assert_array_equal(sc_b, want_sc)
    for stem in STEMS:
        np.testing.assert_array_equal(all_b[stem], want_all[stem])
    # the first song's results, kept across the second song's calls
    fresh_a = _fresh(tiny)
    want_pcm_a, _ = fresh_a.separate_all_pcm(a, stems=STEMS)
    want_all_a = fresh_a.separate_all(a, stems=STEMS)
    np.testing.assert_array_equal(pcm_a, want_pcm_a)
    for stem in STEMS:
        np.testing.assert_array_equal(all_a[stem], want_all_a[stem])
    again, _ = sep.separate_all_pcm(a, stems=STEMS)
    np.testing.assert_array_equal(again, pcm_a)
    np.testing.assert_array_equal(sep.separate_all(a, stems=STEMS)["bass"],
                                  want_all_a["bass"])
    assert sc_a[0] != sc_b[0]


_CALLS = {
    "separate": lambda sep, song, stem: sep.separate(song, stem),
    "separate_pcm": lambda sep, song, stem: sep.separate_pcm(song, stem),
    "separate_all": lambda sep, song, stem: sep.separate_all(
        song, stems=(stem, "bass"))[stem],
    "separate_all_pcm": lambda sep, song, stem: sep.separate_all_pcm(
        song, stems=(stem, "bass"))[0][0],
}


@pytest.mark.parametrize("call", sorted(_CALLS))
def test_a_result_outlives_the_next_call(tiny, call):
    """A result handed to the caller is its own: the next call of the
    same program, with another stem or another song of the same grid,
    rewrites the program's outputs but not what an earlier call
    returned."""
    run = _CALLS[call]
    song, other = _song(12, 60000), _song(13, 58000, rms=0.1)
    sep = _fresh(tiny)
    first = run(sep, song, "drums")
    kept = np.array(first, copy=True)
    run(sep, song, "vocals")
    run(sep, other, "drums")
    assert all(p.replays >= 2 for p in sep._programs.values())
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(first, run(_fresh(tiny), song, "drums"))


def test_whole_song_programs_are_bounded(tiny):
    """Songs of ``SWEEP_PROGRAMS + 2`` chunk counts keep only the
    ``SWEEP_PROGRAMS`` most recently used whole-song programs; the group
    programs stay; a dropped length is captured again and still gives the
    fresh separator's stems."""
    from audio_to_sheet_music_tpu_torch.infer import session

    n = session.SWEEP_PROGRAMS
    lengths = [20000 + 2 * 8820 * i for i in range(n + 2)]
    sep = _fresh(tiny)
    sep.separate_all_pcm(_song(14, 88200), stems=("vocals",))
    groups = _group_keys(sep)
    chunks = []
    for i, length in enumerate(lengths):
        sep.separate(_song(15, length), "vocals")
        chunks.append(next(reversed(sep._programs))[0])
        if i == n - 1:                 # the first length, used again
            sep.separate(_song(15, lengths[0]), "vocals")
    assert len(set(chunks)) == n + 2
    sweeps = [k[0] for k in sep._programs if isinstance(k[0], int)]
    assert sweeps == chunks[3:n] + [chunks[0]] + chunks[n:]
    assert _group_keys(sep) == groups
    dropped = _song(15, lengths[1])
    np.testing.assert_array_equal(sep.separate(dropped, "vocals"),
                                  _fresh(tiny).separate(dropped, "vocals"))
    assert len([k for k in sep._programs if isinstance(k[0], int)]) == n


def test_int16_song_after_a_float_song(tiny):
    song = _song(7, 60000)
    pcm16 = (np.clip(song, -1, 1) * 32767).astype(np.int16)
    sep = _fresh(tiny)
    sep.separate_all_pcm(song, stems=("vocals",))
    got, _ = sep.separate_all_pcm(pcm16, stems=("vocals",), absolute=True)
    want, _ = _fresh(tiny).separate_all_pcm(pcm16, stems=("vocals",),
                                            absolute=True)
    np.testing.assert_array_equal(got, want)


# -- keys and counts --------------------------------------------------------

def test_group_programs_keyed_as_the_jax_cache(tiny, jax_seps):
    """The [2, 4, 4] schedule builds two group programs, a second call
    none; another stem count or song dtype builds new ones.  Each key
    starts with the JAX ``_get_group_fn`` key and adds the selection, the
    song's dtype and ``deterministic``."""
    _, jpcm = jax_seps
    sep = _fresh(tiny)
    song = _song(8, 88200)
    sep.separate_all_pcm(song, stems=STEMS)
    keys = _group_keys(sep)
    jpcm._sweep_cache.clear()
    jpcm.separate_all_pcm(song, stems=STEMS)
    assert [k[:5] for k in keys] == sorted(jpcm._sweep_cache)
    assert keys == sorted(
        ("group", g, sep.segment, 8820, 4, "default", "float32", False)
        for g in (2, 4))
    before = {k: id(p) for k, p in sep._programs.items()}
    sep.separate_all_pcm(song, stems=STEMS)
    assert {k: id(p) for k, p in sep._programs.items()} == before
    sep.separate_all_pcm(song, stems=("bass",))
    sep.separate_all_pcm((song * 1000).astype(np.int16), stems=STEMS)
    assert len(_group_keys(sep)) == 6
    assert {(k[1], k[4], k[6]) for k in _group_keys(sep)} == {
        (g, s, d) for g in (2, 4)
        for s, d in ((4, "float32"), (1, "float32"), (4, "int16"))}


def test_sweep_and_stream_keys_mirror_the_jax_cache(tiny, jax_seps):
    jf32, _ = jax_seps
    sep = _fresh(tiny)
    song = _song(9, 60000)
    sep.separate(song, "vocals")
    sep.separate_pcm(song, "vocals")        # the same program
    StreamingSeparator(sep, stems=("vocals",), block_chunks=3).feed(
        _song(9, 3 * 8820 + sep.segment))
    jf32._sweep_cache.clear()
    jf32.separate(song, "vocals")
    jstream = JaxStreamingSeparator(jf32, stems=("vocals",), block_chunks=3)
    jstream.feed(_song(9, 3 * 8820 + sep.segment))
    want = set(jf32._sweep_cache)
    assert {k[:-3] for k in sep._programs} == want
    assert len(sep._programs) == 2
    sep.deterministic = True                 # a key of its own
    sep.separate(song, "vocals")
    assert len(sep._programs) == 3


def test_program_outputs_are_static(tiny):
    sep = _fresh(tiny)
    song = _song(10, 88200)
    sep.separate_all_pcm(song, stems=("vocals",))
    outs = {k: tuple(map(id, p.outputs)) for k, p in sep._programs.items()}
    sep.separate_all_pcm(_song(11, 85000), stems=("vocals",))
    assert {k: tuple(map(id, p.outputs))
            for k, p in sep._programs.items()} == outs

    prog = programs.Program(lambda x, y: (x + y, x * y),
                            [torch.ones(3), torch.ones(3)], "cpu")
    first = prog(torch.ones(3), torch.full((3,), 2.0))
    second = prog(torch.full((3,), 3.0), torch.full((3,), 4.0))
    assert all(a is b for a, b in zip(first, second))
    np.testing.assert_array_equal(second[0].numpy(), [7.0] * 3)
    np.testing.assert_array_equal(second[1].numpy(), [12.0] * 3)
    assert prog.replays == 2 and prog.graph is None


def test_program_checks_its_arguments():
    prog = programs.Program(lambda x: x + 1, [torch.zeros(4)], "cpu")
    with pytest.raises(ValueError, match="captured for"):
        prog(torch.zeros(5))
    with pytest.raises(ValueError, match="captured for"):
        prog(torch.zeros(4, dtype=torch.int16))
    with pytest.raises(TypeError, match="arguments"):
        prog(torch.zeros(4), torch.zeros(4))


# -- launch counts ----------------------------------------------------------

@pytest.fixture
def counters():
    saved = select.launch_counts()
    select.zero_launch_counts()
    yield
    select.zero_launch_counts()
    select.add_launch_counts(saved)


def test_add_launch_counts(counters):
    select.add_launch_counts({"layer_tail": 40, "henc_freq_fused": 4})
    select.add_launch_counts({"layer_tail": -10, "stft": 2,
                              "group_norm": 5})
    # with the layer counters a model module registered in this process
    assert select.launch_counts() == {
        "layer_tail": 30, "henc_freq_fused": 4, "dconv_rows": 0,
        "attn_block": 0, "stft": 2, "group_norm": 5, "dec_join": 0,
        "attn_gated": 0, "rope_qkv": 0, **dict.fromkeys(select.LAYERS, 0)}
    with pytest.raises(KeyError):
        select.add_launch_counts({"no_such_kernel": 1})


def test_launch_delta_reads_what_a_run_counted(counters):
    def run():
        fused_attn.layer_tail.launches += 3
        fused_attn.attn_block.launches += 1
        return "out"

    out, delta = programs.launch_delta(run)
    assert out == "out" and delta == {"layer_tail": 3, "attn_block": 1}
    assert select.launch_counts()["layer_tail"] == 3


class _Graph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_each_replay_adds_the_captured_counts_once(counters):
    prog = programs.Program(lambda x: x * 2, [torch.ones(3)], "cpu")
    prog(torch.ones(3))                     # the static outputs
    prog.graph = _Graph()
    prog.launches = {"layer_tail": 10, "henc_freq_fused": 1}
    for _ in range(3):
        prog(torch.ones(3))
    assert prog.graph.replays == 3 and prog.replays == 4
    counts = select.launch_counts()
    assert counts["layer_tail"] == 30 and counts["henc_freq_fused"] == 3
    assert sum(counts.values()) == 33


# -- the fade window ----------------------------------------------------------

@pytest.mark.parametrize("segment,overlap", [(11025, 2205), (100, 30),
                                             (50, 1)])
def test_fade_weights_kept_per_geometry_and_device(segment, overlap):
    w = chunked.fade_weights(segment, overlap)
    assert chunked.fade_weights(segment, overlap) is w
    assert chunked.fade_weights(segment, overlap, "cpu") is w
    assert chunked.fade_weights(segment, overlap, torch.device("cpu")) is w
    assert chunked.fade_weights(segment, overlap + 1) is not w
    assert not w.is_inference() and w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(),
                                  np.asarray(JC.fade_weights(segment, overlap)))
    with torch.inference_mode():
        assert chunked.fade_weights(segment, overlap) is w
