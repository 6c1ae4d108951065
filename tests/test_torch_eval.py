"""The port's evaluation path against the JAX package's (f32, CPU).

One seeded JAX ``atht.init_tiny`` tree (its tower is the JAX
``htdemucs_init`` at channels (8, 16, 24, 32), bottom 64, 2 transformer
layers) is loaded into the port through ``convert.jax_params`` with
``strict=True``; the same numpy-seeded inputs go through both packages.

Tolerances, each relative to the peak of the JAX output: 1e-5 for one
decoder layer (the layer tolerance of ``tests/test_htdemucs_golden.py``),
1e-4 for the whole 4-source tower and for the chunked baseline (met with
room to spare: the tower has no divide by a near-zero spectrum, unlike the
text-conditioned head; the tower measured ~5e-7).  SDR and SI-SDR agree to
1e-4 dB on the same pairs and to 0.01 dB through the two packages'
text-conditioned separators.  The results file and the table are compared
as equal.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.eval import harness as JE
from audio_to_sheet_music_tpu.eval import models as JEM
from audio_to_sheet_music_tpu.infer import chunked as JC
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.models import htdemucs as JH
from audio_to_sheet_music_tpu.ops import dsp as JD
from audio_to_sheet_music_tpu_torch import cli
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.data import synthetic_tracks
from audio_to_sheet_music_tpu_torch.eval import harness as TE
from audio_to_sheet_music_tpu_torch.eval import models as TEM
from audio_to_sheet_music_tpu_torch.infer import chunked as TC
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.models import htdemucs as TH
from audio_to_sheet_music_tpu_torch.ops import dsp as TD
from audio_to_sheet_music_tpu_torch.text.prompts import STEM_NAMES

ROOT = Path(__file__).resolve().parents[1]
LAYER, TOWER, METRIC_DB, SDR_DB = 1e-5, 1e-4, 1e-4, 0.01
TINY = dict(channels=(8, 16, 24, 32), bottom_channels=64, t_layers=2)
BASELINE = dict(segment_seconds=0.25, overlap_ratio=0.25)


@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    return params, model


@pytest.fixture(scope="module")
def tower(pair):
    """The tiny tower alone, loaded from its own subtree."""
    params, _ = pair
    ht = TH.HTDemucs(**TINY)
    ht.load_state_dict(jax_params.state_dict_from_params(params["htdemucs"]),
                       strict=True)
    return params["htdemucs"], ht.requires_grad_(False)


@pytest.fixture(scope="module")
def baselines(tower):
    jparams, ht = tower
    return (JEM.HTDemucsBaseline(jparams, compute_dtype=jnp.float32,
                                 **BASELINE),
            TEM.HTDemucsBaseline(ht, device="cpu", **BASELINE))


@pytest.fixture(scope="module")
def tracks(tmp_path_factory):
    return synthetic_tracks(2, seconds=3.0,
                            cache_dir=tmp_path_factory.mktemp("eval_synth"))


def _near(got, want, tol: float) -> None:
    """max |got - want| <= tol x max |want|."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * peak, f"max err {err:.3g} vs {tol:g} x peak {peak:.3g}"


# ---------------------------------------------------------------------------
# The tower's decoders and forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("freq", [True, False])
@pytest.mark.parametrize("idx", [0, 3])
def test_hdec_layer_apply_matches_jax(tower, freq, idx):
    """Decoder 0 (GELU) and 3 (the last: no GELU, the 16 source
    channels), freq and time; the time crop at an odd length."""
    jparams, ht = tower
    c = TINY["channels"][::-1][idx]
    shape = (2, c, 8, 11) if freq else (2, c, 13)
    length = 49                         # 4 x 13 + 4 - 2 x 2 = 52 >= 49
    r = np.random.default_rng(10 + idx)
    x = r.standard_normal(shape).astype(np.float32)
    skip = r.standard_normal(shape).astype(np.float32)
    key = "decoder" if freq else "tdecoder"
    last = idx == 3
    want_z, want_pre = JH.hdec_layer_apply(
        jparams[key][idx], jnp.asarray(x), jnp.asarray(skip), length,
        freq=freq, last=last)
    with torch.no_grad():
        got_z, got_pre = TH.hdec_layer_apply(
            getattr(ht, key)[idx], torch.from_numpy(x),
            torch.from_numpy(skip), length, freq, last)
    _near(got_z, want_z, LAYER)
    _near(got_pre, want_pre, LAYER)


def test_mask_cac_inverts_magnitude_cac():
    r = np.random.default_rng(2)
    m = r.standard_normal((2, 3, 8, 5, 7)).astype(np.float32)
    z = TD.mask_cac(torch.from_numpy(m))
    want = np.asarray(JD.mask_cac(jnp.asarray(m)))
    np.testing.assert_array_equal(z.real.numpy(), want.real)
    np.testing.assert_array_equal(z.imag.numpy(), want.imag)
    back = TD.magnitude_cac(z.reshape(6, 4, 5, 7)).reshape(m.shape)
    np.testing.assert_array_equal(back.numpy(), m)


def test_forward_matches_jax(baselines):
    """``htdemucs.forward`` on a batch of eight 0.25 s chunks at 0.1 rms,
    against the JAX ``htdemucs.forward`` the JAX baseline compiles."""
    jbase, tbase = baselines
    mix = (0.1 * np.random.default_rng(0).standard_normal(
        (8, 2, tbase.segment))).astype(np.float32)
    want = jbase._fwd(jbase.params, jnp.asarray(mix))
    with torch.no_grad():
        got = TH.forward(tbase.ht, torch.from_numpy(mix))
    assert got.shape == (8, 4, 2, tbase.segment) and got.dtype == torch.float32
    _near(got, want, TOWER)


# ---------------------------------------------------------------------------
# Chunking and the baseline
# ---------------------------------------------------------------------------

def _per_chunk(chunks):
    """A stand-in model that depends on each chunk's own statistics:
    (n, 2, L) -> (n, 4, L)."""
    return chunks, chunks * (chunks ** 2).mean(-1, keepdims=True)


@pytest.mark.parametrize("chunk_batch", [None, 3, 8, 20])
def test_separate_chunked_matches_jax(chunk_batch):
    """A 5300-sample song on 1000-sample chunks (8 after the bucket), all
    at once or in ragged blocks of 3."""
    song = np.random.default_rng(4).standard_normal((2, 5300)).astype(
        np.float32)

    def jfn(c):
        a, b = _per_chunk(c)
        return jnp.concatenate([jnp.sin(3 * a), b], axis=1)

    def tfn(c):
        a, b = _per_chunk(c)
        return torch.cat([torch.sin(3 * a), b], dim=1)

    want = JC.separate_chunked(jfn, jnp.asarray(song), 1000, 250,
                               chunk_batch=chunk_batch)
    got = TC.separate_chunked(tfn, torch.from_numpy(song), 1000, 250,
                              chunk_batch=chunk_batch)
    assert got.shape == (4, 5300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_baseline_separate_all_matches_jax(baselines):
    """The chunked 4-source baseline on a 30000-sample song (0.25 s chunks,
    25 % overlap: 8 chunks after the bucket)."""
    jbase, tbase = baselines
    assert tbase.device == torch.device("cpu")
    assert tbase.compute_dtype == torch.float32
    song = (0.1 * np.random.default_rng(0).standard_normal((2, 30000))
            ).astype(np.float32)
    got = tbase.separate_all(song)
    want = jbase.separate_all(song)
    assert set(got) == set(STEM_NAMES)
    peak = max(np.abs(w).max() for w in want.values())
    for s in STEM_NAMES:
        assert got[s].shape == (2, 30000) and got[s].dtype == np.float32
        np.testing.assert_allclose(got[s], want[s], atol=TOWER * peak, rtol=0)
    np.testing.assert_array_equal(tbase.separate(song, "drums"), got["drums"])


def test_baseline_name_is_honest_about_weights(tower):
    _, ht = tower
    assert TEM.HTDemucsBaseline(ht, device="cpu").name == \
        "HTDemucs (random init)"
    assert TEM.HTDemucsBaseline(ht, device="cpu", pretrained=True).name == \
        "HTDemucs (pretrained)"


# ---------------------------------------------------------------------------
# Metrics, results file, table
# ---------------------------------------------------------------------------

def _metric_pairs():
    r = np.random.default_rng(5)
    ref = r.standard_normal((2, 20000)).astype(np.float32)
    noise = r.standard_normal((2, 20000)).astype(np.float32)
    return {"noisy": (ref + 0.3 * noise, ref),
            "faint": (ref + 3.0 * noise, ref),
            "noise only": (noise, ref),
            "exact: +30 clamp": (ref.copy(), ref),
            "scaled: SI-SDR +30 clamp": (2.0 * ref, ref),
            "swamped: -30 clamp": (1e3 * noise, ref)}


@pytest.mark.parametrize("case", list(_metric_pairs()))
def test_compute_metrics_matches_jax(case):
    est, ref = _metric_pairs()[case]
    got = TE.compute_metrics(est, ref)
    want = JE.compute_metrics(est, ref)
    assert np.abs(np.subtract(got, want)).max() <= METRIC_DB, (got, want)
    assert TE.compute_sdr(est, ref) == got[0]
    assert TE.compute_sisdr(est, ref) == got[1]
    if "clamp" in case:
        assert 30.0 in np.abs(got)


def _results(cls):
    nan = float("nan")
    a = {s: -1.5 + i for i, s in enumerate(STEM_NAMES)}
    return {
        "model A": [cls("t0", "model A", {**a, "average": 0.0},
                        {**a, "average": -0.25}),
                    cls("t1", "model A", {**a, "drums": nan, "average": nan},
                        {**a, "average": 30.0})],
        "model B (empty)": [],
    }


def test_save_results_and_table_match_jax(tmp_path):
    got, want = _results(TE.TrackResult), _results(JE.TrackResult)
    TE.save_results(got, tmp_path / "port.json")
    JE.save_results(want, tmp_path / "jax.json")
    port = json.loads((tmp_path / "port.json").read_text())
    assert port == json.loads((tmp_path / "jax.json").read_text())
    assert port["model B (empty)"]["aggregate"]["sdr"]["drums"] is None
    assert port["model A"]["per_track"][1]["sdr"]["drums"] is None
    assert TE.format_results_table(got) == JE.format_results_table(want)


def test_evaluate_ours_matches_jax(pair, tracks):
    """``OursModel`` on two 3 s synthetic tracks, the same tiny weights in
    both packages' ``Separator``: per-stem SDR and SI-SDR within 0.01 dB."""
    params, model = pair
    port = TEM.OursModel(model, device="cpu")
    jax_model = JEM.OursModel(params, compute_dtype=jnp.float32,
                              wire_dtype=np.float32)
    got = TE.evaluate_model(port.separate_all, tracks, port.name,
                            verbose=False)
    want = JE.evaluate_model(jax_model.separate_all, tracks, port.name,
                             verbose=False)
    assert [r.track_name for r in got] == ["synth_0", "synth_1"]
    for g, w in zip(got, want):
        for metric in ("sdr", "sisdr"):
            a, b = getattr(g, metric), getattr(w, metric)
            assert set(a) == set(STEM_NAMES) | {"average"}
            assert max(abs(a[k] - b[k]) for k in a) <= SDR_DB, (a, b)


def test_bad_track_is_skipped(tracks, tmp_path):
    """A track that cannot load and a separator that raises are reported
    and skipped; the good track still counts."""
    missing = type(tracks[0])("gone", tmp_path / "gone.npy", "npy")

    def oracle(mixture):
        arr = tracks[0].load(mmap=False)
        return {s: arr[1 + i] for i, s in enumerate(STEM_NAMES)}

    res = TE.evaluate_model(oracle, [missing, tracks[0]], "oracle",
                            verbose=False)
    assert [r.track_name for r in res] == [tracks[0].name]
    assert res[0].sdr["average"] == pytest.approx(30.0)

    def explode(mixture):
        raise RuntimeError("boom")

    assert TE.evaluate_model(explode, tracks, "broken", verbose=False) == []


# ---------------------------------------------------------------------------
# The benchmark command
# ---------------------------------------------------------------------------

MODEL_NAMES = {"AudioTextHTDemucs (Ours)",
               "AudioTextHTDemucs (Ours, random head)",
               "HTDemucs (random init)"}


def test_cli_benchmark_writes_the_jax_schema(tmp_path):
    env = {**os.environ, "ATSM_TINY_MODEL": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "audio_to_sheet_music_tpu_torch.cli",
         "benchmark", "--synthetic", "--synthetic-tracks", "1", "--device",
         "cpu", "--models", "ours", "ours-random", "htdemucs",
         "--output-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "=== SDR (dB) ===" in out.stdout
    payload = json.loads((tmp_path / "evaluation_results.json").read_text())
    assert set(payload) == MODEL_NAMES
    for entry in payload.values():
        assert set(entry) == {"per_track", "aggregate"}
        (track,) = entry["per_track"]
        assert set(track) == {"track", "sdr", "sisdr"}
        assert set(track["sdr"]) == set(STEM_NAMES) | {"average"}
        for metric in ("sdr", "sisdr"):
            vals = entry["aggregate"][metric].values()
            assert all(isinstance(v, float) and math.isfinite(v)
                       and -30.0 <= v <= 30.0 for v in vals)


def test_cli_benchmark_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["benchmark", "--synthetic", "--synthetic-tracks", "1",
                  "--output-dir", str(tmp_path)])


@pytest.mark.parametrize("argv", [["--models", "demucs"],
                                  ["--models", "ours", "clap"],
                                  ["--kernels", "all"]])
def test_cli_benchmark_refuses_what_is_not_ported(argv, capsys):
    """The parser takes the JAX command's four models and the port's
    kernel selections; anything else is refused before a model is built."""
    with pytest.raises(SystemExit) as e:
        cli.main(["benchmark", *argv])
    assert e.value.code == 2


def test_init_from_env(monkeypatch):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    tiny = TA.init_from_env(0)
    assert tiny.htdemucs.channel_upsampler.weight.shape[0] == 64
    monkeypatch.delenv("ATSM_TINY_MODEL")
    monkeypatch.setattr(TA, "init", lambda seed: ("init", seed))
    assert TA.init_from_env(3) == ("init", 3)
