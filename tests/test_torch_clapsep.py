"""The CLAPSep baseline in the port against the JAX package (CPU, f32).

- ``dsp.istft`` at CLAPSep's geometry (n_fft 1024, hop 320: the hop does
  not divide the window) against the JAX ``dsp.istft`` overlap-add path,
  within 1e-5 of the peak; the STFT the same way.
- ``TINY`` ``forward`` within 1e-5 of the peak, on the JAX
  ``clapsep_init`` params carried across by ``convert/jax_params``.
- ``CLAPSepModel.separate`` (the reference protocol: mono, 32 kHz, chunks,
  queries, overlap-add, back to 44.1 kHz, stereo) within 1e-4 of the peak.
- A weights file that is not there raises the ``RuntimeError`` the
  benchmark skips on; one that is there loads and names the model.
- ``cli benchmark --models ours clapsep`` at test size writes the JAX
  results schema, and a missing CLAPSep weights file skips that model.
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.eval.models import CLAPSepModel as JaxCLAPSep
from audio_to_sheet_music_tpu.models import clap_text as JCT
from audio_to_sheet_music_tpu.models import clapsep as JCS
from audio_to_sheet_music_tpu.ops import dsp as JD
from audio_to_sheet_music_tpu_torch import cli
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.eval.models import CLAPSepModel
from audio_to_sheet_music_tpu_torch.models import clap_text as TCT
from audio_to_sheet_music_tpu_torch.models import clapsep as TCS
from audio_to_sheet_music_tpu_torch.ops import dsp as TD
from audio_to_sheet_music_tpu_torch.text.prompts import STEM_NAMES
from audio_to_sheet_music_tpu_torch.text.tokenizer import HashTokenizer

CHUNKING = dict(chunk_seconds=0.5, overlap_seconds=0.05)


@pytest.fixture(scope="module")
def sep_params():
    return jax.tree.map(np.asarray, JCS.clapsep_init(jax.random.PRNGKey(0),
                                                     JCS.TINY))


@pytest.fixture(scope="module")
def port_sep(sep_params):
    model = TCS.ClapSep(TCS.TINY)
    model.load_state_dict(jax_params.state_dict_from_params(sep_params),
                          strict=True)
    return model


def test_stft_istft_at_clapsep_geometry():
    r = np.random.default_rng(0)
    wav = (0.3 * r.standard_normal((2, 32000))).astype(np.float32)
    want_z = np.asarray(JD.stft(jnp.asarray(wav), 1024, 320))
    got_z = TD.stft(torch.from_numpy(wav), 1024, 320).numpy()
    assert got_z.shape == want_z.shape == (2, 513, 101)
    assert np.abs(got_z - want_z).max() <= 1e-5 * np.abs(want_z).max()
    z = (want_z * np.exp(1j * r.uniform(0, 6.3, want_z.shape))
         ).astype(np.complex64)
    want = np.asarray(JD.istft(jnp.asarray(z), 32000, 1024, 320))
    got = TD.istft(torch.from_numpy(z), 32000, 1024, 320).numpy()
    assert got.shape == want.shape == (2, 32000)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_tiny_forward_matches_jax(sep_params, port_sep):
    r = np.random.default_rng(1)
    wav = (0.1 * r.standard_normal((2, 6401))).astype(np.float32)
    ep = r.standard_normal((2, 512)).astype(np.float32)
    en = r.standard_normal((2, 512)).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: JCS.forward(*a, JCS.TINY))(
        sep_params, wav, ep, en))
    with torch.no_grad():
        got = TCS.forward(port_sep, *map(torch.from_numpy, (wav, ep, en)))
    assert got.shape == want.shape == wav.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_separate_matches_jax(sep_params, port_sep):
    text = jax.tree.map(np.asarray, JCT.clap_text_init(
        jax.random.PRNGKey(1), num_layers=2, hidden=128))
    clap = TCT.ClapText(num_layers=2, hidden=128)
    clap.load_state_dict(jax_params.state_dict_from_params(text), strict=True)
    jm = JaxCLAPSep(clap_params=text, cfg=JCS.TINY, tokenizer=HashTokenizer(),
                    **CHUNKING)
    tm = CLAPSepModel(clap=clap, cfg=TCS.TINY, tokenizer=HashTokenizer(),
                      device="cpu", **CHUNKING)
    tm.model.load_state_dict(port_sep.state_dict(), strict=True)
    assert tm.name == jm.name == "CLAPSep (random init)"
    song = (0.2 * np.random.default_rng(2).standard_normal((2, 61000))
            ).astype(np.float32)
    for stem in ("vocals", "piano"):
        want = jm.separate(song, stem)
        got = tm.separate(song, stem)
        assert got.shape == want.shape == song.shape
        np.testing.assert_array_equal(got[0], got[1])
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_weights_file(tmp_path, port_sep):
    with pytest.raises(RuntimeError, match="skipping"):
        CLAPSepModel(weights=str(tmp_path / "absent.pt"), cfg=TCS.TINY,
                     device="cpu")
    torch.save({"model_state_dict": {"module." + k: v for k, v in
                                     port_sep.state_dict().items()}},
               tmp_path / "w.pt")
    m = CLAPSepModel(clap=TCT.ClapText(num_layers=1, hidden=64),
                     weights=str(tmp_path / "w.pt"), cfg=TCS.TINY,
                     tokenizer=HashTokenizer(), device="cpu")
    assert m.name == "CLAPSep (Baseline)"
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, port_sep.state_dict()[k]), k


def test_cli_benchmark_runs_clapsep(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    cli.main(["benchmark", "--synthetic", "--synthetic-tracks", "1",
              "--device", "cpu", "--models", "ours", "clapsep",
              "--max-tracks", "1", "--output-dir", str(tmp_path)])
    payload = json.loads((tmp_path / "evaluation_results.json").read_text())
    assert set(payload) == {"AudioTextHTDemucs (Ours)",
                            "CLAPSep (random init)"}
    for entry in payload.values():
        assert set(entry) == {"per_track", "aggregate"}
        (track,) = entry["per_track"]
        assert set(track) == {"track", "sdr", "sisdr"}
        assert set(track["sdr"]) == set(STEM_NAMES) | {"average"}
        for metric in ("sdr", "sisdr"):
            vals = entry["aggregate"][metric].values()
            assert all(isinstance(v, float) and math.isfinite(v)
                       and -30.0 <= v <= 30.0 for v in vals)
    monkeypatch.setenv("ATSM_CLAPSEP_CKPT", str(tmp_path / "absent.pt"))
    capsys.readouterr()
    cli.main(["benchmark", "--synthetic", "--synthetic-tracks", "1",
              "--device", "cpu", "--models", "clapsep", "ours-random",
              "--output-dir", str(tmp_path / "skip")])
    assert "skipping clapsep" in capsys.readouterr().out
    payload = json.loads((tmp_path / "skip" / "evaluation_results.json"
                          ).read_text())
    assert set(payload) == {"AudioTextHTDemucs (Ours, random head)"}
