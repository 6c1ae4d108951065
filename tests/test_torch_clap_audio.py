"""The CLAP audio tower, the mel front end and the whole CLAP model in the
port against the JAX package (CPU, f32).

- ``log_mel_spectrogram`` within 1e-3 dB of JAX, slaney and htk banks, and
  ``prepare_input_features`` (repeat-padded short audio, the first 10 s of
  long audio) the same way.
- ``reshape_mel2img`` within 1e-6 of JAX.
- HTSAT ``audio_embeds`` at full width, batch 1, within 1e-4 of max|ref|,
  on the JAX ``clap_audio_init`` params carried across by
  ``convert/jax_params`` (with seeded relative-position tables and BatchNorm
  statistics, which that init leaves at zeros and ones).
- ``clap.similarity`` (a tiny text tower, the full audio tower) within 1e-4
  of max|ref|.
- Against ``transformers``' ``ClapAudioModelWithProjection`` through the HF
  audio name map, at the JAX package's tolerance against it (5e-3 absolute,
  1e-2 relative: HF resizes with ``F.interpolate``, whose f32 source
  positions differ from the float64 matrix).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.models import clap as JC
from audio_to_sheet_music_tpu.models import clap_audio as JCA
from audio_to_sheet_music_tpu.models import clap_text as JCT
from audio_to_sheet_music_tpu.ops import mel as JM
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.convert import torch_import as TTI
from audio_to_sheet_music_tpu_torch.models import clap as TC
from audio_to_sheet_music_tpu_torch.models import clap_audio as TCA
from audio_to_sheet_music_tpu_torch.models import clap_text as TCT
from audio_to_sheet_music_tpu_torch.ops import mel as TM


@pytest.fixture(scope="module")
def audio_params():
    params = jax.tree.map(np.asarray,
                          JCA.clap_audio_init(jax.random.PRNGKey(0)))
    r = np.random.default_rng(4)
    for stage in params["layers"]:
        for blk in stage["blocks"]:
            t = blk["attention"]["self"]["relative_position_bias_table"]
            blk["attention"]["self"]["relative_position_bias_table"] = (
                0.02 * r.standard_normal(t.shape)).astype(np.float32)
    bn = params["batch_norm"]
    bn["running_mean"] = r.standard_normal(64).astype(np.float32)
    bn["running_var"] = r.uniform(0.5, 2.0, 64).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def port_audio(audio_params):
    model = TCA.ClapAudio()
    model.load_state_dict(jax_params.state_dict_from_params(audio_params),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(1).standard_normal((1, 1, 1001, 64)
                                                    ).astype(np.float32)


@pytest.mark.parametrize("fusion", [False, True])
def test_log_mel_matches_jax(fusion):
    wav = (0.2 * np.random.default_rng(0).standard_normal(3 * 48000)
           ).astype(np.float32)
    want = np.asarray(JM.log_mel_spectrogram(jnp.asarray(wav),
                                             fusion_filters=fusion))
    got = TM.log_mel_spectrogram(torch.from_numpy(wav), fusion).numpy()
    assert got.shape == want.shape == (301, 64)
    assert np.abs(got - want).max() <= 1e-3
    np.testing.assert_array_equal(TM.mel_filter_bank(), JM.mel_filter_bank())


@pytest.mark.parametrize("seconds", [3.3, 12.0])
def test_prepare_input_features_matches_jax(seconds):
    wav = (0.2 * np.random.default_rng(2).standard_normal(int(seconds * 48000))
           ).astype(np.float32)
    want = JM.prepare_input_features(wav)
    got = TM.prepare_input_features(wav, device="cpu").numpy()
    assert got.shape == want.shape == (1, 1, 1001, 64)
    assert np.abs(got - want).max() <= 1e-3


def test_reshape_mel2img_matches_jax(feats):
    want = np.asarray(JCA.reshape_mel2img(jnp.asarray(feats)))
    got = TCA.reshape_mel2img(torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (1, 1, 256, 256)
    assert np.abs(got - want).max() <= 1e-6


def test_audio_embeds_match_jax(audio_params, port_audio, feats):
    want = np.asarray(jax.jit(JCA.audio_embeds)(audio_params, feats))
    with torch.no_grad():
        got = TCA.audio_embeds(port_audio, torch.from_numpy(feats)).numpy()
        unit = TCA.get_audio_features(port_audio, torch.from_numpy(feats))
    assert got.shape == want.shape == (1, 512)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(float(unit.norm()), 1.0, atol=1e-6)


def test_similarity_matches_jax(audio_params, port_audio, feats):
    text = jax.tree.map(np.asarray, JCT.clap_text_init(
        jax.random.PRNGKey(1), num_layers=2, hidden=128))
    params = {"text": text, "audio": audio_params,
              "logit_scale_t": np.float32(2.1),
              "logit_scale_a": np.float32(2.9)}
    model = TC.Clap(TCT.ClapText(num_layers=2, hidden=128),
                    TCA.ClapAudio(gen=None))
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    ids = np.array([[0, 7, 2, 1], [0, 9, 11, 2], [0, 5, 6, 2]], np.int32)
    mask = (ids != 1).astype(np.int32)
    want = jax.jit(JC.similarity)(params, ids, mask, feats)
    with torch.no_grad():
        got = TC.similarity(model, torch.from_numpy(ids),
                            torch.from_numpy(mask), torch.from_numpy(feats))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    np.testing.assert_allclose(got[0].numpy().T, got[1].numpy()
                               * np.exp(2.9 - 2.1), rtol=1e-5)


def test_against_transformers_through_the_hf_name_map(feats):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.ClapAudioModelWithProjection(
        transformers.ClapAudioConfig()).eval()
    model = TTI.import_clap_audio_state(hf.state_dict(), strict=True)
    x = torch.from_numpy(np.concatenate([feats, -feats]))
    with torch.no_grad():
        want = hf(input_features=x).audio_embeds.numpy()
        got = TCA.audio_embeds(model, x).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-2)
    with pytest.raises(KeyError, match="missing"):
        TTI.import_clap_audio_state({}, strict=True)
