"""The port's seeded models are the JAX package's (CPU).

Each seeded port module is built from ``nn.prng`` keys and held against
the JAX init of the same key, leaf by leaf under the torch names
(``convert.jax_params``): leaves drawn by ``jax.random.uniform`` (and the
constant ones) bit for bit, leaves drawn by ``jax.random.normal`` (the
CLAP text embeddings, the HTDemucs frequency embedding) within
``prng.NORMAL_RTOL`` (1e-5) of each value.  The frequency embedding is a
running sum of normal rows, whose elements can cancel towards zero, so it
is held to 1e-5 of its largest value instead.

- ``atht.init_tiny`` for seeds 0, 1 and 7, the tiny CLAPSep, the CLAP
  audio tower (it has only its full width) and the tiny CLAP text tower
  at seed 1 (the seed ``eval.models.CLAPSepModel`` gives it);
- a seeded tiny ``Separator`` with no weights loaded against the JAX
  seeded one, to one int16 step;
- the full-width seed-0 fingerprint (``models/seed0_fingerprint.json``)
  against the JAX package's ``atht.init(PRNGKey(0))`` and against the
  port's ``atht.init(0)`` drawn on the CPU.

``python tests/test_torch_seeded_init.py --write`` rewrites the
fingerprint file from the JAX package.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.infer import Separator as JaxSeparator
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.models import clap_audio as JCA
from audio_to_sheet_music_tpu.models import clap_text as JCT
from audio_to_sheet_music_tpu.models import clapsep as JS
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.models import clap_audio as TCA
from audio_to_sheet_music_tpu_torch.models import clap_text as TCT
from audio_to_sheet_music_tpu_torch.models import clapsep as TS
from audio_to_sheet_music_tpu_torch.models import fingerprint
from audio_to_sheet_music_tpu_torch.nn import prng

CUMSUM_LEAVES = ("htdemucs.freq_emb.embedding.weight",)


def _jax_state(params) -> dict:
    return jax_params.state_dict_from_params(jax.tree.map(np.asarray, params))


def _normal(name: str) -> bool:
    return name.endswith(("word_embeddings.weight",
                          "position_embeddings.weight",
                          "token_type_embeddings.weight")) \
        or name in CUMSUM_LEAVES


def _assert_same(got: dict, want: dict) -> int:
    assert set(got) == set(want)
    n_normal = 0
    for k, w in want.items():
        g = got[k].detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if _normal(k):
            n_normal += 1
            atol = (prng.NORMAL_RTOL * np.abs(w).max() if k in CUMSUM_LEAVES
                    else 0.0)
            np.testing.assert_allclose(g, w, rtol=prng.NORMAL_RTOL,
                                       atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=k)
    return n_normal


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_init_tiny_is_the_jax_init_tiny(seed):
    got = TA.init_tiny(seed).state_dict()
    n_normal = _assert_same(got, _jax_state(
        JA.init_tiny(jax.random.PRNGKey(seed))))
    assert n_normal == 4


def test_materialize_false_draws_nothing():
    model = TA.init_tiny(3, materialize=False)
    assert set(model.state_dict()) == set(TA.init_tiny(3).state_dict())


@pytest.mark.parametrize("seed", [0, 5])
def test_clapsep_is_the_jax_clapsep(seed):
    got = TS.ClapSep(TS.TINY, key=prng.PRNGKey(seed)).state_dict()
    _assert_same(got, _jax_state(
        JS.clapsep_init(jax.random.PRNGKey(seed), JS.TINY)))


def test_clap_audio_is_the_jax_clap_audio():
    got = TCA.ClapAudio(key=prng.PRNGKey(0)).state_dict()
    _assert_same(got, _jax_state(JCA.clap_audio_init(jax.random.PRNGKey(0))))


def test_seed_1_clap_text_is_the_jax_one():
    got = TCT.ClapText(num_layers=2, hidden=128,
                       key=prng.PRNGKey(1)).state_dict()
    assert _assert_same(got, _jax_state(JCT.clap_text_init(
        jax.random.PRNGKey(1), num_layers=2, hidden=128))) == 3


def test_seeded_separators_agree_without_loading_weights():
    """No weights move between the packages: each side draws its own."""
    kw = dict(segment_seconds=0.25, overlap_seconds=0.05)
    port = Separator(TA.init_tiny(0), device="cpu", **kw)
    jax_sep = JaxSeparator(JA.init_tiny(jax.random.PRNGKey(0)),
                           compute_dtype=jnp.float32, **kw)
    song = (0.3 * np.random.default_rng(4).standard_normal((2, 44100))
            ).astype(np.float32)
    stems = ("drums", "vocals")
    got, scales = port.separate_all_pcm(song, stems=stems)
    want, want_scales = jax_sep.separate_all_pcm(song, stems=stems)
    np.testing.assert_allclose(scales, want_scales, rtol=1e-6)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def _jax_fingerprint() -> dict:
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in
             _jax_state(JA.init(jax.random.PRNGKey(0))).items()}
    return fingerprint.fingerprint(state)


@pytest.fixture(scope="module")
def jax_seed0():
    return _jax_fingerprint()


def test_fingerprint_file_is_the_jax_seed0_model(jax_seed0):
    want = fingerprint.load()
    assert len(want) == len(jax_seed0) > 500
    assert fingerprint.mismatches(jax_seed0, want) == []
    hashed = [k for k, v in want.items() if "sha256" in v]
    assert len(hashed) == len(want) - len(fingerprint.NORMAL_LEAVES)


def test_port_seed0_model_matches_the_fingerprint(jax_seed0):
    model = TA.init(0)
    got = fingerprint.fingerprint(model.state_dict())
    assert fingerprint.mismatches(got, fingerprint.load()) == []
    assert fingerprint.mismatches(got, jax_seed0) == []
    # the check is not vacuous: one changed value is caught
    model.htdemucs.channel_upsampler.bias.data[0] += 1e-7
    got["htdemucs.channel_upsampler.bias"] = fingerprint.leaf_print(
        "htdemucs.channel_upsampler.bias", model.htdemucs.channel_upsampler.bias)
    assert fingerprint.mismatches(got, jax_seed0) == [
        "htdemucs.channel_upsampler.bias: count or hash differs"]


if __name__ == "__main__" and "--write" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    prints = _jax_fingerprint()
    fingerprint.PATH.write_text("{\n" + ",\n".join(
        f"{json.dumps(k)}: {json.dumps(prints[k], sort_keys=True)}"
        for k in sorted(prints)) + "\n}\n")
    print(f"wrote {fingerprint.PATH}")
