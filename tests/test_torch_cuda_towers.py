"""The modules of the checkpoint, loader and tower slice on the card.

Marked ``cuda``: each test skips without a card (decided in the fixture).
On a machine with one, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_towers.py

- The C++ segment loader built with g++ on the card's host, its batches on
  the card through ``trainer.put_batch`` equal to the host arrays.
- The HTSAT tower (full width, f32, no TF32) on ``cuda`` against the CPU
  within 1e-4 of max|ref|, batch 2, and the mel front end within 1e-3 dB.
- ``CLAPSepModel`` at ``TINY`` width on ``cuda`` against the CPU within
  1e-4 of the peak, and a full-width 10 s chunk within 1e-4 of rms(ref).
- The seeded init drawn on the card equals the one drawn on the CPU: the
  uniform leaves bit for bit, the normal ones within ``NORMAL_RTOL``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu_torch.data import native_loader, synthetic_tracks
from audio_to_sheet_music_tpu_torch.eval.models import CLAPSepModel
from audio_to_sheet_music_tpu_torch.models import (atht, clap_audio, clap_text,
                                                   clapsep, fingerprint)
from audio_to_sheet_music_tpu_torch.nn import prng
from audio_to_sheet_music_tpu_torch.ops import mel
from audio_to_sheet_music_tpu_torch.text.tokenizer import HashTokenizer
from audio_to_sheet_music_tpu_torch.train.trainer import put_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_segment_loader_on_the_card_host(card, tmp_path):
    tracks = synthetic_tracks(2, seconds=3.0, cache_dir=tmp_path)
    loader = native_loader.NativeBatchLoader([t.path for t in tracks], 22050,
                                             4, HashTokenizer(), n_threads=4)
    n = 0
    for raw in loader:
        batch = put_batch(raw, card)
        for k, v in batch.items():
            assert v.device.type == "cuda"
            assert np.array_equal(v.cpu().numpy(), raw[k])
        n += 1
    assert n == len(loader) > 0


@torch.no_grad()
def test_clap_audio_on_the_card(card):
    model = clap_audio.ClapAudio(key=prng.PRNGKey(0))
    wav = (0.2 * np.random.default_rng(0).standard_normal(4 * 48000)
           ).astype(np.float32)
    f_cpu = mel.prepare_input_features(wav, device="cpu")
    f_card = mel.prepare_input_features(wav, device=card)
    assert (f_card.cpu() - f_cpu).abs().max() <= 1e-3
    feats = torch.cat([f_cpu, -0.5 * f_cpu])
    ref = clap_audio.audio_embeds(model, feats)
    got = clap_audio.audio_embeds(model.to(card), feats.to(card)).cpu()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@torch.no_grad()
def test_clapsep_on_the_card(card):
    clap = clap_text.ClapText(num_layers=2, hidden=128,
                              key=prng.PRNGKey(1))
    kw = dict(cfg=clapsep.TINY, tokenizer=HashTokenizer(), chunk_seconds=0.5,
              overlap_seconds=0.05)
    on_cpu = CLAPSepModel(clap=clap, device="cpu", **kw)
    on_card = CLAPSepModel(clap=clap_text.ClapText(num_layers=2, hidden=128),
                           device=card, **kw)
    on_card.clap.load_state_dict(on_cpu.clap.state_dict())
    on_card.model.load_state_dict(on_cpu.model.state_dict())
    song = (0.2 * np.random.default_rng(2).standard_normal((2, 61000))
            ).astype(np.float32)
    want = on_cpu.separate(song, "bass")
    got = on_card.separate(song, "bass")
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    full = clapsep.ClapSep(key=prng.PRNGKey(0))
    r = np.random.default_rng(3)
    wav = torch.from_numpy((0.1 * r.standard_normal((1, 320000))
                            ).astype(np.float32))
    ep, en = (torch.from_numpy(r.standard_normal((1, 512)).astype(np.float32))
              for _ in range(2))
    ref = clapsep.forward(full, wav, ep, en)
    got = clapsep.forward(full.to(card), wav.to(card), ep.to(card),
                          en.to(card)).cpu()
    rms = (got - ref).pow(2).mean().sqrt()
    assert rms <= 1e-4 * ref.pow(2).mean().sqrt()


def test_seeded_draw_on_the_card_matches_the_cpu(card):
    on_card = atht.init_tiny(7, device=card).state_dict()
    on_cpu = atht.init_tiny(7).state_dict()
    for k, want in on_cpu.items():
        got = on_card[k]
        assert got.device.type == "cuda", k
        if k in fingerprint.NORMAL_LEAVES:
            torch.testing.assert_close(got.cpu(), want, rtol=prng.NORMAL_RTOL,
                                       atol=prng.NORMAL_RTOL
                                       * float(want.abs().max()))
        else:
            assert torch.equal(got.cpu(), want), k

