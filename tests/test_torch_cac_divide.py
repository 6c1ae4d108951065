"""The head's divide by its signed CaC plane + 1e-8 (``models/atht.py``,
``apply_head``) magnifies perturbations of the STFT's values near zero,
and only those (tiny width, CPU).

The head divides the mixture's spectrogram by the real and imaginary
planes of its first channel plus 1e-8, as the reference does.  Where such
a value lies near -1e-8 the quotient is large, and a change in the last
bits of the STFT there moves the separated stems by far more than the
change itself.  That is why two STFTs that agree to rounding (cuFFT and
the port's STFT kernel) give stems that differ visibly on a song.  The
test perturbs ``dsp.stft``'s output three ways on one song: seeded noise
of 1e-8 rms everywhere, the same noise kept off values under 1e-6 in
magnitude, and one ulp up or down at random.  The first moves the stems
by orders of magnitude more than the other two.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu_torch.infer import Separator
from audio_to_sheet_music_tpu_torch.models import atht
from audio_to_sheet_music_tpu_torch.ops import dsp

STEMS = ("drums", "vocals")
SIGMA = 1e-8


def _song(seconds: float = 2.0) -> np.ndarray:
    """Sines at 55/220/880 Hz + 0.05 noise, as ``chip_smoke.py``'s song."""
    n = int(seconds * 44100)
    t = np.arange(n) / 44100
    tone = sum(np.sin(2 * math.pi * f * t) for f in (55.0, 220.0, 880.0))
    noise = np.random.default_rng(0).standard_normal((2, n))
    return (0.2 * tone + 0.05 * noise).astype(np.float32)


def _perturbed(what: str, orig):
    """``orig`` (``dsp.stft``) with its output moved as ``what`` says."""
    gen = torch.Generator().manual_seed(0)

    def stft(x, n_fft=4096, hop=1024, kernel=False, normalized=True):
        z = orig(x, n_fft, hop, kernel=kernel, normalized=normalized)
        r = torch.view_as_real(z)
        if what == "ulp":
            up = torch.rand(r.shape, generator=gen) < 0.5
            inf = torch.full_like(r, math.inf)
            moved = torch.nextafter(r, torch.where(up, inf, -inf))
        else:
            noise = torch.randn(r.shape, generator=gen) * SIGMA
            if what == "far":
                noise = torch.where(r.abs() >= 1e-6, noise, 0.0)
            moved = r + noise
        return torch.view_as_complex(moved.contiguous())

    return stft


@pytest.fixture(scope="module")
def moved():
    torch.manual_seed(0)
    model = atht.init_tiny()
    song = _song()

    def stems() -> dict:
        sep = Separator(model, device="cpu", segment_seconds=0.25,
                        overlap_seconds=0.05)
        return sep.separate_all(song, stems=STEMS)

    base = stems()
    out = {}
    orig = dsp.stft
    mp = pytest.MonkeyPatch()
    try:
        for what in ("noise", "far", "ulp"):
            mp.setattr(dsp, "stft", _perturbed(what, orig))
            got = stems()
            out[what] = max(float(np.sqrt(np.mean((got[s] - base[s]) ** 2)))
                            for s in STEMS)
    finally:
        mp.undo()
    out["stem_rms"] = min(float(np.sqrt(np.mean(base[s] ** 2)))
                          for s in STEMS)
    return out


def test_noise_near_zero_moves_the_stems(moved):
    # 1e-8 rms of noise on the spectrogram, and the stems move by more
    # than a thousandth of their own rms
    assert moved["noise"] > 1e-3 * moved["stem_rms"], moved


def test_noise_away_from_zero_barely_moves_them(moved):
    assert moved["far"] < 1e-6 * moved["stem_rms"], moved
    assert moved["noise"] > 1e3 * moved["far"], moved


def test_one_ulp_barely_moves_them(moved):
    assert moved["ulp"] < 1e-6 * moved["stem_rms"], moved
