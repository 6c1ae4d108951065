"""Log-mel spectrogram front end of the CLAP audio tower.

Counterpart of ``audio_to_sheet_music_tpu/ops/mel.py``: HF
``ClapFeatureExtractor``'s un-fused path (48 kHz, Hann 1024, hop 480, 64
mels over 0-14 kHz, power 2, dB).  The filterbanks are built in numpy
float64 and cast to float32: slaney norm and scale for the un-fused
(``rand_trunc``) path, htk without norm for the fusion path.  The STFT is
``ops.dsp.stft`` unscaled (``normalized=False``), the filterbank product a
matmul on the waveform's device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dsp

SAMPLE_RATE = 48_000
N_FFT = 1024
HOP = 480
N_MELS = 64
FREQ_MIN = 0.0
FREQ_MAX = 14_000.0
MAX_SAMPLES = 10 * SAMPLE_RATE


def _hz_to_mel(freq, scale: str):
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # slaney: linear below 1 kHz, log above
    mel = 3.0 * freq / 200.0
    if np.isscalar(freq):
        if freq >= 1000.0:
            mel = 15.0 + np.log(freq / 1000.0) / (np.log(6.4) / 27.0)
        return mel
    log_region = freq >= 1000.0
    mel = np.asarray(mel, dtype=np.float64)
    mel[log_region] = 15.0 + np.log(freq[log_region] / 1000.0) / (
        np.log(6.4) / 27.0)
    return mel


def _mel_to_hz(mel, scale: str):
    if scale == "htk":
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    freq = 200.0 * mel / 3.0
    log_region = mel >= 15.0
    freq = np.asarray(freq, dtype=np.float64)
    freq[log_region] = 1000.0 * np.exp((np.log(6.4) / 27.0)
                                       * (mel[log_region] - 15.0))
    return freq


def mel_filter_bank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = N_MELS,
                    fmin: float = FREQ_MIN, fmax: float = FREQ_MAX,
                    sr: int = SAMPLE_RATE, norm: str | None = "slaney",
                    scale: str = "slaney") -> np.ndarray:
    """Triangular filterbank ``(n_freqs, n_mels)`` float32 (HF
    ``mel_filter_bank``)."""
    mel_pts = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, scale)
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def log_mel_spectrogram(waveform: torch.Tensor,
                        fusion_filters: bool = False) -> torch.Tensor:
    """48 kHz mono ``(..., T)`` -> log-mel ``(..., T // 480 + 1, 64)`` in
    dB, on the waveform's device (10 s -> 1001 frames)."""
    fb = (mel_filter_bank(norm=None, scale="htk") if fusion_filters
          else mel_filter_bank())
    z = dsp.stft(waveform.float(), N_FFT, HOP, normalized=False)
    power = z.real.square() + z.imag.square()            # (..., 513, T')
    mel = torch.matmul(power.transpose(-1, -2),
                       torch.from_numpy(fb).to(power.device))
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def prepare_input_features(waveform_48k: np.ndarray, device="cuda"
                           ) -> torch.Tensor:
    """Raw mono 48 kHz audio (host array) -> the ``(1, 1, 1001, 64)`` model
    input on ``device``: ``repeatpad`` short audio up to 10 s, keep the
    first 10 s window of longer audio (the deterministic variant of HF's
    ``rand_trunc``)."""
    wav = np.asarray(waveform_48k, np.float32).reshape(-1)
    if len(wav) < MAX_SAMPLES:
        n_repeat = max(1, MAX_SAMPLES // max(len(wav), 1))
        wav = np.tile(wav, n_repeat)
        wav = np.pad(wav, (0, MAX_SAMPLES - len(wav)))
    else:
        wav = wav[:MAX_SAMPLES]
    mel = log_mel_spectrogram(torch.from_numpy(wav).to(device))
    return mel[None, None]
