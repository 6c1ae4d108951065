"""WAV read/write and resampling with scipy (no ffmpeg).

Counterpart of ``audio_to_sheet_music_tpu/utils/audio_io.py``: float32 and
int16 WAV IO, polyphase resampling to 44.1 kHz, mono -> stereo.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np


def read_wav_pcm(path: str | Path) -> tuple[int, np.ndarray]:
    """-> (sample_rate, int16 (C, T)).  16-bit WAVs pass straight through
    (``Separator`` takes int16 mixtures and converts on the device); other
    encodings are read as float and quantised."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.T if data.ndim == 2 else data[None, :]
        return int(sr), np.ascontiguousarray(wav)
    sr, f32 = read_wav(path)
    return sr, (np.clip(f32, -1, 1) * 32767).astype(np.int16)


def payload_to_float(data: np.ndarray) -> np.ndarray:
    """Any WAV-payload dtype -> float32 in [-1, 1]."""
    if data.dtype == np.float32:
        return data
    if data.dtype == np.uint8:          # 8-bit PCM is offset-binary
        return (data.astype(np.float32) - 128.0) / 128.0
    if np.issubdtype(data.dtype, np.integer):
        return data.astype(np.float32) / np.iinfo(data.dtype).max
    return data.astype(np.float32)


def read_wav(path: str | Path) -> tuple[int, np.ndarray]:
    """-> (sample_rate, float32 (C, T))."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = payload_to_float(data)
    wav = data.T if data.ndim == 2 else data[None, :]
    return int(sr), np.ascontiguousarray(wav)


def write_wav(path: str | Path, wav: np.ndarray, sr: int = 44100) -> None:
    """float32 (C, T) -> 16-bit PCM WAV, clipped at ±1."""
    from scipy.io import wavfile

    data = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (data.T * 32767.0).astype(np.int16))


def write_wav_pcm(path: str | Path, pcm: np.ndarray, scale: float = 1.0,
                  sr: int = 44100) -> None:
    """Write int16 ``(C, T)`` PCM (a ``separate_all_pcm`` stem) verbatim.

    ``scale`` is the stem's scale from ``separate_all_pcm``: the PCM encodes
    ``sample = pcm * scale / 32767``.  The bytes go into the file as they
    are, as in the JAX package, so a shared-scale stem plays as a
    peak-normalised master and only ``scale`` 1 (``absolute=True``) plays at
    the float stem's level."""
    from scipy.io import wavfile

    wavfile.write(path, sr, np.ascontiguousarray(pcm.T))


def resample(wav: np.ndarray, sr: int, target_sr: int = 44100) -> np.ndarray:
    """Polyphase resample (C, T) waveforms."""
    if sr == target_sr:
        return wav
    from scipy.signal import resample_poly

    g = math.gcd(sr, target_sr)
    return resample_poly(wav, target_sr // g, sr // g, axis=-1).astype(np.float32)


def to_stereo(wav: np.ndarray) -> np.ndarray:
    """Mono -> stereo duplication; more than 2 channels keep the first 2."""
    if wav.shape[0] == 1:
        return np.repeat(wav, 2, axis=0)
    return wav[:2]
