"""Spectrogram figures: the counterpart of
``audio_to_sheet_music_tpu/utils/plotting.py``.

The same pictures: STFT n_fft 2048 / hop 512, power in dB with an 80 dB
floor under the maximum, the magma colour map, time in s and frequency in
kHz.  The dB image is ``ops.dsp.spectrogram_db`` on ``device`` (the card
unless the caller passes ``"cpu"``), copied to the host; matplotlib (Agg)
only draws.  matplotlib is imported inside the functions, so the
module imports where matplotlib is not installed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ops import dsp

SR = 44100


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _db(wav, n_fft: int = 2048, hop: int = 512, device="cuda"
        ) -> np.ndarray:
    """A (C, T) or (T,) waveform -> its mono dB image on the host."""
    mono = torch.as_tensor(np.asarray(wav, np.float32)).to(device)
    if mono.ndim == 2:
        mono = mono.mean(dim=0)
    with torch.inference_mode():
        return dsp.spectrogram_db(mono, n_fft, hop).cpu().numpy()


def _imshow(ax, db: np.ndarray, sr: int, hop: int, title: str):
    extent = [0, db.shape[-1] * hop / sr, 0, sr / 2 / 1000]
    im = ax.imshow(db, origin="lower", aspect="auto", cmap="magma",
                   extent=extent)
    ax.set_title(title)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("freq [kHz]")
    return im


def plot_spectrogram(wav: np.ndarray, title: str = "spectrogram",
                     sr: int = SR, hop: int = 512, device="cuda"):
    """One waveform's spectrogram figure."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    im = _imshow(ax, _db(wav, hop=hop, device=device), sr, hop, title)
    fig.colorbar(im, ax=ax, format="%+2.0f dB")
    fig.tight_layout()
    return fig


def plot_separation_comparison(mixture: np.ndarray, target: np.ndarray,
                               estimate: np.ndarray, stem: str = "stem",
                               sr: int = SR, device="cuda"):
    """Mixture / ground truth / estimate, side by side."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(16, 4))
    for ax, (wav, title) in zip(axes, [
            (mixture, "mixture"),
            (target, f"{stem} (ground truth)"),
            (estimate, f"{stem} (estimated)")]):
        _imshow(ax, _db(wav, device=device), sr, 512, title)
    fig.tight_layout()
    return fig


def plot_all_stems(mixture: np.ndarray, stems: Mapping[str, np.ndarray],
                   sr: int = SR, device="cuda"):
    """The mixture and every stem in one row."""
    plt = _pyplot()
    names = list(stems)
    fig, axes = plt.subplots(1, 1 + len(names),
                             figsize=(4 * (1 + len(names)), 4))
    _imshow(axes[0], _db(mixture, device=device), sr, 512, "mixture")
    for ax, name in zip(axes[1:], names):
        _imshow(ax, _db(stems[name], device=device), sr, 512, name)
    fig.tight_layout()
    return fig


def save_figure(fig, path) -> None:
    fig.savefig(path, dpi=120, bbox_inches="tight")
    _pyplot().close(fig)
