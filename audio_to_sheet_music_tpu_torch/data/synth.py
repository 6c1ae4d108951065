"""Synthetic in-memory MusDB fixture: sine-mixture stems.

The port's copy of ``audio_to_sheet_music_tpu/data/synth.py``: the same
numpy generator, so the same seed writes the same tracks.

Four band-separated deterministic sources per track so separation quality is
measurable without the 10 GB MusDB download: drums = decaying noise bursts,
bass = low sine, other = mid chord, vocals = vibrato tone.  ``mixture`` is
their exact sum, so an oracle separator achieves perfect SDR.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import List

import numpy as np

from .musdb import Track

SR = 44100


def _stem_signals(t: np.ndarray, rng: np.random.Generator) -> List[np.ndarray]:
    drums = np.zeros_like(t)
    period = int(0.5 * SR)
    for start in range(0, len(t), period):
        n = min(2000, len(t) - start)
        burst = rng.standard_normal(n) * np.exp(-np.linspace(0, 8, n))
        drums[start : start + n] += burst
    bass = 0.5 * np.sin(2 * np.pi * 55.0 * t / SR)
    other = 0.3 * (np.sin(2 * np.pi * 440.0 * t / SR)
                   + np.sin(2 * np.pi * 554.37 * t / SR))
    vib = np.sin(2 * np.pi * 5.0 * t / SR)
    vocals = 0.4 * np.sin(2 * np.pi * (220.0 + 8.0 * vib) * t / SR)
    return [drums, bass, other, vocals]


def synthetic_tracks(n_tracks: int = 2, seconds: float = 12.0,
                     cache_dir: str | Path | None = None,
                     seed: int = 0) -> List[Track]:
    """Write ``n_tracks`` synthetic ``(5, 2, T)`` npy tracks, return Tracks."""
    cache = Path(cache_dir) if cache_dir else Path(tempfile.mkdtemp(prefix="atsm_synth_"))
    cache.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR), dtype=np.float32)
    tracks = []
    for i in range(n_tracks):
        stems = _stem_signals(t, rng)
        phase = rng.uniform(0.8, 1.2, size=4)
        stereo = [np.stack([s * g, s * g * 0.9]).astype(np.float32)
                  for s, g in zip(stems, phase)]
        mixture = np.sum(stereo, axis=0)
        arr = np.stack([mixture] + stereo)           # (5, 2, T)
        path = cache / f"synth_{i}.npy"
        np.save(path, arr)
        tracks.append(Track(f"synth_{i}", path, "npy"))
    return tracks
