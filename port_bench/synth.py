"""Seeded synthetic songs, made on the card.

Adapted from the port's ``data/synth.py`` (the JAX package's generator):
four band-separated sources a song (drums: decaying noise bursts every
0.5 s; bass: a low sine; other: a two-note chord; vocals: a vibrato tone),
each with a random gain in [0.8, 1.2] and the right channel at 0.9 of the
left; the mixture is their exact sum.  Changed for the benchmark: the
numbers come from a ``torch.Generator`` on the device instead of numpy, so
a song of minutes is made in milliseconds; every pitch of a song is
scaled by one factor drawn from [0.8, 1.25], so songs differ; a burst cut
by the song's end keeps its full-length decay; and the song is scaled so
that the mixture peaks at 0.9.
"""

from __future__ import annotations

import math

import torch

SR = 44100
BURST = 2000


def song(seconds: float, gen: torch.Generator, device) -> torch.Tensor:
    """(5, 2, T) float32 on ``device``: the mixture, then drums, bass,
    other, vocals."""
    n = int(round(seconds * SR))
    period = SR // 2
    t = torch.arange(n, device=device, dtype=torch.float64)
    pitch = 0.8 + 0.45 * torch.rand((), generator=gen, device=device).item()
    bursts = -(-n // period)
    drums = torch.zeros((bursts, period), device=device, dtype=torch.float64)
    decay = torch.exp(-torch.linspace(0, 8, BURST, device=device,
                                      dtype=torch.float64))
    drums[:, :BURST] = torch.randn((bursts, BURST), generator=gen,
                                   device=device, dtype=torch.float64) * decay
    drums = drums.reshape(-1)[:n]
    w = 2 * math.pi * pitch / SR
    bass = 0.5 * torch.sin(w * 55.0 * t)
    other = 0.3 * (torch.sin(w * 440.0 * t) + torch.sin(w * 554.37 * t))
    vib = torch.sin(2 * math.pi * 5.0 * t / SR)
    vocals = 0.4 * torch.sin(w * (220.0 + 8.0 * vib) * t)
    gain = 0.8 + 0.4 * torch.rand(4, generator=gen, device=device,
                                  dtype=torch.float64)
    stems = torch.stack([drums, bass, other, vocals]) * gain[:, None]
    stereo = torch.stack([stems, stems * 0.9], dim=1)          # (4, 2, T)
    mix = stereo.sum(0)
    peak = mix.abs().max().clamp(min=1e-9)
    return (torch.cat([mix[None], stereo]) * (0.9 / peak)).float()


def stratified(lo: float, hi: float, k: int) -> list:
    """``k`` lengths at the midpoints of ``k`` equal slices of [lo, hi]:
    every seed gets the same set, in its own order."""
    return [lo + (hi - lo) * (i + 0.5) / k for i in range(k)]
