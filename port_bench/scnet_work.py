"""Operations and bytes of SCNet's LSTM recurrence, the numerator of
``scnet_rnn_roofline_pct``; and the shapes of the separation net a chunk
group runs, from the configuration (``configs/scnet.json``).

A dual-path layer of width d runs two bidirectional LSTMs of hidden width
H = d·expand: the frequency path over ``g·T`` sequences of ``F`` steps and
the time path over ``g·F`` sequences of ``T`` steps, for a group of ``g``
chunks, F the band rows at the separation net and T the frames (T on even
layers, T/2 + 1 after the FFT on odd ones, where d doubles).

The recurrence of one LSTM call over ``m`` sequences of ``steps`` steps, a
direction:

- operations: each step's product ``h·W_hhᵀ`` (``2·m·4H·H``) and its cell
  update, 8 operations a unit (the four gate pre-activations added to the
  input side's, ``c = f·c + i·g`` and ``h = o·tanh(c)``; the sigmoids and
  tanh not counted);
- bytes, each read or written once, bf16: the input side's gate
  pre-activations (``m·4H`` a step, made by the one input product that
  precedes the steps and is not part of the recurrence), the hidden states
  written (``m·H`` a step) and ``W_hh`` (``4H·H``).

The bound is the larger of the operations at the bf16 tensor peak and the
bytes at the memory rate, a call at a time."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from . import common


def recurrence_work(m: int, steps: int, hidden: int) -> Tuple[float, float]:
    """(operations, bytes) of one bidirectional LSTM call's recurrence."""
    flops = 2 * steps * (8.0 * m * hidden * hidden + 8.0 * m * hidden)
    nbytes = 2 * (steps * m * 5 * hidden * 2.0 + 4 * hidden * hidden * 2.0)
    return flops, nbytes


def frames(cfg: Dict, segment: int) -> int:
    """STFT frames of a ``segment``-sample chunk after its right pad: the
    padded length in hops, + 1 (centred), an even number."""
    hop = cfg["hop_size"]
    pad = hop - segment % hop
    if (segment + pad) // hop % 2 == 0:
        pad += hop
    return (segment + pad) // hop + 1


def rows(cfg: Dict) -> int:
    """Frequency rows at the separation net: the STFT's ``nfft / 2 + 1``
    through the SD layers (three bands a layer, split at the configured
    shares, each padded and strided by its band's convolution)."""
    r = cfg["nfft"] // 2 + 1
    sr = cfg["band_SR"]
    for _ in range(len(cfg["dims"]) - 1):
        cuts = [0, math.ceil(r * sr[0]), math.ceil(r * (sr[0] + sr[1])), r]
        out = 0
        for b in range(3):
            n = cuts[b + 1] - cuts[b]
            s, k = cfg["band_stride"][b], cfg["band_kernel"][b]
            pad = k - s if s == 1 else (s - n % s) % s
            out += (n + pad - k) // s + 1
        r = out
    return r


def lstm_calls(cfg: Dict, segment: int, g: int) -> List[Tuple[int, int, int]]:
    """``(sequences, steps, hidden)`` of each LSTM call a group of ``g``
    chunks makes, layer by layer (frequency path, then time path)."""
    f, t = rows(cfg), frames(cfg, segment)
    calls = []
    for i in range(cfg["num_dplayer"]):
        odd = i % 2 == 1
        d = cfg["dims"][-1] * (2 if odd else 1)
        ti = t // 2 + 1 if odd else t
        hidden = d * cfg["expand"]
        calls += [(g * ti, f, hidden), (g * f, ti, hidden)]
    return calls


def launches_per_group(cfg: Dict) -> int:
    """Dual-path layers a chunk group runs: ``launches.dual_path``'s
    count."""
    return cfg["num_dplayer"]


def window_bound(cfg: Dict, segment: int, groups: Iterable[int]) -> float:
    """Summed bound seconds of the recurrences of chunk groups of the
    given sizes."""
    return sum(common.bound(*recurrence_work(*call))["bound_s"]
               for g in groups for call in lstm_calls(cfg, segment, g))
