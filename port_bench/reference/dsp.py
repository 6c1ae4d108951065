"""The demucs ``_spec`` / ``_ispec`` front and back end in plain PyTorch:
reflect padding, a centred normalised STFT (Hann, n_fft 4096, hop 1024),
the Nyquist bin and two edge frames dropped, and their inverse through
``torch.istft``; complex-as-channels packing.  Always float32."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pad_reflect(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect padding of the last axis; a signal too short to reflect is
    zero-extended first (demucs ``pad1d``)."""
    n = x.shape[-1]
    big = max(left, right)
    if n <= big:
        extra = big - n + 1
        er = min(right, extra)
        el = extra - er
        x = F.pad(x, (el, er))
        left, right = left - el, right - er
    lead = x.shape[:-1]
    out = F.pad(x.reshape(-1, 1, x.shape[-1]), (left, right), mode="reflect")
    return out.reshape(*lead, out.shape[-1])


def spec(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> complex (..., n_fft // 2, ceil(T / hop))."""
    length = x.shape[-1]
    le = math.ceil(length / hop)
    pad = hop // 2 * 3
    x = pad_reflect(x.float(), pad, pad + le * hop - length)
    x = pad_reflect(x, n_fft // 2, n_fft // 2)
    lead = x.shape[:-1]
    z = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop,
                   window=torch.hann_window(n_fft, device=x.device),
                   win_length=n_fft, center=False, normalized=True,
                   return_complex=True)
    z = z.reshape(*lead, *z.shape[-2:])
    return z[..., :-1, 2:2 + le]


def ispec(z: torch.Tensor, length: int, n_fft: int, hop: int) -> torch.Tensor:
    """complex (..., n_fft // 2, le) -> (..., length)."""
    z = F.pad(z, (2, 2, 0, 1))
    pad = hop // 2 * 3
    le = hop * math.ceil(length / hop) + 2 * pad
    lead = z.shape[:-2]
    x = torch.istft(z.reshape(-1, *z.shape[-2:]), n_fft, hop,
                    window=torch.hann_window(n_fft, device=z.device),
                    win_length=n_fft, center=True, normalized=True,
                    length=le)
    return x.reshape(*lead, le)[..., pad:pad + length]


def to_cac(z: torch.Tensor) -> torch.Tensor:
    """complex (B, C, F, T) -> real (B, 2C, F, T): [c0 re, c0 im, c1 re, ...]."""
    b, c, f, t = z.shape
    return torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, 2 * c, f, t)
