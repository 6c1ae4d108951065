"""Fused STFT (framing + window + real FFT): the hand-written Hopper kernel
and its plain PyTorch version.

Counterpart of ``audio_to_sheet_music_tpu/ops/pallas_stft.py:stft_pallas``
(Pallas body ``_kernel``): frames ``x[f*hop : f*hop + n_fft]`` of an
already padded signal, a periodic Hann window, and the unnormalised
``n_fft // 2 + 1``-bin spectrum, in f32.  ``ops.dsp.stft`` pads the signal
and applies the ``n_fft ** -0.5`` scale around it, as the JAX ``dsp.stft``
does around ``stft_pallas``.

- ``stft``: the wrapper.  A CUDA tensor launches the CUDA kernel
  (``csrc/stft.cu``; its header says what bounds it and what the design does
  about it) or raises; a CPU tensor takes ``stft_plain``.
  ``stft.launches`` counts kernel launches.
- ``stft_plain``: framing by ``unfold``, the window, ``torch.fft.rfft`` —
  the JAX kernel tests' reference (framing + ``rfft``).
- ``passes``, ``tables`` and ``table_offsets``: the kernel's Stockham pass
  schedule and the f32 tables it reads (window, split factors, pass
  twiddles), built once per ``n_fft`` and device in float64, and where each
  table starts.  This module owns the layout: the launch gets a pointer to
  each table and the schedule they were built for, which the kernel checks
  against its own.
- ``supports``: the JAX package's routing test, unchanged.

``torch.stft`` (cuFFT) is the per-op path of ``dsp.stft`` and the library
yardstick; it is never this kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import build

LANE = 128
_MIN_NFFT, _MAX_NFFT = 256, 8192    # the kernel's instantiated sizes
_TABLES: Dict[Tuple[int, str], torch.Tensor] = {}


def supports(n_fft: int, hop: int) -> bool:
    """The geometries the JAX package sends to its kernel
    (``pallas_stft.supports``); ``dsp.stft`` routes by the same test."""
    return n_fft % LANE == 0 and hop % LANE == 0 and n_fft // LANE >= 2


def hann(n_fft: int, device) -> torch.Tensor:
    """Periodic Hann window ``0.5 - 0.5 cos(2 pi n / n_fft)`` in f32."""
    n = torch.arange(n_fft, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).float().to(device)


def stft_plain(x: torch.Tensor, n_fft: int, hop: int, n_frames: int
               ) -> torch.Tensor:
    """``(rows, T)`` f32 -> complex64 ``(rows, n_fft // 2 + 1, n_frames)``."""
    frames = x.float().unfold(-1, n_fft, hop)[:, :n_frames]
    z = torch.fft.rfft(frames * hann(n_fft, x.device), dim=-1)
    return z.transpose(-1, -2)


def passes(n_fft: int) -> List[Tuple[int, int]]:
    """The kernel's pass schedule for the ``n_fft // 2``-point complex FFT
    (``csrc/stft.cu:pass_bits``): ``(Ns, R)`` per pass, Ns the product of
    the earlier radices.  ``P = ceil(log2 M / 4)`` passes of radix 8 or 16
    (or less for small M), the first ``log2 M % P`` one bit wider."""
    lm = int(math.log2(n_fft // 2))
    npass = (lm + 3) // 4
    out, ns = [], 1
    for p in range(npass):
        r = 1 << (lm // npass + (1 if p < lm % npass else 0))
        out.append((ns, r))
        ns *= r
    return out


def table_offsets(n_fft: int) -> List[int]:
    """Where each of ``tables``' parts starts, in points: the window (M
    points), the split factors (M + 1), then the twiddles of each pass
    after the first (Ns R points each)."""
    m = n_fft // 2
    offsets, end = [0, m], 2 * m + 1
    for ns, r in passes(n_fft)[1:]:
        offsets.append(end)
        end += ns * r
    return offsets


def tables(n_fft: int, device) -> torch.Tensor:
    """The kernel's f32 tables as one ``(points, 2)`` tensor laid out as
    ``table_offsets`` says, built in float64 and cached per (n_fft,
    device): the window in pairs ``(w[2m], w[2m+1])``, the split factors
    ``e^{-2πik/N}`` (k = 0 .. M), then for each pass after the first its
    twiddles ``e^{-2πi k r / (Ns R)}`` laid out ``[r][k]``."""
    key = (n_fft, str(device))
    if key not in _TABLES:
        m = n_fft // 2
        n = np.arange(n_fft)
        win = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).reshape(m, 2)
        parts = [win, _pairs(np.exp(-2j * np.pi * np.arange(m + 1) / n_fft))]
        for ns, r in passes(n_fft)[1:]:
            k, q = np.arange(ns)[None, :], np.arange(r)[:, None]
            parts.append(_pairs(np.exp(-2j * np.pi * k * q / (ns * r)).ravel()))
        _TABLES[key] = torch.from_numpy(
            np.concatenate(parts).astype(np.float32)).to(device)
    return _TABLES[key]


def packed_schedule(n_fft: int) -> int:
    """``passes``' radices as the launch takes them: log2 R of pass p in
    bits 4p .. 4p + 3."""
    return sum(int(math.log2(r)) << (4 * p)
               for p, (_, r) in enumerate(passes(n_fft)))


def _pairs(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1)


def _lib() -> ctypes.CDLL:
    lib = build.load("stft")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.stft_launch.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.stft_launch.restype = i
        lib._bound = True
    return lib


def stft(x: torch.Tensor, n_fft: int, hop: int, n_frames: int
         ) -> torch.Tensor:
    """Unnormalised STFT of padded rows: ``(rows, T)`` -> complex64
    ``(rows, n_fft // 2 + 1, n_frames)``; frame ``f`` covers
    ``x[f * hop : f * hop + n_fft]``.

    CPU tensors take ``stft_plain``.  A CUDA ``x`` must be a contiguous f32
    ``(rows, T)`` long enough for ``n_frames`` frames, ``n_fft`` a power of
    two from 256 to 8192, and must not require grad, else this raises.
    """
    if x.device.type == "cpu":
        return stft_plain(x, n_fft, hop, n_frames)
    if x.device.type != "cuda":
        raise ValueError(f"stft: no kernel for device {x.device}")
    build.check_no_grad("stft", x)
    if x.dtype != torch.float32:
        raise TypeError(f"stft: x must be float32, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("stft: x must be a contiguous (rows, T)")
    rows, t = x.shape
    if (n_fft < _MIN_NFFT or n_fft > _MAX_NFFT or n_fft & (n_fft - 1)
            or hop < 1 or n_frames < 1 or t < (n_frames - 1) * hop + n_fft
            or rows < 1):
        raise ValueError(f"stft: unsupported n_fft={n_fft}, hop={hop}, "
                         f"{n_frames} frames of x {tuple(x.shape)}")
    out = torch.empty((rows, n_fft // 2 + 1, n_frames), dtype=torch.complex64,
                      device=x.device)
    base = tables(n_fft, x.device).data_ptr()
    ptrs = [base + 8 * off for off in table_offsets(n_fft)]
    win, split, tw1 = ptrs[:3]
    tw2 = ptrs[3] if len(ptrs) > 3 else None      # two passes: unused
    build.launch(
        "stft", x.device, _lib().stft_launch,
        x.data_ptr(), out.data_ptr(), win, split, tw1, tw2, rows, t, n_fft,
        hop, n_frames, packed_schedule(n_fft),
        torch.cuda.current_stream(x.device).cuda_stream)
    stft.launches += 1
    return out


stft.launches = 0
