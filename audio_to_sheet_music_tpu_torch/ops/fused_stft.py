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
- ``supports``: the JAX package's routing test, unchanged.

``torch.stft`` (cuFFT) is the per-op path of ``dsp.stft`` and the library
yardstick; it is never this kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

LANE = 128
_MAX_NFFT = 8192        # FB frames of n_fft/2 complex values in shared memory


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


def _lib() -> ctypes.CDLL:
    lib = build.load("stft")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.stft_launch.argtypes = [p, p] + [i] * 5 + [p]
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
    two up to 8192, and must not require grad, else this raises.
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
    if (n_fft < 4 or n_fft > _MAX_NFFT or n_fft & (n_fft - 1) or hop < 1
            or n_frames < 1 or t < (n_frames - 1) * hop + n_fft or rows < 1):
        raise ValueError(f"stft: unsupported n_fft={n_fft}, hop={hop}, "
                         f"{n_frames} frames of x {tuple(x.shape)}")
    out = torch.empty((rows, n_fft // 2 + 1, n_frames), dtype=torch.complex64,
                      device=x.device)
    err = _lib().stft_launch(
        x.data_ptr(), out.data_ptr(), rows, t, n_fft, hop, n_frames,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "stft")
    stft.launches += 1
    return out


stft.launches = 0
