"""DSP front/back end: the demucs ``_spec`` / ``_ispec`` contract.

- ``spec``  — demucs ``HTDemucs._spec``: reflect pre-pad so the frame count
  is ``ceil(T/hop)``, STFT (n_fft 4096, hop 1024, periodic Hann,
  ``normalized=True``, centred with reflect padding), drop the Nyquist bin
  (2049 -> 2048) and the 2 leading / 2 trailing frames.
- ``ispec`` — demucs ``HTDemucs._ispec``: restore the Nyquist bin and the
  edge frames, iSTFT, crop back to ``length`` samples.
- ``magnitude_cac`` / ``mask_cac`` — complex-as-channels packing and its
  inverse.
- ``spectrogram_db`` — the power spectrogram in dB the plots draw.

The JAX package lowers the DFT as matmuls for the TPU; here ``torch.stft`` /
``torch.istft`` (cuFFT on the card) compute the same transforms, checked
on outputs.  Under the ``stft`` kernel selection the forward STFT runs the
hand-written kernel ``ops.fused_stft.stft`` instead (the JAX package's
``ATSM_PALLAS_STFT=1`` route), around the same padding and scale.  The STFT
always runs in f32, whatever the model's compute dtype, as it does in the
JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import fused_stft


def pad_reflect_safe(x: torch.Tensor, pad_left: int, pad_right: int
                     ) -> torch.Tensor:
    """Reflect-pad the last axis; zero-extend first if the signal is too
    short for reflect padding (demucs ``pad1d``'s length contract: the
    output is always ``length + pad_left + pad_right`` samples)."""
    length = x.shape[-1]
    max_pad = max(pad_left, pad_right)
    if length <= max_pad:
        extra = max_pad - length + 1
        extra_right = min(pad_right, extra)
        extra_left = extra - extra_right
        x = F.pad(x, (extra_left, extra_right))
        pad_left -= extra_left
        pad_right -= extra_right
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    out = F.pad(flat, (pad_left, pad_right), mode="reflect")
    return out.reshape(*lead, out.shape[-1])


WINDOWS = ("hann", "rect")


def _window(n_fft: int, device, window: str = "hann") -> torch.Tensor:
    """The analysis window: the periodic Hann (``"hann"``) or ones
    (``"rect"``, what ``torch.stft`` takes for ``window=None``)."""
    if window == "rect":
        return torch.ones(n_fft, dtype=torch.float32, device=device)
    if window != "hann":
        raise ValueError(f"stft: window {window!r}, expected one of "
                         f"{WINDOWS}")
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                             device=device)


def stft(x: torch.Tensor, n_fft: int = 4096, hop: int = 1024,
         kernel: bool = False, normalized: bool = True,
         window: str = "hann") -> torch.Tensor:
    """Centred STFT: ``(..., T)`` -> complex ``(..., F, frames)``, scaled by
    ``n_fft ** -0.5`` when ``normalized`` (torch's convention; the mel
    front end takes it unscaled).  ``kernel=True`` runs ``fused_stft.stft``
    where ``fused_stft.supports`` the geometry (the JAX routing test) and
    the window is Hann, the kernel's.  ``window``: ``"hann"`` (the
    periodic Hann) or ``"rect"`` (ones: SCNet's STFT, which passes no
    window)."""
    n_frames = x.shape[-1] // hop + 1
    xp = pad_reflect_safe(x.float(), n_fft // 2, n_fft // 2)
    lead = xp.shape[:-1]
    flat = xp.reshape(-1, xp.shape[-1])
    if kernel and window == "hann" and fused_stft.supports(n_fft, hop):
        z = fused_stft.stft(flat.contiguous(), n_fft, hop, n_frames)
        if normalized:
            z = z * (1.0 / math.sqrt(n_fft))
    else:
        z = torch.stft(flat, n_fft, hop,
                       window=_window(n_fft, x.device, window),
                       win_length=n_fft, center=False, normalized=normalized,
                       return_complex=True)
    return z.reshape(*lead, *z.shape[-2:])


def istft(z: torch.Tensor, length: int, n_fft: int = 4096,
          hop: int = 1024, normalized: bool = True,
          window: str = "hann") -> torch.Tensor:
    """Inverse of ``stft``: complex ``(..., F, frames)`` -> ``(..., length)``.

    ``torch.istft(center=True, normalized=normalized, length=length)``
    written out in its own steps (an inverse real FFT a frame, orthonormal
    when ``normalized``, else scaled by ``1 / n_fft``, the window,
    overlap-add by ``fold``, the centre trimmed, division by the squared
    window's overlap-add), without its check that the envelope is nowhere
    near zero: that check reads a value back to the host, so the host
    would wait for the card in every head, one replica after another on a
    mesh.  The periodic Hann window at ``hop <= n_fft / 2`` overlaps
    itself everywhere inside the trimmed span, whether or not the hop
    divides the window; so does the rectangular one at ``hop <= n_fft``."""
    lead = z.shape[:-2]
    zz = z.reshape(-1, *z.shape[-2:]).transpose(1, 2)    # (B, frames, F)
    n_frames = zz.shape[1]
    win = _window(n_fft, z.device, window)
    frames = torch.fft.irfft(zz, n=n_fft, dim=-1,
                             norm="ortho" if normalized else "backward")
    total = n_fft + hop * (n_frames - 1)

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:
        # (B, frames, n_fft) -> (B, total): the adjoint of unfold
        return torch.ops.aten.unfold_backward(cols, [cols.shape[0], total],
                                              1, n_fft, hop)

    y = overlap_add(frames * win)
    env = overlap_add((win * win).expand(1, n_frames, n_fft))
    start = n_fft // 2
    end = min(start + length, total)
    x = y[:, start:end] / env[:, start:end]
    if end < start + length:
        x = F.pad(x, (0, start + length - end))
    return x.reshape(*lead, length)


def spec(x: torch.Tensor, n_fft: int = 4096, hop: int = 1024,
         kernel: bool = False) -> torch.Tensor:
    """demucs ``HTDemucs._spec``: ``(..., T) -> complex (..., n_fft//2, le)``."""
    length = x.shape[-1]
    le = int(math.ceil(length / hop))
    pad = hop // 2 * 3
    x = pad_reflect_safe(x.float(), pad, pad + le * hop - length)
    z = stft(x, n_fft, hop, kernel)
    return z[..., :-1, 2:2 + le]


def ispec(z: torch.Tensor, length: int, n_fft: int = 4096,
          hop: int = 1024) -> torch.Tensor:
    """demucs ``HTDemucs._ispec``: complex ``(..., F, le) -> (..., length)``."""
    z = F.pad(z, (2, 2, 0, 1))          # edge frames, Nyquist bin
    pad = hop // 2 * 3
    le = hop * int(math.ceil(length / hop)) + 2 * pad
    x = istft(z, le, n_fft, hop)
    return x[..., pad:pad + length]


def magnitude_cac(z: torch.Tensor) -> torch.Tensor:
    """complex ``(B, C, F, T)`` -> real ``(B, 2C, F, T)``, channel order
    ``[c0_re, c0_im, c1_re, c1_im, ...]``."""
    b, c, f, t = z.shape
    m = torch.view_as_real(z).permute(0, 1, 4, 2, 3)     # (B, C, 2, F, T)
    return m.reshape(b, c * 2, f, t)


def mask_cac(m: torch.Tensor) -> torch.Tensor:
    """Inverse of ``magnitude_cac``: real ``(..., 2C, F, T)`` -> complex
    ``(..., C, F, T)`` (demucs ``HTDemucs._mask`` with ``cac=True``)."""
    *lead, c2, f, t = m.shape
    m = m.reshape(*lead, c2 // 2, 2, f, t)
    return torch.complex(m[..., 0, :, :], m[..., 1, :, :])


def spectrogram_db(x: torch.Tensor, n_fft: int = 2048, hop: int = 512,
                   top_db: float = 80.0) -> torch.Tensor:
    """Power spectrogram in dB for plotting: ``(..., T)`` -> ``(..., n_fft/2
    + 1, T // hop + 1)`` f32 on ``x``'s device.

    The centred, normalised f32 STFT (Hann window, reflect padding),
    ``10·log10(max(power, 1e-10))``, then a floor ``top_db`` under each
    spectrogram's own maximum over its last two axes, so a quiet item of a
    batch keeps its own range."""
    z = stft(torch.as_tensor(x, dtype=torch.float32), n_fft, hop)
    power = z.real.square() + z.imag.square()
    db = 10.0 * torch.log10(torch.clamp(power, min=1e-10))
    peak = db.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(db, peak - top_db)
