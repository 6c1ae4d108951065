"""SCNet in plain PyTorch, float32: the benchmark's reference.

``starrytong/SCNet`` (``scnet/SCNet.py``, ``SCNet.forward``;
arXiv:2401.13276) at inference, written again from its equations: the
right pad to an even frame count, the STFT of each channel (``torch.stft``
centred with reflect padding, normalised, the rectangular window the
published module gets by passing none), complex-as-channels, the per-item
mean and unbiased std; three SD blocks (a strided convolution a band,
convolution modules with GroupNorm(1), GLU, a depthwise convolution,
SiLU, GELU, the global 3x3 convolution); the dual-path BiLSTM layers with
the FFT along time and its inverse in turn; the decoder's fusion layers
(skip add, channel repeat, 3x3 convolution, GLU) and transposed
convolutions, trimmed; the inverse STFT.  Tensors keep the published
module's ``(B, C, F, T)`` layout and its transposes.

Each LSTM is its equations, PyTorch's gate order (i, f, g, o): the input
side ``x·W_ihᵀ + b_ih + b_hh`` for all steps in one product, then a step
``g = gx_t + h·W_hhᵀ``, ``c = σ(f)·c + σ(i)·tanh(g)``, ``h = σ(o)·tanh(c)``,
both directions side by side (the backward one on the time-reversed
sequence); no ``nn.LSTM``, so ``FlopCounterMode`` counts its products.

Parameters come as a flat ``{name: tensor}`` dict under the program's
names, which are the published ``state_dict`` names; ``cfg`` holds the
configuration's keys (``sources``, ``dims``, ``nfft``, ``hop_size``,
``band_SR``, ``band_stride``, ``band_kernel``, ``conv_depths``,
``compress``, ``conv_kernel``, ``num_dplayer``, ``expand``).  ``Prec``
(``layers``) rounds every product's operands (convolutions, Linear, both
LSTM products), so the fp8 control exists; the norms, the gates'
nonlinearities, the cell state, the FFTs and the DSP stay f32.  It imports
neither the program nor JAX.  Songs are cut by ``protocols.separate``
(the program's ``min(fade_in, fade_out)`` triangle and weighted
overlap-add), not by the chunk/10 fades of ZFTurbo's ``demix``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import protocols
from .layers import F32, Params, Prec, conv2d, gelu, glu, group_norm1


def _bands(rows: int, sr) -> List[Tuple[int, int]]:
    lo = math.ceil(rows * sr[0])
    mid = math.ceil(rows * (sr[0] + sr[1]))
    return [(0, lo), (lo, mid), (mid, rows)]


def conv_module(p: Params, pre: str, x: torch.Tensor, depth: int,
                prec: Prec) -> torch.Tensor:
    """``ConvolutionModule``: (N, C, T) rows, ``depth`` residual steps."""
    for d in range(depth):
        s = f"{pre}layers.{d}."
        h = group_norm1(p, s + "0", x)
        w = p[s + "1.weight"]
        h = glu(F.conv1d(prec.q(h), prec.q(w), p[s + "1.bias"],
                         padding=w.shape[-1] // 2), dim=1)
        w = p[s + "3.weight"]
        h = F.conv1d(prec.q(h), prec.q(w), p[s + "3.bias"],
                     padding=w.shape[-1] // 2, groups=h.shape[1])
        h = group_norm1(p, s + "4", h)
        h = h * torch.sigmoid(h)
        x = x + F.conv1d(prec.q(h), prec.q(p[s + "6.weight"]),
                         p[s + "6.bias"])
    return x


def sd_block(p: Params, pre: str, x: torch.Tensor, cfg: Dict, prec: Prec):
    """``SDblock``: (B, C, F, T) -> (output, skip, lengths, original
    lengths)."""
    outs, lengths, origins = [], [], []
    for i, (a, e) in enumerate(_bands(x.shape[2], cfg["band_SR"])):
        stride, kernel = cfg["band_stride"][i], cfg["band_kernel"][i]
        n = e - a
        total = kernel - stride if stride == 1 else (stride - n % stride) % stride
        band = F.pad(x[:, :, a:e], (0, 0, total // 2, total - total // 2))
        y = conv2d(p, f"{pre}SDlayer.convs.{i}", band, (stride, 1), prec=prec)
        b, c, rows, t = y.shape
        rows_in = y.permute(0, 2, 1, 3).reshape(-1, c, t)
        out = conv_module(p, f"{pre}conv_modules.{i}.", rows_in,
                          cfg["conv_depths"][i], prec)
        outs.append(gelu(out).view(b, rows, c, t).permute(0, 2, 1, 3))
        lengths.append(rows)
        origins.append(n)
    skip = torch.cat(outs, dim=2)
    return (conv2d(p, pre + "globalconv", skip, padding=(1, 1), prec=prec),
            skip, lengths, origins)


def lstm(p: Params, pre: str, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """A one-layer bidirectional LSTM (batch first) from its equations:
    (N, L, I) -> (N, L, 2H)."""
    n, length, _ = x.shape
    wi = torch.stack([p[pre + "weight_ih_l0"], p[pre + "weight_ih_l0_reverse"]])
    wh = torch.stack([p[pre + "weight_hh_l0"], p[pre + "weight_hh_l0_reverse"]])
    b = torch.stack([p[pre + "bias_ih_l0"] + p[pre + "bias_hh_l0"],
                     p[pre + "bias_ih_l0_reverse"]
                     + p[pre + "bias_hh_l0_reverse"]])
    hidden = wh.shape[-1]
    xs = torch.stack([x, x.flip(1)])                      # (2, N, L, I)
    gx = torch.matmul(prec.q(xs), prec.q(wi).transpose(1, 2)[:, None]) \
        + b[:, None, None]                                # (2, N, L, 4H)
    wht = prec.q(wh).transpose(1, 2)                      # (2, H, 4H)
    h = x.new_zeros((2, n, hidden))
    c = x.new_zeros((2, n, hidden))
    hs = []
    for t in range(length):
        g = gx[:, :, t] + torch.bmm(prec.q(h), wht)
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    y = torch.stack(hs, dim=2)                            # (2, N, L, H)
    return torch.cat([y[0], y[1].flip(1)], dim=-1)


def linear(p: Params, name: str, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    return F.linear(prec.q(x), prec.q(p[name + ".weight"]), p[name + ".bias"])


def dual_path(p: Params, pre: str, x: torch.Tensor, prec: Prec
              ) -> torch.Tensor:
    """``DualPathRNN``: (B, C, F, T), the frequency path then the time
    path, each with its residual."""
    b, c, f, t = x.shape
    h = group_norm1(p, pre + "norm_layers.0", x)
    h = h.transpose(1, 3).contiguous().view(b * t, f, c)
    h = linear(p, pre + "linear_layers.0",
               lstm(p, pre + "lstm_layers.0.", h, prec), prec)
    x = x + h.view(b, t, f, c).transpose(1, 3)
    h = group_norm1(p, pre + "norm_layers.1", x)
    h = h.transpose(1, 2).contiguous().view(b * f, c, t).transpose(1, 2)
    h = linear(p, pre + "linear_layers.1",
               lstm(p, pre + "lstm_layers.1.", h, prec), prec)
    return x + h.transpose(1, 2).contiguous().view(b, f, c, t).transpose(1, 2)


def feature_conversion(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """``FeatureConversion``: rfft along T with (re, im) concatenated on the
    channels, or its inverse."""
    if inverse:
        c = x.shape[1] // 2
        return torch.fft.irfft(torch.complex(x[:, :c], x[:, c:]), dim=3,
                               norm="ortho")
    z = torch.fft.rfft(x, dim=3, norm="ortho")
    return torch.cat([z.real, z.imag], dim=1)


def forward(p: Params, wav: torch.Tensor, cfg: Dict, prec: Prec = F32
            ) -> torch.Tensor:
    """(B, 2, L) chunks -> (B, sources, 2, L)."""
    b, ch, length = wav.shape
    hop, n_fft = cfg["hop_size"], cfg["nfft"]
    pad = hop - length % hop
    if (length + pad) // hop % 2 == 0:
        pad += hop
    x = F.pad(wav.float(), (0, pad)).reshape(b * ch, -1)
    # no window in the published stft_config: torch.stft's rectangular one
    z = torch.stft(x, n_fft, hop, win_length=n_fft,
                   window=torch.ones(n_fft, device=x.device), center=True,
                   pad_mode="reflect", normalized=True, return_complex=True)
    z = torch.view_as_real(z)                             # (B·2, F, T, 2)
    x = z.permute(0, 3, 1, 2).reshape(b, 2 * ch, z.shape[1], z.shape[2])
    _, _, rows, t = x.shape
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = x.std(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) / (1e-5 + std)
    saved = []
    for i in range(len(cfg["dims"]) - 1):
        x, skip, lengths, origins = sd_block(p, f"encoder.{i}.", x, cfg, prec)
        saved.append((skip, lengths, origins))
    for i in range(cfg["num_dplayer"]):
        x = dual_path(p, f"separation_net.dp_modules.{i}.", x, prec)
        x = feature_conversion(x, inverse=i % 2 == 1)
    for i, (skip, lengths, origins) in enumerate(reversed(saved)):
        x = x + skip
        x = x.repeat(1, 2, 1, 1)
        x = glu(conv2d(p, f"decoder.{i}.0.conv", x, padding=(1, 1), prec=prec),
                dim=1)
        outs, a = [], 0
        for j, (n, orig) in enumerate(zip(lengths, origins)):
            name = f"decoder.{i}.1.convtrs.{j}"
            stride = cfg["band_stride"][j]
            y = F.conv_transpose2d(prec.q(x[:, :, a:a + n]),
                                   prec.q(p[name + ".weight"]),
                                   p[name + ".bias"], stride=(stride, 1))
            a += n
            dist = abs(orig - y.shape[2]) // 2
            outs.append(y[:, :, dist:dist + orig])
        x = torch.cat(outs, dim=2)
    n_src = len(cfg["sources"])
    x = x.view(b, cfg["dims"][0], -1, rows, t)
    x = x * std[:, None] + mean[:, None]
    x = x.reshape(-1, 2, rows, t).permute(0, 2, 3, 1)
    y = torch.istft(torch.view_as_complex(x.contiguous()), n_fft, hop,
                    win_length=n_fft, window=torch.ones(n_fft,
                                                        device=x.device),
                    center=True, normalized=True)
    return y.reshape(b, n_src, ch, -1)[..., :length]


def stems(p: Params, cfg: Dict, song: torch.Tensor, segment: int,
          overlap: int, prec: Prec = F32, block: int = 4) -> torch.Tensor:
    """A float (2, T) song -> (sources, 2, T) through ``protocols.separate``
    in blocks of ``block`` chunks."""
    def fwd(chunks):
        out = forward(p, chunks, cfg, prec)
        return out.reshape(chunks.shape[0], -1, out.shape[-1])

    with torch.no_grad():
        flat = protocols.separate(fwd, song.float(), segment, overlap, block)
    return flat.reshape(-1, 2, flat.shape[-1])
