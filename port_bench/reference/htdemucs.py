"""HTDemucs (Rouard et al., arXiv:2211.08553; demucs ``htdemucs``) in plain
PyTorch, written from the published model: the frequency and time
encoders (strided conv, GELU, two-block DConv residual, 1x1 rewrite +
GLU), the scaled frequency embedding after the first frequency layer, the
384 <-> 512 channel samplers around the cross-domain transformer (5
layers a branch: self attention at 0, 2, 4, cross attention at 1, 3;
pre-LN, LayerScale, a one-group GroupNorm on the way out): the part the
text-conditioned model keeps.  Parameters come as a flat dict under the
demucs checkpoint names; widths are read off the parameters."""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import dsp
from .layers import (F32, Params, Prec, conv1d, conv2d, count_prefixed,
                     gelu, glu, group_norm1, layer_norm, lin, mha)

STRIDE = 4
KERNEL = 8
FREQ_EMB_SCALE = 0.2
EMB_SCALE = 10.0
MAX_PERIOD = 10000.0


def dconv(p: Params, name: str, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Two residual blocks: dilated k=3 conv -> GN -> GELU -> 1x1 conv ->
    GN -> GLU -> LayerScale; dilation 1 then 2."""
    for d in range(count_prefixed(p, name + ".layers")):
        b = f"{name}.layers.{d}"
        dil = 2 ** d
        y = conv1d(p, b + ".0", x, padding=dil, dilation=dil, prec=prec)
        y = gelu(group_norm1(p, b + ".1", y))
        y = conv1d(p, b + ".3", y, prec=prec)
        y = glu(group_norm1(p, b + ".4", y), 1)
        x = x + p[b + ".6.scale"][None, :, None] * y
    return x


def _dconv_freq(p: Params, name: str, y: torch.Tensor, prec: Prec
                ) -> torch.Tensor:
    """The DConv along time for every (batch, frequency) row."""
    b, c, f, t = y.shape
    rows = y.permute(0, 2, 1, 3).reshape(b * f, c, t)
    rows = dconv(p, name, rows, prec)
    return rows.reshape(b, f, c, t).permute(0, 2, 1, 3)


def enc_layer(p: Params, name: str, x: torch.Tensor, freq: bool,
              prec: Prec) -> torch.Tensor:
    if freq:
        y = conv2d(p, name + ".conv", x, (STRIDE, 1), (KERNEL // 4, 0), prec)
        y = _dconv_freq(p, name + ".dconv", gelu(y), prec)
        return glu(conv2d(p, name + ".rewrite", y, prec=prec), 1)
    t = x.shape[-1]
    if t % STRIDE:
        x = torch.nn.functional.pad(x, (0, STRIDE - t % STRIDE))
    y = gelu(conv1d(p, name + ".conv", x, STRIDE, KERNEL // 4, prec=prec))
    y = dconv(p, name + ".dconv", y, prec)
    return glu(conv1d(p, name + ".rewrite", y, prec=prec), 1)


def sin_embedding(length: int, dim: int, device) -> torch.Tensor:
    """(length, dim): [cos(phase), sin(phase)]."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    adim = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    phase = pos / (MAX_PERIOD ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def sin_embedding_2d(dim: int, height: int, width: int, device
                     ) -> torch.Tensor:
    """(dim, height, width): the first half of the channels encodes the
    width (time), the second the height (frequency), sin/cos interleaved."""
    half = dim // 2
    div = torch.exp(torch.arange(0.0, half, 2.0, device=device)
                    * -(math.log(MAX_PERIOD) / half))
    pw = torch.arange(width, dtype=torch.float32, device=device)[:, None] * div
    ph = torch.arange(height, dtype=torch.float32, device=device)[:, None] * div
    pe = torch.zeros((dim, height, width), device=device)
    pe[0:half:2] = torch.sin(pw).T[:, None, :]
    pe[1:half:2] = torch.cos(pw).T[:, None, :]
    pe[half::2] = torch.sin(ph).T[:, :, None]
    pe[half + 1::2] = torch.cos(ph).T[:, :, None]
    return pe


def _norm_tokens(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """One-group GroupNorm over a (B, L, C) token stream."""
    return group_norm1(p, name, x.transpose(1, 2)).transpose(1, 2)


def _ff(p: Params, name: str, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    return lin(p, name + ".linear2", gelu(lin(p, name + ".linear1", x, prec)),
               prec)


def _self_layer(p, name, x, heads, prec):
    h = layer_norm(p, name + ".norm1", x)
    x = x + p[name + ".gamma_1.scale"] * mha(p, name + ".self_attn", h, h, h,
                                             heads, prec)
    x = x + p[name + ".gamma_2.scale"] * _ff(
        p, name, layer_norm(p, name + ".norm2", x), prec)
    return _norm_tokens(p, name + ".norm_out", x)


def _cross_layer(p, name, q, mem, heads, prec):
    qn = layer_norm(p, name + ".norm1", q)
    mn = layer_norm(p, name + ".norm2", mem)
    x = q + p[name + ".gamma_1.scale"] * mha(p, name + ".cross_attn", qn, mn,
                                             mn, heads, prec)
    x = x + p[name + ".gamma_2.scale"] * _ff(
        p, name, layer_norm(p, name + ".norm3", x), prec)
    return _norm_tokens(p, name + ".norm_out", x)


def crosstransformer(p: Params, name: str, x: torch.Tensor, xt: torch.Tensor,
                     heads: int, prec: Prec):
    """x (B, C, F, T1), xt (B, C, T2) -> both after the transformer.  Freq
    tokens are time-major."""
    b, c, fr, t1 = x.shape
    pos = sin_embedding_2d(c, fr, t1, x.device).permute(2, 1, 0).reshape(
        t1 * fr, c)
    xs = layer_norm(p, name + ".norm_in",
                    x.permute(0, 3, 2, 1).reshape(b, t1 * fr, c)) + pos
    xts = layer_norm(p, name + ".norm_in_t", xt.transpose(1, 2))
    xts = xts + sin_embedding(xt.shape[-1], c, xt.device)
    for i in range(count_prefixed(p, name + ".layers")):
        lf, lt = f"{name}.layers.{i}", f"{name}.layers_t.{i}"
        if i % 2 == 0:
            xs = _self_layer(p, lf, xs, heads, prec)
            xts = _self_layer(p, lt, xts, heads, prec)
        else:
            old = xs
            xs = _cross_layer(p, lf, xs, xts, heads, prec)
            xts = _cross_layer(p, lt, xts, old, heads, prec)
    return (xs.reshape(b, t1, fr, c).permute(0, 3, 2, 1),
            xts.transpose(1, 2))


def normalize(mix: torch.Tensor, n_fft: int, hop: int) -> Dict:
    """The spectrogram and the waveform, each normalised by its own mean
    and unbiased std over all but the batch axis."""
    z = dsp.spec(mix, n_fft, hop)
    mag = dsp.to_cac(z)
    mean = mag.mean(dim=(1, 2, 3), keepdim=True)
    std = mag.std(dim=(1, 2, 3), keepdim=True)
    meant = mix.mean(dim=(1, 2), keepdim=True)
    stdt = mix.std(dim=(1, 2), keepdim=True)
    return {"z": z, "mag": mag, "x": (mag - mean) / (1e-5 + std),
            "xt": (mix - meant) / (1e-5 + stdt), "mean": mean, "std": std,
            "meant": meant, "stdt": stdt}


def encode(p: Params, x: torch.Tensor, xt: torch.Tensor, heads: int,
           prec: Prec = F32) -> Dict:
    """The two encoders, the samplers and the transformer: the bottleneck
    pair and each level's skip and input length."""
    saved, saved_t, lengths, lengths_t = [], [], [], []
    for i in range(count_prefixed(p, "encoder")):
        lengths.append(x.shape[-1])
        lengths_t.append(xt.shape[-1])
        xt = enc_layer(p, f"tencoder.{i}", xt, False, prec)
        saved_t.append(xt)
        x = enc_layer(p, f"encoder.{i}", x, True, prec)
        if i == 0:
            emb = p["freq_emb.embedding.weight"][:x.shape[-2]] * EMB_SCALE
            x = x + FREQ_EMB_SCALE * emb.T[None, :, :, None]
        saved.append(x)
    b, c, f, t = x.shape
    x = conv1d(p, "channel_upsampler", x.reshape(b, c, f * t), prec=prec
               ).reshape(b, -1, f, t)
    xt = conv1d(p, "channel_upsampler_t", xt, prec=prec)
    x, xt = crosstransformer(p, "crosstransformer", x, xt, heads, prec)
    b, c2, f, t = x.shape
    x = conv1d(p, "channel_downsampler", x.reshape(b, c2, f * t), prec=prec
               ).reshape(b, -1, f, t)
    xt = conv1d(p, "channel_downsampler_t", xt, prec=prec)
    return {"x": x, "xt": xt, "saved": saved, "saved_t": saved_t,
            "lengths": lengths, "lengths_t": lengths_t}
