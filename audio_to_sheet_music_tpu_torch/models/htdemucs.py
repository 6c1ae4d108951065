"""HTDemucs in PyTorch.

Counterpart of ``audio_to_sheet_music_tpu/models/htdemucs.py``: the frozen
42 M-param tower's dual encoders, cross-domain transformer and decoders.
The modules hold the full tower's parameters under the torch checkpoint
names; the functions below compute the encode path the serving forward
runs (``encode``) and the whole 4-source tower the HTDemucs baseline runs
(``forward``: ``encode``, then 4 freq and 4 time ``HDecLayer``s, the CaC
mask and the iSTFT, plus the time branch).  The encode path is:

- 4 frequency ``HEncLayer``s (Conv2d k=(8,1) s=(4,1), GELU, DConv residual,
  1x1 rewrite + GLU) over the 2048-bin CaC spectrogram, and 4 time
  ``HEncLayer``s (Conv1d k=8 s=4) over the waveform;
- the ``ScaledEmbedding`` frequency embedding after layer 0;
- 384 <-> 512 channel samplers around the cross-domain transformer
  (5 layers per branch, self at 0/2/4, cross at 1/3, pre-LN, LayerScale,
  GroupNorm out).

The hand-written kernels a forward runs are chosen by ``kernels`` (see
``ops.select``), with the JAX package's routing: under the default
selection freq layer 0 goes through ``ops.fused_enc.henc_freq_fused`` and
every transformer layer through ``ops.fused_attn.layer_tail``; under
``"opt_in"`` the attention of every transformer layer goes through
``ops.fused_attn.attn_block`` and the freq DConv of encoder layers 1-3
and of the four freq decoder layers through ``ops.fused_dconv.dconv_rows``.
``kernels=False`` computes the same layers with per-op PyTorch calls
instead; that is the comparison path, not a substitute: a kernel that
cannot take its input raises.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from ..nn import core as L
from ..nn import prng
from ..nn.attention import MHA, mha
from ..ops import dsp, fused_attn, fused_dconv, fused_enc
from ..ops.select import Kernels, KernelSelection, resolve

CHANNELS = [48, 96, 192, 384]
AUDIO_CHANNELS = 2
CAC_CHANNELS = 2 * AUDIO_CHANNELS
KERNEL = 8
STRIDE = 4
DCONV_COMPRESS = 8
DCONV_DEPTH = 2
DCONV_INIT = 1e-3
FREQ_EMB_DIM = 512
FREQ_EMB_SCALE = 0.2
SCALED_EMB_SCALE = 10.0
BOTTOM_CHANNELS = 512
T_LAYERS = 5
T_MAX_PERIOD = 10000.0
T_LAYER_SCALE_INIT = 1e-4
SOURCES = ["drums", "bass", "other", "vocals"]
NFFT = 4096
HOP = 1024


# ---------------------------------------------------------------------------
# Modules (parameter names follow the demucs checkpoint)
# ---------------------------------------------------------------------------

class DConvBlock(nn.Module):
    """demucs DConv block, ``Sequential(conv1, norm1, GELU, conv2, norm2,
    GLU, LayerScale)``: parameters live at indices 0, 1, 3, 4, 6.  ``keys``
    is the JAX ``dconv_init``'s ``(k1, k2)`` for the two convolutions."""

    def __init__(self, channels: int, keys=(None, None)):
        super().__init__()
        hidden = channels // DCONV_COMPRESS
        self.add_module("0", L.Conv1d(channels, hidden, 3, keys[0]))
        self.add_module("1", L.Norm(hidden))
        self.add_module("3", L.Conv1d(hidden, 2 * channels, 1, keys[1]))
        self.add_module("4", L.Norm(2 * channels))
        self.add_module("6", L.LayerScale(channels, DCONV_INIT))

    conv1 = property(lambda self: self._modules["0"])
    norm1 = property(lambda self: self._modules["1"])
    conv2 = property(lambda self: self._modules["3"])
    norm2 = property(lambda self: self._modules["4"])
    scale = property(lambda self: self._modules["6"])


class DConv(nn.Module):
    """The JAX ``dconv_init``: ``key, k1, k2 = split(key, 3)`` per block."""

    def __init__(self, channels: int, key=None):
        super().__init__()
        blocks = []
        for _ in range(DCONV_DEPTH):
            key, k1, k2 = L.split(key, 3)
            blocks.append(DConvBlock(channels, (k1, k2)))
        self.layers = nn.ModuleList(blocks)


class HEncLayer(nn.Module):
    """The JAX ``henc_layer_init``: conv, rewrite, DConv from
    ``split(key, 3)``."""

    def __init__(self, chin: int, chout: int, freq: bool, key=None):
        super().__init__()
        self.freq = freq
        k1, k2, k3 = L.split(key, 3)
        if freq:
            self.conv = L.Conv2d(chin, chout, (KERNEL, 1), k1)
            self.rewrite = L.Conv2d(chout, 2 * chout, (1, 1), k2)
        else:
            self.conv = L.Conv1d(chin, chout, KERNEL, k1)
            self.rewrite = L.Conv1d(chout, 2 * chout, 1, k2)
        self.dconv = DConv(chout, k3)


class HDecLayer(nn.Module):
    """Decoder layer: 3x3 (freq) or k=3 (time) rewrite + GLU, DConv, then
    the stride-4 transposed conv (``hdec_layer_apply``); keys as the JAX
    ``hdec_layer_init``: conv_tr, rewrite, DConv from ``split(key, 3)``."""

    def __init__(self, chin: int, chout: int, freq: bool, key=None):
        super().__init__()
        k1, k2, k3 = L.split(key, 3)
        if freq:
            self.conv_tr = L.ConvTranspose2d(chin, chout, (KERNEL, 1), k1)
            self.rewrite = L.Conv2d(chin, 2 * chin, (3, 3), k2)
        else:
            self.conv_tr = L.ConvTranspose1d(chin, chout, KERNEL, k1)
            self.rewrite = L.Conv1d(chin, 2 * chin, 3, k2)
        self.dconv = DConv(chin, k3)


class TransformerLayer(nn.Module):
    """The JAX ``_transformer_layer_init``: attention, linear1, linear2
    from ``split(key, 3)``."""

    def __init__(self, dim: int, cross: bool, ff: int, key=None):
        super().__init__()
        self.cross = cross
        k1, k2, k3 = L.split(key, 3)
        self.add_module("cross_attn" if cross else "self_attn", MHA(dim, k1))
        self.linear1 = L.Linear(dim, ff, k2)
        self.linear2 = L.Linear(ff, dim, k3)
        self.norm1 = L.Norm(dim)
        self.norm2 = L.Norm(dim)
        self.norm_out = L.Norm(dim)
        self.gamma_1 = L.LayerScale(dim, T_LAYER_SCALE_INIT)
        self.gamma_2 = L.LayerScale(dim, T_LAYER_SCALE_INIT)
        if cross:
            self.norm3 = L.Norm(dim)

    @property
    def attn(self) -> MHA:
        return self._modules["cross_attn" if self.cross else "self_attn"]


class CrossTransformer(nn.Module):
    """The JAX ``crosstransformer_init``: ``split(key, 2 * n_layers)``,
    freq layer ``i`` from key ``2i``, time layer ``i`` from ``2i + 1``."""

    def __init__(self, dim: int = BOTTOM_CHANNELS, n_layers: int = T_LAYERS,
                 ff: int | None = None, key=None):
        super().__init__()
        ff = ff if ff is not None else 4 * dim
        keys = L.split(key, 2 * n_layers)
        self.norm_in = L.Norm(dim)
        self.norm_in_t = L.Norm(dim)
        layers, layers_t = [], []
        for idx in range(n_layers):
            cross = idx % 2 == 1
            layers.append(TransformerLayer(dim, cross, ff, keys[2 * idx]))
            layers_t.append(TransformerLayer(dim, cross, ff,
                                             keys[2 * idx + 1]))
        self.layers = nn.ModuleList(layers)
        self.layers_t = nn.ModuleList(layers_t)


class ScaledEmbedding(nn.Module):
    def __init__(self, num: int, dim: int, key=None):
        super().__init__()
        self.embedding = L.Embedding(num, dim, None)
        if key is not None:
            # smooth init: cumsum of normals down-weighted by sqrt(row + 1),
            # pre-divided by the output scale
            w = prng.normal(key, (num, dim)).cumsum(0)
            rows = torch.arange(1, num + 1, dtype=torch.float32,
                                device=w.device)
            self.embedding.weight.data = (w / rows.sqrt()[:, None]
                                          / SCALED_EMB_SCALE)


class HTDemucs(nn.Module):
    """The tower's parameters; ``channels``/``bottom_channels``/``t_layers``
    build smaller family members with the same wiring (depth stays 4).
    ``key`` is consumed as the JAX ``htdemucs_init`` consumes it:
    ``split(key, 4n + 7)`` handed out in order to the freq and time encoder
    layers (level by level), the freq and time decoder layers, the
    frequency embedding, the four channel samplers and the transformer."""

    def __init__(self, channels=tuple(CHANNELS),
                 bottom_channels: int = BOTTOM_CHANNELS,
                 t_layers: int = T_LAYERS, key=None):
        super().__init__()
        channels = list(channels)
        ki = iter(L.split(key, 4 * len(channels) + 7))
        enc, tenc, dec, tdec = [], [], [], []
        chin_f, chin_t = CAC_CHANNELS, AUDIO_CHANNELS
        for ch in channels:
            enc.append(HEncLayer(chin_f, ch, True, next(ki)))
            tenc.append(HEncLayer(chin_t, ch, False, next(ki)))
            chin_f, chin_t = ch, ch
        n_src = len(SOURCES)
        douts_f = channels[-2::-1] + [n_src * CAC_CHANNELS]
        douts_t = channels[-2::-1] + [n_src * AUDIO_CHANNELS]
        dins = channels[::-1]
        for i in range(len(channels)):
            dec.append(HDecLayer(dins[i], douts_f[i], True, next(ki)))
            tdec.append(HDecLayer(dins[i], douts_t[i], False, next(ki)))
        self.encoder = nn.ModuleList(enc)
        self.tencoder = nn.ModuleList(tenc)
        self.decoder = nn.ModuleList(dec)
        self.tdecoder = nn.ModuleList(tdec)
        self.freq_emb = ScaledEmbedding(FREQ_EMB_DIM, channels[0], next(ki))
        top = channels[-1]
        self.channel_upsampler = L.Conv1d(top, bottom_channels, 1, next(ki))
        self.channel_downsampler = L.Conv1d(bottom_channels, top, 1, next(ki))
        self.channel_upsampler_t = L.Conv1d(top, bottom_channels, 1, next(ki))
        self.channel_downsampler_t = L.Conv1d(bottom_channels, top, 1,
                                              next(ki))
        self.crosstransformer = CrossTransformer(bottom_channels, t_layers,
                                                 key=next(ki))


# ---------------------------------------------------------------------------
# DConv and the encoder layers
# ---------------------------------------------------------------------------

def dconv_apply(dconv: DConv, x: torch.Tensor) -> torch.Tensor:
    """x: (B, C, T).  Two residual dilated compress-expand blocks."""
    for d, blk in enumerate(dconv.layers):
        dil = 2 ** d
        y = L.conv1d(blk.conv1, x, padding=dil, dilation=dil)
        y = L.group_norm(blk.norm1, y, 1, act="gelu")
        y = L.conv1d(blk.conv2, y)
        y = L.group_norm(blk.norm2, y, 1, act="glu")
        x = x + L.layer_scale(blk.scale, y)
    return x


def _dconv_freq(dconv: DConv, y: torch.Tensor,
                sel: KernelSelection) -> torch.Tensor:
    """The 1-D DConv along time for every (batch, freq) row; the folded rows
    go through ``dconv_rows`` under the ``dconv`` selection where the JAX
    package's test (``fused_dconv.supports``) takes them."""
    b, c, f, t = y.shape
    y = y.permute(0, 2, 1, 3).reshape(b * f, c, t)
    if sel.dconv and fused_dconv.supports(b * f, t, c):
        y = fused_dconv.dconv_rows(dconv, y.contiguous())
    else:
        y = dconv_apply(dconv, y)
    return y.reshape(b, f, c, t).permute(0, 2, 1, 3)


def henc_layer_apply(layer: HEncLayer, x: torch.Tensor,
                     kernels: Kernels = True) -> torch.Tensor:
    """HEncLayer: strided conv -> GELU -> DConv -> rewrite + GLU."""
    sel = resolve(kernels)
    if layer.freq:
        cin, cout = x.shape[1], layer.conv.weight.shape[0]
        if (sel.enc and fused_enc.profitable(cin)
                and fused_enc.supports(cin, cout, x.shape[2], x.shape[3])):
            return fused_enc.henc_freq_fused(layer, x)
        y = L.conv2d(layer.conv, x, stride=(STRIDE, 1), padding=(KERNEL // 4, 0))
    else:
        t = x.shape[-1]
        if t % STRIDE:
            x = torch.nn.functional.pad(x, (0, STRIDE - t % STRIDE))
        y = L.conv1d(layer.conv, x, stride=STRIDE, padding=KERNEL // 4)
    y = L.gelu(y)
    if layer.freq:
        y = _dconv_freq(layer.dconv, y, sel)
        z = L.conv2d(layer.rewrite, y)
    else:
        y = dconv_apply(layer.dconv, y)
        z = L.conv1d(layer.rewrite, y)
    return L.glu(z, dim=1)


def hdec_layer_apply(layer: HDecLayer, x: torch.Tensor, skip: torch.Tensor,
                     length: int, freq: bool, last: bool,
                     kernels: Kernels = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HDecLayer: +skip -> rewrite + GLU -> DConv -> transposed conv -> crop
    -> GELU (not on the ``last`` layer).  The freq crop drops the 2 bins
    the transposed conv adds at each end; the time crop keeps ``length``
    samples.  Returns ``(z, pre)``, ``pre`` being the DConv output, as the
    reference does.  The freq DConv is routed as the encoder's is."""
    sel = resolve(kernels)
    pad = (KERNEL - STRIDE) // 2
    x = x + skip
    if freq:
        y = L.glu(L.conv2d(layer.rewrite, x, padding=(1, 1)), dim=1)
        y = _dconv_freq(layer.dconv, y, sel)
        z = L.conv_transpose2d(layer.conv_tr, y, stride=(STRIDE, 1))
        z = z[..., pad:-pad, :]
    else:
        y = L.glu(L.conv1d(layer.rewrite, x, padding=1), dim=1)
        y = dconv_apply(layer.dconv, y)
        z = L.conv_transpose1d(layer.conv_tr, y, stride=STRIDE)
        z = z[..., pad:pad + length]
    if not last:
        z = L.gelu(z)
    return z, y


# ---------------------------------------------------------------------------
# Positional embeddings
# ---------------------------------------------------------------------------

def create_sin_embedding(length: int, dim: int, device,
                         max_period: float = T_MAX_PERIOD) -> torch.Tensor:
    """1-D sin embedding, ``(length, dim)`` = concat[cos(phase), sin(phase)]."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    adim = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def create_2d_sin_embedding(d_model: int, height: int, width: int, device,
                            max_period: float = T_MAX_PERIOD) -> torch.Tensor:
    """2-D sin embedding ``(d_model, height, width)``: the first half of the
    channels encodes width (time), the second half height (frequency),
    interleaved sin/cos."""
    half = d_model // 2
    div_term = torch.exp(torch.arange(0.0, half, 2.0, device=device)
                         * -(math.log(max_period) / half))
    pos_w = torch.arange(width, dtype=torch.float32, device=device)[:, None]
    pos_h = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    sin_w, cos_w = torch.sin(pos_w * div_term).T, torch.cos(pos_w * div_term).T
    sin_h, cos_h = torch.sin(pos_h * div_term).T, torch.cos(pos_h * div_term).T
    pe = torch.zeros((d_model, height, width), dtype=torch.float32,
                     device=device)
    pe[0:half:2] = sin_w[:, None, :]
    pe[1:half:2] = cos_w[:, None, :]
    pe[half::2] = sin_h[:, :, None]
    pe[half + 1::2] = cos_h[:, :, None]
    return pe


# ---------------------------------------------------------------------------
# Cross-domain transformer
# ---------------------------------------------------------------------------

def _n_heads(dim: int) -> int:
    """Head count by the head_dim=64 convention (8 for the 512-wide tower)."""
    return max(1, dim // 64)


def _group_norm_tokens(m: L.Norm, x: torch.Tensor) -> torch.Tensor:
    """MyGroupNorm(1, C) over a (B, L, C) token stream: stats over (L, C)."""
    return L.group_norm(m, x, 1, layout="tokens")


def _ff(layer: TransformerLayer, x: torch.Tensor) -> torch.Tensor:
    return L.linear(layer.linear2, L.gelu(L.linear(layer.linear1, x)))


def _attn_residual(layer: TransformerLayer, x_res: torch.Tensor,
                   q_in: torch.Tensor, kv_in: torch.Tensor,
                   sel: KernelSelection) -> torch.Tensor:
    """``x_res + LayerScale(MHA(q_in, kv_in, kv_in))``, per op or through
    ``attn_block`` under the ``attn`` selection (JAX ``_attn_residual``)."""
    heads = _n_heads(x_res.shape[-1])
    if sel.attn and fused_attn.supports_block(x_res.shape[-1], heads):
        return fused_attn.mha_residual(layer.attn, layer.gamma_1, x_res, q_in,
                                       kv_in, heads)
    return x_res + L.layer_scale(layer.gamma_1,
                                 mha(layer.attn, q_in, kv_in, kv_in, heads),
                                 channel_last=True)


def _takes_layer_tail(layer: TransformerLayer, sel: KernelSelection,
                      dim: int, heads: int) -> bool:
    """The ``layer`` selection routes a layer to ``layer_tail`` where the
    kernel takes its widths (the JAX ``_use_pallas_layer`` test, with the
    port's kernel's ``supports``); other widths run per op."""
    return sel.layer and fused_attn.supports(dim, heads,
                                             layer.linear1.weight.shape[0])


def _self_layer_apply(layer: TransformerLayer, x: torch.Tensor,
                      kernels: Kernels) -> torch.Tensor:
    sel = resolve(kernels)
    heads = _n_heads(x.shape[-1])
    if _takes_layer_tail(layer, sel, x.shape[-1], heads):
        y = fused_attn.fused_self_layer(layer, x, heads)
        return _group_norm_tokens(layer.norm_out, y)
    h = L.layer_norm(layer.norm1, x)
    x = _attn_residual(layer, x, h, h, sel)
    x = x + L.layer_scale(layer.gamma_2, _ff(layer, L.layer_norm(layer.norm2, x)),
                          channel_last=True)
    return _group_norm_tokens(layer.norm_out, x)


def _cross_layer_apply(layer: TransformerLayer, q: torch.Tensor,
                       mem: torch.Tensor, kernels: Kernels) -> torch.Tensor:
    sel = resolve(kernels)
    heads = _n_heads(q.shape[-1])
    if _takes_layer_tail(layer, sel, q.shape[-1], heads):
        y = fused_attn.fused_cross_layer(layer, q, mem, heads)
        return _group_norm_tokens(layer.norm_out, y)
    qn = L.layer_norm(layer.norm1, q)
    mn = L.layer_norm(layer.norm2, mem)
    x = _attn_residual(layer, q, qn, mn, sel)
    x = x + L.layer_scale(layer.gamma_2, _ff(layer, L.layer_norm(layer.norm3, x)),
                          channel_last=True)
    return _group_norm_tokens(layer.norm_out, x)


def crosstransformer_apply(ct: CrossTransformer, x: torch.Tensor,
                           xt: torch.Tensor, kernels: Kernels = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C, Fr, T1) freq branch; xt: (B, C, T2) time branch.

    Freq tokens are t-major (``b c f t -> b (t f) c``); sin embeddings are
    added after the input LayerNorms; self (0, 2, 4) and cross (1, 3)
    layers alternate.
    """
    b, c, fr, t1 = x.shape
    pos2d = create_2d_sin_embedding(c, fr, t1, x.device)
    pos2d = pos2d.permute(2, 1, 0).reshape(t1 * fr, c)
    xs = x.permute(0, 3, 2, 1).reshape(b, t1 * fr, c)
    xs = L.layer_norm(ct.norm_in, xs)
    xs = xs + pos2d.to(xs.dtype)

    t2 = xt.shape[-1]
    pos1d = create_sin_embedding(t2, c, xt.device)
    xts = L.layer_norm(ct.norm_in_t, xt.transpose(1, 2))
    xts = xts + pos1d.to(xts.dtype)

    for lp, ltp in zip(ct.layers, ct.layers_t):
        if not lp.cross:
            xs = _self_layer_apply(lp, xs, kernels)
            xts = _self_layer_apply(ltp, xts, kernels)
        else:
            old = xs
            xs = _cross_layer_apply(lp, xs, xts, kernels)
            xts = _cross_layer_apply(ltp, xts, old, kernels)

    x = xs.reshape(b, t1, fr, c).permute(0, 3, 2, 1)
    xt = xts.transpose(1, 2)
    return x, xt


# ---------------------------------------------------------------------------
# Front end and encode
# ---------------------------------------------------------------------------

def normalize_inputs(mix: torch.Tensor, stft_kernel: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """Spectral + waveform normalisation; std is unbiased (ddof=1), as in
    the reference.  Returns ``(z, mag, x, xt, mean, std, meant, stdt)``.
    ``stft_kernel`` sends the STFT through ``ops.fused_stft``."""
    z = dsp.spec(mix, NFFT, HOP, stft_kernel)         # (B, 2, 2048, T) complex
    mag = dsp.magnitude_cac(z)                        # (B, 4, 2048, T)
    mean = mag.mean(dim=(1, 2, 3), keepdim=True)
    std = mag.std(dim=(1, 2, 3), keepdim=True)
    x = (mag - mean) / (1e-5 + std)
    mixf = mix.float()
    meant = mixf.mean(dim=(1, 2), keepdim=True)
    stdt = mixf.std(dim=(1, 2), keepdim=True)
    xt = (mixf - meant) / (1e-5 + stdt)
    return z, mag, x, xt, mean, std, meant, stdt


def encode(ht: HTDemucs, x: torch.Tensor, xt: torch.Tensor,
           kernels: Kernels = True
           ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor],
                      List[torch.Tensor], List[int], List[int]]:
    """x: (B, 4, 2048, T) normalised CaC spectrogram; xt: (B, 2, T) waveform.

    Returns the bottleneck after the cross-transformer plus per-layer skips
    and lengths for the decoders.
    """
    kernels = resolve(kernels)
    saved, saved_t, lengths, lengths_t = [], [], [], []
    for idx in range(len(ht.encoder)):
        lengths.append(x.shape[-1])
        lengths_t.append(xt.shape[-1])
        xt = henc_layer_apply(ht.tencoder[idx], xt, kernels)
        saved_t.append(xt)
        x = henc_layer_apply(ht.encoder[idx], x, kernels)
        if idx == 0:
            frs = torch.arange(x.shape[-2], device=x.device)
            emb = L.embedding(ht.freq_emb.embedding, frs) * SCALED_EMB_SCALE
            x = x + FREQ_EMB_SCALE * emb.T[None, :, :, None].to(x.dtype)
        saved.append(x)

    b, c, f, t = x.shape
    x = L.conv1d(ht.channel_upsampler, x.reshape(b, c, f * t)).reshape(b, -1, f, t)
    xt = L.conv1d(ht.channel_upsampler_t, xt)
    x, xt = crosstransformer_apply(ht.crosstransformer, x, xt, kernels)
    b, c2, f, t = x.shape
    x = L.conv1d(ht.channel_downsampler, x.reshape(b, c2, f * t)).reshape(b, -1, f, t)
    xt = L.conv1d(ht.channel_downsampler_t, xt)
    return x, xt, saved, saved_t, lengths, lengths_t


def forward(ht: HTDemucs, mix: torch.Tensor,
            compute_dtype: torch.dtype | None = None,
            kernels: Kernels = True) -> torch.Tensor:
    """The whole 4-source tower: ``(B, 2, T) -> (B, 4 sources, 2, T)`` in
    ``mix``'s dtype.

    The DSP front end runs in f32 (with the STFT kernel under the ``stft``
    selection, as ``atht.encode_mixture`` runs it); ``compute_dtype`` casts
    the tower's inputs after it.  The de-normalisation promotes the
    decoders' output to f32, so the CaC mask and the iSTFT run in f32.
    """
    sel = resolve(kernels)
    length = mix.shape[-1]
    _, _, x, xt, mean, std, meant, stdt = normalize_inputs(mix.float(),
                                                           sel.stft)
    b, _, fq, tspec = x.shape
    if compute_dtype is not None:
        x, xt = x.to(compute_dtype), xt.to(compute_dtype)
    x, xt, saved, saved_t, lengths, lengths_t = encode(ht, x, xt, sel)

    n_layers = len(ht.decoder)
    for idx in range(n_layers):
        last = idx == n_layers - 1
        x, _ = hdec_layer_apply(ht.decoder[idx], x, saved.pop(),
                                lengths.pop(), True, last, sel)
        xt, _ = hdec_layer_apply(ht.tdecoder[idx], xt, saved_t.pop(),
                                 lengths_t.pop(), False, last, sel)

    n_src = len(SOURCES)
    x = x.reshape(b, n_src, CAC_CHANNELS, fq, tspec)
    x = x * std[:, None] + mean[:, None]
    wav_f = dsp.ispec(dsp.mask_cac(x), length, NFFT, HOP)   # (B, S, 2, T)
    xt = xt.reshape(b, n_src, AUDIO_CHANNELS, length)
    xt = xt * stdt[:, None] + meant[:, None]
    return (wav_f + xt).to(mix.dtype)
