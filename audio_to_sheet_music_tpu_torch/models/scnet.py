"""SCNet: a band-split convolutional U-Net around dual-path BiLSTMs.

Tong, Liang, Zhang, Wang, Hu, "SCNet: Sparse Compression Network for Music
Source Separation" (ICASSP 2024, arXiv:2401.13276), as
``starrytong/SCNet`` (``scnet/SCNet.py``) builds it: the parameters carry
that module's ``state_dict`` names and layouts (``encoder.{i}.SDlayer``,
``encoder.{i}.conv_modules``, ``encoder.{i}.globalconv``,
``separation_net.dp_modules.{i}.{lstm_layers,linear_layers,norm_layers}``,
``decoder.{i}.0.conv``, ``decoder.{i}.1.convtrs``; each LSTM an
``nn.LSTM``).  ``PUBLISHED`` holds the widths of SCNet-large as
``ZFTurbo/Music-Source-Separation-Training``'s
``configs/config_musdb18_scnet_large.yaml`` sets them, ``TINY`` a test
size.

The forward of a ``(B, 2, L)`` chunk batch:

1. pad each chunk on the right by ``hop - L % hop``, and by one hop more
   where that leaves an even number of hops, so the frame count is even;
   the STFT of each channel (n_fft 4096, hop 1024, centred with reflect
   padding, normalised, no window: ``torch.stft``'s rectangular one), laid
   out complex-as-channels ``(B, 4, F, T)`` (ch0 re, ch0 im, ch1 re, ch1
   im), then ``(x - mean) / (1e-5 + std)`` per item over (C, F, T), the
   std unbiased;
2. 3 SD blocks.  A block splits F into three bands at ``ceil(F·SR_low)``
   and ``ceil(F·(SR_low + SR_mid))``, pads each along F (``kernel -
   stride`` where the stride is 1, else up to a multiple of the stride,
   split evenly), takes ``Conv2d(C_in, C_out, (kernel, 1), (stride, 1))``
   a band, runs each band's rows ``(B·F_b, C, T)`` through a convolution
   module of depth 3, 2 or 1 and a GELU, and concatenates the bands along
   F (the skip); its output is ``Conv2d(C, C, 3, pad 1)`` of the skip.  A
   convolution module's step is ``x += Conv1d(h, C, 1)(SiLU(GN1(
   DWConv1d(h, 3)(GLU(Conv1d(C, 2h, 3)(GN1(x)))))))``, ``h = C / 4``,
   ``GN1 = GroupNorm(1, ·)``;
3. the separation net: ``num_dplayer`` dual-path layers of width d (d on
   even layers, 2d on odd ones).  A layer runs ``x += Linear(2d, d)(
   BiLSTM(GN1(x)))`` over sequences along F (one per item and frame),
   then the same over sequences along T (one per item and band row).
   After an even layer ``rfft`` along T (orthonormal, f32) with its real
   and imaginary parts concatenated on the channels (d -> 2d, T -> T/2 +
   1), after an odd one ``irfft`` back;
4. the decoder, from the deepest block: ``x = GLU_ch(Conv2d(2C, 2C, 3, pad
   1)(repeat(x + skip, 2 on channels)))``, then ``ConvTranspose2d(C,
   C_out, (kernel, 1), (stride, 1))`` a band, each trimmed symmetrically to
   its band's length before the SD layer;
5. ``x·std + mean`` as ``(B, sources, 2 channels, re/im, F, T)``, the
   inverse STFT with the same settings (``hop·(T - 1)`` samples), the pad
   trimmed -> ``(B, sources, 2, L)`` f32.

Layout and algebra the port takes where the published module does
otherwise, each the same function: the separation net holds x
channels-last, ``(B, F, T, C)`` (the time path's sequences are then its
rows as they lie, and each GN1 is the token form of ``nn.core.group_norm``,
whose statistics over (F, T, C) do not depend on the layout); the decoder's
``repeat`` on the channels is folded into its convolution's weights
(``conv(repeat(x, 2)) = conv_{W[:, :C] + W[:, C:]}(x)``, the sum formed in
f32, then rounded), which halves that convolution's work; the SU layers'
transposed convolutions are a product (stride = kernel) or a convolution
with the kernel flipped (stride 1), ``conv_transpose_rows``.

Precision: products and convolutions take ``compute_dtype`` operands (bf16
on the card) with f32 sums; the STFT, the inverse STFT, the mean and std,
the GroupNorm statistics and the separation net's FFTs run in f32 (the
FFTs' outputs round to the compute dtype).  Every GroupNorm goes through
``nn.core.group_norm`` (on the card ``ops.fused_norm.group_norm``, the
convolution module's second norm with its SiLU: ``act="silu"``).  Each
LSTM runs PyTorch's own ``nn.LSTM`` (cuDNN on the card) on a copy of its
weights in the compute dtype, flattened once into one buffer
(``_lstm_in``): a captured program replays cuDNN's launches on it.

Span ``atsm.model.scnet`` on an eager ``forward`` (none while a CUDA graph
captures it).  Counter ``launches.dual_path``: one a dual-path layer
(``num_dplayer`` a forward), registered in ``ops.select.LAYERS`` when
this module is imported, so a program's replays book it as a kernel's
launches are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import prng
from ..nn.core import (Conv1d, Conv2d, ConvTranspose2d, Linear, Norm, conv1d,
                       conv2d, gelu, group_norm, linear, split)
from ..ops import dsp, fused_norm, kernel_gate, select
from ..ops.select import NONE, Kernels, resolve
from ..utils import profiling
from .stem_serving import StemServing

# the dual-path layers' counter, ``launches.dual_path``
DUAL_PATH = select.LAYERS.setdefault("dual_path", select.LayerCount())

# fixed in every configuration the port runs: stereo, each channel's STFT as
# re/im channels, the STFT's window size its n_fft, normalised, no window
AUDIO_CHANNELS = 2
STD_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Config:
    sources: Tuple[str, ...] = ("drums", "bass", "other", "vocals")
    dims: Tuple[int, ...] = (4, 64, 128, 256)
    nfft: int = 4096
    hop: int = 1024
    band_sr: Tuple[float, ...] = (0.225, 0.372, 0.403)
    band_stride: Tuple[int, ...] = (1, 4, 16)
    band_kernel: Tuple[int, ...] = (3, 4, 16)
    conv_depths: Tuple[int, ...] = (3, 2, 1)
    compress: int = 4
    conv_kernel: int = 3
    num_dplayer: int = 6
    expand: int = 1

    def __post_init__(self):
        if self.dims[0] != 2 * AUDIO_CHANNELS:
            raise ValueError(f"SCNet: dims[0] {self.dims[0]}: the stereo "
                             "STFT has 4 channels")
        if not (len(self.band_sr) == len(self.band_stride)
                == len(self.band_kernel) == len(self.conv_depths) == 3):
            raise ValueError("SCNet: three bands (low, mid, high)")
        if any(s not in (1, k) for s, k in zip(self.band_stride,
                                                 self.band_kernel)):
            raise ValueError(f"SCNet: band strides {self.band_stride} with "
                             f"kernels {self.band_kernel}: each stride is 1 "
                             "or its kernel (conv_transpose_rows)")
        if self.num_dplayer % 2 or self.conv_kernel % 2 == 0:
            raise ValueError("SCNet: an even number of dual-path layers (the "
                             "FFT and its inverse in turn) and an odd "
                             "convolution kernel")


PUBLISHED = Config()
# 3 blocks 8-16-32 wide, 2 dual-path layers (one rfft, one irfft), n_fft 256
# (129 bins: bands of 30, 48 and 51 rows, then 46, 18 and 8 rows)
TINY = Config(dims=(4, 8, 16, 32), nfft=256, hop=64, num_dplayer=2)


def band_splits(rows: int, band_sr: Sequence[float]) -> List[Tuple[int, int]]:
    """``[(start, end)]`` of the three bands of ``rows`` frequency rows, at
    ``ceil(rows·SR_low)`` and ``ceil(rows·(SR_low + SR_mid))``."""
    a = math.ceil(rows * band_sr[0])
    b = math.ceil(rows * (band_sr[0] + band_sr[1]))
    return [(0, a), (a, b), (b, rows)]


def band_pad(rows: int, stride: int, kernel: int) -> Tuple[int, int]:
    """(before, after) rows of zeros a band of ``rows`` takes along F."""
    total = kernel - stride if stride == 1 else (stride - rows % stride) % stride
    return total // 2, total - total // 2


def band_rows(cfg: Config) -> List[List[int]]:
    """The band lengths after each SD layer, for the STFT's ``nfft // 2 +
    1`` rows: ``[[low, mid, high]]`` a block (the published widths: 462,
    191, 52; 159, 66, 18; 55, 23, 7: F = 705, 243, 85)."""
    rows, out = cfg.nfft // 2 + 1, []
    for _ in range(len(cfg.dims) - 1):
        lens = []
        for (a, e), s, k in zip(band_splits(rows, cfg.band_sr),
                                cfg.band_stride, cfg.band_kernel):
            lo, hi = band_pad(e - a, s, k)
            lens.append((e - a + lo + hi - k) // s + 1)
        out.append(lens)
        rows = sum(lens)
    return out


def right_pad(length: int, hop: int) -> int:
    """Samples added on the right of a ``length``-sample chunk: up to the
    next multiple of ``hop``, and a hop more where that is an even number
    of hops, so that the centred STFT has an even frame count."""
    pad = hop - length % hop
    if (length + pad) // hop % 2 == 0:
        pad += hop
    return pad


# ---------------------------------------------------------------------------
# Modules: the published state_dict names
# ---------------------------------------------------------------------------

def _lstm(dim: int, hidden: int, key=None) -> nn.LSTM:
    """A one-layer bidirectional ``nn.LSTM`` (batch first), each weight and
    bias U(±1/√hidden) (``nn.LSTM``'s init) from ``key``; without a key,
    uninitialised storage."""
    m = nn.LSTM(dim, hidden, batch_first=True, bidirectional=True,
                device="meta")
    names, bound = list(m._flat_weights_names), 1.0 / math.sqrt(hidden)
    for name, k in zip(names, split(key, len(names))):
        shape = tuple(getattr(m, name).shape)
        setattr(m, name, nn.Parameter(
            torch.empty(shape) if k is None
            else prng.uniform(k, shape, -bound, bound)))
    return m


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, depth: int, compress: int, kernel: int,
                 key=None):
        super().__init__()
        hidden = channels // compress
        self.layers = nn.ModuleList()
        for k in split(key, depth):
            k1, k2, k3 = split(k, 3)
            self.layers.append(nn.Sequential(
                Norm(channels), Conv1d(channels, 2 * hidden, kernel, k1),
                nn.GLU(1), Conv1d(1, hidden, kernel, k2),   # depthwise
                Norm(hidden), nn.SiLU(), Conv1d(hidden, channels, 1, k3)))


class SDlayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: Config, key=None):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv2d(c_in, c_out, (k, 1), kk)
            for k, kk in zip(cfg.band_kernel, split(key, 3))])


class SDblock(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: Config, key=None):
        super().__init__()
        k1, k2, k3 = split(key, 3)
        self.SDlayer = SDlayer(c_in, c_out, cfg, k1)
        self.conv_modules = nn.ModuleList([
            ConvolutionModule(c_out, d, cfg.compress, cfg.conv_kernel, kk)
            for d, kk in zip(cfg.conv_depths, split(k2, 3))])
        self.globalconv = Conv2d(c_out, c_out, (3, 3), k3)


class FusionLayer(nn.Module):
    def __init__(self, channels: int, key=None):
        super().__init__()
        self.conv = Conv2d(2 * channels, 2 * channels, (3, 3), key)


class SUlayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: Config, key=None):
        super().__init__()
        self.convtrs = nn.ModuleList([
            ConvTranspose2d(c_in, c_out, (k, 1), kk)
            for k, kk in zip(cfg.band_kernel, split(key, 3))])


class DualPathRNN(nn.Module):
    def __init__(self, dim: int, expand: int, key=None):
        super().__init__()
        hidden = dim * expand
        k1, k2, k3, k4 = split(key, 4)
        self.lstm_layers = nn.ModuleList([_lstm(dim, hidden, k1),
                                          _lstm(dim, hidden, k2)])
        self.linear_layers = nn.ModuleList([Linear(2 * hidden, dim, k3),
                                            Linear(2 * hidden, dim, k4)])
        self.norm_layers = nn.ModuleList([Norm(dim), Norm(dim)])


class SeparationNet(nn.Module):
    def __init__(self, cfg: Config, key=None):
        super().__init__()
        d = cfg.dims[-1]
        self.dp_modules = nn.ModuleList([
            DualPathRNN(d * (2 if i % 2 else 1), cfg.expand, k)
            for i, k in enumerate(split(key, cfg.num_dplayer))])


class SCNet(nn.Module):
    def __init__(self, cfg: Config = PUBLISHED, key=None):
        super().__init__()
        self.cfg = cfg
        dims, n = cfg.dims, len(cfg.dims) - 1
        keys = split(key, 2 * n + 1)
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for i in range(n):
            self.encoder.append(SDblock(dims[i], dims[i + 1], cfg, keys[i]))
            k1, k2 = split(keys[n + i])
            c_out = dims[i] if i else dims[0] * len(cfg.sources)
            self.decoder.insert(0, nn.Sequential(
                FusionLayer(dims[i + 1], k1),
                SUlayer(dims[i + 1], c_out, cfg, k2)))
        self.separation_net = SeparationNet(cfg, keys[2 * n])
        self.requires_grad_(False)

    @property
    def stems(self) -> Tuple[str, ...]:
        return self.cfg.sources

    def serving(self, tokenizer=None, normalize_text: bool = False):
        """What an ``infer.Separator`` serves this model through."""
        return Serving(self, tokenizer)

    def gate_pair(self, compute_dtype: torch.dtype):
        """The kernel parity gate's ``(forward, args)``: SD block 0 over a
        6 s chunk's seeded unit-normal spectrogram and dual-path layer 0
        over seeded unit-normal features at the separation net's rows, both
        ways: every GroupNorm through ``nn.core.group_norm`` (the kernel
        pair on a card: its plain, SiLU and token forms) for a selection,
        through ``fused_norm.group_norm_plain`` for ``none``; the rest (the
        convolutions, cuDNN's LSTM) is the same op both ways.  A tenth of
        the unit-order outputs, the scale the threshold was set on."""
        cfg = self.cfg
        frames = int(kernel_gate.GATE_SECONDS * kernel_gate.SAMPLE_RATE
                     ) // cfg.hop + 1
        rng = np.random.default_rng(0)
        spec = rng.standard_normal((1, cfg.dims[0], cfg.nfft // 2 + 1,
                                    frames)).astype(np.float32)
        feats = rng.standard_normal((1, sum(band_rows(cfg)[-1]), frames,
                                     cfg.dims[-1])).astype(np.float32)
        dev = next(self.parameters()).device

        def fwd(sel, m, s, f):
            norm = _plain_norm if resolve(sel) == NONE else group_norm
            y = sd_block(m.encoder[0], s, cfg, norm)[0]
            z = dual_path(m.separation_net.dp_modules[0], f, norm)
            return 0.1 * torch.cat([y.float().flatten(), z.float().flatten()])

        return fwd, (self, torch.from_numpy(spec).to(dev, compute_dtype),
                     torch.from_numpy(feats).to(dev, compute_dtype))


class Serving(StemServing):
    """An ``SCNet`` behind an ``infer.Separator``: its own stem names, no
    text prompts, whole songs on one device (``stem_serving``)."""

    name = "SCNet"

    def separate(self, model, chunks, compute_dtype, kernels) -> torch.Tensor:
        return forward(model, chunks, compute_dtype, kernels)


def init(cfg: Config = PUBLISHED, seed: int = 0, materialize: bool = True,
         device: str | torch.device = "cpu") -> SCNet:
    """The model with every convolution, Linear and LSTM weight and bias
    drawn U(±1/√fan_in) (an LSTM's fan the hidden width) from the threefry
    key of ``seed`` on ``device``, every GroupNorm's weight 1 and bias 0;
    ``materialize=False`` leaves the storage uninitialised, for a model
    that is about to be loaded."""
    key = prng.PRNGKey(seed, device) if materialize else None
    model = SCNet(cfg, key)
    return model.to(device) if materialize else model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

Norm1 = Callable[..., torch.Tensor]


def _plain_norm(m: Norm, x: torch.Tensor, num_groups: int = 1,
                act: str = "none", layout: str = "channels") -> torch.Tensor:
    """``fused_norm.group_norm_plain`` with a norm module's affine: the
    gate's per-op side."""
    return fused_norm.group_norm_plain(x, m.weight, m.bias, num_groups,
                                       act=act, layout=layout)


def _stamp(p: torch.Tensor) -> tuple:
    return (p.data_ptr(), 0 if p.is_inference() else p._version)


def _flatten(m: nn.LSTM) -> None:
    """``m``'s weights as views of one buffer in cuDNN's layout, on a card:
    ``flatten_parameters``' own call, which that method skips for bf16
    weights (its dtype check predates cuDNN's bf16 RNN), so that cuDNN
    does not copy them into a buffer of its own at every call."""
    first = m._flat_weights[0]
    if first.is_cuda and torch._use_cudnn_rnn_flatten_weight():
        from torch.backends.cudnn import rnn

        with torch.cuda.device_of(first), torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                m._flat_weights, 4, m.input_size, rnn.get_cudnn_mode("LSTM"),
                m.hidden_size, m.proj_size, m.num_layers, m.batch_first,
                m.bidirectional)


def _lstm_in(m: nn.LSTM, x: torch.Tensor) -> nn.LSTM:
    """The LSTM ``x`` runs through: ``m`` where its weights are in x's dtype
    and on its device, else a copy of them in one flattened buffer (cuDNN's
    layout), made on the first call and kept on ``m`` until its weights
    change.  Made outside inference mode and, in a captured program, by its
    warm-up runs, before the capture."""
    w = m._flat_weights
    if w[0].dtype == x.dtype and w[0].device == x.device:
        return m
    key = (x.dtype, x.device, tuple(_stamp(p) for p in w))
    kept = m.__dict__.get("_cast")
    if kept is None or kept[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            cast = nn.LSTM(m.input_size, m.hidden_size, batch_first=True,
                           bidirectional=True, device="meta", dtype=x.dtype
                           ).to_empty(device=x.device)
            for name, p in zip(m._flat_weights_names, w):
                getattr(cast, name).copy_(p)
            _flatten(cast)
            cast.requires_grad_(False)
        kept = (key, cast)
        m.__dict__["_cast"] = kept
    return kept[1]


def bilstm(m: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """(N, L, d) sequences -> (N, L, 2·hidden): forward and backward hidden
    states, concatenated."""
    return _lstm_in(m, x)(x)[0]


def conv_module(m: ConvolutionModule, x: torch.Tensor, norm: Norm1
                ) -> torch.Tensor:
    """(N, C, T) rows -> (N, C, T): the residual steps of the module."""
    for layer in m.layers:
        gn1, conv_a, _, dw, gn2, _, conv_b = layer
        pad = conv_a.weight.shape[-1] // 2
        h = F.glu(conv1d(conv_a, norm(gn1, x, 1), padding=pad), dim=1)
        h = F.conv1d(h, dw.weight.to(h.dtype), dw.bias.to(h.dtype),
                     padding=pad, groups=h.shape[1])
        x = x + conv1d(conv_b, norm(gn2, h, 1, act="silu"))
    return x


def sd_block(m: SDblock, x: torch.Tensor, cfg: Config, norm: Norm1 = group_norm
             ) -> Tuple[torch.Tensor, torch.Tensor, List[int], List[int]]:
    """(B, C_in, F, T) -> (output (B, C_out, F', T), skip, band lengths
    after the SD layer, band lengths before it)."""
    outs, lengths, origins = [], [], []
    for conv, cm, stride, kernel, (a, e) in zip(
            m.SDlayer.convs, m.conv_modules, cfg.band_stride, cfg.band_kernel,
            band_splits(x.shape[2], cfg.band_sr)):
        band = F.pad(x[:, :, a:e], (0, 0, *band_pad(e - a, stride, kernel)))
        y = conv2d(conv, band, stride=(stride, 1))
        b, c, rows, t = y.shape
        y = conv_module(cm, y.transpose(1, 2).reshape(b * rows, c, t), norm)
        outs.append(gelu(y).reshape(b, rows, c, t).transpose(1, 2))
        lengths.append(rows)
        origins.append(e - a)
    skip = torch.cat(outs, dim=2)
    return conv2d(m.globalconv, skip, padding=(1, 1)), skip, lengths, origins


def dual_path(m: DualPathRNN, x: torch.Tensor, norm: Norm1 = group_norm
              ) -> torch.Tensor:
    """One dual-path layer on channels-last ``(B, F, T, d)`` features: the
    frequency path (a sequence along F for each item and frame), then the
    time path (a sequence along T for each item and band row), each
    ``x += Linear(BiLSTM(GN1(x)))``.  Counted as ``dual_path``."""
    DUAL_PATH.launches += 1
    b, f, t, d = x.shape
    h = norm(m.norm_layers[0], x.reshape(b, f * t, d), 1, layout="tokens")
    h = h.reshape(b, f, t, d).transpose(1, 2).reshape(b * t, f, d)
    h = linear(m.linear_layers[0], bilstm(m.lstm_layers[0], h))
    x = x + h.reshape(b, t, f, d).transpose(1, 2)
    h = norm(m.norm_layers[1], x.reshape(b, f * t, d), 1, layout="tokens")
    h = linear(m.linear_layers[1], bilstm(m.lstm_layers[1],
                                          h.reshape(b * f, t, d)))
    return x + h.reshape(b, f, t, d)



def feature_conversion(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Between dual-path layers, on ``(B, F, T, C)`` in f32: ``rfft`` along
    T (orthonormal) with real and imaginary parts concatenated on the
    channels, or (``inverse``) the channel halves as one complex tensor
    through ``irfft``; rounded to x's dtype."""
    xf = x.float()
    if inverse:
        c = x.shape[-1] // 2
        y = torch.fft.irfft(torch.complex(xf[..., :c], xf[..., c:]), dim=2,
                            norm="ortho")
    else:
        z = torch.fft.rfft(xf, dim=2, norm="ortho")
        y = torch.cat([z.real, z.imag], dim=-1)
    return y.to(x.dtype)


def separation_net(m: SeparationNet, x: torch.Tensor, norm: Norm1 = group_norm
                   ) -> torch.Tensor:
    """(B, C, F, T) -> (B, C, F, T) through the dual-path layers, each
    followed by the FFT along T or its inverse, in turn."""
    x = x.permute(0, 2, 3, 1).contiguous()
    for i, dp in enumerate(m.dp_modules):
        x = feature_conversion(dual_path(dp, x, norm), inverse=i % 2 == 1)
    return x.permute(0, 3, 1, 2).contiguous()


def fusion(m: FusionLayer, x: torch.Tensor, skip: torch.Tensor
           ) -> torch.Tensor:
    """``GLU_ch(conv(repeat(x + skip, 2)))``, the repeat folded into the
    convolution's weights."""
    w = m.conv.weight
    c = w.shape[1] // 2
    y = F.conv2d(x + skip, (w[:, :c] + w[:, c:]).to(x.dtype),
                 m.conv.bias.to(x.dtype), padding=1)
    return F.glu(y, dim=1)


def conv_transpose_rows(m: ConvTranspose2d, x: torch.Tensor, stride: int
                       ) -> torch.Tensor:
    """``ConvTranspose2d`` with a ``(k, 1)`` kernel at stride ``(s, 1)`` on
    (B, C, F, T), as ops cuDNN runs fast with its deterministic algorithms
    (the serving programs run under ``cudnn.deterministic``, where its
    transposed convolution took ~0.36 s of a songs group's ~0.45 s on an
    H100): at ``s = k`` the output rows do not overlap, one product
    (each input row gives k output rows); at ``s = 1`` the convolution
    with the kernel flipped along F and k - 1 rows of zeros each side
    (``Config`` allows no other stride)."""
    w = m.weight.to(x.dtype)                                  # (C, O, k, 1)
    c, o, k, _ = w.shape
    bias = m.bias.to(x.dtype)
    if stride == k:
        b, _, f, t = x.shape
        y = F.linear(x.permute(0, 2, 3, 1), w.reshape(c, o * k).t(),
                     bias.repeat_interleave(k))               # (B, F, T, O·k)
        return y.view(b, f, t, o, k).permute(0, 3, 1, 4, 2).reshape(
            b, o, f * k, t)
    return F.conv2d(x, w.flip(2).transpose(0, 1), bias, padding=(k - 1, 0))


def su_layer(m: SUlayer, x: torch.Tensor, lengths: Sequence[int],
             origins: Sequence[int], cfg: Config) -> torch.Tensor:
    """A transposed convolution a band, each trimmed symmetrically to the
    band's length before its SD layer, concatenated along F."""
    outs, a = [], 0
    for convtr, n, orig, stride in zip(m.convtrs, lengths, origins,
                                       cfg.band_stride):
        y = conv_transpose_rows(convtr, x[:, :, a:a + n], stride)
        a += n
        dist = abs(orig - y.shape[2]) // 2
        outs.append(y[:, :, dist:dist + orig])
    return torch.cat(outs, dim=2)


def _forward(model: SCNet, wav: torch.Tensor, compute_dtype: torch.dtype
             ) -> torch.Tensor:
    cfg = model.cfg
    b, c, length = wav.shape
    pad = right_pad(length, cfg.hop)
    z = dsp.stft(F.pad(wav.float(), (0, pad)).reshape(b * c, -1), cfg.nfft,
                 cfg.hop, normalized=True, window="rect")
    rows, t = z.shape[-2:]
    x = torch.view_as_real(z).permute(0, 3, 1, 2).reshape(b, 2 * c, rows, t)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = x.std(dim=(1, 2, 3), keepdim=True)
    x = ((x - mean) / (STD_EPS + std)).to(compute_dtype)
    saved = []
    for block in model.encoder:
        x, *kept = sd_block(block, x, cfg)
        saved.append(kept)
    x = separation_net(model.separation_net, x)
    for (fuse, su), (skip, lengths, origins) in zip(model.decoder,
                                                    reversed(saved)):
        x = su_layer(su, fusion(fuse, x, skip), lengths, origins, cfg)
    # channel s·4 + ch·2 + (re, im) of the last SU layer: source s, channel ch
    x = x.float() * std + mean
    n = len(cfg.sources)
    spec = torch.view_as_complex(
        x.reshape(b * n * c, 2, rows, t).permute(0, 2, 3, 1).contiguous())
    y = dsp.istft(spec, cfg.hop * (t - 1), cfg.nfft, cfg.hop,
                  normalized=True, window="rect")
    return y.reshape(b, n, c, -1)[..., :length]


def forward(model: SCNet, wav: torch.Tensor,
            compute_dtype: torch.dtype = torch.float32,
            kernels: Kernels = True) -> torch.Tensor:
    """``(B, 2, L)`` chunks -> ``(B, sources, 2, L)`` f32 (see the module
    notes).  ``kernels`` chooses nothing: no kernel of the selection takes
    a part of SCNet, and GroupNorm follows the device."""
    capturing = wav.device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()
    with profiling.OFF if capturing else profiling.span("atsm.model.scnet"):
        return _forward(model, wav, compute_dtype)
