"""BS-RoFormer: band-split RoPE transformer for music source separation.

Lu, Wang, Kong, Hung, "Music Source Separation with Band-Split RoPE
Transformer" (arXiv:2309.02612), as lucidrains' ``BS-RoFormer``
(``bs_roformer.py``, ``BSRoformer``) builds it: the parameters carry that
module's ``state_dict`` names and layouts (Linear ``(out, in)``), with
``linear_transformer_depth`` 0, dropout off and the later options
(``zero_dc``, skip connections) left off.  ``PUBLISHED`` holds the widths
of the public vocal model (``ZFTurbo/Music-Source-Separation-Training``,
``configs/viperx/model_bs_roformer_ep_317_sdr_12.9755.yaml``), ``TINY`` a
test size.

The forward of a ``(B, 2, T)`` chunk batch:

1. the STFT of each channel (n_fft 2048, hop 441, periodic Hann, centred,
   unnormalised, f32); a frame's features ordered (bin, channel, re/im);
2. the band split: band ``b`` takes its ``4·f_b`` features through
   ``RMSNorm`` and ``Linear(4·f_b -> dim)``: a ``(B, frames, bands, dim)``
   grid;
3. ``depth`` layers, each a transformer over time (every band a sequence
   of frames) and one over bands (every frame a sequence of bands).  A
   transformer is one pre-norm block: ``x += W_o·concat_h(σ(h·W_g + b_g)_h
   · softmax(rope(q_h) rope(k_h)ᵀ / √dh) v_h)`` with ``h = RMSNorm(x)``,
   ``q, k, v = h·W_qkv``; then ``x += W_2·GELU(W_1·RMSNorm(x) + b_1) +
   b_2``;
4. a final ``RMSNorm``;
5. a mask estimator per stem and band: ``GLU(W_2·tanh(W_1·h_b + c_1) +
   c_2)``;
6. the complex mask times the STFT, and the inverse STFT at the chunk's
   length -> ``(B, stems, 2, T)`` f32.

Precision: products take ``compute_dtype`` operands (bf16 on the card)
with f32 sums; the RMSNorm statistics, RoPE, softmax, the STFT, the mask
product and the inverse STFT run in f32.  Where the kernel selection has
``layer`` or ``attn`` on, RoPE and the split of the packed projection run
in ``ops.fused_rope.rope_qkv`` (else in its plain version), and both axes'
attention in ``ops.fused_attn.attn_gated`` (the flash launch of
``csrc/attn_common.cuh`` with the gate, then the out-projection GEMM with
the residual; else its plain version).  A norm's gamma is folded into
the weights of the products that read its output (``W·diag(γ)``, formed
in f32, then rounded), so a norm on the token grid is one launch.  The
bands of one width run as one batched product in the band split and in
the mask estimator.

Span ``atsm.model.bs_roformer`` on an eager ``forward`` (none while a CUDA
graph captures it).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import prng
from ..nn.core import Linear, RMSNorm, gelu, rms_normalize, rms_scale, split
from ..ops import dsp, fused_attn, fused_rope, kernel_gate
from ..ops.select import Kernels, resolve
from ..utils import profiling
from .stem_serving import StemServing

# the vocal model's bands: 62 bands over the 1025 bins of n_fft 2048
VOCAL_BANDS = ((2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8
               + (128, 129))
# fixed in every configuration the port runs: stereo (each bin's features
# are 2 channels x re/im), feed-forward 4x, mask MLPs of depth 2 with a
# hidden 4x wide
FEATURES_PER_BIN = 4
FF_MULT = 4
MLP_EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class Config:
    dim: int = 512
    depth: int = 12
    heads: int = 8
    dim_head: int = 64
    stems: Tuple[str, ...] = ("vocals",)
    freqs_per_bands: Tuple[int, ...] = VOCAL_BANDS
    n_fft: int = 2048
    hop: int = 441

    def __post_init__(self):
        if sum(self.freqs_per_bands) != self.n_fft // 2 + 1:
            raise ValueError(f"bands cover {sum(self.freqs_per_bands)} bins; "
                             f"n_fft {self.n_fft} has {self.n_fft // 2 + 1}")


PUBLISHED = Config()
# 2 layers, 2 heads of 64, n_fft 256 (129 bins) in 8 ragged bands with a
# 1-bin and odd-width ones
TINY = Config(dim=128, depth=2, heads=2, n_fft=256, hop=60,
              freqs_per_bands=(1, 2, 3, 5, 8, 13, 32, 65))


def _band_runs(widths: Sequence[int]) -> List[Tuple[int, int, int]]:
    """``(first band, band count, width)`` of each run of equal widths."""
    runs, i = [], 0
    for w, group in itertools.groupby(widths):
        n = len(list(group))
        runs.append((i, n, w))
        i += n
    return runs


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, key=None):
        super().__init__()
        k1, k2, k3 = split(key, 3)
        inner = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = Linear(dim, 3 * inner, k1, bias=False)
        self.to_gates = Linear(dim, heads, k2)
        self.to_out = nn.Sequential(Linear(inner, dim, k3, bias=False))


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner: int, key=None):
        super().__init__()
        k1, k2 = split(key)
        # lucidrains' Sequential: norm, linear, GELU, dropout, linear
        self.net = nn.Sequential(RMSNorm(dim), Linear(dim, inner, k1),
                                 nn.GELU(), nn.Identity(),
                                 Linear(inner, dim, k2))


class Transformer(nn.Module):
    """One pre-norm block (``depth`` 1 a transformer, as the model has)."""

    def __init__(self, cfg: Config, key=None):
        super().__init__()
        k1, k2 = split(key)
        self.layers = nn.ModuleList([nn.ModuleList([
            Attention(cfg.dim, cfg.heads, cfg.dim_head, k1),
            FeedForward(cfg.dim, cfg.dim * FF_MULT, k2)])])


class BandSplit(nn.Module):
    def __init__(self, cfg: Config, key=None):
        super().__init__()
        keys = split(key, len(cfg.freqs_per_bands))
        c = FEATURES_PER_BIN
        self.to_features = nn.ModuleList([
            nn.Sequential(RMSNorm(c * f), Linear(c * f, cfg.dim, k))
            for f, k in zip(cfg.freqs_per_bands, keys)])


class MaskEstimator(nn.Module):
    def __init__(self, cfg: Config, key=None):
        super().__init__()
        keys = split(key, len(cfg.freqs_per_bands))
        hidden = cfg.dim * MLP_EXPANSION
        self.to_freqs = nn.ModuleList()
        for f, k in zip(cfg.freqs_per_bands, keys):
            k1, k2 = split(k)
            # lucidrains' MLP (linear, tanh, linear), then a GLU
            mlp = nn.Sequential(
                Linear(cfg.dim, hidden, k1), nn.Tanh(),
                Linear(hidden, 2 * FEATURES_PER_BIN * f, k2))
            self.to_freqs.append(nn.Sequential(mlp, nn.GLU(dim=-1)))


class BSRoformer(nn.Module):
    def __init__(self, cfg: Config = PUBLISHED, key=None):
        super().__init__()
        self.cfg = cfg
        keys = split(key, 2 * cfg.depth + 1 + len(cfg.stems))
        self.band_split = BandSplit(cfg, keys[0])
        self.layers = nn.ModuleList([
            nn.ModuleList([Transformer(cfg, keys[1 + 2 * i]),
                           Transformer(cfg, keys[2 + 2 * i])])
            for i in range(cfg.depth)])
        self.final_norm = RMSNorm(cfg.dim)
        self.mask_estimators = nn.ModuleList([
            MaskEstimator(cfg, k) for k in keys[1 + 2 * cfg.depth:]])
        self.requires_grad_(False)

    @property
    def stems(self) -> Tuple[str, ...]:
        return self.cfg.stems

    def serving(self, tokenizer=None, normalize_text: bool = False):
        """What an ``infer.Separator`` serves this model through."""
        return Serving(self, tokenizer)

    def gate_pair(self, compute_dtype: torch.dtype):
        """The kernel parity gate's ``(forward, args)``: layer 0 (each kernel
        launch of a layer) over a 6 s chunk's seeded unit-rms tokens; a
        tenth of its unit-order output, the scale the threshold was set on."""
        cfg = self.cfg
        frames = int(kernel_gate.GATE_SECONDS * kernel_gate.SAMPLE_RATE
                     ) // cfg.hop + 1
        x = np.random.default_rng(0).standard_normal(
            (1, frames, len(cfg.freqs_per_bands), cfg.dim)).astype(np.float32)

        def fwd(sel, m, tokens):
            return 0.1 * axial_layer(m, 0, tokens, _uses_kernel(resolve(sel))
                                     ).float()

        return fwd, (self, torch.from_numpy(x).to(
            next(self.parameters()).device, compute_dtype))


class Serving(StemServing):
    """A ``BSRoformer`` behind an ``infer.Separator``: its own stem names, no
    text prompts, whole songs on one device (``stem_serving``)."""

    name = "BS-RoFormer"

    def separate(self, model, chunks, compute_dtype, kernels) -> torch.Tensor:
        return forward(model, chunks, compute_dtype, kernels)


def init(cfg: Config = PUBLISHED, seed: int = 0, materialize: bool = True,
         device: str | torch.device = "cpu") -> BSRoformer:
    """The model with every Linear drawn U(±1/√fan_in) from the threefry
    key of ``seed`` on ``device`` and every RMSNorm's gamma 1;
    ``materialize=False`` leaves the storage uninitialised, for a model that
    is about to be loaded."""
    key = prng.PRNGKey(seed, device) if materialize else None
    model = BSRoformer(cfg, key)
    return model.to(device) if materialize else model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _uses_kernel(sel) -> bool:
    return sel.layer or sel.attn


def _folded(w: torch.Tensor, gamma: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    """``W·diag(γ)`` in ``dtype``: the weight of a product whose input is
    the normed ``x / rms(x)``, with the norm's gamma taken in."""
    return (w * gamma).to(dtype)


def attention(m: Attention, x: torch.Tensor, cfg: Config, kernel: bool
              ) -> torch.Tensor:
    """``x + W_o·concat_h(σ(h·W_g + b_g)_h · attention_h)``, ``h =
    RMSNorm(x)``, RoPE on q and k; x ``(B, L, dim)`` in the compute dtype."""
    dt = x.dtype
    h = rms_normalize(x)
    qkv = F.linear(h, _folded(m.to_qkv.weight, m.norm.gamma, dt))
    split_qkv = fused_rope.rope_qkv if kernel else fused_rope.rope_qkv_plain
    q, k, v = split_qkv(qkv, cfg.heads)
    gate = F.linear(h, _folded(m.to_gates.weight, m.norm.gamma, dt),
                    m.to_gates.bias.to(dt))
    wo = m.to_out[0].weight.to(dt).contiguous()
    fn = fused_attn.attn_gated if kernel else fused_attn.attn_gated_plain
    return fn(q, k, v, gate.contiguous(), x.contiguous(), wo, cfg.heads)


def feed_forward(m: FeedForward, x: torch.Tensor) -> torch.Tensor:
    """``x + W_2·GELU(W_1·RMSNorm(x) + b_1) + b_2``."""
    norm, ff1, ff2 = m.net[0], m.net[1], m.net[4]
    dt = x.dtype
    u = gelu(F.linear(rms_normalize(x), _folded(ff1.weight, norm.gamma, dt),
                      ff1.bias.to(dt)))
    return x + F.linear(u, ff2.weight.to(dt), ff2.bias.to(dt))


def transformer(m: Transformer, x: torch.Tensor, cfg: Config, kernel: bool
                ) -> torch.Tensor:
    for attn, ff in m.layers:
        x = feed_forward(ff, attention(attn, x, cfg, kernel))
    return x


def axial_layer(model: BSRoformer, i: int, x: torch.Tensor, kernel: bool
                ) -> torch.Tensor:
    """Layer ``i``: the time transformer over each band's frames, then the
    band transformer over each frame's bands; x ``(B, frames, bands,
    dim)``."""
    b, t, nb, d = x.shape
    time_t, band_t = model.layers[i]
    x = x.transpose(1, 2).reshape(b * nb, t, d)
    x = transformer(time_t, x, model.cfg, kernel)
    x = x.reshape(b, nb, t, d).transpose(1, 2).reshape(b * t, nb, d)
    return transformer(band_t, x, model.cfg, kernel).reshape(b, t, nb, d)


def band_split(m: BandSplit, feats: torch.Tensor, cfg: Config,
               dtype: torch.dtype) -> torch.Tensor:
    """``(B, T, Σ 4·f_b)`` f32 features -> ``(B, T, bands, dim)`` in
    ``dtype``: each run of equal-width bands as one batched product."""
    b, t, _ = feats.shape
    c = FEATURES_PER_BIN
    outs, col = [], 0
    for i0, n, f in _band_runs(cfg.freqs_per_bands):
        mods = m.to_features[i0:i0 + n]
        xb = feats[..., col:col + n * c * f].reshape(b * t, n, c * f)
        col += n * c * f
        gamma = torch.stack([s[0].gamma for s in mods])
        h = rms_scale(xb, gamma, dtype).transpose(0, 1)          # (n, BT, cf)
        w = torch.stack([s[1].weight for s in mods]).to(dtype)
        bias = torch.stack([s[1].bias for s in mods]).to(dtype)
        outs.append(torch.baddbmm(bias[:, None, :], h, w.transpose(1, 2)))
    return torch.cat(outs).reshape(-1, b, t, cfg.dim).permute(1, 2, 0, 3)


def mask_estimator(m: MaskEstimator, x: torch.Tensor, cfg: Config,
                   gamma: torch.Tensor) -> torch.Tensor:
    """``(B, T, bands, dim)`` -> ``(B, T, Σ 4·f_b)`` mask features in x's
    dtype: each run of equal-width bands as one batched MLP.  ``gamma``
    (dim,) scales x on its way in (folded into the first product's
    weights: the final norm's)."""
    b, t, nb, d = x.shape
    outs = []
    xt = x.permute(2, 0, 1, 3).reshape(nb, b * t, d)
    for i0, n, f in _band_runs(cfg.freqs_per_bands):
        mlps = [seq[0] for seq in m.to_freqs[i0:i0 + n]]

        def layer(j, h):
            w = torch.stack([mlp[j].weight for mlp in mlps])
            if j == 0:
                w = w * gamma
            bias = torch.stack([mlp[j].bias for mlp in mlps]).to(x.dtype)
            return torch.baddbmm(bias[:, None, :], h,
                                 w.to(x.dtype).transpose(1, 2))

        h = layer(2, torch.tanh(layer(0, xt[i0:i0 + n])))
        h = F.glu(h, dim=-1)                                     # (n, BT, cf)
        outs.append(h.transpose(0, 1).reshape(b, t, -1))
    return torch.cat(outs, dim=-1)


def _forward(model: BSRoformer, wav: torch.Tensor, compute_dtype: torch.dtype,
             kernels: Kernels) -> torch.Tensor:
    cfg = model.cfg
    kernel = _uses_kernel(resolve(kernels))
    b, c, length = wav.shape
    z = dsp.stft(wav.float().reshape(b * c, length), cfg.n_fft, cfg.hop,
                 normalized=False)
    nf, t = z.shape[-2:]
    z = z.reshape(b, c, nf, t)
    # (B, T, F, C, re/im): bin-major, channel, then real and imaginary
    feats = torch.view_as_real(z).permute(0, 3, 2, 1, 4).reshape(b, t, -1)
    x = band_split(model.band_split, feats, cfg, compute_dtype)
    for i in range(cfg.depth):
        x = axial_layer(model, i, x, kernel)
    x = rms_normalize(x)
    masks = torch.stack([mask_estimator(me, x, cfg, model.final_norm.gamma)
                         for me in model.mask_estimators], dim=1)
    n = masks.shape[1]
    mask = torch.view_as_complex(
        masks.float().reshape(b, n, t, nf, c, 2)).permute(0, 1, 4, 3, 2)
    y = dsp.istft((z[:, None] * mask).reshape(b * n * c, nf, t), length,
                  cfg.n_fft, cfg.hop, normalized=False)
    return y.reshape(b, n, c, length)


def forward(model: BSRoformer, wav: torch.Tensor,
            compute_dtype: torch.dtype = torch.float32,
            kernels: Kernels = True) -> torch.Tensor:
    """``(B, 2, T)`` chunks -> ``(B, stems, 2, T)`` f32 (see the module
    notes)."""
    capturing = wav.device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()
    with profiling.OFF if capturing else profiling.span(
            "atsm.model.bs_roformer"):
        return _forward(model, wav, compute_dtype, kernels)
