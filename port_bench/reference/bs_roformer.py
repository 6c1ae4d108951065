"""BS-RoFormer in plain PyTorch, float32: the benchmark's reference.

lucidrains' ``BS-RoFormer`` (``bs_roformer.py``, ``BSRoformer.forward``;
arXiv:2309.02612) at inference, written again from its equations: the
STFT of each channel (``torch.stft``, periodic Hann, centred with reflect
padding, unnormalised), each frame's features ordered (bin, channel,
re/im), the band split (``RMSNorm`` and a Linear a band), ``depth`` layers
of a time transformer and a band transformer (pre-norm attention with
RoPE on q and k and a sigmoid gate per head, then a GELU feed-forward),
a final ``RMSNorm``, a tanh MLP with a GLU per band and stem for the mask,
the complex product and ``torch.istft`` at the chunk's length.

Parameters come as a flat ``{name: tensor}`` dict under the program's
names, which are lucidrains' ``state_dict`` names; ``cfg`` holds the
configuration's keys (``dim``, ``depth``, ``heads``, ``dim_head``,
``freqs_per_bands``, ``num_stems``, ``mask_estimator_depth``,
``stft_n_fft``, ``stft_hop_length``).  ``Prec`` (``layers``) rounds every
product's operands, so the fp8 control exists; the norms, RoPE, the
softmax and the DSP stay f32.  It imports neither the program nor JAX.

Departures from lucidrains' forward, each a choice of the configuration:
``linear_transformer_depth`` 0 (no linear-attention layers), dropout off,
no ``zero_dc``, no skip connections, no training loss; attention as an
explicit softmax in place of ``F.scaled_dot_product_attention`` (the same
function); the rotary frequencies computed here (lucidrains holds them as
a parameter of ``rotary_embedding_torch``, fixed at these values).  Songs
are cut by ``protocols.separate`` (the program's ``min(fade_in,
fade_out)`` triangle and weighted overlap-add), not by ZFTurbo's
``demix`` with its chunk/10 fades.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import protocols
from .layers import F32, Params, Prec, attention, gelu, glu

THETA = 10000.0


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """lucidrains' ``RMSNorm``: ``F.normalize(x) · √d · γ``."""
    return F.normalize(x, dim=-1) * math.sqrt(x.shape[-1]) * gamma


def rotate(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``rotary_embedding_torch``'s ``rotate_queries_or_keys`` on (B, L,
    heads·dh), positions 0..L-1: each head's dimensions in interleaved pairs,
    ``t·cos + rotate_half(t)·sin`` with the angles repeated pairwise."""
    b, length, e = t.shape
    dh = e // heads
    freqs = 1.0 / (THETA ** (torch.arange(0, dh, 2, device=t.device).float()
                             / dh))
    ang = torch.arange(length, device=t.device).float()[:, None] * freqs
    ang = ang.repeat_interleave(2, dim=-1)                  # (L, dh)
    th = t.reshape(b, length, heads, dh)
    pairs = th.reshape(b, length, heads, dh // 2, 2)
    half = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).reshape(
        b, length, heads, dh)
    out = th * ang.cos()[:, None, :] + half * ang.sin()[:, None, :]
    return out.reshape(b, length, e)


def attend(p: Params, pre: str, x: torch.Tensor, heads: int, prec: Prec
           ) -> torch.Tensor:
    """lucidrains' ``Attention`` with its residual: x + to_out(gated heads)."""
    b, length, _ = x.shape
    h = rms_norm(x, p[pre + "norm.gamma"])
    q, k, v = F.linear(prec.q(h), prec.q(p[pre + "to_qkv.weight"])).chunk(
        3, dim=-1)
    out = attention(rotate(q, heads), rotate(k, heads), v, heads, prec=prec)
    gates = F.linear(prec.q(h), prec.q(p[pre + "to_gates.weight"]),
                     p[pre + "to_gates.bias"])
    out = (out.reshape(b, length, heads, -1)
           * torch.sigmoid(gates)[..., None]).reshape(b, length, -1)
    return x + F.linear(prec.q(out), prec.q(p[pre + "to_out.0.weight"]))


def feed_forward(p: Params, pre: str, x: torch.Tensor, prec: Prec
                 ) -> torch.Tensor:
    """lucidrains' ``FeedForward`` with its residual."""
    h = rms_norm(x, p[pre + "net.0.gamma"])
    u = gelu(F.linear(prec.q(h), prec.q(p[pre + "net.1.weight"]),
                      p[pre + "net.1.bias"]))
    return x + F.linear(prec.q(u), prec.q(p[pre + "net.4.weight"]),
                        p[pre + "net.4.bias"])


def transformer(p: Params, pre: str, x: torch.Tensor, heads: int,
                prec: Prec) -> torch.Tensor:
    x = attend(p, pre + "layers.0.0.", x, heads, prec)
    return feed_forward(p, pre + "layers.0.1.", x, prec)


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, device=device)


def features(wav: torch.Tensor, cfg: Dict) -> tuple:
    """(B, C, T) -> (complex STFT (B, C, F, frames), features (B, frames,
    F·C·2) in the order (bin, channel, re/im): 'b s f t c -> b t (f s
    c)')."""
    b, c, length = wav.shape
    n_fft, hop = cfg["stft_n_fft"], cfg["stft_hop_length"]
    z = torch.stft(wav.reshape(b * c, length).float(), n_fft, hop,
                   win_length=n_fft, window=_window(n_fft, wav.device),
                   center=True, pad_mode="reflect", normalized=False,
                   return_complex=True)
    z = z.reshape(b, c, *z.shape[-2:])
    return z, torch.view_as_real(z).permute(0, 3, 2, 1, 4).reshape(
        b, z.shape[-1], -1)


def band_split(p: Params, feats: torch.Tensor, cfg: Dict, prec: Prec = F32
               ) -> torch.Tensor:
    """(B, T, Σ 2·C·f_b) -> (B, T, bands, dim): RMSNorm and a Linear a
    band."""
    c = 2 * (feats.shape[-1] // (2 * sum(cfg["freqs_per_bands"])))
    tokens, col = [], 0
    for i, f in enumerate(cfg["freqs_per_bands"]):
        pre = f"band_split.to_features.{i}."
        xb = rms_norm(feats[..., col:col + c * f], p[pre + "0.gamma"])
        tokens.append(F.linear(prec.q(xb), prec.q(p[pre + "1.weight"]),
                               p[pre + "1.bias"]))
        col += c * f
    return torch.stack(tokens, dim=-2)


def mask_features(p: Params, x: torch.Tensor, cfg: Dict, prec: Prec = F32
                  ) -> torch.Tensor:
    """(B, T, bands, dim) -> (B, stems, T, Σ 2·C·f_b): per stem and band
    ``GLU(MLP(x_b))``, the MLP's hidden layers tanh."""
    depth = cfg["mask_estimator_depth"]
    masks = []
    for s in range(cfg["num_stems"]):
        outs = []
        for i in range(x.shape[2]):
            h = x[:, :, i]
            pre = f"mask_estimators.{s}.to_freqs.{i}.0."
            for j in range(depth):
                h = F.linear(prec.q(h), prec.q(p[pre + f"{2 * j}.weight"]),
                             p[pre + f"{2 * j}.bias"])
                if j < depth - 1:
                    h = torch.tanh(h)
            outs.append(glu(h, dim=-1))
        masks.append(torch.cat(outs, dim=-1))
    return torch.stack(masks, dim=1)


def forward(p: Params, wav: torch.Tensor, cfg: Dict, prec: Prec = F32
            ) -> torch.Tensor:
    """(B, 2, T) chunks -> (B, stems, 2, T)."""
    b, c, length = wav.shape
    n_fft, hop, heads = cfg["stft_n_fft"], cfg["stft_hop_length"], cfg["heads"]
    z, feats = features(wav, cfg)
    nf, t = z.shape[-2:]
    x = band_split(p, feats, cfg, prec)                # (B, T, bands, dim)
    nb, d = x.shape[2], cfg["dim"]
    for i in range(cfg["depth"]):
        x = x.transpose(1, 2).reshape(b * nb, t, d)
        x = transformer(p, f"layers.{i}.0.", x, heads, prec)
        x = x.reshape(b, nb, t, d).transpose(1, 2).reshape(b * t, nb, d)
        x = transformer(p, f"layers.{i}.1.", x, heads, prec)
        x = x.reshape(b, t, nb, d)
    masks = mask_features(p, rms_norm(x, p["final_norm.gamma"]), cfg, prec)
    n = masks.shape[1]
    mask = torch.view_as_complex(masks.reshape(b, n, t, nf, c, 2)
                                 .contiguous()).permute(0, 1, 4, 3, 2)
    y = torch.istft((z[:, None] * mask).reshape(b * n * c, nf, t), n_fft, hop,
                    win_length=n_fft, window=_window(n_fft, wav.device),
                    center=True, normalized=False, length=length)
    return y.reshape(b, n, c, length)


def stems(p: Params, cfg: Dict, song: torch.Tensor, segment: int,
          overlap: int, prec: Prec = F32, block: int = 4) -> torch.Tensor:
    """A float (2, T) song -> (stems, 2, T) through ``protocols.separate``
    in blocks of ``block`` chunks."""
    def fwd(chunks):
        out = forward(p, chunks, cfg, prec)
        return out.reshape(chunks.shape[0], -1, out.shape[-1])

    with torch.no_grad():
        flat = protocols.separate(fwd, song.float(), segment, overlap, block)
    return flat.reshape(-1, 2, flat.shape[-1])
