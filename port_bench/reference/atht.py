"""AudioTextHTDemucs (savage-hacker14/audio-to-sheet-music, ``ATHTDemucs_v2``)
in plain PyTorch: the frozen HTDemucs encoder and transformer, the CLAP
text embedding, and the trained head: a text cross-attention, a frequency
and a time decoder (transposed convs 384-192-96-48-4, GroupNorm, GELU,
0.1-scaled skips resized to each level), 1x1 output convs, a sigmoid mask
on the CaC planes with the mixture's phase, the iSTFT, and the time branch.

The source model's quirks are part of its definition and kept: the
frequency decoder resizes its frequency axis to the encoder's recorded
*time* lengths; the mask multiplies the first two CaC planes (the left
channel's real and imaginary parts) and the phase divides by that signed
plane + 1e-8; the cross-attention attends to one text token, so its
softmax is 1 and the attention is ``out_proj(in_proj_v(v_proj(text)))``
broadcast over the queries (written so: the query and key projections do
not change the result)."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import dsp, htdemucs
from .layers import (F32, Params, Prec, conv1d, conv2d, conv_tr1d, conv_tr2d,
                     count_prefixed, gelu, group_norm1, layer_norm, lin, resize,
                     sub)

SKIP_SCALE = 0.1


def _text_attend(p: Params, q: torch.Tensor, emb: torch.Tensor, prec: Prec
                 ) -> torch.Tensor:
    """q (B, L, C), emb (B, 512) -> (B, L, C)."""
    a = "head.text_attn"
    e = q.shape[-1]
    v = lin(p, a + ".v_proj", emb, prec)
    w, b = p[a + ".attn.in_proj_weight"], p[a + ".attn.in_proj_bias"]
    v = prec.q(v) @ prec.q(w[2 * e:]).T + b[2 * e:]
    out = q + lin(p, a + ".attn.out_proj", v, prec)[:, None, :]
    out = out + lin(p, a + ".out_mlp.2",
                    gelu(lin(p, a + ".out_mlp.0", out, prec)), prec)
    return layer_norm(p, a + ".norm_out", out)


def _skip_add(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """x (S*B, ...) + 0.1 * skip (B, ...), the skip shared by the stems."""
    b0 = skip.shape[0]
    xr = x.reshape(x.shape[0] // b0, b0, *x.shape[1:])
    return (xr + SKIP_SCALE * skip[None]).reshape(x.shape)


def _decoder(p: Params, name: str, x: torch.Tensor, skips: List[torch.Tensor],
             lengths: List[int], freq: bool, prec: Prec) -> torch.Tensor:
    n = count_prefixed(p, name + ".layers")
    for i in range(n):
        ln = f"{name}.layers.{i}"
        if freq:
            x = conv_tr2d(p, ln + ".conv", x, (4, 1), (2, 0), prec)
        else:
            x = conv_tr1d(p, ln + ".conv", x, 4, 2, prec)
        if i < n - 1:
            x = gelu(group_norm1(p, ln + ".norm", x))
        if i < len(lengths) and x.shape[2] != lengths[i]:
            x = resize(x, lengths[i], 2)
        if i < len(skips):
            skip = skips[i][:, :x.shape[1]]
            skip = resize(skip, x.shape[2], 2)
            if freq:
                skip = resize(skip, x.shape[3], 3)
            x = _skip_add(x, skip)
    return x


def encode(p: Params, chunks: torch.Tensor, cfg: Dict, prec: Prec = F32
           ) -> Dict:
    """(n, 2, seg) -> the normalised front end and the encoder's state."""
    nrm = htdemucs.normalize(chunks.float(), cfg["nfft"], cfg["hop"])
    enc = htdemucs.encode(sub(p, "htdemucs"), nrm["x"], nrm["xt"],
                          cfg["transformer_heads"], prec)
    return {**nrm, **enc, "length": chunks.shape[-1]}


def head_rows(p: Params, e: Dict, emb: torch.Tensor, cfg: Dict,
              prec: Prec = F32) -> torch.Tensor:
    """The head over one encoder state of B chunks with ``emb (k*B, 512)``,
    row ``j*B + i`` conditioning chunk ``i`` (the encoder state is shared by
    the ``k`` embeddings) -> (k, B, 2, seg) float32."""
    b = e["x"].shape[0]
    s = emb.shape[0] // b
    x, xt = e["x"].repeat(s, 1, 1, 1), e["xt"].repeat(s, 1, 1)
    bb, c, f, t = x.shape
    xs = _text_attend(p, x.reshape(bb, c, f * t).transpose(1, 2), emb, prec)
    x = xs.transpose(1, 2).reshape(bb, c, f, t)
    xt = _text_attend(p, xt.transpose(1, 2), emb, prec).transpose(1, 2)
    fq, tspec = e["mag"].shape[-2:]
    x = _decoder(p, "head.freq_decoder", x, e["saved"][::-1],
                 e["lengths"][::-1], True, prec)
    x = conv2d(p, "head.freq_out", x, prec=prec)
    x = resize(resize(x, fq, 2), tspec, 3)
    mask = torch.sigmoid(x).reshape(s, b, 2, fq, tspec)
    mag = e["mag"][:, :2][None]
    z = e["z"][:, :2][None]
    masked = mag * mask * (z / (mag + 1e-8))
    length = e["length"]
    wav = dsp.ispec(masked, length, cfg["nfft"], cfg["hop"])
    xt = _decoder(p, "head.time_decoder", xt, e["saved_t"][::-1],
                  e["lengths_t"][::-1], False, prec)
    xt = conv1d(p, "head.time_out", xt, prec=prec)
    xt = resize(xt, length, 2).reshape(s, b, 2, length)
    return wav + xt * e["stdt"][None] + e["meant"][None]


def heads(p: Params, e: Dict, embs: torch.Tensor, cfg: Dict, prec: Prec = F32
          ) -> torch.Tensor:
    """The head for S stems, ``embs (S, 512)``, over one encoder state of B
    chunks -> (S, B, 2, seg)."""
    return head_rows(p, e, embs.repeat_interleave(e["x"].shape[0], dim=0),
                     cfg, prec)


def forward(p: Params, chunks: torch.Tensor, embs: torch.Tensor, cfg: Dict,
            prec: Prec = F32) -> torch.Tensor:
    """(B, 2, seg) chunks and (S, 512) stem embeddings -> (S, B, 2, seg)."""
    return heads(p, encode(p, chunks, cfg, prec), embs, cfg, prec)
