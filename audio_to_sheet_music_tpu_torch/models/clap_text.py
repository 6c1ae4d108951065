"""CLAP text tower (RoBERTa encoder + projection) in PyTorch.

Counterpart of ``audio_to_sheet_music_tpu/models/clap_text.py``
(``laion/clap-htsat-unfused``'s text side): word (50265, 768, pad 1) +
RoBERTa-offset positions (514) + token type embeddings, LayerNorm eps 1e-12;
12 post-LN layers (768 wide, 12 heads, FF 3072, exact GELU); tanh pooler on
the first token; projection 768 -> 512 -> 512 with ReLU.  Parameter names
follow the HF state dict.  Attention is plain matmul and softmax with an
additive mask.

- ``text_embeds``: ``ClapTextModelWithProjection().text_embeds`` (training
  path), the projection output, not normalised.
- ``get_text_features``: ``ClapModel.get_text_features``, L2-normalised.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..nn import core as L

VOCAB_SIZE = 50265
MAX_POSITIONS = 514
HIDDEN = 768
NUM_LAYERS = 12
PROJECTION_DIM = 512
PAD_TOKEN_ID = 1
LN_EPS = 1e-12


def _layer(hidden: int, ff: int, key) -> nn.ModuleDict:
    k = L.split(key, 6)
    return nn.ModuleDict({
        "attention": nn.ModuleDict({
            "self": nn.ModuleDict({
                "query": L.Linear(hidden, hidden, k[0]),
                "key": L.Linear(hidden, hidden, k[1]),
                "value": L.Linear(hidden, hidden, k[2]),
            }),
            "output": nn.ModuleDict({
                "dense": L.Linear(hidden, hidden, k[3]),
                "LayerNorm": L.Norm(hidden),
            }),
        }),
        "intermediate": nn.ModuleDict({"dense": L.Linear(hidden, ff, k[4])}),
        "output": nn.ModuleDict({
            "dense": L.Linear(ff, hidden, k[5]),
            "LayerNorm": L.Norm(hidden),
        }),
    })


class ClapText(nn.Module):
    """Defaults = laion/clap-htsat-unfused; smaller values build test-sized
    family members (heads = hidden // 64).  Keys as the JAX
    ``clap_text_init``: ``split(key, num_layers + 5)``, six per layer, then
    three for the embeddings and three for the pooler and projection."""

    def __init__(self, num_layers: int = NUM_LAYERS, hidden: int = HIDDEN,
                 ff: int | None = None, vocab_size: int = VOCAB_SIZE,
                 projection_dim: int = PROJECTION_DIM, key=None):
        super().__init__()
        ff = ff if ff is not None else 4 * hidden
        keys = L.split(key, num_layers + 5)
        ke = L.split(keys[num_layers], 3)
        kp = L.split(keys[num_layers + 1], 3)
        self.embeddings = nn.ModuleDict({
            "word_embeddings": L.Embedding(vocab_size, hidden, ke[0]),
            "position_embeddings": L.Embedding(MAX_POSITIONS, hidden, ke[1]),
            "token_type_embeddings": L.Embedding(1, hidden, ke[2]),
            "LayerNorm": L.Norm(hidden),
        })
        self.layer = nn.ModuleList([_layer(hidden, ff, keys[i])
                                    for i in range(num_layers)])
        self.pooler = nn.ModuleDict({"dense": L.Linear(hidden, hidden, kp[0])})
        self.text_projection = nn.ModuleDict({
            "linear1": L.Linear(hidden, projection_dim, kp[1]),
            "linear2": L.Linear(projection_dim, projection_dim, kp[2]),
        })


def _position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """RoBERTa position ids: cumsum over non-pad tokens, offset by pad idx."""
    mask = attention_mask.long()
    return torch.cumsum(mask, dim=1) * mask + PAD_TOKEN_ID


def _attention(p: nn.ModuleDict, x: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    """Post-LN BERT self-attention block with an additive mask bias."""
    hidden = x.shape[-1]
    heads = max(1, hidden // 64)
    sp = p["self"]
    q = L.linear(sp["query"], x)
    k = L.linear(sp["key"], x)
    v = L.linear(sp["value"], x)
    b, l, _ = x.shape
    dh = hidden // heads
    split = (lambda t: t.reshape(b, l, heads, dh).transpose(1, 2))  # noqa: E731
    scores = torch.matmul(split(q), split(k).transpose(-1, -2)) / (dh ** 0.5)
    attn = torch.softmax((scores + bias).float(), dim=-1).to(x.dtype)
    ctx = torch.matmul(attn, split(v)).transpose(1, 2).reshape(b, l, hidden)
    out = L.linear(p["output"]["dense"], ctx)
    return L.layer_norm(p["output"]["LayerNorm"], out + x, eps=LN_EPS)


def encode(clap: ClapText, input_ids: torch.Tensor,
           attention_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) ids + (B, L) 0/1 mask -> (hidden (B, L, H), pooled (B, H))."""
    emb = clap.embeddings
    x = L.embedding(emb["word_embeddings"], input_ids.long())
    x = x + L.embedding(emb["position_embeddings"], _position_ids(attention_mask))
    x = x + emb["token_type_embeddings"].weight[0]
    x = L.layer_norm(emb["LayerNorm"], x, eps=LN_EPS)
    bias = (1.0 - attention_mask.float()) * torch.finfo(torch.float32).min
    bias = bias[:, None, None, :]
    for lp in clap.layer:
        x = _attention(lp["attention"], x, bias)
        h = L.gelu(L.linear(lp["intermediate"]["dense"], x))
        h = L.linear(lp["output"]["dense"], h)
        x = L.layer_norm(lp["output"]["LayerNorm"], h + x, eps=LN_EPS)
    pooled = torch.tanh(L.linear(clap.pooler["dense"], x[:, 0]))
    return x, pooled


def _project(clap: ClapText, pooled: torch.Tensor) -> torch.Tensor:
    proj = clap.text_projection
    return L.linear(proj["linear2"], torch.relu(L.linear(proj["linear1"], pooled)))


def text_embeds(clap: ClapText, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
    """``ClapTextModelWithProjection().text_embeds``: not normalised."""
    _, pooled = encode(clap, input_ids, attention_mask)
    return _project(clap, pooled)


def get_text_features(clap: ClapText, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor) -> torch.Tensor:
    """``ClapModel.get_text_features``: projection, L2-normalised."""
    emb = text_embeds(clap, input_ids, attention_mask)
    norm = torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True)
    return (emb / norm).to(emb.dtype)
