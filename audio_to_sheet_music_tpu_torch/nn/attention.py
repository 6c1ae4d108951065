"""Multi-head attention with torch ``nn.MultiheadAttention``'s packed layout.

``in_proj_weight (3E, E)``, ``in_proj_bias (3E,)`` and ``out_proj`` hold
the parameters under torch's names.  The math is plain matmul and softmax,
as in the JAX package's ``nn/attention.py``: scores in the activation
dtype, softmax in f32, out-projection in the activation dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .core import Linear, _uniform, split


class MHA(nn.Module):
    """The JAX ``mha_init``: ``k1, k2, _ = split(key, 3)``; xavier-uniform
    packed in-projection from ``k1``, the out-projection's weight
    U(-1/sqrt(E), 1/sqrt(E)) from ``k2``, zero biases."""

    def __init__(self, embed_dim: int, key=None):
        super().__init__()
        k1, k2, _ = split(key, 3)
        # torch applies xavier_uniform_ to the PACKED (3E, E) tensor
        bound = math.sqrt(6.0 / (4.0 * embed_dim))
        self.in_proj_weight = _uniform((3 * embed_dim, embed_dim), bound, k1)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        if key is not None:
            self.out_proj.weight = _uniform((embed_dim, embed_dim),
                                            1.0 / math.sqrt(embed_dim), k2)
            nn.init.zeros_(self.out_proj.bias)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           num_heads: int) -> torch.Tensor:
    """softmax(q kᵀ/√dh) v per head; (B, L, E) x (B, S, E) -> (B, L, E)."""
    e = q.shape[-1]
    qh, kh, vh = _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(e // num_heads)
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.matmul(attn, vh)
    return out.transpose(1, 2).reshape(q.shape)


def mha(m: MHA, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
        num_heads: int) -> torch.Tensor:
    """Batch-first MHA: query (B, L, E), key/value (B, S, E) -> (B, L, E)."""
    e = query.shape[-1]
    w = m.in_proj_weight.to(query.dtype)
    b = m.in_proj_bias.to(query.dtype)
    q = torch.nn.functional.linear(query, w[:e], b[:e])
    k = torch.nn.functional.linear(key, w[e:2 * e], b[e:2 * e])
    v = torch.nn.functional.linear(value, w[2 * e:], b[2 * e:])
    out = attend(q, k, v, num_heads)
    op = m.out_proj
    return torch.nn.functional.linear(out, op.weight.to(query.dtype),
                                      op.bias.to(query.dtype))
