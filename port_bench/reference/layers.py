"""Plain PyTorch layers of the benchmark's reference, and its precision.

The reference takes its parameters as a flat ``{name: tensor}`` dict under
the port's ``state_dict`` names and computes every product in float32 (TF32
off: ``reference.set_f32``).  ``Prec`` rounds the operands of each product
(linear, convolution, attention matmul) before it runs, and in training
the gradient that flows back to it: ``"f32"`` rounds nothing, ``"bf16"`` and ``"fp8"`` round to bfloat16 or to float8 (e4m3 forward,
e5m2 for gradients) with one scale per tensor (its absolute maximum onto
the format's largest normal).  ``"fp8"`` is the control of a bf16 configuration: the reference
put in the program's place one precision below it.  Norm statistics, the
DSP and the losses stay in f32 at every precision.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# the largest normal of each float8 format
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t: torch.Tensor, name: str,
           fp8: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    if name == "bf16":
        return t.to(torch.bfloat16).float()
    s = FP8_MAX[fp8] / t.abs().amax().float().clamp(min=1e-30)
    return (t * s).to(fp8).float() / s


class _Rounded(torch.autograd.Function):
    """Rounds a product's operand on the way forward and the gradient that
    comes back to it on the way backward, as a network held in that
    precision rounds both; fp8 gradients in e5m2, the hybrid recipe of
    fp8 training (e4m3 forward, e5m2 backward)."""

    @staticmethod
    def forward(ctx, t, name):
        ctx.name = name
        return _round(t, name)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.name, torch.float8_e5m2), None


class Prec:
    """Rounding of the operands of every product (see the module notes)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return t
        if t.requires_grad:
            return _Rounded.apply(t, self.name)
        with torch.no_grad():
            return _round(t, self.name)


F32 = Prec("f32")


def lin(p: Params, name: str, x: torch.Tensor, prec: Prec = F32) -> torch.Tensor:
    return F.linear(prec.q(x), prec.q(p[name + ".weight"]), p[name + ".bias"])


def conv1d(p: Params, name: str, x: torch.Tensor, stride: int = 1,
           padding: int = 0, dilation: int = 1, prec: Prec = F32
           ) -> torch.Tensor:
    return F.conv1d(prec.q(x), prec.q(p[name + ".weight"]), p[name + ".bias"],
                    stride=stride, padding=padding, dilation=dilation)


def conv2d(p: Params, name: str, x: torch.Tensor, stride=(1, 1),
           padding=(0, 0), prec: Prec = F32) -> torch.Tensor:
    return F.conv2d(prec.q(x), prec.q(p[name + ".weight"]), p[name + ".bias"],
                    stride=tuple(stride), padding=tuple(padding))


def conv_tr1d(p: Params, name: str, x: torch.Tensor, stride: int,
              padding: int = 0, prec: Prec = F32) -> torch.Tensor:
    return F.conv_transpose1d(prec.q(x), prec.q(p[name + ".weight"]),
                              p[name + ".bias"], stride=stride,
                              padding=padding)


def conv_tr2d(p: Params, name: str, x: torch.Tensor, stride, padding=(0, 0),
              prec: Prec = F32) -> torch.Tensor:
    return F.conv_transpose2d(prec.q(x), prec.q(p[name + ".weight"]),
                              p[name + ".bias"], stride=tuple(stride),
                              padding=tuple(padding))


def group_norm1(p: Params, name: str, x: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with one group over (C, *spatial), per batch item."""
    dims = tuple(range(1, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return y * p[name + ".weight"].reshape(shape) + p[name + ".bias"].reshape(shape)


def layer_norm(p: Params, name: str, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + eps) * p[name + ".weight"]
            + p[name + ".bias"])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def resize(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Linear resize of one axis, ``align_corners=False``, with the source
    positions computed in float64 (the demucs reference's numpy
    positions; ``F.interpolate`` rounds them to float32)."""
    n = x.shape[dim]
    if n == size:
        return x
    src = (np.arange(size) + 0.5) * (n / size) - 0.5
    lo = np.floor(src)
    frac = torch.from_numpy((src - lo).astype(np.float32)).to(x.device)
    i0 = torch.from_numpy(np.clip(lo, 0, n - 1).astype(np.int64)).to(x.device)
    i1 = torch.from_numpy(np.clip(lo + 1, 0, n - 1).astype(np.int64)).to(x.device)
    shape = [1] * x.ndim
    shape[dim] = size
    f = frac.reshape(shape)
    return x.index_select(dim, i0) * (1 - f) + x.index_select(dim, i1) * f


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              bias: torch.Tensor | None = None, prec: Prec = F32
              ) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(dh) + bias) v per head; (B, L, E) -> (B, L, E)."""
    b, lq, e = q.shape
    dh = e // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, dh).transpose(1, 2)

    scores = prec.q(split(q)) @ prec.q(split(k)).transpose(-1, -2) / math.sqrt(dh)
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1)
    out = prec.q(w) @ prec.q(split(v))
    return out.transpose(1, 2).reshape(b, lq, e)


def mha(p: Params, name: str, query: torch.Tensor, key: torch.Tensor,
        value: torch.Tensor, heads: int, prec: Prec = F32) -> torch.Tensor:
    """torch ``nn.MultiheadAttention`` (batch first) with its packed
    ``in_proj_weight`` / ``in_proj_bias`` and ``out_proj``."""
    e = query.shape[-1]
    w, b = p[name + ".in_proj_weight"], p[name + ".in_proj_bias"]
    q = F.linear(prec.q(query), prec.q(w[:e]), b[:e])
    k = F.linear(prec.q(key), prec.q(w[e:2 * e]), b[e:2 * e])
    v = F.linear(prec.q(value), prec.q(w[2 * e:]), b[2 * e:])
    return lin(p, name + ".out_proj", attention(q, k, v, heads, prec=prec), prec)


def sub(p: Params, prefix: str) -> Params:
    """The entries of ``p`` under ``prefix + '.'``, with the prefix cut."""
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in p.items() if k.startswith(prefix + ".")}


def count_prefixed(p: Params, prefix: str) -> int:
    """How many numbered children ``prefix.<i>.`` the names hold."""
    idx = {int(k[len(prefix) + 1:].split(".")[0]) for k in p
           if k.startswith(prefix + ".")}
    return len(idx)
