"""Layer modules and plain tensor ops with the JAX package's numerics.

Each layer is an ``nn.Module`` that holds its parameters under the torch
checkpoint names and layouts (Linear ``(out, in)``, Conv ``(out, in, *k)``,
ConvTranspose ``(in, out, *k)``), so a JAX param pytree loads with
``load_state_dict(strict=True)`` after a renaming
(``convert/jax_params.py``).  The math lives in plain functions over
``(module, tensor)`` that mirror ``audio_to_sheet_music_tpu/nn/core.py``:
weights are cast to the activation's dtype, norms take their statistics and
affine in f32 and return the input's dtype, GELU is the exact erf form.

Initialisation takes an explicit threefry key (``nn.prng``) and consumes it
as the JAX init does: a Linear / conv layer splits it into ``(kw, kb)`` and
draws each from ``jax.random.uniform``'s numbers, an embedding is a
``jax.random.normal`` draw, so a layer built from a key equals the JAX
layer built from the same key.  The draws land on the key's device.
``key=None`` leaves the storage uninitialised, for modules that are about
to be loaded.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import prng


def _uniform(shape, bound: float, key: prng.Key | None) -> nn.Parameter:
    """U(-bound, bound) from ``key`` (``nn.core._uniform`` of the JAX
    package); empty storage without a key."""
    if key is None:
        return nn.Parameter(torch.empty(shape, dtype=torch.float32))
    return nn.Parameter(prng.uniform(key, shape, -bound, bound))


def split(key: prng.Key | None, num: int = 2) -> list:
    """``prng.split``, passing ``None`` (no draw) through as ``num`` Nones."""
    return [None] * num if key is None else prng.split(key, num)


def _full(shape, value: float) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class _Affine(nn.Module):
    """A Linear / conv layer's ``weight`` and ``bias``, drawn as the JAX
    ``*_init`` functions draw them: ``(kw, kb) = split(key)``, both
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, shape, n_out: int, fan_in: int, key, bias: bool = True):
        super().__init__()
        kw, kb = split(key)
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = _uniform(shape, bound, kw)
        self.bias = _uniform((n_out,), bound, kb) if bias else None


class Linear(_Affine):
    def __init__(self, in_dim: int, out_dim: int, key=None, bias: bool = True):
        super().__init__((out_dim, in_dim), out_dim, in_dim, key, bias)


class Conv1d(_Affine):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, key=None):
        super().__init__((out_ch, in_ch, kernel), out_ch, in_ch * kernel, key)


class Conv2d(_Affine):
    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int], key=None):
        kh, kw = kernel
        super().__init__((out_ch, in_ch, kh, kw), out_ch, in_ch * kh * kw, key)


class ConvTranspose1d(_Affine):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, key=None):
        # torch ConvTranspose fan_in = weight.size(1) * k = out_ch * k
        super().__init__((in_ch, out_ch, kernel), out_ch, out_ch * kernel, key)


class ConvTranspose2d(_Affine):
    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int], key=None):
        kh, kw = kernel
        super().__init__((in_ch, out_ch, kh, kw), out_ch, out_ch * kh * kw,
                         key)


class Norm(nn.Module):
    """Affine parameters of a GroupNorm / LayerNorm (ones / zeros init)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = _full((dim,), 1.0)
        self.bias = _full((dim,), 0.0)


class LayerScale(nn.Module):
    """demucs LayerScale: a learned per-channel scale."""

    def __init__(self, channels: int, init: float = 0.0):
        super().__init__()
        self.scale = _full((channels,), init)


class Embedding(nn.Module):
    """A standard-normal table (the JAX ``embedding_init``)."""

    def __init__(self, num: int, dim: int, key=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((num, dim), dtype=torch.float32) if key is None
            else prng.normal(key, (num, dim)))


# ---------------------------------------------------------------------------
# Plain ops (torch data layouts: NC{T,HW}, channels-last token streams)
# ---------------------------------------------------------------------------

def _cast(p: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    return None if p is None else p.to(x.dtype)


def linear(m: Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), _cast(m.bias, x))


def conv1d(m: Conv1d, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """x: (B, C, T); weight (O, I, K)."""
    return F.conv1d(x, m.weight.to(x.dtype), _cast(m.bias, x), stride=stride,
                    padding=padding, dilation=dilation)


def conv2d(m: Conv2d, x: torch.Tensor, stride=(1, 1), padding=(0, 0)
           ) -> torch.Tensor:
    """x: (B, C, H, W); weight (O, I, KH, KW)."""
    return F.conv2d(x, m.weight.to(x.dtype), _cast(m.bias, x),
                    stride=tuple(stride), padding=tuple(padding))


def conv_transpose1d(m: ConvTranspose1d, x: torch.Tensor, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """torch ConvTranspose1d: out = (T-1)*s - 2p + k."""
    return F.conv_transpose1d(x, m.weight.to(x.dtype), _cast(m.bias, x),
                              stride=stride, padding=padding)


def conv_transpose2d(m: ConvTranspose2d, x: torch.Tensor, stride=(1, 1),
                     padding=(0, 0)) -> torch.Tensor:
    return F.conv_transpose2d(x, m.weight.to(x.dtype), _cast(m.bias, x),
                              stride=tuple(stride), padding=tuple(padding))


def group_norm(m: Norm, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """torch GroupNorm over (B, C, *spatial); stats and affine in f32."""
    return F.group_norm(x.float(), num_groups, m.weight.float(),
                        m.bias.float(), eps).to(x.dtype)


def layer_norm(m: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch LayerNorm over the last dim; stats and affine in f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), m.weight.float(),
                        m.bias.float(), eps).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return F.glu(x, dim=dim)


def layer_scale(m: LayerScale, x: torch.Tensor,
                channel_last: bool = False) -> torch.Tensor:
    s = m.scale.to(x.dtype)
    if channel_last:
        return s * x
    return s.reshape(-1, *([1] * (x.ndim - 2))) * x


def embedding(m: Embedding, idx: torch.Tensor) -> torch.Tensor:
    return m.weight[idx]


@functools.lru_cache(maxsize=64)
def _lerp_src(in_size: int, size: int, device: torch.device):
    """Source taps of torch's ``align_corners=False`` linear resize, with the
    positions computed in float64 as the JAX package does (``F.interpolate``
    computes them in float32, which moves a 11028 -> 11025 resize by up to
    ~1e-3 of a sample near the end): ``(i0, i1, frac)`` on ``device``.
    Kept per geometry and device: copying host arrays to the card on every
    call would wait for the card each time (a pageable host-to-device copy
    synchronises), which would serialise the replicas of a mesh sweep.
    Made outside inference mode, so a training step can use the taps that
    a sweep made."""
    src = (np.arange(size) + 0.5) * (in_size / size) - 0.5
    i0f = np.floor(src)
    frac = (src - i0f).astype(np.float32)
    i0 = np.clip(i0f.astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0f.astype(np.int64) + 1, 0, in_size - 1)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in (i0, i1, frac))


def _resize_axis(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Linear resize of one axis: two gathered taps and a lerp in f32."""
    in_size = x.shape[dim]
    if in_size == size:
        return x
    i0, i1, frac = _lerp_src(in_size, size, x.device)
    shape = [1] * x.ndim
    shape[dim] = size
    f = frac.reshape(shape)
    x0 = x.index_select(dim, i0).float()
    x1 = x.index_select(dim, i1).float()
    return (x0 * (1.0 - f) + x1 * f).to(x.dtype)


def interpolate_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, size); 'linear', align_corners=False."""
    return _resize_axis(x, size, x.ndim - 1)


def interpolate_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *size); 'bilinear', align_corners=False,
    one axis after the other (the same result: bilinear is separable)."""
    x = _resize_axis(x, size[0], x.ndim - 2)
    return _resize_axis(x, size[1], x.ndim - 1)
