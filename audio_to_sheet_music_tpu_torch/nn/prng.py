"""Threefry-2x32 keys and draws with ``jax.random``'s numbers, in PyTorch.

The JAX package seeds every model from ``jax.random.PRNGKey(seed)`` and
hands keys down its init functions with ``jax.random.split``; its committed
head was trained on the towers that ``PRNGKey(0)`` draws.  This module
draws the same numbers, so the port's seeded models are the JAX package's
(JAX's defaults: the threefry implementation with
``jax_threefry_partitionable`` on):

- ``PRNGKey(seed)``: the key ``(0, seed & 0xFFFFFFFF)``: JAX's seed is a
  32-bit integer unless 64-bit types are on, which the JAX package leaves
  off, so the high word is 0;
- ``split(key, n)``: threefry2x32 of the key over the counters
  ``(i >> 32, i & 0xFFFFFFFF)``, ``i < n``; key ``i`` is the pair of words;
- ``random_bits(key, shape)``: the two words of the same hash over the flat
  index of ``shape``, XOR-ed;
- ``uniform``: the top 23 bits as an f32 mantissa in [1, 2), minus 1, then
  ``f * (hi - lo) + lo`` rounded once (XLA fuses it into one FMA) and
  clamped below at ``lo``; bit for bit ``jax.random.uniform``'s;
- ``normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
  ``(nextafter(-1, 0), 1)``; XLA's f32 ``erf_inv`` polynomial is
  reproduced, and the draw stays within ``NORMAL_RTOL`` of JAX's.

A ``Key`` is a value: two 32-bit words (host integers) and the device its
draws land on.  Splitting hashes a handful of counters on the host; the
draws hash one counter per value, in chunks of ``CHUNK`` values.  On a
card the 32-bit lanes live in int64 tensors, masked after every add and
left shift, 2**24 values a chunk (one set of launches).  On the CPU they
are numpy uint32 arrays (the masks are then no-ops), 2**15 values a
chunk, and so is the normal's polynomial: one thread, in cache, so that
draws in many processes at once do not oversubscribe the host.  One hash
serves both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
CHUNK = {"cuda": 1 << 24, "cpu": 1 << 15}
NORMAL_RTOL = 1e-5
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclass(frozen=True)
class Key:
    """A threefry key: words ``(hi, lo)``; draws land on ``device``."""

    hi: int
    lo: int
    device: torch.device = torch.device("cpu")


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> Key:
    """``jax.random.PRNGKey(seed)`` with JAX's default 32-bit integers: the
    seed's low 32 bits (two's complement for a negative one).  A ``cuda``
    device needs a card: without one this raises ``RuntimeError``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"PRNGKey: device {device} requested but "
                           "torch.cuda.is_available() is False")
    return Key(0, int(seed) & MASK, device)


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x1, x2)``
    (int64 arrays or tensors holding 32-bit values) under key ``(k1, k2)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of keys."""
    idx = np.arange(num, dtype=np.int64)
    b1, b2 = threefry2x32(key.hi, key.lo, idx >> 32, idx & MASK)
    return [Key(int(a), int(b), key.device) for a, b in zip(b1, b2)]


def _bits_chunks(key: Key, n: int):
    """The 32-bit draws of flat indices ``[0, n)``, in chunks: ``(start,
    bits)``, bits a numpy uint32 array for a CPU key, an int64 tensor on
    the key's card otherwise."""
    cpu = key.device.type == "cpu"
    step = CHUNK["cpu" if cpu else "cuda"]
    for start in range(0, n, step):
        stop = min(n, start + step)
        if cpu:
            idx = np.arange(start, stop, dtype=np.uint64)
            x1, x2 = (idx >> 32).astype(np.uint32), idx.astype(np.uint32)
        else:
            idx = torch.arange(start, stop, dtype=torch.int64,
                               device=key.device)
            x1, x2 = idx >> 32, idx & MASK
        b1, b2 = threefry2x32(key.hi, key.lo, x1, x2)
        yield start, b1 ^ b2


def random_bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 on the device."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=key.device)
    for start, bits in _bits_chunks(key, n):
        if isinstance(bits, np.ndarray):
            bits = torch.from_numpy(bits.astype(np.int64))
        out[start:start + len(bits)] = bits
    return out.reshape(tuple(shape))


def _uniform_chunk(bits, lo32: np.float32, span: float):
    """``bits`` -> f32 uniforms (numpy for numpy bits): the top 23 bits as a
    mantissa in [1, 2), minus 1, then ``f * span + lo`` with one rounding
    (the product of two f32 values is exact in f64, so only the sum rounds
    before the cast, as in XLA's FMA), clamped below at ``lo``."""
    if isinstance(bits, np.ndarray):
        f = ((bits >> 9) | 0x3F800000).view(np.float32) - np.float32(1)
        u = (f.astype(np.float64) * span + float(lo32)).astype(np.float32)
        return np.maximum(u, lo32)
    mant = (bits >> 9) | 0x3F800000
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    return (f.double() * span + float(lo32)).float().clamp_min_(float(lo32))


def _uniform_fill(key: Key, shape, lo: float, hi: float, finish=None
                  ) -> torch.Tensor:
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = float(hi32 - lo32)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for start, bits in _bits_chunks(key, n):
        u = _uniform_chunk(bits, lo32, span)
        u = u if finish is None else finish(u)
        if isinstance(u, np.ndarray):
            u = torch.from_numpy(u)
        out[start:start + u.numel()] = u
    return out.reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _uniform_fill(key, shape, minval, maxval)


# XLA's f32 ErfInv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, w = -log1p(-x^2)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """XLA's f32 ``erf_inv`` (the polynomial ``jax.random.normal`` runs) of
    an f32 tensor or numpy array, in f32."""
    xp, c = (np, np.float32) if isinstance(x, np.ndarray) else (torch, float)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -xp.log1p(-x * x)
        lt = w < c(5.0)
        w = xp.where(lt, w - c(2.5), xp.sqrt(w) - c(3.0))
        p = xp.where(lt, c(_ERFINV_LT5[0]), c(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = xp.where(lt, c(a), c(b)) + p * w
        return xp.where(xp.abs(x) == c(1.0), x * c(math.inf), p * x)


_SQRT2 = np.float32(np.sqrt(2.0))


def normal(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``, within ``NORMAL_RTOL``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _uniform_fill(key, shape, lo, 1.0,
                         finish=lambda u: erfinv(u) * _SQRT2)
