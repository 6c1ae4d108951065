"""Fused transformer layer tail and attention block: the hand-written Hopper
kernels and their plain PyTorch versions.

Counterpart of ``audio_to_sheet_music_tpu/ops/pallas_attn.py:layer_tail``
(Pallas body ``_layer_kernel``), which runs every self and cross layer of the
HTDemucs crosstransformer.  ``layer_tail`` computes, per query row,
Q-projection, 8-head ``softmax(q kᵀ/√64)·v`` over the projected keys with
padded keys masked, out-projection + bias, LayerScale γ1 + residual,
LayerNorm (``norm2`` for self layers, ``norm3`` for cross layers), FF
D -> FF -> D with exact GELU, LayerScale γ2 + residual.  K/V projection and
the GroupNorm-out stay outside, as in the JAX package.

- ``layer_tail``: the wrapper.  A CUDA tensor launches the CUDA kernel
  (``csrc/layer_tail.cu``; its header says what bounds it on an H100 and
  what the design does about it) or raises; a CPU tensor takes
  ``layer_tail_plain``.  ``layer_tail.launches`` counts the calls that
  launched the kernels.
- ``layer_tail_plain``: the same function in PyTorch ops, with the Pallas
  kernel's rounding points (bf16 operands, f32 accumulation, f32 softmax,
  LayerNorm statistics and residual stream).
- ``fused_self_layer`` / ``fused_cross_layer``: project K/V and call
  ``layer_tail`` from a layer module's parameters.

Counterpart of ``pallas_attn.attn_block`` (Pallas body ``_attn_kernel``),
the opt-in kernel the JAX package runs when the whole-layer kernel is off:
``attn_block`` computes ``x + γ·(softmax(q kᵀ/√64)·v·Woᵀ + bo)`` per query
row over projected q, k, v (``csrc/attn_block.cu``: the flash-attention
launch and the out-projection GEMM of ``csrc/attn_common.cuh``, which
``layer_tail`` uses too).  ``attn_block_plain`` is its plain version and
``mha_residual`` projects Q/K/V (torch matmuls, as the JAX package leaves
them to XLA) and calls it from an attention module's parameters.
``attn_block.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..nn.core import layer_norm
from . import build

EPS = 1e-5
_HEAD_DIM = 64          # the kernel's fixed head width
_TILE = 64              # kernel column granularity for D and FF
_MAX_D = 512            # the LayerNorm launch holds a row in one warp's registers


def _mm(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ wᵀ`` with operands rounded to ``dtype`` and f32 accumulation."""
    return torch.matmul(a.to(dtype).float(), w.to(dtype).float().transpose(-1, -2))


def attention_plain(q, k, v, num_heads: int) -> torch.Tensor:
    """``concat_heads softmax(q_h k_hᵀ/√dh) v_h`` -> (B, L, D) in q's dtype,
    with the Pallas kernels' rounding points: f32 scores and softmax, the
    probabilities rounded to the input dtype, an f32 product."""
    dt = q.dtype
    b, l, d = q.shape
    dh = d // num_heads
    qh = q.reshape(b, l, num_heads, dh).transpose(1, 2)
    kh = k.reshape(b, -1, num_heads, dh).transpose(1, 2)
    vh = v.reshape(b, -1, num_heads, dh).transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(dh)
    probs = torch.softmax(scores, dim=-1).to(dt)
    attn = torch.matmul(probs.float(), vh.float())
    return attn.transpose(1, 2).reshape(b, l, d).to(dt)


def layer_tail_plain(h, k, v, x, wq, bq, wo, bo, g1, lnw, lnb, w1, b1, w2,
                     b2, g2, num_heads: int) -> torch.Tensor:
    """The fused layer tail in plain PyTorch ops; same contract as
    ``layer_tail``.  Rounds to the input dtype where the Pallas kernel does:
    after the Q-projection, the softmax probabilities, the concatenated
    heads, the LayerNorm and the GELU."""
    dt = h.dtype
    d = h.shape[-1]
    q = (_mm(h, wq, dt) + bq.float()).to(dt)
    attn = attention_plain(q, k, v, num_heads)
    y1 = x.float() + g1.float() * (_mm(attn, wo, dt) + bo.float())
    ln = torch.nn.functional.layer_norm(y1, (d,), lnw.float(), lnb.float(),
                                        EPS).to(dt)
    f1 = torch.nn.functional.gelu(_mm(ln, w1, dt) + b1.float()).to(dt)
    y2 = y1 + g2.float() * (_mm(f1, w2, dt) + b2.float())
    return y2.to(dt)


def attn_block_plain(q, k, v, x, wo, bo, gamma, num_heads: int
                     ) -> torch.Tensor:
    """The attention block in plain PyTorch ops; same contract as
    ``attn_block``.  Rounds to the input dtype where the Pallas kernel does:
    the softmax probabilities and the concatenated heads."""
    dt = q.dtype
    attn = attention_plain(q, k, v, num_heads)
    out = x.float() + gamma.float() * (_mm(attn, wo, dt) + bo.float())
    return out.to(dt)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device,
           what: str = "layer_tail") -> None:
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, the input on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if t.data_ptr() % 32:
        raise ValueError(f"{what}: {name} must be 32-byte aligned")


def supports(d: int, num_heads: int, ff: int) -> bool:
    """Shapes the CUDA kernel takes: 64-wide heads, D and FF in 64-column
    tiles, D within one warp's LayerNorm registers."""
    return (num_heads * _HEAD_DIM == d and d % _TILE == 0 and d <= _MAX_D
            and ff % _TILE == 0)


def supports_block(d: int, num_heads: int) -> bool:
    """The shapes the JAX package sends to ``attn_block``
    (``pallas_attn.supports``); the model routes by the same test.  The CUDA
    kernel also needs 64-wide heads and raises on other widths."""
    return d % 128 == 0 and d % num_heads == 0 and d // num_heads >= 8


def _lib() -> ctypes.CDLL:
    lib = build.load("layer_tail")
    if not getattr(lib, "_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.layer_tail_launch.argtypes = [p] * 21 + [i] * 5 + [f, f, p]
        lib.layer_tail_launch.restype = i
        lib._bound = True
    return lib


def layer_tail(h, k, v, x, wq, bq, wo, bo, g1, lnw, lnb, w1, b1, w2, b2, g2,
               num_heads: int) -> torch.Tensor:
    """Fused layer tail -> the layer output before the GroupNorm-out.

    h (normed queries), x (residual stream): (B, L, D); k, v: (B, S, D),
    already projected; wq, wo (D, D), w1 (FF, D), w2 (D, FF) in torch
    layout; bq, bo, g1, lnw, lnb, b2, g2 (D,) and b1 (FF,).

    CPU tensors take ``layer_tail_plain``.  CUDA tensors launch the kernel:
    activations and weight matrices bf16, vectors f32, all contiguous, else
    this raises.
    """
    if h.device.type == "cpu":
        return layer_tail_plain(h, k, v, x, wq, bq, wo, bo, g1, lnw, lnb,
                                w1, b1, w2, b2, g2, num_heads)
    if h.device.type != "cuda":
        raise ValueError(f"layer_tail: no kernel for device {h.device}")
    bsz, l, d = h.shape
    s = k.shape[1]
    ff = w1.shape[0]
    if not supports(d, num_heads, ff):
        raise ValueError(f"layer_tail: unsupported D={d}, heads={num_heads}, "
                         f"FF={ff}")
    if l < 1 or s < 1:
        raise ValueError("layer_tail: empty query or key sequence")
    build.check_no_grad("layer_tail", h, k, v, x, wq, bq, wo, bo, g1, lnw,
                        lnb, w1, b1, w2, b2, g2)
    bf, f32, dev = torch.bfloat16, torch.float32, h.device
    for name, t, dt, shape in (
            ("h", h, bf, (bsz, l, d)), ("x", x, bf, (bsz, l, d)),
            ("k", k, bf, (bsz, s, d)), ("v", v, bf, (bsz, s, d)),
            ("wq", wq, bf, (d, d)), ("wo", wo, bf, (d, d)),
            ("w1", w1, bf, (ff, d)), ("w2", w2, bf, (d, ff)),
            ("bq", bq, f32, (d,)), ("bo", bo, f32, (d,)),
            ("g1", g1, f32, (d,)), ("lnw", lnw, f32, (d,)),
            ("lnb", lnb, f32, (d,)), ("b1", b1, f32, (ff,)),
            ("b2", b2, f32, (d,)), ("g2", g2, f32, (d,))):
        _check(name, t, dt, shape, dev)
    # scratch: queries / LayerNorm out, attention out, y1, FF hidden
    qa, qb = torch.empty_like(h), torch.empty_like(h)
    y1 = torch.empty((bsz, l, d), dtype=f32, device=dev)
    u = torch.empty((bsz, l, ff), dtype=bf, device=dev)
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.launch(
        "layer_tail", dev, _lib().layer_tail_launch,
        *(t.data_ptr() for t in (h, k, v, x, wq, bq, wo, bo, g1, lnw, lnb,
                                 w1, b1, w2, b2, g2, qa, qb, y1, u, out)),
        bsz, l, s, d, ff, 1.0 / math.sqrt(d // num_heads), EPS, stream)
    layer_tail.launches += 1
    return out


layer_tail.launches = 0


def _block_lib() -> ctypes.CDLL:
    lib = build.load("attn_block")
    if not getattr(lib, "_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_block_launch.argtypes = [p] * 9 + [i] * 4 + [f, p]
        lib.attn_block_launch.restype = i
        lib._bound = True
    return lib


def attn_block(q, k, v, x, wo, bo, gamma, num_heads: int) -> torch.Tensor:
    """``x + γ·(softmax(q kᵀ/√dh)·v·Woᵀ + bo)`` per head -> (B, L, D).

    q, x: (B, L, D); k, v: (B, S, D), already projected; wo (D, D) in torch
    layout; bo, gamma (D,).  CPU tensors take ``attn_block_plain``.  CUDA
    tensors launch the kernel: activations and ``wo`` bf16, vectors f32,
    all contiguous, 64-wide heads, nothing requiring grad, else this raises.
    """
    if q.device.type == "cpu":
        return attn_block_plain(q, k, v, x, wo, bo, gamma, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"attn_block: no kernel for device {q.device}")
    bsz, l, d = q.shape
    s = k.shape[1]
    if num_heads * _HEAD_DIM != d or d % _TILE:
        raise ValueError(f"attn_block: unsupported D={d}, heads={num_heads}")
    if l < 1 or s < 1:
        raise ValueError("attn_block: empty query or key sequence")
    build.check_no_grad("attn_block", q, k, v, x, wo, bo, gamma)
    bf, f32, dev = torch.bfloat16, torch.float32, q.device
    for name, t, dt, shape in (
            ("q", q, bf, (bsz, l, d)), ("x", x, bf, (bsz, l, d)),
            ("k", k, bf, (bsz, s, d)), ("v", v, bf, (bsz, s, d)),
            ("wo", wo, bf, (d, d)), ("bo", bo, f32, (d,)),
            ("gamma", gamma, f32, (d,))):
        _check(name, t, dt, shape, dev, "attn_block")
    a = torch.empty_like(q)
    out = torch.empty_like(q)
    build.launch(
        "attn_block", dev, _block_lib().attn_block_launch,
        *(t.data_ptr() for t in (q, k, v, x, wo, bo, gamma, a, out)),
        bsz, l, s, d, 1.0 / math.sqrt(d // num_heads),
        torch.cuda.current_stream(dev).cuda_stream)
    attn_block.launches += 1
    return out


attn_block.launches = 0


def mha_residual(attn, gamma, x_res: torch.Tensor, q_in: torch.Tensor,
                 kv_in: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``x_res + LayerScale(MHA(q_in, kv_in, kv_in))`` through
    ``attn_block``.  ``attn`` is an ``nn.attention.MHA`` (packed in-proj),
    ``gamma`` a ``LayerScale``; ``q_in`` / ``kv_in`` are the normed token
    streams.  The projections are torch matmuls in the stream's dtype."""
    dt = q_in.dtype
    e = q_in.shape[-1]
    w = attn.in_proj_weight.to(dt)
    bias = attn.in_proj_bias.to(dt)
    lin = torch.nn.functional.linear
    q = lin(q_in, w[:e], bias[:e])
    k = lin(kv_in, w[e:2 * e], bias[e:2 * e])
    v = lin(kv_in, w[2 * e:], bias[2 * e:])
    return attn_block(q.contiguous(), k.contiguous(), v.contiguous(),
                      x_res.contiguous(), attn.out_proj.weight.to(dt).contiguous(),
                      attn.out_proj.bias.float().contiguous(),
                      gamma.scale.float().contiguous(), num_heads)


def _tail_from_layer(layer, attn, ln, x_res, h_q, kv, num_heads: int):
    """Project K/V from the normed memory stream ``kv`` (torch matmul, as
    the JAX package leaves it to XLA) and run ``layer_tail``."""
    dt = h_q.dtype
    e = h_q.shape[-1]
    w = attn.in_proj_weight.to(dt)
    bias = attn.in_proj_bias.to(dt)
    k = torch.nn.functional.linear(kv, w[e:2 * e], bias[e:2 * e])
    v = torch.nn.functional.linear(kv, w[2 * e:], bias[2 * e:])
    vec = (lambda p: p.float().contiguous())   # noqa: E731
    mat = (lambda p: p.to(dt).contiguous())    # noqa: E731
    return layer_tail(
        h_q.contiguous(), k.contiguous(), v.contiguous(), x_res.contiguous(),
        mat(w[:e]), vec(attn.in_proj_bias[:e]),
        mat(attn.out_proj.weight), vec(attn.out_proj.bias),
        vec(layer.gamma_1.scale), vec(ln.weight), vec(ln.bias),
        mat(layer.linear1.weight), vec(layer.linear1.bias),
        mat(layer.linear2.weight), vec(layer.linear2.bias),
        vec(layer.gamma_2.scale), num_heads)


def fused_self_layer(layer, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Pre-LN self-attention layer up to (not including) the GroupNorm-out.

    ``layer`` is a ``models.htdemucs.TransformerLayer`` with ``cross=False``.
    """
    h = layer_norm(layer.norm1, x)
    return _tail_from_layer(layer, layer.self_attn, layer.norm2, x, h, h,
                            num_heads)


def fused_cross_layer(layer, q: torch.Tensor, mem: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """Pre-LN cross-attention layer up to the GroupNorm-out; the FF
    pre-norm is ``norm3``."""
    qn = layer_norm(layer.norm1, q)
    mn = layer_norm(layer.norm2, mem)
    return _tail_from_layer(layer, layer.cross_attn, layer.norm3, q, qn, mn,
                            num_heads)
