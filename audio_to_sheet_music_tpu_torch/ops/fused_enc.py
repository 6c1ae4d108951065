"""Fused frequency HEncLayer: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``audio_to_sheet_music_tpu/ops/pallas_enc.py:
henc_freq_fused`` (Pallas body ``_kernel``, with the DConv math of
``ops/pallas_dconv.py:_block_body``).  It computes one frequency
``HEncLayer`` without the time-branch inject:

    Conv2d(Cin -> C, k=(8,1), s=(4,1), p=(2,0)) + bias -> exact GELU
    -> 2 DConv blocks per (b, f) row along T (dilated k=3 C -> C/8,
       GroupNorm(1), GELU, 1x1 C/8 -> 2C, GroupNorm(1), GLU, LayerScale,
       residual)
    -> rewrite 1x1 C -> 2C -> GLU

- ``henc_freq_fused``: the wrapper.  A CUDA tensor launches the CUDA kernel
  (``csrc/henc_freq.cu``; its header says what bounds it on an H100 and what
  the design does about it) or raises; a CPU tensor takes
  ``henc_freq_plain``.  ``henc_freq_fused.launches`` counts kernel launches.
- ``henc_freq_plain``: the same function in PyTorch ops, computed in f32
  like the kernel (bf16 in, f32 sums and intermediates, input dtype out),
  with the operands of every product (the strided conv, the DConv's two
  convolutions, the rewrite) rounded to ``dot_dtype``: bf16 for bf16 input,
  the JAX ``_kernel``'s rule and what the kernel's tensor-core products
  take.
- ``top_weights``: the conv and rewrite weights cast and zero-padded once
  a call into the layout the kernel reads.
- ``profitable`` and ``supports``: the layers and shapes the model sends
  here, the JAX package's tests.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .fused_dconv import (MAX_CHANNELS, block_weights, dconv_rows_plain,
                          default_dot_dtype, kernel_weights)

KERNEL = 8
STRIDE = 4
PAD = 2
EPS = 1e-5


def profitable(cin: int) -> bool:
    """Layer 0 only (Cin <= 4), the gate the JAX package measured on the
    TPU (22.0 -> 15.6 ms there).  Kept until an A/B on the H100 says which
    layers the kernel should take."""
    return cin <= 4


def _freq_block(nb_out: int, t: int, cin: int, cout: int) -> int | None:
    """The JAX kernel's VMEM frequency block (``pallas_enc._freq_block``)."""
    tp = -(-t // 128) * 128
    for fb in (64, 32, 16, 8, 4, 2, 1):
        if nb_out % fb == 0 and (22 * cout + 32 * cin) * fb * tp <= 14 * 2 ** 20:
            return fb
    return None


def supports(cin: int, cout: int, f: int, t: int) -> bool:
    """The shapes the JAX package sends to its kernel
    (``pallas_enc.supports``): F on the stride-4 grid, a whole DConv hidden
    width C/8, one frequency block within its VMEM budget (at layer 0 that is
    T up to ~12.6k frames, ~290 s chunks); and C up to the DConv routine's
    ``MAX_CHANNELS``.  The model routes by this test; the CUDA kernel itself
    takes any T."""
    return (f % STRIDE == 0 and f >= STRIDE and cout % 8 == 0
            and cout <= MAX_CHANNELS
            and _freq_block(f // STRIDE, t, cin, cout) is not None)


def henc_freq_plain(layer, x: torch.Tensor,
                    dot_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``(B, Cin, F, T) -> (B, C, F/4, T)`` in PyTorch ops, f32 inside.

    ``dot_dtype`` (default: ``default_dot_dtype`` of ``x``) rounds the
    operands of every product, as the JAX ``_kernel`` does
    (``pallas_enc.py:150``: ``wc`` to the input's dtype; ``:164-165``: ``wr``
    and y to ``dot_dtype``; the DConv's through ``_block_body``): x and
    ``wc``, the DConv's, then ``wr`` and the DConv's output y.  Every sum,
    bias, GELU, statistic and GLU stays f32."""
    dot = dot_dtype or default_dot_dtype(x.dtype)
    rnd = lambda t: t.float().to(dot).float()  # noqa: E731
    y = F.gelu(F.conv2d(rnd(x), rnd(layer.conv.weight),
                        layer.conv.bias.float(), stride=(STRIDE, 1),
                        padding=(PAD, 0)))
    b, c, f, t = y.shape
    r = dconv_rows_plain(layer.dconv,
                         y.permute(0, 2, 1, 3).reshape(b * f, c, t), dot)
    y = r.reshape(b, f, c, t).permute(0, 2, 1, 3)
    z = F.conv2d(rnd(y), rnd(layer.rewrite.weight),
                 layer.rewrite.bias.float())
    return F.glu(z, dim=1).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("henc_freq")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.henc_freq_launch.argtypes = [p] * 10 + [i] * 5 + [p]
        lib.henc_freq_launch.restype = i
        lib.henc_freq_part_floats.argtypes = [i, i, i]
        lib.henc_freq_part_floats.restype = ctypes.c_size_t
        for fn in (lib.henc_freq_hidden_pad, lib.henc_freq_conv_depth,
                   lib.henc_freq_channel_pad):
            fn.argtypes = [i]
            fn.restype = i
        lib._bound = True
    return lib


def top_weights(layer, device, what: str, kp: int, cp: int) -> list:
    """The conv and rewrite weights in the layout and types
    ``csrc/henc_freq.cu`` reads: ``wc`` as bf16 ``(C, kp)`` (column
    ``ci * 8 + kf``), ``bc`` f32, ``wr`` as bf16 ``(2C, cp)``, ``br`` f32;
    the columns past ``Cin * 8`` and ``C`` zero, to the widths the library
    asks for (``henc_freq_conv_depth``, ``henc_freq_channel_pad``)."""
    wc, bc, wr, br = (build.f32(w, device, what) for w in (
        layer.conv.weight, layer.conv.bias, layer.rewrite.weight,
        layer.rewrite.bias))
    wc = wc.reshape(wc.shape[0], -1)                 # from (C, Cin, 8, 1)
    wr = wr.reshape(wr.shape[0], -1)                 # from (2C, C, 1, 1)
    pad = lambda w, n: F.pad(w, (0, n - w.shape[1])).to(  # noqa: E731
        torch.bfloat16).contiguous()
    return [pad(wc, kp), bc, pad(wr, cp), br]


def henc_freq_fused(layer, x: torch.Tensor) -> torch.Tensor:
    """Fused frequency HEncLayer ``(B, Cin, F, T) -> (B, C, F/4, T)``.

    ``layer`` is a ``models.htdemucs.HEncLayer`` with ``freq=True``.  CPU
    tensors take ``henc_freq_plain``.  A CUDA ``x`` must be a contiguous
    bf16 ``(B, Cin, F, T)`` with F on the stride-4 grid and C a multiple of
    8 up to ``MAX_CHANNELS`` (any T), and nothing may require grad (there is
    no backward kernel), else this raises.
    """
    if x.device.type == "cpu":
        return henc_freq_plain(layer, x)
    if x.device.type != "cuda":
        raise ValueError(f"henc_freq_fused: no kernel for device {x.device}")
    dconv_w = block_weights(layer.dconv)
    top_w = [layer.conv.weight, layer.conv.bias, layer.rewrite.weight,
             layer.rewrite.bias]
    build.check_no_grad("henc_freq_fused", x, *top_w, *dconv_w)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"henc_freq_fused: x must be bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("henc_freq_fused: x must be a contiguous (B, Cin, F, T)")
    b, cin, f, t = x.shape
    c = layer.conv.weight.shape[0]
    if tuple(layer.conv.weight.shape) != (c, cin, KERNEL, 1):
        raise ValueError(f"henc_freq_fused: conv weight "
                         f"{tuple(layer.conv.weight.shape)} for Cin={cin}")
    if (f % STRIDE or f < STRIDE or c % 8 or c > MAX_CHANNELS or t < 1
            or len(dconv_w) != 18):
        raise ValueError(f"henc_freq_fused: unsupported shape {(b, cin, f, t)} "
                         f"-> C={c} (C at most {MAX_CHANNELS})")
    dev = x.device
    lib = _lib()
    weights = top_weights(layer, dev, "henc_freq_fused",
                          lib.henc_freq_conv_depth(cin),
                          lib.henc_freq_channel_pad(c))
    dw = kernel_weights(layer.dconv, dev, "henc_freq_fused",
                        lib.henc_freq_hidden_pad(c))
    dw_ptrs = (ctypes.c_void_p * 18)(*(w.data_ptr() for w in dw))
    rows = b * (f // STRIDE)
    y = torch.empty((rows, c, t), dtype=torch.float32, device=dev)
    u = torch.empty((rows, c // 8, t), dtype=torch.float32, device=dev)
    part = torch.empty((lib.henc_freq_part_floats(b, f, t),),
                       dtype=torch.float32, device=dev)
    out = torch.empty((b, c, f // STRIDE, t), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.launch(
        "henc_freq_fused", dev, lib.henc_freq_launch,
        x.data_ptr(), *(w.data_ptr() for w in weights),
        ctypes.cast(dw_ptrs, ctypes.c_void_p), y.data_ptr(), u.data_ptr(),
        part.data_ptr(), out.data_ptr(), b, cin, f, t, c, stream)
    henc_freq_fused.launches += 1
    return out


henc_freq_fused.launches = 0
