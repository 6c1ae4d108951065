"""DConv over folded frequency rows: the hand-written Hopper kernel and its
plain PyTorch version.

Counterpart of ``audio_to_sheet_music_tpu/ops/pallas_dconv.py:dconv_rows``
(Pallas body ``_kernel`` over ``_block_body``): the HTDemucs DConv residual
branch, two blocks of

    conv1d(C -> C/8, k=3, dil 2^d) -> GroupNorm(1) -> GELU
    -> conv1d(C/8 -> 2C, k=1) -> GroupNorm(1) -> GLU -> LayerScale -> +x

over ``(R, C, T)`` rows, each row's GroupNorm statistics over its (C, T)
positions.  ``models.htdemucs._dconv_freq`` sends the folded (b * f) rows
of the freq encoder layers here under the ``dconv`` kernel selection.

- ``dconv_rows``: the wrapper.  A CUDA tensor launches the CUDA kernel
  (``csrc/dconv_rows.cu`` over the shared routine ``csrc/dconv_row.cuh``,
  whose header says what bounds it and what the design does about it) or
  raises; a CPU tensor takes ``dconv_rows_plain``.  ``dconv_rows.launches``
  counts kernel launches.
- ``dconv_rows_plain``: the same function in PyTorch ops.  The operands of
  both convolutions are rounded to ``dot_dtype`` (bf16 for bf16 input, as
  the kernel's ``mma.sync`` products take them; f32 otherwise); sums,
  statistics and everything between the blocks stay f32, and the result is
  rounded once to the input dtype.  ``fused_enc.henc_freq_plain`` uses it
  for its DConv part.
- ``kernel_weights``: the 18 weights as the routine reads them.
- ``supports``: the JAX package's routing test, and C up to
  ``MAX_CHANNELS``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

EPS = 1e-5
# The widest row the CUDA routine takes (``dconv_row.cuh``: MAX_C, where
# conv1's w1 fills a Hopper block's shared memory); the model's widest.
MAX_CHANNELS = 384


def _row_block(n_rows: int, t: int, c: int) -> int | None:
    """The JAX kernel's VMEM row block (``pallas_dconv._row_block``)."""
    tp = -(-t // 128) * 128
    for rb in (32, 16, 8, 4, 2, 1):
        if n_rows % rb == 0 and 80 * c * rb * tp <= 14 * 2 ** 20:
            return rb
    return None


def supports(n_rows: int, t: int, c: int) -> bool:
    """The shapes the JAX package sends to its kernel
    (``pallas_dconv.supports``) that the CUDA kernel takes: C up to
    ``MAX_CHANNELS``, any T.  The model routes by this test."""
    return (c % 8 == 0 and c <= MAX_CHANNELS
            and _row_block(n_rows, t, c) is not None)


def block_weights(dconv):
    """The 18 weights of the two blocks, in the kernel's order."""
    out = []
    for blk in dconv.layers:
        out += [blk.conv1.weight, blk.conv1.bias, blk.norm1.weight,
                blk.norm1.bias, blk.conv2.weight, blk.conv2.bias,
                blk.norm2.weight, blk.norm2.bias, blk.scale.scale]
    return out


def default_dot_dtype(dtype: torch.dtype) -> torch.dtype:
    """Conv operand precision for an input dtype: bf16 for bf16, f32 for
    anything else (``pallas_enc.py:223``)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def dconv_rows_plain(dconv, x: torch.Tensor,
                     dot_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``(R, C, T) -> (R, C, T)`` in PyTorch ops, f32 inside; the conv
    operands rounded to ``dot_dtype`` (default: ``default_dot_dtype`` of
    ``x``), as ``pallas_dconv._block_body`` rounds them."""
    dot = dot_dtype or default_dot_dtype(x.dtype)
    rnd = lambda t: t.float().to(dot).float()  # noqa: E731
    r = x.float()
    for d, blk in enumerate(dconv.layers):
        dil = 2 ** d
        z = F.conv1d(rnd(r), rnd(blk.conv1.weight), blk.conv1.bias.float(),
                     padding=dil, dilation=dil)
        z = F.gelu(F.group_norm(z, 1, blk.norm1.weight.float(),
                                blk.norm1.bias.float(), EPS))
        z = F.conv1d(rnd(z), rnd(blk.conv2.weight), blk.conv2.bias.float())
        z = F.glu(F.group_norm(z, 1, blk.norm2.weight.float(),
                               blk.norm2.bias.float(), EPS), dim=1)
        r = r + blk.scale.scale.float()[:, None] * z
    return r.to(x.dtype)


def kernel_weights(dconv, device, what: str, hp: int) -> list:
    """The 18 weights in the layout and types ``csrc/dconv_row.cuh`` reads,
    block 0 then block 1: w1 as bf16 ``(3, C, hp)`` (tap, channel, hidden),
    b1 g1 bt1 f32, w2 as bf16 ``(2C, hp)``, b2 g2 bt2 scale f32; the hidden
    C/8 zero-padded to ``hp``, the width the library asks for
    (``*_hidden_pad``)."""
    ws = [build.f32(w, device, what) for w in block_weights(dconv)]
    for i in range(0, len(ws), 9):
        pad = hp - ws[i].shape[0]
        w1 = F.pad(ws[i].permute(2, 1, 0), (0, pad))        # from (H, C, 3)
        w2 = F.pad(ws[i + 4][:, :, 0], (0, pad))            # from (2C, H, 1)
        ws[i] = w1.to(torch.bfloat16).contiguous()
        ws[i + 4] = w2.to(torch.bfloat16).contiguous()
    return ws


def _lib() -> ctypes.CDLL:
    lib = build.load("dconv_rows")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dconv_rows_launch.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.dconv_rows_launch.restype = i
        lib.dconv_rows_part_floats.argtypes = [i, i]
        lib.dconv_rows_part_floats.restype = ctypes.c_size_t
        lib.dconv_rows_hidden_pad.argtypes = [i]
        lib.dconv_rows_hidden_pad.restype = i
        lib._bound = True
    return lib


def dconv_rows(dconv, x: torch.Tensor) -> torch.Tensor:
    """DConv branch over ``(R, C, T)`` rows (the contract of
    ``models.htdemucs.dconv_apply``).

    ``dconv`` is a ``models.htdemucs.DConv`` of two blocks.  CPU tensors
    take ``dconv_rows_plain``.  A CUDA ``x`` must be a contiguous bf16
    ``(R, C, T)`` with C a multiple of 8 up to ``MAX_CHANNELS``, and
    nothing may require grad (there is no backward kernel), else this
    raises.
    """
    if x.device.type == "cpu":
        return dconv_rows_plain(dconv, x)
    if x.device.type != "cuda":
        raise ValueError(f"dconv_rows: no kernel for device {x.device}")
    weights = block_weights(dconv)
    build.check_no_grad("dconv_rows", x, *weights)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dconv_rows: x must be bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("dconv_rows: x must be a contiguous (R, C, T)")
    r, c, t = x.shape
    if c % 8 or r < 1 or t < 1 or len(weights) != 18:
        raise ValueError(f"dconv_rows: unsupported shape {(r, c, t)} or "
                         f"{len(weights) // 9} blocks")
    if c > MAX_CHANNELS:
        raise ValueError(f"dconv_rows: C={c} channels, the kernel takes at "
                         f"most {MAX_CHANNELS}")
    if tuple(dconv.layers[0].conv1.weight.shape) != (c // 8, c, 3):
        raise ValueError(f"dconv_rows: conv1 weight "
                         f"{tuple(dconv.layers[0].conv1.weight.shape)} for C={c}")
    dev = x.device
    lib = _lib()
    dw = kernel_weights(dconv, dev, "dconv_rows", lib.dconv_rows_hidden_pad(c))
    dw_ptrs = (ctypes.c_void_p * 18)(*(w.data_ptr() for w in dw))
    mid = torch.empty((r, c, t), dtype=torch.float32, device=dev)
    u = torch.empty((r, c // 8, t), dtype=torch.float32, device=dev)
    part = torch.empty((lib.dconv_rows_part_floats(r, t),),
                       dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    build.launch(
        "dconv_rows", dev, lib.dconv_rows_launch,
        x.data_ptr(), ctypes.cast(dw_ptrs, ctypes.c_void_p), mid.data_ptr(),
        u.data_ptr(), part.data_ptr(), out.data_ptr(), r, c, t,
        torch.cuda.current_stream(dev).cuda_stream)
    dconv_rows.launches += 1
    return out


dconv_rows.launches = 0
