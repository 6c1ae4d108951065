"""RoPE of BS-RoFormer's queries and keys: the hand-written kernel and its
plain version.

No counterpart in the JAX package.  ``models.bs_roformer``'s attention
projects ``qkv = h·W_qkv`` (B, L, 3·D) and needs q and k turned by rotary
position embedding (``nn.core.rope``: each head's dimensions in
interleaved pairs, position ``p`` of ``L`` along the transformer's axis)
and q, k, v as contiguous (B, L, D) tensors for the flash launch.

- ``rope_qkv``: the wrapper.  A CUDA tensor launches ``csrc/rope.cu``
  (its header says what bounds it and what the design does about it) or
  raises; a CPU tensor takes ``rope_qkv_plain``.  ``rope_qkv.launches``
  counts the calls that launched the kernel.
- ``rope_qkv_plain``: the same in PyTorch ops (``nn.core.rope`` on the q
  and k columns, f32 rotation, one rounding; v copied).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..nn.core import rope, rope_rotation
from . import build


def rope_qkv_plain(qkv: torch.Tensor, heads: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v) of ``qkv`` (B, L, 3·D), q and k rotated; same contract as
    ``rope_qkv``."""
    d = qkv.shape[-1] // 3
    return (rope(qkv[..., :d], heads), rope(qkv[..., d:2 * d], heads),
            qkv[..., 2 * d:].contiguous())


def _lib() -> ctypes.CDLL:
    lib = build.load("rope")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rope_qkv_launch.argtypes = [p] * 5 + [ctypes.c_longlong] + \
            [i] * 3 + [p]
        lib.rope_qkv_launch.restype = i
        lib._bound = True
    return lib


def rope_qkv(qkv: torch.Tensor, heads: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v), each (B, L, D) contiguous, from the packed projection
    ``qkv`` (B, L, 3·D): q and k rotated (RoPE, angles ``p·θ^(-2j/dh)``),
    v as it is.  CPU tensors take ``rope_qkv_plain``; CUDA tensors launch
    the kernel: ``qkv`` bf16 and contiguous, head width a multiple of 8,
    nothing requiring grad, else this raises."""
    if qkv.device.type == "cpu":
        return rope_qkv_plain(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"rope_qkv: no kernel for device {qkv.device}")
    b, length, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads if heads else 0
    if d3 % 3 or heads < 1 or d % heads or dh % 8 or 3 * d // 8 > 1024:
        raise ValueError(f"rope_qkv: unsupported width {d3} / {heads} heads")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"rope_qkv: qkv must be bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("rope_qkv: qkv must be contiguous, 16-byte aligned")
    build.check_no_grad("rope_qkv", qkv)
    rot = rope_rotation(length, dh, qkv.device)
    q, k, v = (torch.empty((b, length, d), dtype=qkv.dtype,
                           device=qkv.device) for _ in range(3))
    build.launch("rope_qkv", qkv.device, _lib().rope_qkv_launch,
                 qkv.data_ptr(), rot.data_ptr(), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), b * length, length, d, dh,
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    rope_qkv.launches += 1
    return q, k, v


rope_qkv.launches = 0
