"""Which hand-written kernels a forward runs: the JAX package's switches.

The JAX package picks its Pallas kernels with process-wide environment
variables read at trace time (``ATSM_PALLAS_LAYER``, ``ATSM_PALLAS_ENC``,
``ATSM_PALLAS_ATTN``, ``ATSM_PALLAS_DCONV``, ``ATSM_PALLAS_STFT``).  The port
reads no environment: every entry point takes a ``kernels`` argument that
``resolve`` turns into a ``KernelSelection``.

- ``True`` or ``"default"``: ``layer`` + ``enc``, the JAX TPU default
  (every crosstransformer layer through ``layer_tail``, freq encoder layer 0
  through ``henc_freq_fused``, each where the kernel takes the widths).
- ``"opt_in"``: ``enc`` + ``dconv`` + ``attn`` + ``stft`` with ``layer``
  off: ``ATSM_PALLAS_LAYER=0 ATSM_PALLAS_ATTN=1 ATSM_PALLAS_DCONV=1
  ATSM_PALLAS_STFT=1`` in the JAX package.
- ``False``, ``None`` or ``"none"``: the per-op path, none of these five.

BS-RoFormer (``models.bs_roformer``, no JAX counterpart) sends its
attention to ``fused_attn.attn_gated`` and its RoPE to
``fused_rope.rope_qkv`` where ``layer`` or ``attn`` is on.

The JAX precedence rules hold: ``layer`` subsumes ``attn``; with ``enc`` on,
freq layer 0 goes whole into ``henc_freq_fused``, so ``dconv`` takes the
freq DConv of the other layers; ``dconv`` never takes the time branch.

GroupNorm is no part of the selection: on the card every norm of the
model goes through ``fused_norm.group_norm`` under any selection, as any
op follows its tensor's device.  Its launches are counted here with the
others'.

``LAYERS`` holds counters of model layers that run no hand-written
kernel, registered by the model module that counts them when it is
imported: each is counted, zeroed and booked through a program's replays
as a kernel's launches are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union


@dataclasses.dataclass(frozen=True)
class KernelSelection:
    layer: bool = False     # ops.fused_attn.layer_tail
    enc: bool = False       # ops.fused_enc.henc_freq_fused
    attn: bool = False      # ops.fused_attn.attn_block
    dconv: bool = False     # ops.fused_dconv.dconv_rows
    stft: bool = False      # ops.fused_stft.stft


DEFAULT = KernelSelection(layer=True, enc=True)
OPT_IN = KernelSelection(enc=True, attn=True, dconv=True, stft=True)
NONE = KernelSelection()

PRESETS = {"default": DEFAULT, "opt_in": OPT_IN, "none": NONE}

Kernels = Union[KernelSelection, bool, str, None]


def resolve(kernels: Kernels) -> KernelSelection:
    """``kernels`` argument -> ``KernelSelection`` (see the module notes)."""
    if isinstance(kernels, KernelSelection):
        return kernels
    if kernels is True:
        return DEFAULT
    if kernels is False or kernels is None:
        return NONE
    if isinstance(kernels, str) and kernels in PRESETS:
        return PRESETS[kernels]
    raise ValueError(f"unknown kernel selection {kernels!r}: expected a "
                     f"KernelSelection, a bool, None or one of "
                     f"{sorted(PRESETS)}")


def name(sel: KernelSelection) -> str:
    """The preset's name for ``sel`` (``"default"``, ``"opt_in"``,
    ``"none"``), else the flags that are on, joined by ``+``."""
    for key, preset in PRESETS.items():
        if sel == preset:
            return key
    return "+".join(f.name for f in dataclasses.fields(sel)
                    if getattr(sel, f.name))


class LayerCount:
    """A model layer's call counter, in ``launches`` as a kernel wrapper
    keeps its count."""

    def __init__(self):
        self.launches = 0


# model layers counted beside the kernels, by name (see the module notes)
LAYERS: Dict[str, LayerCount] = {}


def _wrappers() -> Dict[str, object]:
    """Each kernel's wrapper, by kernel name, and each counted layer;
    each counts its launches in its ``launches`` attribute."""
    from . import (fused_attn, fused_dconv, fused_enc, fused_norm, fused_rope,
                   fused_stft)

    return {"layer_tail": fused_attn.layer_tail,
            "henc_freq_fused": fused_enc.henc_freq_fused,
            "dconv_rows": fused_dconv.dconv_rows,
            "attn_block": fused_attn.attn_block, "stft": fused_stft.stft,
            "group_norm": fused_norm.group_norm,
            "dec_join": fused_norm.decoder_join,
            "attn_gated": fused_attn.attn_gated,
            "rope_qkv": fused_rope.rope_qkv, **LAYERS}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter in this process, by name."""
    return {k: fn.launches for k, fn in _wrappers().items()}


def zero_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches, possibly negative) to the
    kernels' counters: how ``infer.programs.Program`` books the launches a
    graph replay makes, which no wrapper sees."""
    wrappers = _wrappers()
    for k, n in counts.items():
        wrappers[k].launches += n
