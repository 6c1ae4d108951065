"""Which hand-written kernels a forward runs: the JAX package's switches.

The JAX package picks its Pallas kernels with process-wide environment
variables read at trace time (``ATSM_PALLAS_LAYER``, ``ATSM_PALLAS_ENC``,
``ATSM_PALLAS_ATTN``, ``ATSM_PALLAS_DCONV``, ``ATSM_PALLAS_STFT``).  The port
reads no environment: every entry point takes a ``kernels`` argument that
``resolve`` turns into a ``KernelSelection``.

- ``True`` or ``"default"``: ``layer`` + ``enc``, the JAX TPU default
  (every crosstransformer layer through ``layer_tail``, freq encoder layer 0
  through ``henc_freq_fused``).
- ``"opt_in"``: ``enc`` + ``dconv`` + ``attn`` + ``stft`` with ``layer``
  off: ``ATSM_PALLAS_LAYER=0 ATSM_PALLAS_ATTN=1 ATSM_PALLAS_DCONV=1
  ATSM_PALLAS_STFT=1`` in the JAX package.
- ``False``, ``None`` or ``"none"``: the per-op path, no kernel at all.

The JAX precedence rules hold: ``layer`` subsumes ``attn``; with ``enc`` on,
freq layer 0 goes whole into ``henc_freq_fused``, so ``dconv`` takes the
freq DConv of the other layers; ``dconv`` never takes the time branch.
"""

from __future__ import annotations

import dataclasses
from typing import Union


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
