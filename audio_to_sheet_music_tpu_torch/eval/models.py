"""Benchmark model registry: the reference ``SeparationModel`` and two of
its implementations.

Counterpart of ``audio_to_sheet_music_tpu/eval/models.py``:

- ``OursModel``: the text-conditioned model through the port's
  ``Separator`` (all stems in one sweep);
- ``HTDemucsBaseline``: the frozen 4-source HTDemucs (``htdemucs.forward``)
  over 7.8 s chunks with 25 % overlap, the reference's
  ``demucs.apply_model(split=True, overlap=0.25)`` protocol.

The JAX package's third model, the CLAPSep baseline, is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..infer import chunked
from ..infer.session import SAMPLE_RATE, Separator, open_device
from ..models import atht, htdemucs
from ..ops.select import Kernels, resolve
from ..text.prompts import STEM_NAMES


class SeparationModel:
    """``separate(mixture, stem)`` / ``separate_all(mixture)`` on ``(2, T)``
    float32 host arrays."""

    name = "base"

    def separate(self, mixture: np.ndarray, stem: str) -> np.ndarray:
        raise NotImplementedError

    def separate_all(self, mixture: np.ndarray) -> Mapping[str, np.ndarray]:
        return {stem: self.separate(mixture, stem) for stem in STEM_NAMES}


class OursModel(SeparationModel):
    """AudioTextHTDemucs through the port's ``Separator``; ``kwargs`` go to
    it (``device``, ``kernels``, ``pretrained``, ...)."""

    name = "AudioTextHTDemucs (Ours)"

    def __init__(self, model: atht.AudioTextHTDemucs, **kwargs):
        self._sep = Separator(model, **kwargs)

    def separate(self, mixture, stem):
        return self._sep.separate(mixture, stem)

    def separate_all(self, mixture):
        return self._sep.separate_all(mixture)


class HTDemucsBaseline(SeparationModel):
    """Frozen 4-source HTDemucs with demucs-style chunking.

    ``ht`` moves to ``device`` (``cuda`` unless the caller asks for the CPU)
    and is frozen.  ``compute_dtype`` defaults to bf16 on the card and f32
    on the CPU; ``kernels`` is an ``ops.select`` selection.  The name says
    "(pretrained)" only when the caller loaded real tower weights."""

    def __init__(self, ht: htdemucs.HTDemucs, segment_seconds: float = 7.8,
                 overlap_ratio: float = 0.25,
                 compute_dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda", kernels: Kernels = True,
                 pretrained: bool = False):
        self.name = ("HTDemucs (pretrained)" if pretrained
                     else "HTDemucs (random init)")
        self.device = open_device(device, "HTDemucsBaseline")
        self.ht = ht.to(self.device).requires_grad_(False)
        self.segment = int(segment_seconds * SAMPLE_RATE)
        self.overlap = int(self.segment * overlap_ratio)
        if compute_dtype is None:
            compute_dtype = (torch.float32 if self.device.type == "cpu"
                             else torch.bfloat16)
        self.compute_dtype = compute_dtype
        self.kernels = resolve(kernels)

    def _forward_stems(self, chunks: torch.Tensor) -> torch.Tensor:
        """(n, 2, L) chunks -> (n, 8, L): the 4 stereo sources as rows."""
        out = htdemucs.forward(self.ht, chunks, self.compute_dtype,
                               self.kernels)
        n, s, c, length = out.shape
        return out.reshape(n, s * c, length)

    @torch.inference_mode()
    def separate_all(self, mixture) -> Dict[str, np.ndarray]:
        """Framing, the forward, the overlap-add on the device; one copy of
        the (8, T) result to the host."""
        mix = torch.from_numpy(np.ascontiguousarray(mixture, np.float32))
        flat = chunked.separate_chunked(self._forward_stems,
                                        mix.to(self.device), self.segment,
                                        self.overlap)
        out = flat.cpu().numpy().reshape(len(STEM_NAMES), 2, -1)
        return {stem: out[i] for i, stem in enumerate(STEM_NAMES)}

    def separate(self, mixture, stem):
        return self.separate_all(mixture)[stem]
