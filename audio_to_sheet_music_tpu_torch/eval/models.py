"""Benchmark model registry: the reference ``SeparationModel`` and its
three implementations.

Counterpart of ``audio_to_sheet_music_tpu/eval/models.py``:

- ``OursModel``: the text-conditioned model through the port's
  ``Separator`` (all stems in one sweep);
- ``HTDemucsBaseline``: the frozen 4-source HTDemucs (``htdemucs.forward``)
  over 7.8 s chunks with 25 % overlap, the reference's
  ``demucs.apply_model(split=True, overlap=0.25)`` protocol;
- ``CLAPSepModel``: the CLAPSep baseline (``models.clapsep``) under the
  reference's protocol, in f32.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from ..convert.torch_import import load_into, load_torch_state_dict
from ..infer import chunked
from ..infer.session import SAMPLE_RATE, Separator, open_device
from ..models import atht, clap_text, clapsep, htdemucs
from ..ops.select import Kernels, resolve
from ..text.prompts import STEM_NAMES
from ..text.tokenizer import default_tokenizer
from ..utils import audio_io


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
    it (``device``, ``kernels``, ...)."""

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


class CLAPSepModel(SeparationModel):
    """The CLAPSep baseline under the reference protocol: stereo -> mono
    mean, 44.1 -> 32 kHz, 10 s chunks with 1 s overlap (``plan_chunks``,
    bucket 2) through ``clapsep.forward`` with the stem's
    ``CLAPSEP_PROMPTS`` query and an empty negative query, the weighted
    overlap-add (padded chunks weigh 0), back to 44.1 kHz, stereo by
    duplication.

    The separator's weights come from ``weights`` or ``ATSM_CLAPSEP_CKPT``
    (a ``.pt`` / ``.ckpt`` state dict, loaded non-strictly); without one it
    keeps its seeded init and says so in its name.  A weights file that is
    not there raises ``RuntimeError``, which the benchmark takes as "skip
    this model", as the reference does when its download fails.  ``clap``
    is the text tower of the queries (default: the seeded full-width one).
    The model computes in f32 on ``device`` (``cuda`` unless the caller
    asks for the CPU)."""

    def __init__(self, clap: clap_text.ClapText | None = None,
                 weights: str | None = None,
                 cfg: clapsep.ClapSepConfig | None = None, tokenizer=None,
                 chunk_seconds: float | None = None,
                 overlap_seconds: float | None = None,
                 pretrained: bool = False, device: str | torch.device = "cuda"):
        self.device = open_device(device, "CLAPSepModel")
        self.cfg = cfg or clapsep.ClapSepConfig()
        self.chunk_seconds = (clapsep.CHUNK_SECONDS if chunk_seconds is None
                              else chunk_seconds)
        self.overlap_seconds = (clapsep.OVERLAP_SECONDS
                                if overlap_seconds is None
                                else overlap_seconds)
        weights = weights or os.environ.get("ATSM_CLAPSEP_CKPT")
        self.name = ("CLAPSep (Baseline)" if weights
                     else "CLAPSep (random init)")
        model = clapsep.ClapSep(self.cfg, gen=torch.Generator().manual_seed(0))
        if weights:
            if not Path(weights).exists():
                raise RuntimeError(f"CLAPSep weights not found at {weights}; "
                                   "skipping")
            load_into(model, load_torch_state_dict(weights), strict=False)
        else:
            print("CLAPSep: no weights provided, running with random init "
                  "(set ATSM_CLAPSEP_CKPT to load a checkpoint)")
        self.model = model.to(self.device).requires_grad_(False)
        if clap is None:
            clap = clap_text.ClapText(gen=torch.Generator().manual_seed(1))
        self.clap = clap.to(self.device).requires_grad_(False)
        self._tok = tokenizer or default_tokenizer(
            require_real=pretrained or bool(weights))
        self._emb_cache: Dict[str, torch.Tensor] = {}

    def _text_embedding(self, prompt: str) -> torch.Tensor:
        if prompt not in self._emb_cache:
            ids, mask = self._tok([prompt])
            self._emb_cache[prompt] = clap_text.get_text_features(
                self.clap, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))[0]
        return self._emb_cache[prompt]

    @torch.inference_mode()
    def separate(self, mixture, stem) -> np.ndarray:
        mix = np.asarray(mixture, np.float32)
        t44 = mix.shape[-1]
        mono32 = audio_io.resample(mix.mean(axis=0, keepdims=True),
                                   SAMPLE_RATE, clapsep.SAMPLE_RATE)
        seg = int(self.chunk_seconds * clapsep.SAMPLE_RATE)
        ov = int(self.overlap_seconds * clapsep.SAMPLE_RATE)
        pos = self._text_embedding(clapsep.CLAPSEP_PROMPTS.get(stem, stem))
        neg = self._text_embedding("")
        grid = chunked.plan_chunks(mono32.shape[-1], seg, ov, bucket=2)
        chunks = chunked.frame_song(
            torch.from_numpy(np.ascontiguousarray(mono32)).to(self.device),
            grid)                                           # (n, 1, L)
        n = grid.n_chunks
        outs = clapsep.forward(self.model, chunks[:, 0, :],
                               pos.expand(n, -1), neg.expand(n, -1))
        valid = (torch.arange(n, device=self.device) * grid.hop) < grid.length
        out32 = chunked.overlap_add_weighted(outs[:, None, :], grid, ov, valid)
        out44 = audio_io.resample(out32.cpu().numpy(), clapsep.SAMPLE_RATE,
                                  SAMPLE_RATE)
        if out44.shape[-1] < t44:
            out44 = np.pad(out44, ((0, 0), (0, t44 - out44.shape[-1])))
        return np.repeat(out44[:, :t44], 2, axis=0)
