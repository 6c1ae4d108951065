"""The serving seam of a whole-song model that separates its own stems.

BS-RoFormer and SCNet are served alike behind an ``infer.Separator``: the
stem request is the model's own stem names as ``(S,)`` indices, kept per
stem list; no text prompts; whole songs on one device (no mesh, no
stream).  Each model module subclasses ``StemServing`` with its ``name``
and its ``separate`` (the model's forward)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch


class StemServing:
    """A model with ``stems`` behind an ``infer.Separator`` (see the module
    notes)."""

    name = "this model"

    def __init__(self, model, tokenizer):
        self.model, self.tokenizer = model, tokenizer
        self._stems_cache: Dict[tuple, torch.Tensor] = {}

    def separate(self, model, chunks, compute_dtype, kernels) -> torch.Tensor:
        """(n, 2, seg) chunks -> (n, stems, 2, seg): the model's forward."""
        raise NotImplementedError

    def check(self, path: str) -> None:
        """Whole songs on one device: no ``mesh``, no ``stream``."""
        raise ValueError(
            f"Separator: {self.name} runs on one device; no mesh"
            if path == "mesh" else f"StreamingSeparator: {self.name} is "
            "served whole-song only (separate_all_pcm, separate_pcm)")

    def text_embedding(self, prompt: str) -> torch.Tensor:
        raise TypeError(f"Separator: {self.name} takes stem names, not text "
                        "prompts")

    def stem_inputs(self, stems: Sequence[str]) -> torch.Tensor:
        key = tuple(stems)
        if key not in self._stems_cache:
            own = self.model.stems
            unknown = [s for s in key if s not in own]
            if unknown:
                raise ValueError(f"Separator: this {self.name} separates "
                                 f"{list(own)}; no stem {unknown}")
            self._stems_cache[key] = torch.tensor(
                [own.index(s) for s in key],
                device=next(self.model.parameters()).device)
        return self._stems_cache[key]

    def prompt_input(self, prompt: str) -> torch.Tensor:
        return self.stem_inputs([prompt])

    def blank_inputs(self, n: int) -> torch.Tensor:
        return torch.zeros((n,), dtype=torch.int64,
                           device=next(self.model.parameters()).device)

    def heads(self, model, chunks, picks, compute_dtype, kernels
              ) -> torch.Tensor:
        """(n, 2, seg) chunks, (S,) stem indices -> (n, S*2, seg)."""
        out = self.separate(model, chunks, compute_dtype, kernels)
        out = out.index_select(1, picks)
        return out.reshape(out.shape[0], -1, out.shape[-1])
