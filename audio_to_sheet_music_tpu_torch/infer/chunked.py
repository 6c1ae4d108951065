"""Chunked full-song separation with weighted overlap-add.

Counterpart of ``audio_to_sheet_music_tpu/infer/chunked.py``:

1. ``plan_chunks`` — the static plan for a song length, with the chunk
   count bucketed upward (padded chunks carry zero weight);
2. ``frame_song`` — the padded song as a batch of chunks;
3. the model runs over the chunk axis as a batch;
4. ``overlap_add_weighted`` — linear cross-fade accumulate, then division
   by the clamped weight sum (the reference's weighting: ones with
   ``linspace`` fades over ``overlap`` samples).

``separate_chunked`` runs all four for a chunk-batched model; everything
stays on the song's device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

DEFAULT_SEGMENT_SECONDS = 6.0
DEFAULT_OVERLAP_SECONDS = 1.5


@dataclasses.dataclass(frozen=True)
class ChunkGrid:
    """Static chunking plan for one (bucketed) song length."""

    segment: int          # chunk length, samples
    hop: int              # stride between chunk starts
    n_chunks: int         # bucketed chunk count (>= needed)
    length: int           # true song length, samples

    @property
    def padded_length(self) -> int:
        return (self.n_chunks - 1) * self.hop + self.segment


def plan_chunks(length: int, segment: int, overlap: int,
                bucket: int | str = "auto") -> ChunkGrid:
    """Chunk plan for a song of ``length`` samples: every chunk start below
    ``length`` contributes (``ceil(length / hop)`` chunks), rounded up to a
    multiple of ``bucket`` (``"auto"``: 2 up to 16 chunks, else 8)."""
    overlap = min(overlap, segment - 1)
    hop = segment - overlap
    needed = max(1, math.ceil(length / hop))
    if bucket == "auto":
        bucket = 2 if needed <= 16 else 8
    n = math.ceil(needed / bucket) * bucket
    return ChunkGrid(segment=segment, hop=hop, n_chunks=n, length=length)


def fade_weights(segment: int, overlap: int, device=None) -> torch.Tensor:
    """Ones with linear fade-in/out over ``overlap`` samples, composed as
    ``min(fade_in, fade_out)`` so long overlaps give a symmetric triangle.

    One tensor per ``(segment, overlap, device)``, kept as
    ``ops.fused_norm.lerp_taps`` keeps its taps: a host-to-device copy on
    every call would make the host wait for the card, and cannot be
    captured in a CUDA graph (``infer.programs``).  Made outside inference
    mode, so training can use it too.  Callers must not write into it."""
    return _fade_weights(segment, overlap, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=64)
def _fade_weights(segment: int, overlap: int, device: torch.device
                  ) -> torch.Tensor:
    w = np.ones(segment, np.float32)
    if overlap > 1:
        ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
        w[:overlap] = np.minimum(w[:overlap], ramp)
        w[segment - overlap:] = np.minimum(w[segment - overlap:], ramp[::-1])
    with torch.inference_mode(False):
        return torch.from_numpy(w).to(device)


def frame_song(x: torch.Tensor, grid: ChunkGrid, padded: bool = False
               ) -> torch.Tensor:
    """``(C, T)`` song -> ``(n_chunks, C, segment)`` chunk batch (zero-pads
    to the grid unless ``padded``)."""
    if not padded:
        x = torch.nn.functional.pad(x, (0, grid.padded_length - x.shape[-1]))
    return x.unfold(-1, grid.segment, grid.hop).transpose(0, 1)


def overlap_add_weighted(chunks: torch.Tensor, grid: ChunkGrid, overlap: int,
                         valid_mask: torch.Tensor | None = None,
                         normalize: bool = True):
    """``(n_chunks, C, segment)`` -> ``(C, length)`` weighted overlap-add.

    ``valid_mask (n,)`` zeroes padded bucket chunks.  ``normalize=False``
    returns the raw ``(acc (C, padded), wsum (padded,))`` pair, which the
    group pipeline carries across group boundaries before normalising.
    """
    n, c, seg = chunks.shape
    w = fade_weights(seg, overlap, chunks.device).to(chunks.dtype)
    wn = w.expand(n, seg)
    if valid_mask is not None:
        wn = wn * valid_mask[:, None].to(chunks.dtype)
    weighted = chunks * wn[:, None, :]
    total = grid.padded_length
    acc = chunks.new_zeros((c, total))
    wsum = chunks.new_zeros((total,))
    for i in range(n):
        s = i * grid.hop
        acc[:, s:s + seg] += weighted[i]
        wsum[s:s + seg] += wn[i]
    if not normalize:
        return acc, wsum
    out = acc / torch.clamp(wsum, min=1e-8)[None, :]
    return out[:, : grid.length]


def separate_chunked(forward_fn: Callable[[torch.Tensor], torch.Tensor],
                     mixture: torch.Tensor, segment: int, overlap: int,
                     bucket: int = 8, chunk_batch: int | None = None
                     ) -> torch.Tensor:
    """Separate a whole ``(C, T)`` song through a chunk-batched model.

    ``forward_fn`` maps ``(B, C, segment)`` chunks to ``(B, C', segment)``.
    ``chunk_batch`` caps the chunks a call takes (``None``: all at once);
    the last call takes what is left.  Padded bucket chunks carry zero
    overlap-add weight.  Returns ``(C', T)`` on the song's device."""
    grid = plan_chunks(int(mixture.shape[-1]), segment, overlap, bucket)
    chunks = frame_song(mixture, grid)
    n = grid.n_chunks
    step = n if chunk_batch is None else chunk_batch
    outs = torch.cat([forward_fn(chunks[i:i + step])
                      for i in range(0, n, step)])
    valid = (torch.arange(n, device=mixture.device) * grid.hop) < grid.length
    return overlap_add_weighted(outs, grid, overlap, valid)
