"""Streaming separation: bounded memory, incremental output.

Counterpart of ``audio_to_sheet_music_tpu/infer/streaming.py``.  Feed
samples as they arrive and receive separated samples as soon as their
overlap-add weights are final; memory is O(block), whatever the stream's
length.

The chunk grid is global (chunk ``k`` starts at ``k * hop``).  A block of
``block_chunks`` consecutive chunks runs through the separator's program
for that block (``Separator._run_stream_block``: ``_stream_block``, the
encoder once and every stem's head in one batched pass, captured once per
geometry) and returns the unnormalised ``(acc, wsum)`` pair.  The
overlapping tail (``segment - hop`` samples) carries into the next block,
so the emitted audio equals the offline separation away from the stream's
edges.

The carry stays on the device; only each emitted piece, already divided by
its weights, is copied to the host.  ``(acc, wsum)`` are the program's
outputs, which its next replay rewrites: the carry is added into them in
place, and each step copies the emitted piece to the host and clones the
new carry before the next block runs.  The input buffer is on the host, as
the samples arrive there; each block goes to the program from pinned
memory.

Spans and counters (``utils.profiling``): ``atsm.stream.open`` over
construction, ``atsm.stream.feed``, ``atsm.stream.flush``, and within them
``atsm.stream.block`` a block (its program, the carry, its piece to the
host), counted in ``stream.blocks``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..parallel import mesh as meshlib
from ..text.prompts import STEM_NAMES
from ..utils import profiling


class StreamingSeparator:
    """Incremental multi-stem separation over an audio stream.

    Usage::

        stream = StreamingSeparator(separator, stems=("vocals",))
        for piece in stream.feed(samples):   # (n_stems, 2, n) pieces
            play(piece)
        tail = stream.flush()

    On a separator with a mesh, ``block_chunks`` rounds up to a multiple of
    the mesh's size: the block's chunk axis splits over it.
    """

    def __init__(self, separator, stems: Sequence[str] = STEM_NAMES,
                 block_chunks: int = 8):
        separator.serving.check("stream")
        with profiling.span("atsm.stream.open"):
            self.sep = separator
            self.stems = list(stems)
            if separator.mesh is not None:
                block_chunks = meshlib.pad_to_multiple(block_chunks,
                                                       separator.mesh.size)
            self.block_chunks = block_chunks
            self.segment = separator.segment
            # the plan_chunks clamp: overlap >= segment would make hop <= 0
            # and feed() would never drain its buffer
            self.overlap = min(separator.overlap, self.segment - 1)
            self.hop = self.segment - self.overlap
            self._embs = separator.serving.stem_inputs(self.stems)
            self._buf = np.zeros((2, 0), np.float32)        # pending input
            self._acc = None                                # carry (S*2, tail)
            self._wsum = None                               # carry (tail,)
            self._span = (block_chunks - 1) * self.hop + self.segment

    def _emit(self, acc: torch.Tensor, wsum: torch.Tensor, n: int
              ) -> np.ndarray:
        out = acc[:, :n] / torch.clamp(wsum[:n], min=1e-8)[None, :]
        return out.reshape(len(self.stems), 2, -1).cpu().numpy()

    def feed(self, samples: np.ndarray) -> list[np.ndarray]:
        """Append ``(2, n)`` samples; return the finalised ``(S, 2, m)``
        pieces (possibly none).

        Eager (a list, not a generator): the buffer changes on the call
        itself, so un-iterated or interleaved calls never drop or reorder
        audio."""
        with profiling.span("atsm.stream.feed"):
            self._buf = np.concatenate(
                [self._buf, np.asarray(samples, np.float32)], axis=-1)
            advance = self.block_chunks * self.hop
            pieces = []
            while self._buf.shape[-1] >= self._span:
                with profiling.span("atsm.stream.block"):
                    acc, wsum = self._run_block(self._buf[:, : self._span])
                    # samples at or past ``advance`` still take weight from
                    # the next block
                    pieces.append(self._slide(acc, wsum, advance))
            return pieces

    @torch.inference_mode()
    def _run_block(self, song: np.ndarray):
        """One block plus the carry in -> ``(acc, wsum)`` on the device: the
        one home of the carry recurrence, shared by ``feed`` and ``flush``."""
        profiling.count("stream.blocks")
        acc, wsum = self.sep._run_stream_block(song, self._embs,
                                               self.block_chunks, self.hop)
        if self._acc is not None:
            tail = self._acc.shape[-1]
            acc[:, :tail] += self._acc
            wsum[:tail] += self._wsum
        return acc, wsum

    @torch.inference_mode()
    def _slide(self, acc, wsum, advance: int) -> np.ndarray:
        """Emit ``advance`` finalised samples, carry the rest, drop the
        consumed input."""
        piece = self._emit(acc, wsum, advance)
        self._acc = acc[:, advance:].clone()
        self._wsum = wsum[advance:].clone()
        self._buf = self._buf[:, advance:]
        return piece

    @torch.inference_mode()
    def flush(self) -> np.ndarray:
        """Finalise the buffered audio; returns ``(S, 2, m)``.

        Every chunk whose start lies inside the remaining audio contributes
        (the offline valid-chunk rule), so a short tail may run several
        zero-padded blocks."""
        with profiling.span("atsm.stream.flush"):
            advance = self.block_chunks * self.hop
            pieces = []
            while self._buf.shape[-1] > 0:
                n = self._buf.shape[-1]
                with profiling.span("atsm.stream.block"):
                    song = np.zeros((2, self._span), np.float32)
                    take = min(n, self._span)
                    song[:, :take] = self._buf[:, :take]
                    acc, wsum = self._run_block(song)
                    n_chunks_needed = (n - 1) // self.hop + 1   # starts < n
                    if n_chunks_needed <= self.block_chunks:
                        pieces.append(self._emit(acc, wsum, n))
                        break
                    pieces.append(self._slide(acc, wsum, advance))
            if not pieces and self._acc is not None:
                pieces.append(self._emit(self._acc, self._wsum,
                                         self._acc.shape[-1]))
            self._buf = np.zeros((2, 0), np.float32)
            self._acc = self._wsum = None
            return (np.concatenate(pieces, axis=-1) if pieces
                    else np.zeros((len(self.stems), 2, 0), np.float32))
