"""Separator — the inference session the entry points share.

Counterpart of ``audio_to_sheet_music_tpu/infer/session.py``.  It owns the
model on its device, a prompt -> embedding cache (the text tower runs once
per distinct prompt) and the chunked sweeps:

- ``separate`` / ``separate_all``: the whole song's chunks as one batch,
  the frozen encoder once, every stem's head as one batched pass, weighted
  overlap-add, float32 stems back on the host;
- ``separate_pcm``: ``separate`` quantised on the device to absolute-level
  int16 (``sample = pcm / 32767``), one int16 copy to the host: the HTTP
  server's hot path;
- ``separate_all_pcm``: the serving path.  Chunks run in groups
  (``[g/2, g, g, ...]``); each group encodes, runs every stem head, adds its
  unnormalised overlap-add to the carry from the group before, and
  quantises the samples whose weights are final to int16 against one shared
  scale (2 x the mixture's peak).  Each group's PCM goes to the host in one
  copy into pinned memory on a side stream, so it overlaps later groups;
- ``_stream_block``: one block of ``infer.streaming.StreamingSeparator``:
  ``block_chunks`` chunks through the encoder once and every stem's head,
  returning the unnormalised overlap-add ``(acc, wsum)`` on the device.

The JAX package caches one jitted program per chunk geometry; eager
PyTorch has nothing to cache, so every sweep above goes through the same
``_heads``.

On the card the model computes in bf16 (f32 for the STFT, the norms'
statistics and the text tower); on the CPU in f32.  The CUDA path sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False: every f32 product it does
(text tower, f32 statistics, the plain versions it is checked against) is
true f32.  A ``Separator`` built with ``deterministic=True`` (the serving
app's, ``apps/serve.build_separator``) runs its chunk programs with
``torch.backends.cudnn.deterministic`` set, so a request repeats bit for
bit; the flag is restored after each program, so training and evaluation
in the same process keep cuDNN's free choice of algorithms.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..models import atht
from ..ops.select import Kernels, resolve
from ..text.prompts import STEM_NAMES
from ..text.tokenizer import default_tokenizer
from . import chunked

SAMPLE_RATE = 44100


def set_precision_flags() -> None:
    """No TF32 anywhere: f32 products and convolutions are true f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def cudnn_deterministic(on: bool = True) -> Iterator[None]:
    """With ``on``, cuDNN takes deterministic algorithms inside the block
    and the process's setting comes back after it; without, a no-op.  On
    the H100 the head's bf16 convolutions otherwise differ by a few int16
    steps between two sweeps of one song (``chip_smoke.py --profile``
    prints both settings).  The flag is process-wide: the server holds its
    device lock around every sweep, so no other sweep sees it."""
    if not on:
        yield
        return
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def open_device(device: str | torch.device, who: str) -> torch.device:
    """``device`` as a ``torch.device``.  ``cuda`` needs a card (``who``
    names the caller that raises without one) and sets
    ``set_precision_flags``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        set_precision_flags()
    return device


def _to_float_song(song: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> f32 in [-1, 1) on the song's device; f32 passes."""
    if song.dtype == torch.int16:
        return song.float() * (1.0 / 32768.0)
    return song.float()


class Separator:
    """Text-conditioned full-song stem separation."""

    def __init__(self, model: atht.AudioTextHTDemucs,
                 segment_seconds: float = chunked.DEFAULT_SEGMENT_SECONDS,
                 overlap_seconds: float = chunked.DEFAULT_OVERLAP_SECONDS,
                 compute_dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda", tokenizer=None,
                 normalize_text: bool = False,
                 sample_rate: int = SAMPLE_RATE,
                 kernels: Kernels = True, deterministic: bool = False):
        """``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the
        host.  ``compute_dtype`` defaults to bf16 on the card and f32 on the
        CPU.  A model marked ``pretrained`` (``atht.load_params`` of a
        ``.pt`` marks it) makes the tokenizer refuse the hash fallback,
        which is meaningless for a pretrained text tower.
        ``kernels`` picks the hand-written kernels (``ops.select``: the
        default selection, ``"opt_in"``, or ``False`` for the encoder layer
        by layer in PyTorch ops, the yardstick the kernels are timed
        against).  ``deterministic=True`` runs every chunk program under
        ``cudnn_deterministic``, so two calls give the same bytes."""
        self.device = open_device(device, "Separator")
        self.model = model.to(self.device)
        self.sample_rate = sample_rate
        self.segment = int(segment_seconds * sample_rate)
        self.overlap = int(overlap_seconds * sample_rate)
        if compute_dtype is None:
            compute_dtype = (torch.float32 if self.device.type == "cpu"
                             else torch.bfloat16)
        self.compute_dtype = compute_dtype
        self.normalize_text = normalize_text
        self.pretrained = model.pretrained
        self.tokenizer = tokenizer or default_tokenizer(
            require_real=model.pretrained)
        self.bucket = "auto"
        self.kernels = resolve(kernels)
        self.deterministic = deterministic
        self._emb_cache: Dict[str, torch.Tensor] = {}

    # -- text ---------------------------------------------------------------

    @torch.inference_mode()
    def text_embedding(self, prompt: str) -> torch.Tensor:
        """(512,) f32 CLAP embedding on the device, cached per prompt."""
        if prompt not in self._emb_cache:
            ids, mask = self.tokenizer([prompt])
            emb = atht.encode_text(
                self.model, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device), self.normalize_text)
            self._emb_cache[prompt] = emb[0]
        return self._emb_cache[prompt]

    def _stem_embs(self, stems: Sequence[str]) -> torch.Tensor:
        return torch.stack([self.text_embedding(s) for s in stems])

    # -- chunk programs -------------------------------------------------------

    def _heads(self, chunks: torch.Tensor, embs: torch.Tensor) -> torch.Tensor:
        """(n, 2, seg) chunks -> (n, S*2, seg): encoder once, all stems."""
        with cudnn_deterministic(self.deterministic):
            enc = atht.encode_mixture(self.model, chunks, self.compute_dtype,
                                      self.kernels)
            # (S, n, 2, L)
            stacked = atht.apply_head_multi(self.model, enc, embs)
        s_, b_, c_, l_ = stacked.shape
        return stacked.permute(1, 0, 2, 3).reshape(b_, s_ * c_, l_)

    def _upload(self, mixture: np.ndarray) -> torch.Tensor:
        song = np.ascontiguousarray(mixture)
        if song.dtype not in (np.int16, np.float32):
            song = song.astype(np.float32)
        return torch.from_numpy(song).to(self.device)

    # -- separation ---------------------------------------------------------

    @torch.inference_mode()
    def _sweep_on_device(self, mixture: np.ndarray, embs: torch.Tensor
                         ) -> torch.Tensor:
        """Whole-song sweep -> (S*2, T) float32 on the device."""
        length = int(np.shape(mixture)[-1])
        grid = chunked.plan_chunks(length, self.segment, self.overlap,
                                   self.bucket)
        song = _to_float_song(self._upload(mixture))
        song = torch.nn.functional.pad(song, (0, grid.padded_length - length))
        flat = self._heads(chunked.frame_song(song, grid, padded=True), embs)
        valid = (torch.arange(grid.n_chunks, device=self.device)
                 * grid.hop) < length
        out = chunked.overlap_add_weighted(flat, grid, self.overlap, valid)
        return out.float()

    def _sweep(self, mixture: np.ndarray, embs: torch.Tensor) -> np.ndarray:
        """Whole-song sweep -> (S*2, T) float32 on the host."""
        return self._sweep_on_device(mixture, embs).cpu().numpy()

    @torch.inference_mode()
    def separate(self, mixture: np.ndarray, prompt: str) -> np.ndarray:
        """(2, T) mixture (float32 or int16 PCM) + free-text prompt ->
        (2, T) float32 stem: 6 s chunks, linear cross-fade overlap-add,
        weight renormalisation."""
        return self._sweep(mixture, self.text_embedding(prompt)[None])

    @torch.inference_mode()
    def separate_pcm(self, mixture: np.ndarray, prompt: str) -> np.ndarray:
        """``separate`` as absolute-level int16 ``(2, T)``: ``pcm / 32767``
        is the float stem, clipped at ±32767 as an int16 WAV write clips.
        The quantisation runs on the device; one int16 copy comes back,
        whose bytes go into a WAV as they are.  (The JAX package rounds
        twice, to its shared-scale wire format and then to this level; one
        rounding here, so the two differ by at most one step while the
        stem's peak stays under 1.)"""
        out = self._sweep_on_device(mixture, self.text_embedding(prompt)[None])
        q = torch.clamp(torch.round(out * 32767.0), -32767, 32767)
        return q.to(torch.int16).cpu().numpy()

    @torch.inference_mode()
    def _stream_block(self, song: torch.Tensor, embs: torch.Tensor,
                      block_chunks: int, hop: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One streaming block: ``song (2, span)`` f32 on the device, with
        ``span = (block_chunks - 1) * hop + segment`` -> the unnormalised
        overlap-add ``(acc (S*2, span), wsum (span,))`` f32 on the device.
        The encoder runs once over the block's chunks and every stem's head
        in one batched pass; every chunk carries full weight (the stream
        decides which samples are final)."""
        seg = self.segment
        span = (block_chunks - 1) * hop + seg
        grid = chunked.ChunkGrid(segment=seg, hop=hop, n_chunks=block_chunks,
                                 length=span)
        flat = self._heads(chunked.frame_song(song, grid, padded=True), embs)
        return chunked.overlap_add_weighted(flat.float(), grid, seg - hop,
                                            normalize=False)

    @torch.inference_mode()
    def separate_all(self, mixture: np.ndarray,
                     stems: Sequence[str] = STEM_NAMES
                     ) -> Mapping[str, np.ndarray]:
        """All stems for one mixture; the frozen encoder runs once per chunk."""
        flat = self._sweep(mixture, self._stem_embs(stems))
        out = flat.reshape(len(stems), 2, -1)
        return {stem: out[i] for i, stem in enumerate(stems)}

    def _group_schedule(self, grid: chunked.ChunkGrid,
                        group_chunks: int) -> List[int]:
        """Group sizes for the pipelined PCM sweep: a half-size first group
        (shorter pipeline fill), then full groups covering the grid."""
        g = max(1, min(group_chunks, grid.n_chunks))
        schedule = []
        if grid.n_chunks > g and g >= 2:
            schedule.append(g // 2)
        left = grid.n_chunks - sum(schedule)
        schedule += [g] * max(0, -(-left // g))
        return schedule

    @torch.inference_mode()
    def _group(self, song: torch.Tensor, embs: torch.Tensor, g: int, hop: int,
               start: int, length: int, scale: float, carry_acc, carry_w
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One group: ``song (2, span)`` -> (pcm int16 (S*2, g*hop),
        carry_acc', carry_w').  Chunks whose global start is at or past
        ``length`` carry zero weight."""
        seg = self.segment
        grid = chunked.ChunkGrid(segment=seg, hop=hop, n_chunks=g,
                                 length=(g - 1) * hop + seg)
        flat = self._heads(chunked.frame_song(_to_float_song(song), grid,
                                              padded=True), embs)
        valid = (start + torch.arange(g, device=self.device) * hop) < length
        acc, wsum = chunked.overlap_add_weighted(flat, grid, self.overlap,
                                                 valid, normalize=False)
        acc[:, : carry_acc.shape[-1]] += carry_acc
        wsum[: carry_w.shape[-1]] += carry_w
        advance = g * hop
        emit = acc[:, :advance] / torch.clamp(wsum[:advance], min=1e-8)
        q = torch.clamp(torch.round(emit / scale * 32767.0), -32768, 32767)
        return q.to(torch.int16), acc[:, advance:], wsum[advance:]

    @torch.inference_mode()
    def separate_all_pcm(self, mixture: np.ndarray,
                         stems: Sequence[str] = STEM_NAMES,
                         group_chunks: int = 4, absolute: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """All stems as 16-bit PCM: ``(pcm int16 (S, 2, T), scales (S,))``
        with ``sample = pcm * scale / 32767``.

        The shared scale is ``2 x peak(|mixture|)`` (one bit of headroom,
        inter-stem levels preserved); ``absolute=True`` uses scale 1, so the
        PCM is the float stem clipped at ±1, as a float->int16 WAV write.
        """
        n_stems = len(stems)
        song = np.ascontiguousarray(mixture)
        length = int(song.shape[-1])
        if absolute:
            scale = 1.0
            if song.dtype != np.int16:
                song = song.astype(np.float32, copy=False)
        elif song.dtype == np.int16:
            peak = max(int(song.max(initial=0)), -int(song.min(initial=0)))
            scale = max(2.0 * peak / 32768.0, 1e-8)
        else:
            song = song.astype(np.float32, copy=False)
            peak = max(float(song.max(initial=0.0)), -float(song.min(initial=0.0)))
            scale = max(2.0 * peak, 1e-8)

        grid = chunked.plan_chunks(length, self.segment, self.overlap,
                                   self.bucket)
        schedule = self._group_schedule(grid, group_chunks)
        hop, seg = grid.hop, grid.segment
        embs = self._stem_embs(stems)
        carry_acc = torch.zeros((n_stems * 2, seg - hop), device=self.device)
        carry_w = torch.zeros((seg - hop,), device=self.device)
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        pieces = []                   # (start, host int16 buffer, valid cols)
        start = 0
        for gi in schedule:
            take = min(gi * hop, length - start)
            if take <= 0:             # the schedule over-covers the grid
                break
            span = (gi - 1) * hop + seg
            piece = song[:, start:start + span]
            if piece.shape[-1] < span:
                piece = np.pad(piece, ((0, 0), (0, span - piece.shape[-1])))
            q, carry_acc, carry_w = self._group(
                self._upload(piece), embs, gi, hop, start, length, scale,
                carry_acc, carry_w)
            if cuda:
                host = torch.empty(q.shape, dtype=torch.int16, pin_memory=True)
                copy_stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(copy_stream):
                    host.copy_(q, non_blocking=True)
                q.record_stream(copy_stream)
            else:
                host = q
            pieces.append((start, host, take))
            start += gi * hop
        if cuda:
            copy_stream.synchronize()
        pcm = np.empty((n_stems * 2, length), np.int16)
        for s0, host, take in pieces:
            pcm[:, s0:s0 + take] = host.numpy()[:, :take]
        return pcm.reshape(n_stems, 2, length), np.full((n_stems,), scale,
                                                        np.float32)
