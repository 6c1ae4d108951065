"""Whole songs, all four stems, through ``Separator.separate_all_pcm`` with
an SCNet model: the songs driver's serving path and song set (captured
group programs of [g/2, g, g, ...] chunks, int16 PCM against twice the
mixture's peak, closed loop of one), with the model built and seeded here.

The check recomputes, for each sampled song, a seeded span of
``check_span_seconds`` from every chunk that overlaps it (the first
sampled song's span starts at its first sample), through
``reference/scnet.stems``: the chunks are those of the program's grid, so
the span's overlap-add is the whole song's.

Traffic keys: those of ``songs`` and ``check_span_seconds``."""

from __future__ import annotations

import math
import re
from typing import Dict, List

import torch

from port_bench import program, scnet_work, weights
from port_bench.drivers import bs_roformer_songs
from port_bench.reference import protocols as ref
from port_bench.reference import scnet as ref_model

# the GroupNorms' affine: each convolution module step's two norms (indices
# 0 and 4 of its Sequential) and the dual-path layers' norms
NORM = re.compile(r"(\.layers\.\d+\.[04]|\.norm_layers\.\d+)\.(weight|bias)$")


def build(cfg: Dict, seed: int, device) -> tuple:
    """(port module, weights by name): ``program.build``'s protocol.  Every
    GroupNorm weight is 1 + U(-0.1, 0.1) and bias U(-0.1, 0.1), a norm's
    draw in ``weights``, whose rules read these numbered norms as
    biases."""
    # on a program without the model this raises at once, before any work
    from audio_to_sheet_music_tpu_torch.models import scnet

    conf = scnet.Config(
        sources=tuple(cfg["sources"]), dims=tuple(cfg["dims"]),
        nfft=cfg["nfft"], hop=cfg["hop_size"], band_sr=tuple(cfg["band_SR"]),
        band_stride=tuple(cfg["band_stride"]),
        band_kernel=tuple(cfg["band_kernel"]),
        conv_depths=tuple(cfg["conv_depths"]), compress=cfg["compress"],
        conv_kernel=cfg["conv_kernel"], num_dplayer=cfg["num_dplayer"],
        expand=cfg["expand"])
    with torch.device("meta"):
        module = scnet.SCNet(conf)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    params = weights.make(shapes, seed, device)
    gen = program.generator(seed, device, 5)
    for name, shape in shapes.items():
        if NORM.search(name):
            u = torch.rand(shape, generator=gen, device=device).mul_(0.2)
            params[name] = u.add_(0.9) if name.endswith("weight") \
                else u.sub_(0.1)
    module.load_state_dict(params, strict=True, assign=True)
    return module, params


class Driver(bs_roformer_songs.Driver):
    def setup(self) -> None:
        model, self.params = build(self.cfg, self.seed, self.device)
        self.sep = program.separator(model, self.cfg, self.tr, self.device)
        lo, hi = self.tr["song_seconds"]
        self.songs = program.songs(self.seed, self.device, lo, hi,
                                   self.tr["distinct_songs"], "int16")
        # every group size the songs run, twice: capture, then a replay
        hop = self.segment - min(self.overlap, self.segment - 1)
        g = self.tr["group_chunks"]
        warm = self.songs[0]["mixture"][:, :(g + g // 2 - 1) * hop + 1]
        for _ in range(2):
            self.sep.separate_all_pcm(warm, self.stems, group_chunks=g)
        program.sync(self.device)
        self.launches0 = program.launches()

    def window_flops(self, records: List[Dict]) -> float:
        """Operations of the reference's forward of one chunk (counted on
        the reference) times the chunks the window's songs needed."""
        gen = program.generator(0, self.device, 9)
        chunk = 0.1 * torch.randn((1, 2, self.segment), generator=gen,
                                  device=self.device)
        with torch.no_grad():
            per_chunk = program.count_flops(
                lambda: ref_model.forward(self.params, chunk, self.cfg))
        return per_chunk * sum(r["chunks"] for r in records)

    def window_bound(self, records: List[Dict], kernel: str) -> float:
        """Summed bound seconds of the window's LSTM recurrences
        (``dual_path``)."""
        return scnet_work.window_bound(
            self.cfg, self.segment, [g for r in records for g in r["groups"]])

    def window_launches(self, records: List[Dict], kernel: str) -> int:
        """``dual_path`` once a dual-path layer a group; no hand-written
        kernel of the other cells."""
        if kernel != "dual_path":
            return 0
        return scnet_work.launches_per_group(self.cfg) * sum(
            len(r["groups"]) for r in records)

    def _compare(self, prec) -> List[float]:
        """Each sampled song's span: rel rms of each stem's program int16
        levels (or, as a control, ``prec``'s) against the f32 reference's."""
        ref.set_f32()
        hop = self.segment - min(self.overlap, self.segment - 1)
        order = [self.cfg["sources"].index(s) for s in self.stems]
        out = []
        sample = program.sample(self.records, "pcm", self.tr["check_songs"],
                                self.seed)
        for k, rec in enumerate(sample):
            mix = self.songs[rec["song"]]["mixture"]
            length = mix.shape[-1]
            a, b = self._span(rec, k == 0)
            # the grid's chunks that overlap [a, b)
            j0 = max(0, (a - self.segment) // hop + 1)
            j1 = min(math.ceil(b / hop), math.ceil(length / hop)) - 1
            s0, s1 = j0 * hop, min(length, j1 * hop + self.segment)
            x = torch.from_numpy(mix[:, s0:s1]).to(self.device).float() \
                / 32768.0
            scale = ref.pcm_scale(mix)

            def stems(pr):
                return ref.quantise(ref_model.stems(
                    self.params, self.cfg, x, self.segment, self.overlap,
                    pr)[order, :, a - s0:b - s0], scale).cpu().numpy()

            want = stems(ref.F32)
            got = rec["pcm"][:, :, a:b] if prec is None else stems(prec)
            out += [program.rel_rms(got[s], want[s])
                    for s in range(len(self.stems))]
        return out
