"""Whole songs, all stems, through ``Separator.separate_all_pcm``: the
serving path (captured group programs of [g/2, g, g, ...] chunks, int16
PCM against twice the mixture's peak).  Closed loop, one song in flight,
as the app's device lock serialises requests.

Traffic keys: ``song_seconds`` [lo, hi], ``distinct_songs`` (stratified
lengths, seeded order, cycled), ``stems``, ``group_chunks``,
``segment_seconds``, ``overlap_seconds``, ``check_songs`` (how many
finished songs the reference checks, the longest among them) and
``limits``."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from port_bench import common, program
from port_bench.reference import protocols as ref

SR = 44100


def group_schedule(length: int, segment: int, overlap: int, g: int
                   ) -> List[int]:
    """The group sizes ``separate_all_pcm`` runs for a ``length``-sample
    song on one device: ceil(length / hop) chunks, bucketed up (2 to 16
    chunks, else 8), a half-size first group, then groups of ``g`` until
    the groups' starts pass the song's end.  A copy of the program's
    schedule, held against its launch counters (``readers.schedule_holds``)
    wherever a reader uses it."""
    overlap = min(overlap, segment - 1)
    hop = segment - overlap
    needed = max(1, math.ceil(length / hop))
    bucket = 2 if needed <= 16 else 8
    n = math.ceil(needed / bucket) * bucket
    g = max(1, min(g, n))
    sched = [g // 2] if n > g and g >= 2 else []
    sched += [g] * max(0, -(-(n - sum(sched)) // g))
    out, start = [], 0
    for gi in sched:
        if length - start <= 0:
            break
        out.append(gi)
        start += gi * hop
    return out


class Driver:
    def __init__(self, ctx: Dict):
        cell = ctx["cell"]
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed, self.device = ctx["seed"], ctx["device"]
        self.segment = int(self.tr["segment_seconds"] * SR)
        self.overlap = int(self.tr["overlap_seconds"] * SR)
        self.stems = list(self.tr["stems"])

    def setup(self) -> None:
        model, self.params = program.build(self.cfg, self.seed, self.device)
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

    def request(self, i: int) -> Dict:
        k = i % len(self.songs)
        mix = self.songs[k]["mixture"]
        with torch.profiler.record_function("bench.separate_all_pcm"):
            t0 = time.perf_counter()
            pcm, scales = self.sep.separate_all_pcm(
                mix, self.stems, group_chunks=self.tr["group_chunks"])
            t1 = time.perf_counter()
        length = mix.shape[-1]
        groups = group_schedule(length, self.segment, self.overlap,
                                self.tr["group_chunks"])
        rec = {"start": t0, "end": t1, "seconds": length / SR,
               "audio_s": length / SR * len(self.stems), "song": k,
               "chunks": ref.chunk_count(length, self.segment, self.overlap),
               "groups": groups, "computed": sum(groups)}
        if i < len(self.songs):          # each distinct song's first output
            rec["pcm"] = pcm
        return rec

    def release(self) -> None:
        del self.sep

    def counters(self, records: List[Dict]) -> Dict:
        now = program.launches()
        return {"launches": {k: now[k] - self.launches0[k] for k in now}}

    def window_flops(self, records: List[Dict]) -> float:
        per_chunk = program.atht_chunk_flops(self.params, self.cfg,
                                             self.segment, len(self.stems),
                                             self.device)
        return per_chunk * sum(r["chunks"] for r in records)

    def window_bound(self, records: List[Dict], kernel: str) -> float:
        return program.serve_bound(self.cfg, self.segment,
                                   [g for r in records for g in r["groups"]],
                                   kernel)

    def window_launches(self, records: List[Dict], kernel: str) -> int:
        """The launches of ``kernel`` that the groups of ``group_schedule``
        make: one ``henc_freq_fused`` a forward, ``layer_tail`` one a
        transformer layer and branch."""
        per = {"henc_freq_fused": 1,
               "layer_tail": common.transformer_bound(
                   1, 1, 1, self.cfg["transformer_layers"], 1, 1)[1]}[kernel]
        return per * sum(len(r["groups"]) for r in records)

    def _stems(self, rec: Dict, prec) -> torch.Tensor:
        mix = self.songs[rec["song"]]["mixture"]
        x = torch.from_numpy(mix).to(self.device).float() / 32768.0
        embs = ref.prompt_embeddings(self.params, self.stems, True,
                                     self.device, prec)
        return ref.atht_stems(self.params, self.cfg, x, embs, self.segment,
                              self.overlap, prec)

    def _compare(self, prec) -> List[float]:
        """Each sampled song's worst stem: rel rms of the program's int16
        levels (or, as a control, ``prec``'s) against the f32 reference's."""
        ref.set_f32()
        out = []
        for rec in program.sample(self.records, "pcm", self.tr["check_songs"],
                                  self.seed):
            scale = ref.pcm_scale(self.songs[rec["song"]]["mixture"])
            want = ref.quantise(self._stems(rec, ref.F32), scale)
            if prec is None:
                got = rec["pcm"]
            else:
                got = ref.quantise(self._stems(rec, prec), scale).cpu()
            want = want.cpu().numpy()
            out += [program.rel_rms(got[s], want[s])
                    for s in range(len(self.stems))]
        return out

    def check(self, records: List[Dict]) -> List[tuple]:
        self.records = records
        return [("stem_rel_rms", program.worst(self._compare(None)),
                 self.tr["limits"]["stem_rel_rms"])]

    def control(self, records: List[Dict]) -> List[tuple]:
        self.records = records
        return [("stem_rel_rms", program.worst(self._compare(ref.Prec("fp8"))))]
