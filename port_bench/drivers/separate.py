"""Whole songs, one free-text prompt each, through ``Separator.separate_pcm``:
the hot path of ``/api/separate``.  Each song's chunks run as one batch in
the whole-song program of its bucket (8 chunks a bucket), the prompt's
embedding from the cache or, for a prompt never seen, from the text tower;
the stem comes back as absolute-level int16.  Closed loop, one request in
flight, as the app's device lock serialises them.

Songs are the songs driver's set (stratified lengths, seeded order);
prompts the stream driver's (in each pair of requests one phrase never
seen and one cached variant of a stem prompt).  Set-up caches the known
prompts and runs each bucket's program twice (capture, then a replay).

Traffic keys: ``song_seconds``, ``distinct_songs``, ``segment_seconds``,
``overlap_seconds``, ``max_requests``, ``check_songs``, ``limits``."""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from port_bench import program
from port_bench.drivers import stream
from port_bench.reference import protocols as ref

SR = 44100


class Driver:
    def __init__(self, ctx: Dict):
        cell = ctx["cell"]
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed, self.device = ctx["seed"], ctx["device"]
        self.segment = int(self.tr["segment_seconds"] * SR)
        self.overlap = int(self.tr["overlap_seconds"] * SR)

    def _buckets(self) -> Dict[int, int]:
        """Each whole-song program's chunk count -> the first song of the
        set (in the order the songs were made) that runs it."""
        from audio_to_sheet_music_tpu_torch.infer import chunked

        out: Dict[int, int] = {}
        for k in sorted(range(len(self.songs)),
                        key=lambda i: self.songs[i]["seconds"]):
            n = chunked.plan_chunks(self.songs[k]["mixture"].shape[-1],
                                    self.segment, self.overlap).n_chunks
            out.setdefault(n, k)
        return out

    def setup(self) -> None:
        model, self.params = program.build(self.cfg, self.seed, self.device)
        self.sep = program.separator(model, self.cfg, self.tr, self.device)
        lo, hi = self.tr["song_seconds"]
        self.songs = program.songs(self.seed, self.device, lo, hi,
                                   self.tr["distinct_songs"], "int16")
        self.prompts = stream.prompts(self.seed, self.tr["max_requests"])
        for p in stream.KNOWN:
            self.sep.text_embedding(p)
        self.buckets = self._buckets()
        for k in self.buckets.values():
            for _ in range(2):
                self.sep.separate_pcm(self.songs[k]["mixture"], "warm up")
        program.sync(self.device)

    def request(self, i: int) -> Dict:
        k = i % len(self.songs)
        mix = self.songs[k]["mixture"]
        prompt, new = self.prompts[i % len(self.prompts)]
        with torch.profiler.record_function("bench.separate_pcm"):
            t0 = time.perf_counter()
            pcm = self.sep.separate_pcm(mix, prompt)
            t1 = time.perf_counter()
        length = mix.shape[-1]
        rec = {"start": t0, "end": t1, "seconds": length / SR,
               "audio_s": length / SR, "song": k, "prompt": prompt,
               "new_prompt": new,
               "chunks": ref.chunk_count(length, self.segment, self.overlap)}
        if i < len(self.songs):          # each distinct song's first output
            rec["pcm"] = pcm
        return rec

    def release(self) -> None:
        del self.sep

    def counters(self, records: List[Dict]) -> Dict:
        return {}

    def window_flops(self, records: List[Dict]) -> float:
        per_chunk = program.atht_chunk_flops(self.params, self.cfg,
                                             self.segment, 1, self.device)
        text = sum(program.text_flops(self.params, r["prompt"], self.device)
                   for r in records if r["new_prompt"])
        return per_chunk * sum(r["chunks"] for r in records) + text

    def _compare(self, prec) -> List[float]:
        """Each sampled song: rel rms of the program's int16 stem (or, as a
        control, ``prec``'s) against the f32 reference's, both at the
        absolute level ``separate_pcm`` writes."""
        ref.set_f32()
        out = []
        for rec in program.sample(self.records, "pcm", self.tr["check_songs"],
                                  self.seed):
            x = torch.from_numpy(self.songs[rec["song"]]["mixture"]).to(
                self.device).float() / 32768.0

            def stem(pr):
                embs = ref.prompt_embeddings(self.params, [rec["prompt"]],
                                             True, self.device, pr)
                s = ref.atht_stems(self.params, self.cfg, x, embs,
                                   self.segment, self.overlap, pr)[0]
                return torch.clamp(torch.round(s * 32767.0), -32767,
                                   32767).cpu().numpy()

            want = stem(ref.F32)
            got = rec["pcm"] if prec is None else stem(prec)
            out.append(program.rel_rms(got, want))
        return out

    def check(self, records: List[Dict]) -> List[tuple]:
        self.records = records
        return [("stem_rel_rms", program.worst(self._compare(None)),
                 self.tr["limits"]["stem_rel_rms"])]

    def control(self, records: List[Dict]) -> List[tuple]:
        self.records = records
        return [("stem_rel_rms", program.worst(self._compare(ref.Prec("fp8"))))]
