"""Stream sessions, as ``/api/separate/stream`` runs them: each session a new
``StreamingSeparator(separator, stems=(prompt,), block_chunks=b)`` on the
app-protocol ``Separator`` (its construction embeds the prompt, through
the text tower when the prompt is new), the clip fed in pieces of
``b x hop`` samples as they would arrive, then flushed.  Closed loop, one
session at a time.  A session's first audio is the time from its start to
its first piece on the host.

Prompts: one a session, in each pair of sessions one phrase never seen
before (from seeded word lists) and one of the canonical stem prompts'
variants, which stay cached after set-up; the order within each pair is
drawn from the seed.

Traffic keys: ``clip_seconds``, ``distinct_clips``, ``block_chunks``,
``segment_seconds``, ``overlap_seconds``, ``max_sessions``,
``check_sessions``, ``limits``."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import program
from port_bench.reference import protocols as ref

SR = 44100
KNOWN = ["drums", "drum kit", "percussion", "the drums", "bass",
         "bass guitar", "the bass", "bass line", "other instruments",
         "accompaniment", "instruments", "vocals", "voice", "singing",
         "the vocals"]
ADJECTIVES = ["warm", "bright", "distorted", "muted", "airy", "punchy", "soft",
              "gritty", "lush", "dry", "reverberant", "staccato", "deep",
              "thin", "breathy", "crunchy", "mellow", "sharp", "hollow",
              "driving"]
SOURCES = ["piano", "electric guitar", "acoustic guitar", "synth pad",
           "organ", "strings", "brass section", "saxophone", "flute",
           "choir", "lead vocal", "backing vocals", "kick drum", "snare",
           "hi-hats", "synth bass", "upright bass", "cello", "trumpet",
           "marimba"]
PLACES = ["", "in the chorus", "in the verse", "on the left", "on the right",
          "in the background", "up front", "with delay", "with chorus",
          "from the intro"]


def prompts(seed: int, n: int) -> List[tuple]:
    """``n`` (prompt, new) pairs: in each pair of sessions one prompt is a
    phrase of the word lists never used before and one a known variant, in
    an order drawn from the seed, so any window serves half new ones."""
    rng = np.random.default_rng(int(seed) + 101)
    n_new = n // 2
    combos = rng.choice(len(ADJECTIVES) * len(SOURCES) * len(PLACES),
                        size=n_new, replace=False)
    new = []
    for c in combos:
        a, rest = divmod(int(c), len(SOURCES) * len(PLACES))
        s, pl = divmod(rest, len(PLACES))
        new.append(" ".join(w for w in (ADJECTIVES[a], SOURCES[s], PLACES[pl])
                            if w))
    known = [KNOWN[i] for i in rng.integers(len(KNOWN), size=n - n_new)]
    flags = [f for first in rng.integers(2, size=n_new)
             for f in ((True, False) if first else (False, True))]
    it_new, it_known = iter(new), iter(known)
    return [(next(it_new), True) if f else (next(it_known), False)
            for f in flags]


class Driver:
    def __init__(self, ctx: Dict):
        cell = ctx["cell"]
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed, self.device = ctx["seed"], ctx["device"]
        self.segment = int(self.tr["segment_seconds"] * SR)
        self.overlap = int(self.tr["overlap_seconds"] * SR)
        self.hop = self.segment - min(self.overlap, self.segment - 1)
        self.block = self.tr["block_chunks"]

    def setup(self) -> None:
        model, self.params = program.build(self.cfg, self.seed, self.device)
        self.sep = program.separator(model, self.cfg, self.tr, self.device)
        lo, hi = self.tr["clip_seconds"]
        self.clips = program.songs(self.seed, self.device, lo, hi,
                                   self.tr["distinct_clips"], "float32")
        self.prompts = prompts(self.seed, self.tr["max_sessions"])
        # the known prompts cached, the block program captured and
        # replayed, the text tower run once on a prompt no session uses
        for p in KNOWN:
            self.sep.text_embedding(p)
        # the same warm-up for every seed: a clip of the mix's middle length
        lo, hi = self.tr["clip_seconds"]
        warm = program.songs(self.seed, self.device, (lo + hi) / 2,
                             (lo + hi) / 2, 1, "float32")[0]["mixture"]
        for prompt in ("warm up", "vocals"):
            self._session(warm, prompt, keep=False)
        program.sync(self.device)

    def _session(self, clip: np.ndarray, prompt: str, keep: bool) -> Dict:
        from audio_to_sheet_music_tpu_torch.infer.streaming import (
            StreamingSeparator)

        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.stream_open"):
            stream = StreamingSeparator(self.sep, stems=(prompt,),
                                        block_chunks=self.block)
        t_open = time.perf_counter()
        piece = self.block * self.hop
        first, steps, out = None, [], []
        for s0 in range(0, clip.shape[-1], piece):
            with torch.profiler.record_function("bench.stream_feed"):
                a = time.perf_counter()
                got = stream.feed(clip[:, s0:s0 + piece])
                b = time.perf_counter()
            if got:
                steps.append(b - a)
                first = b - t0 if first is None else first
                out += got
        with torch.profiler.record_function("bench.stream_flush"):
            tail = stream.flush()
        end = time.perf_counter()
        first = end - t0 if first is None else first
        out.append(tail)
        rec = {"start": t0, "end": end, "first_audio_s": first,
               "open_s": t_open - t0, "steps_s": steps}
        if keep:
            rec["out"] = np.concatenate(out, axis=-1)
        return rec

    def request(self, i: int) -> Dict:
        k = i % len(self.clips)
        clip = self.clips[k]["mixture"]
        prompt, new = self.prompts[i % len(self.prompts)]
        rec = self._session(clip, prompt, keep=i < len(self.clips))
        length = clip.shape[-1]
        rec.update({"seconds": length / SR, "audio_s": length / SR,
                    "clip": k, "prompt": prompt, "new_prompt": new,
                    "chunks": ref.chunk_count(length, self.segment,
                                              self.overlap)})
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
        ref.set_f32()
        out = []
        for rec in program.sample(self.records, "out",
                                  self.tr["check_sessions"], self.seed):
            x = torch.from_numpy(self.clips[rec["clip"]]["mixture"]).to(
                self.device)

            def stems(pr):
                embs = ref.prompt_embeddings(self.params, [rec["prompt"]],
                                             True, self.device, pr)
                return ref.atht_stems(self.params, self.cfg, x, embs,
                                      self.segment, self.overlap, pr
                                      ).cpu().numpy()

            want = stems(ref.F32)
            got = rec["out"] if prec is None else stems(prec)
            out.append(program.rel_rms(got, want))
        return out

    def check(self, records: List[Dict]) -> List[tuple]:
        self.records = records
        return [("stem_rel_rms", program.worst(self._compare(None)),
                 self.tr["limits"]["stem_rel_rms"])]

    def control(self, records: List[Dict]) -> List[tuple]:
        self.records = records
        return [("stem_rel_rms", program.worst(self._compare(ref.Prec("fp8"))))]
