"""Head training: the step of ``train.step.make_train_step`` (the frozen text
tower and encoder without gradients, the head forward and backward in bf16
over f32 masters, the global-norm clip, AdamW under the cosine schedule),
fed by the port's ``data.musdb`` segment loader (random 6 s segments, gain
and swap augmentation, one stem prompt a sample, hash-tokenised) over
seeded 60 s tracks cached as npy files under ``TMPDIR``, each batch put on
the card as ``train.trainer.put_batch`` does.  Steps back to back; each
ends with its loss read on the host.

Set-up builds one training state and drives it through its first steps,
keeping what the reference follows from the start: the head before them,
each step's loss, the optimizer's first moment after step 1 (the first
clipped gradient x 0.1) and the head after them.  The window continues the
same state.  At a window step drawn from the seed it keeps the head and
the moments before that step and the head after the next
``window_follow["steps"]`` steps, so the reference follows those window
steps too, resumed from the program's state there.  The reference
cuts every batch it follows from the npy files itself
(``reference.segments``).

Traffic keys: ``tracks``, ``track_seconds``, ``batch``, ``segment_seconds``,
``optimizer`` (lr, weight_decay, grad_clip, total_steps, eta_min_ratio),
``followed_steps``, ``window_follow`` (``within``: the window step is
drawn from [0, within); ``steps``), ``limits``."""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from port_bench import program, synth
from port_bench.reference import protocols as ref
from port_bench.reference import segments

SR = 44100
B1 = 0.9          # AdamW's first-moment decay, the program's and the reference's
# the window's numbers: its first gradient's worst leaf is left out, since
# small bias and norm leaves read it 0.0065-0.24 on sound runs (PERF.md)
WINDOW_NUMBERS = ("loss_gap_db", "update_gap")


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
              ) -> Dict[str, float]:
    """Per leaf |norm(got) - norm(want)| / max(norm(want), the median
    leaf's norm(want)), non-finite norms compared by ``program.gap``."""
    wn = {k: _norm(v) for k, v in want.items()}
    finite = [v for v in wn.values() if np.isfinite(v)]
    med = float(np.median(finite)) if finite else 1.0
    return {k: program.gap(_norm(got[k]), wn[k])
            / max(wn[k] if np.isfinite(wn[k]) else 0.0, med, 1e-30)
            for k in wn}


class Driver:
    def __init__(self, ctx: Dict):
        cell = ctx["cell"]
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed, self.device = ctx["seed"], ctx["device"]
        self.seg = int(self.tr["segment_seconds"] * SR)

    def _tracks(self):
        from audio_to_sheet_music_tpu_torch.data.musdb import Track

        gen = program.generator(self.seed, self.device, 3)
        root = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
        cache = root / "port_bench_tracks"
        cache.mkdir(parents=True, exist_ok=True)
        tracks = []
        for i in range(self.tr["tracks"]):
            path = cache / f"track_{i}.npy"
            np.save(path, synth.song(self.tr["track_seconds"], gen,
                                     self.device).cpu().numpy())
            tracks.append(Track(f"track_{i}", path, "npy"))
        self.paths = [t.path for t in tracks]
        return tracks

    def _batches(self):
        from audio_to_sheet_music_tpu_torch.data.musdb import (
            BatchLoader, StemSegmentDataset)
        from audio_to_sheet_music_tpu_torch.text.tokenizer import HashTokenizer

        ds = StemSegmentDataset(self._tracks(), self.seg, random_segments=True,
                                augment=True, seed=self.seed)
        loader = BatchLoader(ds, self.tr["batch"], HashTokenizer(),
                             seed=self.seed)
        while True:
            yield from loader

    def setup(self) -> None:
        from audio_to_sheet_music_tpu_torch.train.step import (
            TrainState, make_optimizer, make_train_step)

        model, self.params = program.build(self.cfg, self.seed, self.device)
        self.head0 = {k: v.detach().clone() for k, v in self.params.items()
                      if k.startswith("head.")}
        opt = self.tr["optimizer"]
        self.state = TrainState.create(model, lambda ps: make_optimizer(
            ps, opt["lr"], opt["weight_decay"], opt["grad_clip"],
            opt["total_steps"], opt["eta_min_ratio"]))
        self.step = make_train_step(None, program.dtype(self.cfg),
                                    self.tr.get("kernels", "default"))
        self.feed = self._batches()
        self.names = [n for n, _ in self.state.model.named_parameters()
                      if n.startswith("head.")]
        self.losses = []
        for i in range(self.tr["followed_steps"]):
            self.losses.append(self._step(next(self.feed)))
            if i == 0:
                self.grad1 = {n: m / (1 - B1) for n, m in
                              self._moments("exp_avg").items()}
        self.head3 = self._head()
        follow = self.tr["window_follow"]
        self.at = int(np.random.default_rng((self.seed, 11)).integers(
            follow["within"]))
        self.until = self.at + follow["steps"] - 1
        self.snap = self.head_after = None
        program.sync(self.device)

    def _head(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in zip(
            self.names, self.state.optimizer.params)}

    def _moments(self, key: str) -> Dict[str, torch.Tensor]:
        states = self.state.optimizer.adamw.state
        return {n: states[p][key].detach().clone() for n, p in zip(
            self.names, self.state.optimizer.params)}

    def _step(self, raw) -> float:
        from audio_to_sheet_music_tpu_torch.train.trainer import put_batch

        metrics = self.step(self.state, put_batch(raw, self.device))
        return float(metrics["loss/total"])

    def request(self, i: int) -> Dict:
        with torch.profiler.record_function("bench.train_step"):
            t0 = time.perf_counter()
            if i == self.at:
                self.snap = {"head": self._head(),
                             "m": self._moments("exp_avg"),
                             "v": self._moments("exp_avg_sq"),
                             "count": self.state.step}
            raw = next(self.feed)
            loss = self._step(raw)
            if i == self.until:
                self.head_after = self._head()
            t1 = time.perf_counter()
        return {"start": t0, "end": t1, "samples": len(raw["mixture"]),
                "loss": loss}

    def release(self) -> None:
        del self.state, self.step, self.feed

    def counters(self, records: List[Dict]) -> Dict:
        return {}

    def window_flops(self, records: List[Dict]) -> float:
        """The reference's towers forward and head forward and backward on
        one batch, times the steps."""
        p = {**self.params, **self.head0}
        per_step = program.count_flops(lambda: ref.train_steps(
            p, self.cfg, self._batches_at([0]), self.tr["optimizer"],
            self.device))
        return per_step * len(records)

    def _batches_at(self, steps: List[int]) -> List[Dict[str, np.ndarray]]:
        """The batches of the given steps (counted from the first followed
        step), cut by the reference from the npy tracks."""
        tracks = [np.load(p, mmap_mode="r") for p in self.paths]
        plan = segments.plan([t.shape[-1] for t in tracks], self.seg,
                             self.tr["batch"], self.seed, max(steps) + 1)
        return [segments.cut(plan[s], tracks, self.seg) for s in steps]

    def notes(self, records: List[Dict]) -> Dict[str, int]:
        """Window steps whose loss was not finite, and the window step the
        reference follows from."""
        return {"nonfinite_steps": sum(
            1 for r in records if not np.isfinite(r.get("loss", np.nan))),
            "followed_window_step": self.at}

    def _gaps(self, got: Dict, want: Dict, d_head0: Dict, tag: str
              ) -> Dict[str, float]:
        """The worst step's |loss gap| (dB); the worst and the median leaf's
        gap in the first clipped gradient's norm (where ``got`` has it);
        the worst leaf's gap in the norm of its change over the steps
        (leaves whose reference gradient is under 1e-3 of the median
        leaf's left out: they move by round-off)."""
        gnorm = {k: _norm(g) for k, g in want["first_grads"].items()}
        finite = [v for v in gnorm.values() if np.isfinite(v)]
        med = float(np.median(finite)) if finite else 0.0
        moved = {k for k, v in gnorm.items()
                 if not np.isfinite(v) or v >= 1e-3 * med}
        d_want = {k: want["head"][k] - d_head0[k] for k in moved}
        d_got = {k: got["head"][k].to(self.device) - d_head0[k]
                 for k in moved}
        if not all(np.isfinite(want["losses"] + list(got["losses"]))):
            print(f"port_bench: non-finite loss in the {tag} steps: "
                  f"reference {want['losses']}, program {list(got['losses'])}",
                  file=sys.stderr)
        grads = (leaf_gaps(got["first_grads"], want["first_grads"])
                 if got["first_grads"] is not None else {"-": 0.0})
        updates = leaf_gaps(d_got, d_want)
        print(f"port_bench: {tag} steps' worst leaves: gradient "
              f"{max(grads, key=grads.get)}, change "
              f"{max(updates, key=updates.get)}", file=sys.stderr)
        return {"loss_gap_db": max(program.gap(a, b) for a, b in
                                   zip(got["losses"], want["losses"])),
                "grad_gap": max(grads.values()),
                "grad_gap_median": float(np.median(list(grads.values()))),
                "update_gap": max(updates.values())}

    def readings(self, records: List[Dict], prec) -> Dict[str, float]:
        """The followed steps' four numbers and the window's
        (``WINDOW_NUMBERS``, prefixed ``window_``): the program's, or with ``prec`` the reference's in that precision
        put in the program's place, against the f32 reference."""
        ref.set_f32()
        p = {**self.params, **self.head0}
        opt = self.tr["optimizer"]
        n0 = self.tr["followed_steps"]
        k = self.until - self.at + 1
        if len(records) <= self.until or self.head_after is None:
            print(f"port_bench: the window ended after {len(records)} steps, "
                  f"before step {self.until} that the reference follows",
                  file=sys.stderr)
            return {name: float("inf") for name in (
                "loss_gap_db", "grad_gap", "grad_gap_median",
                "update_gap") + tuple(
                    "window_" + n for n in WINDOW_NUMBERS)}
        batches = self._batches_at(list(range(n0)) + [
            n0 + self.at + s for s in range(k)])
        want0 = ref.train_steps(p, self.cfg, batches[:n0], opt, self.device)
        want1 = ref.train_steps(p, self.cfg, batches[n0:], opt, self.device,
                                start=self.snap)
        if prec is None:
            got0 = {"losses": self.losses, "first_grads": self.grad1,
                    "head": self.head3}
            got1 = {"losses": [r["loss"] for r in
                               records[self.at:self.until + 1]],
                    "first_grads": None, "head": self.head_after}
        else:
            got0 = ref.train_steps(p, self.cfg, batches[:n0], opt,
                                   self.device, prec)
            got1 = ref.train_steps(p, self.cfg, batches[n0:], opt,
                                   self.device, prec, start=self.snap)
        out = self._gaps(got0, want0, self.head0, "followed")
        window = self._gaps(got1, want1, self.snap["head"], "window")
        out.update({"window_" + n: window[n] for n in WINDOW_NUMBERS})
        return out

    def check(self, records: List[Dict]) -> List[tuple]:
        r = self.readings(records, None)
        return [(k, v, self.tr["limits"][k]) for k, v in r.items()]

    def control(self, records: List[Dict]) -> List[tuple]:
        return list(self.readings(records, ref.Prec("fp8")).items())
