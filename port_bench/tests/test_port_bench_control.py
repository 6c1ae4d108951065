"""The control and the faults at test size: the reference put in the
program's place one precision below (fp8) reads further from the f32
reference than the program does, and a run whose timed path is broken
underneath comes out not correct."""

import pytest
import torch

from port_bench import control
from port_bench import run as bench_run

import tiny


@pytest.mark.parametrize("name", ["atht.songs-4stem", "atht.stream-1stem",
                                  "atht.train-8x6s"])
def test_control_reads_further_than_the_program(name):
    got = control.readings(tiny.cell(name), tiny.SEED, 1.0, tiny.CPU,
                           tiny.clock(0.5))
    assert got["requests"] == 2
    # the control has to fail at least one number by a wide margin
    assert any(got["control"][k] > 3 * got["program"][k] + 1e-3
               for k in got["program"])


def _run(name):
    return bench_run.run_cell(tiny.cell(name), tiny.SEED, 1.0, False,
                              tiny.CPU, clock=tiny.clock(0.5), t0=0.0)


def test_altered_pcm_is_not_correct(monkeypatch):
    from audio_to_sheet_music_tpu_torch.infer.session import Separator

    real = Separator._group

    def group(self, *args, **kwargs):
        q, acc, w = real(self, *args, **kwargs)
        q = q.clone()
        q[0, :2000] = torch.clamp(q[0, :2000].int() + 3000, -32768, 32767
                                  ).to(q.dtype)
        return q, acc, w

    monkeypatch.setattr(Separator, "_group", group)
    assert not _run("atht.songs-4stem")["correct"]


def test_altered_stream_piece_is_not_correct(monkeypatch):
    from audio_to_sheet_music_tpu_torch.infer.streaming import (
        StreamingSeparator)

    real = StreamingSeparator._emit

    def emit(self, acc, wsum, n):
        out = real(self, acc, wsum, n)
        out[..., :2000] += 0.05
        return out

    monkeypatch.setattr(StreamingSeparator, "_emit", emit)
    assert not _run("atht.stream-1stem")["correct"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_broken_train_step_is_not_correct(monkeypatch, fault):
    from audio_to_sheet_music_tpu_torch.train import step as steps

    monkeypatch.setattr(steps, "make_train_step", steps.make_train_step)
    control.plant(fault)
    assert not _run("atht.train-8x6s")["correct"]


def test_fault_that_starts_in_the_window_is_not_correct(monkeypatch):
    """A step that goes wrong only after set-up's followed steps (here it
    drops half of each batch from the first window step on) is caught by
    the window steps the reference follows."""
    from audio_to_sheet_music_tpu_torch.train import step as steps

    real = steps.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        calls = iter(range(10 ** 6))

        def late(state, batch):
            if next(calls) >= 3:
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, batch)

        return late

    monkeypatch.setattr(steps, "make_train_step", make)
    result = _run("atht.train-8x6s")
    assert not result["correct"]
    checks = result["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("loss_gap_db", "grad_gap", "update_gap"))
    assert result["notes"]["nonfinite_steps"] == 0
