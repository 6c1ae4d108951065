"""wandb media logging in the port (CPU), with and without ``wandb``.

- Without ``wandb`` every ``utils.wandb_log`` function logs nothing and one
  line says so; the trainer's logger and ``cli benchmark --use-wandb`` go
  on without it.
- With a stub ``wandb`` module the trainer logs, at every logged step, the
  separation triptych of one example (the spectrogram figure and the three
  clips, the estimate from the model's forward), as the JAX trainer does;
  ``--use-wandb`` logs every model's aggregates.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest

from audio_to_sheet_music_tpu_torch import cli
from audio_to_sheet_music_tpu_torch import config as TC
from audio_to_sheet_music_tpu_torch.data import synthetic_tracks
from audio_to_sheet_music_tpu_torch.eval.harness import TrackResult
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.utils import wandb_log


class _Run:
    def __init__(self):
        self.logged = []
        self.finished = False

    def log(self, rec, step=None):
        self.logged.append((dict(rec), step))

    def finish(self):
        self.finished = True


def _stub():
    wb = types.ModuleType("wandb")
    wb.run = None

    def init(project=None, name=None):
        wb.run = _Run()
        return wb.run

    wb.init = init
    wb.log = lambda rec, step=None: wb.run.log(rec, step)
    wb.Image = lambda fig: ("image", fig)
    wb.Audio = lambda arr, sample_rate: ("audio", arr.shape, sample_rate)
    return wb


def _cfg(tmp_path, use_wandb):
    data = tmp_path / "data"
    synthetic_tracks(1, seconds=1.0, cache_dir=data)
    return TC.Config(
        data=TC.DataConfig(train_dir=str(data), test_dir=str(data),
                           segment_seconds=0.25),
        model=TC.ModelConfig(compute_dtype="float32"),
        training=TC.TrainingConfig(batch_size=2, num_epochs=1),
        wandb=TC.WandbConfig(use_wandb=use_wandb, log_every=1,
                             validate_every=5,
                             checkpoint_dir=str(tmp_path / "ckpt"),
                             output_dir=str(tmp_path / "out")))


def test_no_wandb_is_a_no_op_with_one_line(monkeypatch, capsys, tmp_path):
    from audio_to_sheet_music_tpu_torch.train.trainer import train

    monkeypatch.setitem(sys.modules, "wandb", None)      # import fails
    wav = np.zeros((2, 4410), np.float32)
    wandb_log.log_separation_to_wandb(wav, wav, wav, "drums", step=1)
    wandb_log.log_audio_to_wandb(wav, "k")
    out = capsys.readouterr().out.splitlines()
    assert out == ["wandb_log: wandb is not installed; media are not "
                   "logged"] * 2
    result = train(_cfg(tmp_path, True), model=TA.init_tiny(0),
                   max_steps_per_epoch=1, device="cpu", kernels=False)
    assert np.isfinite(result["final_loss"])
    assert "wandb is unavailable" in capsys.readouterr().out
    cli._log_wandb({})
    assert "wandb logging skipped" in capsys.readouterr().out


def test_trainer_logs_the_triptych(monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    from audio_to_sheet_music_tpu_torch.train import trainer

    wb = _stub()
    monkeypatch.setitem(sys.modules, "wandb", wb)
    seen = []
    real = trainer.atht.forward
    monkeypatch.setattr(trainer.atht, "forward",
                        lambda *a, **k: seen.append(a[1].shape) or real(*a, **k))
    trainer.train(_cfg(tmp_path, True), model=TA.init_tiny(0),
                  max_steps_per_epoch=2, device="cpu", kernels=False)
    keys = [k for rec, _ in wb.run.logged for k in rec]
    media = sorted(k for k in keys if k.startswith("train_media/"))
    # the train steps' forwards take the batch of 2; the media's one example
    assert len(media) == 8
    assert [tuple(x) for x in seen if x[0] == 1] == [(1, 2, 11025)] * 2
    stems = {k.split("/")[1] for k in media}
    for stem in stems:
        assert {f"train_media/{stem}/{x}" for x in
                ("spectrograms", "mixture", "target", "estimate")} <= set(media)
    steps = {step for rec, step in wb.run.logged
             if any(k.startswith("train_media/") for k in rec)}
    assert steps == {1, 2}
    assert any("train/loss/total" in rec for rec, _ in wb.run.logged)


def test_benchmark_logs_aggregates(monkeypatch):
    wb = _stub()
    monkeypatch.setitem(sys.modules, "wandb", wb)
    stems = ("drums", "bass", "other", "vocals")
    res = [TrackResult("t", "M", {s: 1.0 for s in stems} | {"average": 1.0},
                       {s: 0.5 for s in stems} | {"average": 0.5})]
    cli._log_wandb({"M": res})
    keys = {k for rec, _ in wb.run.logged for k in rec}
    assert {"M/sdr_average", "M/sisdr_drums"} <= keys and wb.run.finished
