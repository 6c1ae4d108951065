"""Data-parallel head training in the port: DP == single device, on the CPU.

The cases of ``tests/test_parallel_train.py`` over 2 gloo ranks spawned
once (``parallel.dryrun.spawn_ranks``, a ``file://`` rendezvous under a
temporary directory), each rank with its half of every global batch and
the head's gradients averaged by one all-reduce, all ranks from the JAX
``init_tiny`` weights (``convert/jax_params.py``):

- one step equals the single-device step on the global batch: head within
  1e-5 in f32, 1e-3 in bf16, the metrics as the JAX test holds them (the
  bf16 ``grad_norm`` within 5 %);
- two steps stay equal (2e-5), the optimizer's state consistent;
- the f32 DP step against the JAX single-device step (which the JAX test
  holds equal to its sharded step): loss 1e-5 and ``grad_norm`` 1e-4
  relative, the head within 1e-2 x lr (Adam's update is about +-lr, so
  last-bit gradient differences move it by a small fraction of lr);
- ``train(data_parallel=True)`` writes the single-device ``train``'s head
  (1e-5) and ``val/sdr`` (1e-4 dB), and only rank 0 writes;
- a batch size that does not split over the ranks raises;

then, each in its own spawn, ``cli train --data-parallel --device cpu
--world-size 2`` for one step, and ``dryrun_multichip(2)`` at tiny width.
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.train import step as JS
from audio_to_sheet_music_tpu_torch import cli
from audio_to_sheet_music_tpu_torch import config as TC
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.parallel import dryrun, init_data_parallel
from audio_to_sheet_music_tpu_torch.train import checkpoint as TCK
from audio_to_sheet_music_tpu_torch.train.trainer import train

WORLD = 2
B = 4                 # global batch: 2 rows a rank
T = 11025             # 0.25 s @ 44.1 kHz
LR = 1e-4             # make_optimizer's default


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    workers on the host's cores, and each taking all of them slows every
    worker several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _make_batch(rng, n):
    return {
        "mixture": rng.standard_normal((n, 2, T)).astype(np.float32),
        "target": rng.standard_normal((n, 2, T)).astype(np.float32),
        "input_ids": np.tile(np.array([0, 100, 7, 2], np.int32), (n, 1)),
        "attention_mask": np.ones((n, 4), np.int32),
    }


def _model(state_dict):
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(state_dict, strict=True)
    return model


def _cfg(data, out, batch_size):
    return TC.Config(
        data=TC.DataConfig(train_dir=str(data), test_dir=str(data),
                           segment_seconds=0.25, augment=True,
                           random_segments=True, pct_test=0.25),
        model=TC.ModelConfig(compute_dtype="float32"),
        training=TC.TrainingConfig(batch_size=batch_size, num_epochs=1),
        wandb=TC.WandbConfig(use_wandb=False, log_every=1, validate_every=1,
                             save_every=1, checkpoint_dir=str(out / "ckpt"),
                             output_dir=str(out / "out")))


STEP_CASES = (("f32", torch.float32, 1), ("bf16", torch.bfloat16, 1),
              ("two", torch.float32, 2))


def _rank_checks(rank, world, init, state_dict, batches, data, work):
    """Every check of one rank, in one process."""
    init_data_parallel("cpu", rank, world, init)
    try:
        out = {}
        lo, hi = rank * B // world, (rank + 1) * B // world
        for name, dtype, n in STEP_CASES:
            out[name] = dryrun._steps(_model(state_dict), batches[:n],
                                      torch.device("cpu"), dtype, "none",
                                      True, lo, hi)
        model = _model(state_dict)
        out["train"] = train(_cfg(data, work / "dp", B), model=model,
                             max_steps_per_epoch=2, device="cpu",
                             kernels="opt_in", data_parallel=True)
        out["train_head"] = {k: v.clone()
                             for k, v in model.head.state_dict().items()}
        try:
            train(_cfg(data, work / "uneven", 3), model=_model(state_dict),
                  device="cpu", data_parallel=True)
        except ValueError as e:
            out["uneven"] = str(e)
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from audio_to_sheet_music_tpu_torch.data import synthetic_tracks

    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    state_dict = jax_params.state_dict_from_params(params)
    rng = np.random.default_rng(0)
    batches = [_make_batch(rng, B), _make_batch(rng, B)]
    data = tmp_path_factory.mktemp("dp_data")
    synthetic_tracks(2, seconds=1.0, cache_dir=data)
    work = tmp_path_factory.mktemp("dp_work")
    ranks = dryrun.spawn_ranks(_rank_checks, WORLD, state_dict, batches,
                               data, work)
    return params, state_dict, batches, data, work, ranks


def _single(state_dict, batches, dtype):
    return dryrun._steps(_model(state_dict), batches, torch.device("cpu"),
                         dtype, "none", False)


@pytest.mark.parametrize("name,atol", [("f32", 1e-5), ("bf16", 1e-3)])
def test_dp_step_equals_single_device(setup, name, atol):
    _, state_dict, batches, _, _, ranks = setup
    dtype = dict((n, d) for n, d, _ in STEP_CASES)[name]
    single = _single(state_dict, batches[:1], dtype)
    for r in ranks:                     # every rank holds the same head
        assert dryrun.max_delta(r[name]["head"], single["head"]) < atol
    dp = ranks[0][name]["metrics"]
    for k, want in single["metrics"].items():
        assert math.isfinite(dp[k])
        tol = (0.05 * abs(want) if k == "grad_norm" and name == "bf16"
               else max(atol, atol * abs(want)))
        assert abs(dp[k] - want) <= tol, (k, dp[k], want)


def test_two_steps_stay_equivalent(setup):
    _, state_dict, batches, _, _, ranks = setup
    single = _single(state_dict, batches, torch.float32)
    assert dryrun.max_delta(ranks[0]["two"]["head"], single["head"]) < 2e-5


def test_dp_step_matches_the_jax_step(setup):
    params, _, batches, _, _, ranks = setup
    frozen = {"htdemucs": params["htdemucs"], "clap": params["clap"]}
    tx = JS.make_optimizer(total_steps=10)
    jstate = JS.TrainState.create(jax.tree.map(jnp.asarray, params["head"]),
                                  tx)
    jstate, jm = JS.make_train_step(tx, {}, jnp.float32)(
        jstate, frozen, {k: jnp.asarray(v) for k, v in batches[0].items()})
    dp = ranks[0]["f32"]
    assert dp["metrics"]["loss/total"] == pytest.approx(
        float(jm["loss/total"]), rel=1e-5)
    assert dp["metrics"]["grad_norm"] == pytest.approx(
        float(jm["grad_norm"]), rel=1e-4)
    want = jax_params.state_dict_from_params(
        jax.tree.map(np.asarray, jstate.head), prefix=("head",))
    for k, v in dp["head"].items():
        np.testing.assert_allclose(v.numpy(), want["head." + k].numpy(),
                                   atol=1e-2 * LR, rtol=0, err_msg=k)


def _val_sdr(out):
    lines = [json.loads(x) for x in
             (out / "out" / "metrics.jsonl").read_text().splitlines()]
    return [r["val/sdr"] for r in lines if "val/sdr" in r]


def test_dp_train_equals_single_device_train(setup):
    _, state_dict, _, data, work, ranks = setup
    model = _model(state_dict)
    result = train(_cfg(data, work / "single", B), model=model,
                   max_steps_per_epoch=2, device="cpu", kernels="opt_in")
    head = model.head.state_dict()
    for r in ranks:
        assert dryrun.max_delta(r["train_head"], head) < 1e-5
    dp = ranks[0]["train"]
    assert dp["final_loss"] == pytest.approx(result["final_loss"], rel=1e-5)
    want, got = _val_sdr(work / "single"), _val_sdr(work / "dp")
    assert len(got) == len(want) == 1
    assert got[0] == pytest.approx(want[0], abs=1e-4)
    assert dp["best_sdr"] == pytest.approx(result["best_sdr"], abs=1e-4)
    # rank 0 alone wrote the logs and the checkpoints
    assert (work / "dp" / "ckpt" / "latest" / TCK.STATE_FILE).exists()
    assert len(list((work / "dp" / "out").iterdir())) == 1


def test_uneven_batch_raises(setup):
    for r in setup[-1]:
        assert "batch_size 3 does not split over 2 ranks" in r["uneven"]


def test_cli_train_data_parallel_runs_one_step(setup, tmp_path, monkeypatch,
                                               capsys):
    data = setup[3]
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    cfg = tmp_path / "dp.yaml"
    cfg.write_text(
        f"data:\n  train_dir: {data}\n  test_dir: {data}\n"
        "  segment_seconds: 0.25\n"
        "model:\n  compute_dtype: float32\n"
        "training:\n  batch_size: 2\n  num_epochs: 1\n"
        f"wandb:\n  log_every: 1\n  checkpoint_dir: {tmp_path / 'ckpt'}\n"
        f"  output_dir: {tmp_path / 'out'}\n")
    cli.main(["train", "--config", str(cfg), "--device", "cpu",
              "--data-parallel", "--world-size", "2",
              "--max-steps-per-epoch", "1"])
    lines = [json.loads(x) for x in
             (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in lines if "train/loss/total" in r]
    assert len(steps) == 1 and math.isfinite(steps[0]["train/loss/total"])
    assert (tmp_path / "ckpt" / "latest" / TCK.STATE_FILE).exists()


def test_dryrun_multichip_tiny(monkeypatch):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    res = dryrun.dryrun_multichip(2, device="cpu")
    assert res["head_delta"] < dryrun.HEAD_TOL
    assert res["loss_delta"] < dryrun.HEAD_TOL
    assert res["sweep_delta"] < dryrun.SWEEP_TOL and math.isfinite(res["loss"])
