"""The port's training slice against the JAX package, on the CPU in f32.

- Losses: every function of ``ops/losses.py`` to 1e-6 relative.
- Optimizer: the global-norm clip and the cosine schedule against optax,
  and the whole clip + AdamW chain step by step on the same gradients.
- Train step: the JAX ``atht.init_tiny`` params carried into the port by
  ``convert/jax_params``; on the same batch, the head's gradients (1e-4 of
  each leaf's largest) and three train steps of each (loss to 1e-5
  relative, head params after three steps to 1e-2 x lr absolute: Adam's
  update is about ±lr·g/(|g|+eps), so small gradient differences move it by
  a small fraction of lr).
- The opt-in kernel selection gives the per-op path's loss on the CPU.
- The trainer end to end (two epochs, val SDR, ``latest`` / ``best`` /
  ``epoch_0001``, resume), as ``tests/test_trainer.py`` runs the JAX one.
- Checkpoints: a head the port saves loads in the JAX ``load_params_npz``;
  the config parses as the JAX config does.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_to_sheet_music_tpu import config as JC
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.ops import losses as JL
from audio_to_sheet_music_tpu.train import checkpoint as JCK
from audio_to_sheet_music_tpu.train import step as JS
from audio_to_sheet_music_tpu_torch import config as TC
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.ops import losses as TL
from audio_to_sheet_music_tpu_torch.train import checkpoint as TCK
from audio_to_sheet_music_tpu_torch.train import step as TS

LR = 1e-3


def _rel(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=0)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def est_tgt():
    r = np.random.default_rng(0)
    tgt = r.standard_normal((3, 2, 500)).astype(np.float32)
    est = (tgt + 0.3 * r.standard_normal((3, 2, 500))).astype(np.float32)
    est[2] = r.standard_normal((2, 500))          # one poor estimate
    return est, tgt


@pytest.mark.parametrize("name", ["sdr_loss", "sisdr_loss", "new_sdr_metric"])
def test_loss_functions_match_jax(est_tgt, name):
    est, tgt = est_tgt
    want = getattr(JL, name)(jnp.asarray(est), jnp.asarray(tgt))
    got = getattr(TL, name)(torch.from_numpy(est), torch.from_numpy(tgt))
    _rel(got, want, 1e-6)


def test_loss_clamps_at_30_db_like_jax():
    tgt = np.ones((2, 1, 8), np.float32)
    for est in (tgt.copy(), np.zeros_like(tgt) + 1e3):
        want = JL.sdr_loss(jnp.asarray(est), jnp.asarray(tgt))
        got = TL.sdr_loss(torch.from_numpy(est), torch.from_numpy(tgt))
        assert abs(float(got)) == 30.0
        _rel(got, want, 1e-6)


@pytest.mark.parametrize("which", ["combined_loss", "combined_l1_sdr_loss"])
def test_combined_losses_match_jax(est_tgt, which):
    est, tgt = est_tgt
    kw = ({"sdr_weight": 0.7, "sisdr_weight": 0.3} if which == "combined_loss"
          else {"sdr_weight": 1.0, "l1_weight": 0.1})
    jl, jm = getattr(JL, which)(jnp.asarray(est), jnp.asarray(tgt), **kw)
    tl, tm = getattr(TL, which)(torch.from_numpy(est), torch.from_numpy(tgt),
                                **kw)
    _rel(tl, jl, 1e-6)
    assert tm.keys() == jm.keys()
    for k in tm:
        _rel(tm[k], jm[k], 1e-6)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    r = np.random.default_rng(1)
    grads = [(scale * r.standard_normal(s)).astype(np.float32)
             for s in ((4, 3), (7,), (2, 2, 2))]
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = TS.clip_by_global_norm_(got, 1.0)
    _rel(norm, optax.global_norm([jnp.asarray(g) for g in grads]), 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(LR, 7, alpha=0.01)
    for count in range(10):
        _rel(LR * TS.cosine_decay(count, 7, 0.01), sched(count), 1e-6)


def test_optimizer_chain_matches_optax_step_by_step():
    """Clip 1.0 (gradients large enough to clip on some steps), AdamW with
    weight decay, the cosine schedule over 4 steps, run for 6: the same
    parameters after every step, and an unused parameter (no gradient) still
    decays, as optax decays it."""
    r = np.random.default_rng(2)
    shapes = ((5, 3), (3,), (2, 4))
    p0 = [r.standard_normal(s).astype(np.float32) for s in shapes]
    tx = JS.make_optimizer(LR, 1e-2, 1.0, total_steps=4)
    jp = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = TS.make_optimizer(tp, LR, 1e-2, 1.0, total_steps=4)
    for step in range(6):
        g = [(r.standard_normal(s) * (0.2 if step % 2 else 3.0)
              ).astype(np.float32) for s in shapes]
        g[2][:] = 0.0                                   # no gradient
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp[:2], g[:2]):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-2 * LR * 1e-2, rtol=1e-6)


# ---------------------------------------------------------------------------
# Train step against the JAX step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    return params


def _port_model(params):
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def batch():
    """One unit-level example.  Adam normalises each element, so an element
    whose gradient is a near-cancellation moves by O(lr) on last-bit
    differences; with one example the text projection's gradient is an
    outer product rather than a sum of two, and such elements are rare."""
    r = np.random.default_rng(3)
    mix = r.standard_normal((1, 2, 11025)).astype(np.float32)
    tgt = (0.5 * mix + 0.1 * r.standard_normal((1, 2, 11025))
           ).astype(np.float32)
    ids = np.array([[0, 9, 11, 13, 8, 2]], np.int32)
    return {"mixture": mix, "target": tgt, "input_ids": ids,
            "attention_mask": (ids != 1).astype(np.int32)}


def _head_grads(model):
    """The head's gradients; a parameter the loss does not reach (the text
    attention's unused query/key projections) has none, which JAX reports
    as zeros."""
    return {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.numpy())
            for k, p in model.head.named_parameters()}


def test_head_gradients_match_jax(pair, batch):
    params = pair
    frozen = {"htdemucs": params["htdemucs"], "clap": params["clap"]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(
        lambda h, f, b: jax.value_and_grad(JS._loss, has_aux=True)(
            h, f, b, {}, jnp.float32))(params["head"], frozen, jb)
    want = {k[len("head."):]: v.numpy() for k, v in
            jax_params.state_dict_from_params(
                jax.tree.map(np.asarray, jgrads), prefix=("head",)).items()}
    model = _port_model(params)
    state = TS.TrainState.create(model, lambda p: TS.make_optimizer(p, LR))
    loss, _ = TS._loss(state.model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                       {}, torch.float32, True)
    loss.backward()
    _rel(loss.detach(), jloss, 1e-5)
    got = _head_grads(model)
    assert got.keys() == want.keys() and len(got) == 50
    for k, g in got.items():
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g, want[k], atol=1e-4 * scale + 1e-12,
                                   rtol=0, err_msg=k)
    for name, p in model.named_parameters():         # towers stay frozen
        assert p.requires_grad == name.startswith("head.")


def test_three_train_steps_match_jax(pair, batch):
    params = pair
    frozen = {"htdemucs": params["htdemucs"], "clap": params["clap"]}
    tx = JS.make_optimizer(LR, 1e-2, 5.0, total_steps=3)
    jstate = JS.TrainState.create(jax.tree.map(jnp.asarray, params["head"]),
                                  tx)
    jstep = JS.make_train_step(tx, {}, jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    model = _port_model(params)
    state = TS.TrainState.create(model, lambda p: TS.make_optimizer(
        p, LR, 1e-2, 5.0, total_steps=3))
    tstep = TS.make_train_step({}, torch.float32, True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jstep(jstate, frozen, jb)
        tm = tstep(state, tb)
        _rel(tm["loss/total"], jm["loss/total"], 1e-5)
        _rel(tm["grad_norm"], jm["grad_norm"], 1e-4)
    assert state.step == int(jstate.step) == 3
    want = jax_params.state_dict_from_params(
        jax.tree.map(np.asarray, jstate.head), prefix=("head",))
    for k, p in model.head.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want["head." + k].numpy(),
                                   atol=1e-2 * LR, rtol=0, err_msg=k)


def test_opt_in_selection_gives_the_per_op_loss(pair, batch):
    """On the CPU every kernel's wrapper takes its plain version, so the
    opt-in selection (STFT, DConv-over-rows, attention block, fused layer 0)
    must give the per-op path's loss and gradients."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for sel in ("opt_in", None):
        model = _port_model(pair)
        state = TS.TrainState.create(model, lambda p: TS.make_optimizer(p, LR))
        loss, _ = TS._loss(state.model, tb, {}, torch.float32, sel)
        loss.backward()
        out[sel] = (float(loss.detach()), _head_grads(model))
    _rel(out["opt_in"][0], out[None][0], 1e-5)
    for k, g in out["opt_in"][1].items():
        ref = out[None][1][k]
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()) + 1e-12)


# ---------------------------------------------------------------------------
# Trainer, checkpoints, config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from audio_to_sheet_music_tpu_torch.data import synthetic_tracks

    data_dir = tmp_path_factory.mktemp("port_train_data")
    synthetic_tracks(2, seconds=1.0, cache_dir=data_dir)
    work = tmp_path_factory.mktemp("port_work")
    cfg = TC.Config(
        data=TC.DataConfig(train_dir=str(data_dir), test_dir=str(data_dir),
                           segment_seconds=0.25, augment=True,
                           random_segments=True, pct_test=0.3),
        model=TC.ModelConfig(compute_dtype="float32"),
        training=TC.TrainingConfig(batch_size=2, num_epochs=2,
                                   optimizer=TC.OptimizerConfig(lr=3e-4)),
        wandb=TC.WandbConfig(use_wandb=False, log_every=1, validate_every=1,
                             save_every=1, checkpoint_dir=str(work / "ckpt"),
                             output_dir=str(work / "out")))
    return cfg, work


class TestTrainer:
    def test_train_validate_checkpoint(self, env):
        from audio_to_sheet_music_tpu_torch.train.trainer import train

        cfg, work = env
        result = train(cfg, model=TA.init_tiny(0), max_steps_per_epoch=2,
                       device="cpu", kernels="opt_in")
        assert np.isfinite(result["final_loss"])
        assert np.isfinite(result["best_sdr"])
        for d in ("latest", "best", "epoch_0001"):
            assert (work / "ckpt" / d / TCK.STATE_FILE).exists()
        meta = json.loads((work / "ckpt" / "latest" / "meta.json").read_text())
        assert meta["epoch"] == 1 and "val_sdr" in meta["metrics"]
        lines = (work / "out" / "metrics.jsonl").read_text().splitlines()
        recs = [json.loads(x) for x in lines]
        assert any("train/loss/total" in r for r in recs)
        assert any(k.startswith("val/sdr_") for r in recs for k in r)

    def test_resume_from_latest(self, env):
        """A second call resumes after epoch 1 with the saved head and
        optimizer, and trains no further."""
        from audio_to_sheet_music_tpu_torch.train.trainer import train

        cfg, work = env
        model = TA.init_tiny(0)
        result = train(cfg, model=model, max_steps_per_epoch=2, device="cpu")
        assert result["final_epoch"] == 1
        saved = torch.load(work / "ckpt" / "latest" / TCK.STATE_FILE,
                           weights_only=True)
        assert saved["step"] == 4
        for k, v in model.head.state_dict().items():
            assert torch.equal(v, saved["head"][k])

    def test_more_workers_are_refused(self, env, tmp_path, monkeypatch):
        """``num_workers >= 1`` asks for the C++ segment loader: when it
        cannot be built, training is refused rather than run on the Python
        loader."""
        from audio_to_sheet_music_tpu_torch.data import native_loader
        from audio_to_sheet_music_tpu_torch.train.trainer import train

        cfg, _ = env
        cfg2 = dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, num_workers=2))
        monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(native_loader, "COMPILER", "false")
        with pytest.raises(RuntimeError, match="segment loader"):
            train(cfg2, model=TA.init_tiny(0), device="cpu")


def test_saved_head_loads_in_the_jax_package(tmp_path):
    model = TA.init_tiny(1)
    path = tmp_path / "head.npz"
    TCK.save_params_npz(path, model.head)
    template = jax.eval_shape(lambda k: JA.init_tiny(k)["head"],
                              jax.random.PRNGKey(0))
    loaded = JCK.load_params_npz(path, template)
    want = {k[len("head."):]: v for k, v in jax_params.state_dict_from_params(
        jax.tree.map(np.asarray, loaded), prefix=("head",)).items()}
    got = model.head.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())
    again = TA.init_tiny(2)
    TCK.load_params_npz(path, again.head)
    for k, v in again.head.state_dict().items():
        assert torch.equal(v, got[k])


def test_committed_head_loads_through_load_params_npz():
    head = TA.Head(key=None)
    TCK.load_params_npz(TA.DEFAULT_HEAD, head)
    with np.load(TA.DEFAULT_HEAD) as data:
        for k, v in head.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), data[k.replace(".", "/")])


@pytest.mark.parametrize("raw", [
    {},
    {"training": {"optimizer": {"grad_clip": None, "lr": 3e-4},
                  "loss_weights": {"sdr": 0.7, "sisdr_weight": 0.3}}},
    {"training": {"loss_weights": {"sdr_weight": 0.6, "sisdr": 0.4}},
     "data": {"segment_seconds": 0.5}, "wandb": {"run_name": None}},
])
def test_config_parses_as_jax(raw):
    assert dataclasses.asdict(TC.Config.from_dict(raw)) == dataclasses.asdict(
        JC.Config.from_dict(raw))


def test_config_yaml_parses_as_jax():
    assert dataclasses.asdict(TC.Config.from_yaml("config.yaml")) == \
        dataclasses.asdict(JC.Config.from_yaml("config.yaml"))


def test_cli_train_passes_its_options(monkeypatch, tmp_path):
    from audio_to_sheet_music_tpu_torch import cli
    from audio_to_sheet_music_tpu_torch.train import trainer

    seen = {}
    monkeypatch.setattr(trainer, "train",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw) or {})
    cli.main(["train", "--config", str(tmp_path / "absent.yaml"), "--device",
              "cpu", "--kernels", "opt_in", "--max-steps-per-epoch", "3"])
    assert seen["device"] == "cpu" and seen["kernels"] == "opt_in"
    assert seen["max_steps_per_epoch"] == 3
    assert seen["cfg"] == TC.Config()
    with pytest.raises(SystemExit):
        cli.main(["serve"])
