"""Head-only training: the port's counterpart of
``audio_to_sheet_music_tpu/train/trainer.py``.

``train(cfg)`` wires: config -> model (given; else a reference ``.pt`` in
``training.resume_from``, converted; else the seeded init with the
committed trained head) on ``cuda`` unless ``device="cpu"`` -> decode-once
datasets + a loader (the C++ segment loader for ``num_workers >= 1``, else
the prefetching Python one) -> AdamW / cosine / clip over the head ->
auto-resume from ``latest`` -> the epoch loop -> validation with per-stem
SDR buckets -> epoch / best / latest checkpoints -> metric logging (JSONL
always; wandb when configured and importable, with the separation triptych
of one example at every logged step).

The kernel selection (``ops.select``) is the caller's: the default runs
``layer_tail`` + ``henc_freq_fused``; ``"opt_in"`` runs ``henc_freq_fused``,
``dconv_rows``, ``attn_block`` and the STFT kernel.  All of them sit in the
frozen encoder, which runs without autograd.

Not here yet: the data-parallel mesh argument.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config
from ..data import BatchLoader, StemSegmentDataset, discover_tracks
from ..data.native_loader import NativeBatchLoader
from ..infer.session import open_device
from ..models import atht
from ..ops.select import Kernels
from ..text.prompts import STEM_NAMES
from ..text.tokenizer import default_tokenizer
from . import checkpoint as ckpt
from .step import TrainState, make_eval_step, make_optimizer, make_train_step


class MetricLogger:
    """JSONL always (``output_dir/metrics.jsonl``), wandb when enabled and
    the package imports."""

    def __init__(self, cfg: Config, out_dir: Path):
        self._wandb = None
        out_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(out_dir / "metrics.jsonl", "a")
        if cfg.wandb.use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=cfg.wandb.project,
                                         name=cfg.wandb.run_name)
            except Exception as e:  # noqa: BLE001 - degrade loudly
                print(f"WARNING: use_wandb=True but wandb is unavailable "
                      f"({e}); metrics go to JSONL only", flush=True)
                self._wandb = None

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        rec = {k: float(v) for k, v in metrics.items()}
        rec["step"] = step
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(rec, step=step)

    @property
    def media_active(self) -> bool:
        return self._wandb is not None

    def log_media(self, mixture, target, estimate, stem: str, step: int,
                  device) -> None:
        """The separation triptych and the three clips of one example."""
        if self._wandb is None:
            return
        from ..utils import wandb_log

        wandb_log.log_separation_to_wandb(mixture, target, estimate, stem,
                                          step=step, prefix="train_media",
                                          device=device)

    def close(self) -> None:
        self._jsonl.close()


def _subset(dataset: StemSegmentDataset, pct: float, seed: int = 0):
    """Random percentage subset (reference `src/train.py:444-452`)."""
    if pct >= 1.0:
        return dataset
    rng = np.random.default_rng(seed)
    n = max(1, int(len(dataset.index_map) * pct))
    keep = rng.permutation(len(dataset.index_map))[:n]
    dataset.index_map = [dataset.index_map[i] for i in keep]
    return dataset


def _default_model(cfg: Config) -> atht.AudioTextHTDemucs:
    """A reference ``.pt`` in ``training.resume_from``, converted (the model
    is then ``pretrained``), else the seeded init with the committed
    trained head."""
    resume = cfg.training.resume_from
    pt = resume if resume and Path(resume).suffix == ".pt" else None
    return atht.load_params(atht.init(0), pt)


def _train_loader(cfg: Config, tracks, tokenizer):
    """The C++ segment loader with ``num_workers`` threads when asked for
    and every track is a decode-once ``npy`` cache with no percentage
    subset; else the Python ``BatchLoader``, as in the JAX trainer."""
    seg = cfg.data.segment_samples
    if (cfg.training.num_workers >= 1 and cfg.data.pct_train >= 1.0
            and all(t.kind == "npy" for t in tracks)):
        return NativeBatchLoader(
            [t.path for t in tracks], seg, cfg.training.batch_size, tokenizer,
            n_threads=cfg.training.num_workers, augment=cfg.data.augment,
            random_segments=cfg.data.random_segments)
    ds = _subset(StemSegmentDataset(tracks, seg,
                                    random_segments=cfg.data.random_segments,
                                    augment=cfg.data.augment),
                 cfg.data.pct_train)
    return BatchLoader(ds, cfg.training.batch_size, tokenizer)


def put_batch(raw: Mapping[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device`` (``stem_index`` stays on the
    host)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device, non_blocking=True)
            for k, v in raw.items() if k != "stem_index"}


def _log_media(logger: MetricLogger, model, batch, raw, step: int,
               compute_dtype, kernels, device) -> None:
    """The first example of ``batch`` through the model as it is now."""
    with torch.no_grad():
        est = atht.forward(model, batch["mixture"][:1],
                           batch["input_ids"][:1],
                           batch["attention_mask"][:1], compute_dtype,
                           kernels)
    stem = STEM_NAMES[int(raw["stem_index"][0])]
    logger.log_media(raw["mixture"][0], raw["target"][0],
                     est[0].float().cpu().numpy(), stem, step, device)


def train(cfg: Config, model: atht.AudioTextHTDemucs | None = None,
          max_steps_per_epoch: int | None = None,
          device: str | torch.device = "cuda", kernels: Kernels = True
          ) -> Dict[str, float]:
    """Run training; returns ``{"best_sdr", "final_epoch", "final_loss",
    "steps_per_s"}``.

    ``model`` defaults to a reference ``.pt`` named by
    ``training.resume_from``, converted, else the seeded init with the
    committed trained head.  A model marked ``pretrained`` (converted real
    weights: ``atht.load_params`` of a ``.pt`` marks it) makes the tokenizer
    refuse the hash fallback.  ``device`` defaults to ``cuda``.
    """
    device = open_device(device, "train")
    compute_dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
                     else torch.float32)
    out_dir = Path(cfg.wandb.output_dir)
    logger = MetricLogger(cfg, out_dir)
    if model is None:
        model = _default_model(cfg)
    model = model.to(device)
    tokenizer = default_tokenizer(require_real=model.pretrained)

    train_tracks = discover_tracks(cfg.data.train_dir)
    val_tracks = discover_tracks(cfg.data.test_dir)
    if not val_tracks:
        print(f"WARNING: no validation tracks found under "
              f"{cfg.data.test_dir!r}; validating on TRAINING tracks — "
              "val/sdr and best-checkpoint selection are unreliable",
              flush=True)
        val_tracks = train_tracks
    seg = cfg.data.segment_samples
    train_loader = _train_loader(cfg, train_tracks, tokenizer)
    val_ds = _subset(StemSegmentDataset(val_tracks, seg), cfg.data.pct_test,
                     seed=1)
    val_loader = BatchLoader(val_ds, cfg.training.batch_size, tokenizer,
                             shuffle=False)
    if len(val_loader) == 0:
        print(f"WARNING: validation set ({len(val_ds)} samples) is smaller "
              f"than batch_size={cfg.training.batch_size}; no val batches "
              "will run and no 'best' checkpoint will be selected", flush=True)

    steps_per_epoch = min(len(train_loader), max_steps_per_epoch or 10**9)
    total_steps = max(1, steps_per_epoch * cfg.training.num_epochs)
    opt_cfg = cfg.training.optimizer
    loss_cfg = {
        "use_l1": cfg.training.use_L1_comb_loss,
        "sdr_weight": cfg.training.sdr_weight,
        "sisdr_weight": cfg.training.sisdr_weight,
        "l1_sdr_weight": cfg.training.l1_sdr_weight,
        "l1_weight": cfg.training.l1_weight,
    }
    state = TrainState.create(model, lambda params: make_optimizer(
        params, opt_cfg.lr, opt_cfg.weight_decay, opt_cfg.grad_clip,
        total_steps))
    train_step = make_train_step(loss_cfg, compute_dtype, kernels)
    eval_step = make_eval_step(loss_cfg, compute_dtype, kernels)

    ckpt_dir = Path(cfg.wandb.checkpoint_dir)
    start_epoch, best_sdr = 0, -np.inf
    resume = cfg.training.resume_from
    latest = None
    if resume and Path(resume).suffix != ".pt":
        if not Path(resume).exists():
            raise FileNotFoundError(
                f"training.resume_from points at missing checkpoint: {resume}")
        latest = Path(resume)
    if latest is None:
        latest = ckpt.latest_checkpoint(ckpt_dir)
    if latest is not None:
        state, epoch, metrics = ckpt.load_checkpoint(latest, state)
        start_epoch = epoch + 1
        best_sdr = metrics.get("best_sdr", -np.inf)
        print(f"resumed from {latest} at epoch {start_epoch}")

    mean_loss, rate = float("nan"), float("nan")
    for epoch in range(start_epoch, cfg.training.num_epochs):
        t0 = time.perf_counter()
        loss_sum = torch.zeros((), device=device)
        n_steps = 0
        for i, raw in enumerate(train_loader):
            if i >= steps_per_epoch:
                break
            batch = put_batch(raw, device)
            metrics = train_step(state, batch)
            if state.step % cfg.wandb.log_every == 0:
                logger.log({f"train/{k}": float(v) for k, v in metrics.items()},
                           state.step)
                if logger.media_active:
                    _log_media(logger, state.model, batch, raw, state.step,
                               compute_dtype, kernels, device)
            loss_sum = loss_sum + metrics["loss/total"]
            n_steps += 1
        mean_loss = float(loss_sum) / n_steps if n_steps else float("nan")
        rate = n_steps / max(time.perf_counter() - t0, 1e-9)
        print(f"epoch {epoch}: loss {mean_loss:.4f} ({rate:.2f} steps/s)")

        val_sdr = float("nan")
        if (epoch + 1) % cfg.wandb.validate_every == 0:
            per_stem = {s: [] for s in STEM_NAMES}
            agg = []
            for raw in val_loader:
                _, per_item = eval_step(state.model, put_batch(raw, device))
                per_item = per_item.float().cpu().numpy()
                agg.append(per_item.mean())
                for j, si in enumerate(raw["stem_index"]):
                    per_stem[STEM_NAMES[int(si)]].append(float(per_item[j]))
            if agg:
                val_sdr = float(np.mean(agg))
                log = {"val/sdr": val_sdr}
                log.update({f"val/sdr_{s}": float(np.mean(v))
                            for s, v in per_stem.items() if v})
                logger.log(log, state.step)
                print(f"  val SDR {val_sdr:.2f} dB")

        is_best = bool(np.isfinite(val_sdr) and val_sdr > best_sdr)
        if is_best:
            best_sdr = val_sdr
        ckpt.save_checkpoint(ckpt_dir, state, epoch,
                             {"loss": mean_loss, "val_sdr": val_sdr,
                              "best_sdr": best_sdr},
                             is_best=is_best, every=cfg.wandb.save_every)
    logger.close()
    return {"best_sdr": float(best_sdr),
            "final_epoch": cfg.training.num_epochs - 1,
            "final_loss": mean_loss, "steps_per_s": rate}
