"""Checkpoints with the reference's epoch/best/latest semantics: the port's
counterpart of ``audio_to_sheet_music_tpu/train/checkpoint.py``.

Each save is a directory (``latest`` always, ``best`` on a new best
validation SDR, ``epoch_NNNN`` every ``every`` epochs) holding
``state.pt`` — ``torch.save`` of {head ``state_dict``, optimizer (AdamW and
the schedule), step} — and ``meta.json`` (epoch and metrics).  As in the JAX
package the frozen towers are never saved: they do not change.

``save_params_npz`` / ``load_params_npz`` keep the JAX package's ``.npz``
format, one array per leaf keyed by its ``/``-joined pytree path, so a head
trained here loads in the JAX ``load_params_npz`` and the committed
``artifacts/trained_head.npz`` loads here.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..convert import jax_params
from .step import TrainState

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str | Path, state: TrainState, epoch: int,
                    metrics: Dict[str, float] | None = None,
                    is_best: bool = False, every: int | None = None) -> None:
    """Write ``latest`` (always), ``best`` (on new best SDR) and
    ``epoch_NNNN`` (every ``every`` epochs)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    meta = {"epoch": int(epoch),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()}}
    targets = [ckpt_dir / "latest"]
    if is_best:
        targets.append(ckpt_dir / "best")
    if every and (epoch + 1) % every == 0:
        targets.append(ckpt_dir / f"epoch_{epoch:04d}")
    first = targets[0]
    first.mkdir(parents=True, exist_ok=True)
    tmp = first / (STATE_FILE + ".tmp")
    torch.save({"head": state.model.head.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, tmp)
    tmp.replace(first / STATE_FILE)
    (first / "meta.json").write_text(json.dumps(meta))
    for t in targets[1:]:
        if t.exists():
            shutil.rmtree(t)
        shutil.copytree(first, t)


def load_checkpoint(path: str | Path, state: TrainState
                    ) -> Tuple[TrainState, int, Dict]:
    """Restore the head, the optimizer and the step into ``state`` from a
    checkpoint directory; returns ``(state, epoch, metrics)``."""
    path = Path(path)
    device = next(state.model.head.parameters()).device
    saved = torch.load(path / STATE_FILE, map_location=device,
                       weights_only=True)
    state.model.head.load_state_dict(saved["head"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    meta = {"epoch": -1, "metrics": {}}
    if (path / "meta.json").exists():
        meta = json.loads((path / "meta.json").read_text())
    return state, int(meta.get("epoch", -1)), meta.get("metrics", {})


def load_head(path: str | Path, head: torch.nn.Module) -> torch.nn.Module:
    """The head of the checkpoint directory ``path`` into ``head``,
    strictly (the serving and separation commands' view of a training
    run)."""
    saved = torch.load(Path(path) / STATE_FILE, map_location="cpu",
                       weights_only=True)
    head.load_state_dict(saved["head"], strict=True)
    return head


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """Auto-resume hook: the ``latest`` directory if present."""
    p = Path(ckpt_dir) / "latest"
    return p if p.exists() else None


def save_params_npz(path: str | Path, module: torch.nn.Module,
                    prefix: Sequence[str] = ("head",)) -> None:
    """A module's parameters -> ``.npz`` keyed by their JAX pytree paths.

    ``prefix`` is where ``module`` sits in the full model tree.  Only
    modules whose names map one to one onto their paths are taken (the head
    does); a name that ``convert.jax_params.translate`` rewrites raises."""
    flat = {}
    for name, t in module.state_dict().items():
        parts = name.split(".")
        full = list(prefix) + parts
        if jax_params.translate(full) != ".".join(full):
            raise ValueError(f"save_params_npz: {name} has no one-to-one "
                             "JAX path")
        flat["/".join(parts)] = t.detach().float().cpu().numpy()
    np.savez(path, **flat)


def load_params_npz(path: str | Path, module: torch.nn.Module,
                    prefix: Sequence[str] = ("head",)) -> torch.nn.Module:
    """Load a JAX ``save_params_npz`` file of the tree at ``prefix`` (the
    head by default) into ``module``, strictly."""
    return jax_params.load_npz(module, path, tuple(prefix))
