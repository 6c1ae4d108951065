"""Head-only train and eval steps: the port's counterpart of
``audio_to_sheet_music_tpu/train/step.py``.

- Only the ~3 M-param head trains.  The model is built frozen; ``TrainState``
  makes exactly the head's parameters trainable, the optimizer holds only
  those, and ``atht.forward`` runs the towers (HTDemucs + CLAP) under
  ``torch.no_grad()``, so the hand-written kernels, which have no backward,
  only ever see tensors without autograd.
- bf16 compute with f32 master weights, f32 loss: the head casts its f32
  parameters to the compute dtype inside the forward (``nn.core``), so
  autograd through the cast gives f32 gradients.  No ``torch.autocast``: it
  picks its own dtypes and would break parity with the JAX package.
- The optimizer is optax's ``chain(clip_by_global_norm(clip),
  adamw(cosine_decay_schedule(lr, total_steps, alpha=0.01), wd))`` written
  out, not torch's defaults: the clip scales by ``clip / norm`` only when
  ``norm >= clip`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` always); the schedule is the closed form, evaluated at the
  count of updates before this one; AdamW decays every head parameter, with
  eps 1e-8 outside the square root (as ``torch.optim.AdamW``), and a
  parameter the loss does not reach gets a zero gradient (and so still
  decays), as optax does.
- Data parallel (``data_parallel=True``): each process holds its own rows
  of the global batch; after ``backward`` one all-reduce averages the
  head's gradients (``parallel.mesh.allreduce_mean_``), and another the
  loss metrics, before the clip.  With equal rows a process, the step then
  equals the single-device step on the global batch, as the JAX package's
  inserted psum makes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch

from ..models import atht
from ..ops import losses
from ..ops.select import Kernels
from ..parallel.mesh import allreduce_mean_
from ..utils import profiling

Batch = Mapping[str, torch.Tensor]   # mixture (B,2,T), target (B,2,T),
                                     # input_ids (B,L), attention_mask (B,L)


def cosine_decay(count: int, total_steps: int, alpha: float) -> float:
    """``optax.cosine_decay_schedule(1, total_steps, alpha)`` at ``count``."""
    t = min(count, total_steps)
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / total_steps)) + alpha


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (no host sync)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: unchanged when the global
    norm is below ``max_norm``, else each gradient is ``g / norm * max_norm``.
    Returns the norm before clipping."""
    norm = global_norm(grads)
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


class HeadOptimizer:
    """Global-norm clip, then AdamW under the cosine schedule (optax's
    order); ``step`` reads the parameters' ``.grad`` and returns the global
    gradient norm before clipping."""

    def __init__(self, params, lr: float = 1e-4, weight_decay: float = 1e-2,
                 grad_clip: float | None = 5.0,
                 total_steps: int | None = None,
                 eta_min_ratio: float = 0.01):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)
        self.scheduler = None
        if total_steps:
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.adamw,
                lambda count: cosine_decay(count, total_steps, eta_min_ratio))

    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.grad_clip is not None:
            norm = clip_by_global_norm_(grads, self.grad_clip)
        else:
            norm = global_norm(grads)
        self.adamw.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.adamw.zero_grad(set_to_none=True)
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(),
                "scheduler": (None if self.scheduler is None
                              else self.scheduler.state_dict())}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        if self.scheduler is not None and state.get("scheduler") is not None:
            self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 1e-2,
                   grad_clip: float | None = 5.0,
                   total_steps: int | None = None,
                   eta_min_ratio: float = 0.01) -> HeadOptimizer:
    """AdamW + cosine anneal to ``lr * eta_min_ratio`` + global-norm clip
    over ``params`` (the head's)."""
    return HeadOptimizer(params, lr, weight_decay, grad_clip, total_steps,
                         eta_min_ratio)


@dataclasses.dataclass
class TrainState:
    """The model (towers frozen, head trainable), its optimizer and the
    count of steps taken."""

    step: int
    model: atht.AudioTextHTDemucs
    optimizer: HeadOptimizer

    @staticmethod
    def create(model: atht.AudioTextHTDemucs,
               optimizer_fn: Callable[[List[torch.nn.Parameter]], HeadOptimizer]
               ) -> "TrainState":
        """Freeze the whole model, make the head trainable, and build the
        optimizer over exactly the head's parameters."""
        model.requires_grad_(False)
        model.head.requires_grad_(True)
        return TrainState(0, model, optimizer_fn(list(model.head.parameters())))


def _loss(model, batch: Batch, loss_cfg: Mapping[str, Any], compute_dtype,
          kernels: Kernels) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    est = atht.forward(model, batch["mixture"], batch["input_ids"],
                       batch["attention_mask"], compute_dtype, kernels)
    if loss_cfg.get("use_l1", False):
        return losses.combined_l1_sdr_loss(
            est, batch["target"],
            sdr_weight=loss_cfg.get("l1_sdr_weight", 1.0),
            l1_weight=loss_cfg.get("l1_weight", 0.1))
    return losses.combined_loss(
        est, batch["target"],
        sdr_weight=loss_cfg.get("sdr_weight", 0.9),
        sisdr_weight=loss_cfg.get("sisdr_weight", 0.1))


def make_train_step(loss_cfg: Mapping[str, Any] | None = None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    kernels: Kernels = True, data_parallel: bool = False
                    ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """``train_step(state, batch) -> metrics``: one forward, backward through
    the head, clip and AdamW; updates ``state`` in place.  The metrics are
    detached 0-d tensors on the device, ``grad_norm`` among them.  With
    ``data_parallel`` (a process group joined by
    ``parallel.init_data_parallel``), ``batch`` is this process's rows and
    the gradients and metrics are averaged over the group.  Spans
    ``atsm.train.step`` over ``atsm.train.forward``, ``atsm.train.backward``
    (with the data-parallel averages) and ``atsm.train.optimizer``."""
    loss_cfg = dict(loss_cfg or {})

    def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        with profiling.span("atsm.train.step"):
            with profiling.span("atsm.train.forward"):
                loss, metrics = _loss(state.model, batch, loss_cfg,
                                      compute_dtype, kernels)
            with profiling.span("atsm.train.backward"):
                loss.backward()
                metrics = {k: v.detach() for k, v in metrics.items()}
                if data_parallel:
                    params = state.optimizer.params
                    for p in params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    allreduce_mean_([p.grad for p in params])
                    names = list(metrics)
                    avg = torch.stack([metrics[k].float() for k in names])
                    allreduce_mean_([avg])
                    metrics = dict(zip(names, avg.unbind()))
            with profiling.span("atsm.train.optimizer"):
                metrics["grad_norm"] = state.optimizer.step()
            state.step += 1
            return metrics

    return train_step


def make_eval_step(loss_cfg: Mapping[str, Any] | None = None,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   kernels: Kernels = True):
    """No-grad validation step ``eval_step(model, batch) -> (metrics,
    per_item_sdr)``; the caller buckets per-stem SDR with the host batch's
    ``stem_index``."""
    loss_cfg = dict(loss_cfg or {})

    @torch.no_grad()
    def eval_step(model, batch: Batch):
        est = atht.forward(model, batch["mixture"], batch["input_ids"],
                           batch["attention_mask"], compute_dtype, kernels)
        _, metrics = losses.combined_loss(
            est, batch["target"],
            sdr_weight=loss_cfg.get("sdr_weight", 0.9),
            sisdr_weight=loss_cfg.get("sisdr_weight", 0.1))
        return metrics, losses.new_sdr_metric(est, batch["target"])

    return eval_step
