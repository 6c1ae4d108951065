"""Separation losses: the port's counterpart of
``audio_to_sheet_music_tpu/ops/losses.py`` (reference `src/loss.py`).

All functions take ``estimated`` / ``target`` tensors of shape ``(B, C, T)``
(or any ``(B, ...)``), reduce exactly as the reference does, and return f32
scalars, with the JAX package's constants:

- ``sdr_loss``    — −10·log10((‖t‖²+δ)/(‖t−e‖²+δ)), δ=1e-8, clamped ±30 dB,
  mean over batch.
- ``sisdr_loss``  — zero-mean, project estimate onto target, same clamp.
- ``new_sdr_metric`` — MDX-style per-item SDR over (C, T), no clamp.
- ``combined_loss`` — 0.9·sdr + 0.1·sisdr + logging metrics.
- ``combined_l1_sdr_loss`` — sdr + L1.

The combined losses return ``(loss, metrics)``; the metrics are 0-d tensors
(``float()`` them for logging).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_DELTA = 1e-8


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float()


def sdr_loss(estimated: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Negative SDR, mean over batch, clamped to ±30 dB."""
    est = _flatten(estimated)
    tgt = _flatten(target)
    num = torch.sum(tgt ** 2, dim=-1)
    den = torch.sum((tgt - est) ** 2, dim=-1)
    sdr = 10.0 * torch.log10((num + _DELTA) / (den + _DELTA))
    return -torch.clamp(sdr, -30.0, 30.0).mean()


def sisdr_loss(estimated: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Negative scale-invariant SDR, mean over batch, clamped to ±30 dB."""
    est = _flatten(estimated)
    tgt = _flatten(target)
    est = est - est.mean(dim=-1, keepdim=True)
    tgt = tgt - tgt.mean(dim=-1, keepdim=True)
    dot = torch.sum(est * tgt, dim=-1, keepdim=True)
    tgt_energy = torch.sum(tgt ** 2, dim=-1, keepdim=True)
    s_target = (dot / (tgt_energy + _DELTA)) * tgt
    e_noise = est - s_target
    num = torch.sum(s_target ** 2, dim=-1)
    den = torch.sum(e_noise ** 2, dim=-1)
    sisdr = 10.0 * torch.log10((num + _DELTA) / (den + _DELTA))
    return -torch.clamp(sisdr, -30.0, 30.0).mean()


def new_sdr_metric(estimated: torch.Tensor, target: torch.Tensor
                   ) -> torch.Tensor:
    """MDX-challenge SDR per batch item, shape (B,).  For logging only."""
    est = estimated.float()
    tgt = target.float()
    dims = tuple(range(1, tgt.ndim))
    num = torch.sum(tgt ** 2, dim=dims)
    den = torch.sum((tgt - est) ** 2, dim=dims)
    return 10.0 * torch.log10((num + _DELTA) / (den + _DELTA))


def combined_loss(estimated: torch.Tensor, target: torch.Tensor,
                  sdr_weight: float = 0.9, sisdr_weight: float = 0.1
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """0.9·SDR + 0.1·SI-SDR (reference `src/loss.py:90-127`)."""
    sdr = sdr_loss(estimated, target)
    sisdr = sisdr_loss(estimated, target)
    total = sdr_weight * sdr + sisdr_weight * sisdr
    pos_sdr = new_sdr_metric(estimated, target).mean()
    metrics = {
        "loss/total": total,
        "loss/sdr": sdr,
        "loss/sisdr": sisdr,
        "metrics/sdr": -sdr,
        "metrics/sisdr": -sisdr,
        "metrics/new_sdr": pos_sdr,
    }
    return total, metrics


def combined_l1_sdr_loss(estimated: torch.Tensor, target: torch.Tensor,
                         sdr_weight: float = 1.0, l1_weight: float = 0.05
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SDR + L1 alternative (reference `src/loss.py:130-162`)."""
    sdr = sdr_loss(estimated, target)
    sisdr = sisdr_loss(estimated, target)
    l1 = torch.mean(torch.abs(estimated.float() - target.float()))
    total = sdr_weight * sdr + l1_weight * l1
    metrics = {
        "loss/total": total,
        "loss/sdr": sdr,
        "loss/sisdr": sisdr,
        "metrics/sdr": -sdr,
        "metrics/sisdr": -sisdr,
    }
    return total, metrics
