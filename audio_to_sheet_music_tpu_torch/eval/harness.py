"""Benchmark harness: the reference protocol and JSON schema.

Counterpart of ``audio_to_sheet_music_tpu/eval/harness.py``.  Per test
track, separate all 4 stems, compute full-track SDR and SI-SDR per stem
(length-aligned, as the loss functions negated), aggregate means, print
tables, and write ``evaluation_results.json`` in the reference's layout:

    {model_name: {"per_track": [{"track", "sdr": {stem..., "average"},
                                 "sisdr": {...}}, ...],
                  "aggregate": {"sdr": {...}, "sisdr": {...}}}}

A track that fails is reported and skipped, as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..ops import losses
from ..text.prompts import STEM_NAMES


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def compute_metrics(estimate, reference) -> tuple[float, float]:
    """-> (SDR, SI-SDR) in dB for (C, T) inputs (numpy or tensors).  The
    reference goes to the estimate's device once; both metrics are computed
    there and read back together.

    The ±30 dB clamp of the training losses is kept on purpose: the
    reference's benchmark negates its clamped losses, so the numbers diff
    directly against its ``eval_results/*.json`` only with the clamp."""
    est = _tensor(estimate)[None]
    ref = _tensor(reference, est.device)[None]
    both = torch.stack([-losses.sdr_loss(est, ref),
                        -losses.sisdr_loss(est, ref)])
    sdr, sisdr = both.tolist()
    return sdr, sisdr


def compute_sdr(estimate, reference) -> float:
    """Full-track SDR in dB, (C, T) inputs."""
    return compute_metrics(estimate, reference)[0]


def compute_sisdr(estimate, reference) -> float:
    """Full-track SI-SDR in dB, (C, T) inputs."""
    return compute_metrics(estimate, reference)[1]


@dataclasses.dataclass
class TrackResult:
    track_name: str
    model_name: str
    sdr: Dict[str, float]       # per stem + "average"
    sisdr: Dict[str, float]


def evaluate_model_on_track(
    separate_all: Callable[[np.ndarray], Mapping[str, np.ndarray]],
    mixture: np.ndarray,
    reference_stems: Mapping[str, np.ndarray],
    track_name: str,
    model_name: str,
    stems: Sequence[str] = STEM_NAMES,
) -> TrackResult:
    estimated = separate_all(mixture)
    sdr, sisdr = {}, {}
    for stem in stems:
        est, ref = np.asarray(estimated[stem]), np.asarray(reference_stems[stem])
        t = min(est.shape[-1], ref.shape[-1])
        sdr[stem], sisdr[stem] = compute_metrics(est[:, :t], ref[:, :t])
    sdr["average"] = float(np.mean([sdr[s] for s in stems]))
    sisdr["average"] = float(np.mean([sisdr[s] for s in stems]))
    return TrackResult(track_name, model_name, sdr, sisdr)


def evaluate_model(
    separate_all: Callable,
    tracks,                      # Sequence[data.Track]
    model_name: str,
    stems: Sequence[str] = STEM_NAMES,
    max_tracks: int | None = None,
    verbose: bool = True,
) -> List[TrackResult]:
    """Evaluate over ``data.Track`` items (mixture = row 0, stems rows 1-4)."""
    results = []
    for track in tracks[:max_tracks]:
        try:
            arr = track.load(mmap=False)
            mixture = arr[0]
            refs = {s: arr[1 + i] for i, s in enumerate(STEM_NAMES)}
            res = evaluate_model_on_track(separate_all, mixture, refs,
                                          track.name, model_name, stems)
            results.append(res)
            if verbose:
                print(f"  {track.name}: SDR avg {res.sdr['average']:.2f} dB")
        except Exception:  # noqa: BLE001 — a bad track is reported, skipped
            traceback.print_exc()
    return results


def aggregate_results(results: Sequence[TrackResult],
                      stems: Sequence[str] = STEM_NAMES) -> Dict:
    agg = {"sdr": {}, "sisdr": {}}
    for metric in ("sdr", "sisdr"):
        for stem in list(stems) + ["average"]:
            vals = [getattr(r, metric).get(stem) for r in results]
            vals = [v for v in vals if v is not None]
            agg[metric][stem] = float(np.mean(vals)) if vals else float("nan")
    return agg


def format_results_table(all_results: Mapping[str, Sequence[TrackResult]],
                         stems: Sequence[str] = STEM_NAMES) -> str:
    """The reference printer's tables, one for SDR and one for SI-SDR."""
    lines = []
    for metric, title in (("sdr", "SDR (dB)"), ("sisdr", "SI-SDR (dB)")):
        lines.append(f"\n=== {title} ===")
        header = f"{'Model':<32}" + "".join(f"{s:>10}" for s in stems) + f"{'Avg':>10}"
        lines.append(header)
        lines.append("-" * len(header))
        for name, results in all_results.items():
            agg = aggregate_results(results, stems)[metric]
            row = f"{name:<32}" + "".join(f"{agg[s]:>10.2f}" for s in stems)
            row += f"{agg['average']:>10.2f}"
            lines.append(row)
    return "\n".join(lines)


def _null_nan(obj):
    """NaN and infinities as ``null``: ``json.dumps`` would write bare
    ``NaN``, which is not JSON."""
    if isinstance(obj, dict):
        return {k: _null_nan(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_null_nan(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def save_results(all_results: Mapping[str, Sequence[TrackResult]],
                 path: str | Path,
                 stems: Sequence[str] = STEM_NAMES) -> None:
    """Write the reference's ``evaluation_results.json`` schema."""
    payload = {}
    for name, results in all_results.items():
        payload[name] = {
            "per_track": [
                {"track": r.track_name, "sdr": r.sdr, "sisdr": r.sisdr}
                for r in results
            ],
            "aggregate": aggregate_results(results, stems),
        }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(_null_nan(payload), indent=2))
