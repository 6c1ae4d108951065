"""End-to-end learning proof: train the head on synthetic stems and measure
eval SDR before and after, the port of ``scripts/learning_proof.py``.

    python -m audio_to_sheet_music_tpu_torch.apps.learning_proof \\
        [--steps 240] [--device cuda|cpu] [--kernels default|opt_in|none] \\
        [--save head.npz]

The same run as the JAX script: 4 synthetic 24 s tracks (seed 0) to train
on and one 12 s track (seed 99) to test on; the model is ``atht.init(0)``
(``init_tiny`` under ``ATSM_TINY_MODEL=1``) with its random head, no
committed head grafted on, so its towers are the JAX ``PRNGKey(0)`` ones
the JAX record was made on (-4.37 -> +6.10 dB after 240 steps).  Training
is batch 8 x 6 s segments with gain / channel-swap augmentation and the
hash tokenizer, through ``train.step.make_optimizer`` (lr 3e-4, cosine
over ``--steps``) and ``make_train_step`` (bf16 on the card, f32 on the
CPU).  Eval SDR goes through ``OursModel`` (6 s segments, 1.5 s overlap)
and the eval harness, per stem and on average.

The last line of standard output is one JSON object: ``before_db``,
``after_db``, ``improvement_db``, the per-stem SDRs, ``steps``,
``steps_per_s`` (the training loop's wall clock, host data included) and
``card`` (``nvidia-smi``'s name and power limit, null without a card).
``--save`` writes the trained head as an ``.npz`` (the JAX
``save_params_npz`` layout) to the path given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Dict

import torch

from ..ops.select import Kernels

STEMS = ("drums", "bass", "other", "vocals")


def card_name() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def eval_sdr(model, tracks, device, kernels, label: str) -> Dict[str, float]:
    """Aggregate SDR per stem and ``average`` over ``tracks``."""
    from ..eval import aggregate_results, evaluate_model
    from ..eval.models import OursModel

    ours = OursModel(model, segment_seconds=6.0, overlap_seconds=1.5,
                     device=device, kernels=kernels)
    sdr = aggregate_results(evaluate_model(ours.separate_all, tracks, label,
                                           verbose=False))["sdr"]
    print(f"{label}: SDR avg {sdr['average']:.2f} ("
          + " ".join(f"{s} {sdr[s]:.2f}" for s in STEMS) + ")", flush=True)
    return sdr


def run(steps: int = 240, device: str | torch.device = "cuda",
        kernels: Kernels = True, batch: int = 8, segment_seconds: float = 6.0,
        train_seconds: float = 24.0, test_seconds: float = 12.0,
        save: str | Path | None = None, data_dir: str | Path | None = None
        ) -> Dict[str, Any]:
    """The learning proof; returns the JSON line's fields.  The model is
    ``atht.init_from_env(0)`` drawn on ``device``; the tracks are written
    under ``data_dir`` (default: a new temporary directory)."""
    from ..data import BatchLoader, StemSegmentDataset, synthetic_tracks
    from ..infer.session import open_device
    from ..models import atht
    from ..text.tokenizer import HashTokenizer
    from ..train.step import TrainState, make_optimizer, make_train_step
    from ..train.trainer import put_batch

    device = open_device(device, "learning_proof")
    root = Path(data_dir or tempfile.mkdtemp(prefix="atsm_learning_proof_"))
    tracks = synthetic_tracks(4, seconds=train_seconds,
                              cache_dir=root / "train")
    test_tracks = synthetic_tracks(1, seconds=test_seconds,
                                   cache_dir=root / "test", seed=99)
    model = atht.init_from_env(0, device)

    before = eval_sdr(model, test_tracks, device, kernels, "random-init")

    ds = StemSegmentDataset(tracks, int(round(segment_seconds * 44100)),
                            random_segments=True, augment=True)
    loader = BatchLoader(ds, batch, HashTokenizer())
    state = TrainState.create(model, lambda p: make_optimizer(
        p, lr=3e-4, total_steps=steps))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    step = make_train_step(compute_dtype=dtype, kernels=kernels)
    t0 = time.perf_counter()
    n = 0
    for _ in range(30):
        for raw in loader:
            metrics = step(state, put_batch(raw, device))
            n += 1
            if n % 50 == 0:
                print(f"step {n}: loss {float(metrics['loss/total']):.3f} "
                      f"({n / (time.perf_counter() - t0):.2f} steps/s)",
                      flush=True)
            if n >= steps:
                break
        if n >= steps:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    model.requires_grad_(False)

    after = eval_sdr(model, test_tracks, device, kernels, f"after-{n}-steps")
    if save:
        from ..train.checkpoint import save_params_npz

        out = Path(save)
        out.parent.mkdir(parents=True, exist_ok=True)
        save_params_npz(out, model.head)
        print(f"saved trained head -> {out}")
    return {"before_db": before["average"], "after_db": after["average"],
            "improvement_db": after["average"] - before["average"],
            "before": {s: before[s] for s in STEMS},
            "after": {s: after[s] for s in STEMS},
            "steps": n, "steps_per_s": n / seconds if seconds else None,
            "train_seconds": seconds, "card": card_name()}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernels", default="default",
                    choices=["default", "opt_in", "none"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segment-seconds", type=float, default=6.0)
    ap.add_argument("--save", default=None,
                    help="write the trained head params .npz here")
    args = ap.parse_args(argv)
    res = run(args.steps, args.device, args.kernels, args.batch,
              args.segment_seconds, save=args.save)
    print(f"SDR improvement: {res['improvement_db']:+.2f} dB")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
