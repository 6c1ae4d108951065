"""Command line of the port.

    python -m audio_to_sheet_music_tpu_torch.cli train --config config.yaml \
        [--device cuda|cpu] [--kernels default|opt_in|none] \
        [--max-steps-per-epoch N]

    python -m audio_to_sheet_music_tpu_torch.cli benchmark \
        [--models ours ours-random htdemucs] [--synthetic \
        [--synthetic-tracks N]] [--test-dir DIR] [--max-tracks N] \
        [--checkpoint params.npz] [--output-dir results] \
        [--device cuda|cpu] [--kernels default|opt_in|none]

``train`` is the counterpart of the JAX package's ``cli.train_main``: it
reads the reference-schema YAML config and runs ``train.trainer.train``.
``benchmark`` is the counterpart of ``cli.benchmark_main``: it scores each
model's SDR and SI-SDR on the test tracks (``--test-dir``, else the
config's ``data.test_dir``; ``--synthetic`` writes 12 s ``data/synth.py``
tracks instead), prints the tables and writes
``<output-dir>/evaluation_results.json``.  Both run on the card unless
``--device cpu``; ``--kernels`` picks the hand-written kernels
(``ops/select.py``).  Without a ``--config`` file the config's defaults
apply.  ``ATSM_TINY_MODEL=1`` builds the models at test size.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

USAGE = ("usage: python -m audio_to_sheet_music_tpu_torch.cli "
         "{train,benchmark} [options]")


def train_main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="audio_to_sheet_music_tpu_torch.cli train",
                                 description="Train the AudioTextHTDemucs head")
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--max-steps-per-epoch", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="default",
                    choices=["default", "opt_in", "none"])
    args = ap.parse_args(argv)

    from .config import Config
    from .train.trainer import train

    cfg = (Config.from_yaml(args.config) if Path(args.config).exists()
           else Config())
    result = train(cfg, max_steps_per_epoch=args.max_steps_per_epoch,
                   device=args.device, kernels=args.kernels)
    print(result)


def benchmark_main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="audio_to_sheet_music_tpu_torch.cli benchmark",
        description="Separation benchmark (SDR / SI-SDR per stem)")
    ap.add_argument("--models", nargs="+", default=["ours"],
                    choices=["ours", "ours-random", "htdemucs"])
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--test-dir", default=None)
    ap.add_argument("--output-dir", default="results")
    ap.add_argument("--max-tracks", type=int, default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="params .npz of the whole model for 'ours'")
    ap.add_argument("--synthetic", action="store_true",
                    help="run on synthetic tracks instead of a dataset")
    ap.add_argument("--synthetic-tracks", type=int, default=5,
                    help="number of synthetic tracks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="default",
                    choices=["default", "opt_in", "none"])
    args = ap.parse_args(argv)

    from .config import Config
    from .data import discover_tracks, synthetic_tracks
    from .eval import evaluate_model, format_results_table, save_results
    from .eval.models import HTDemucsBaseline, OursModel
    from .models import atht

    cfg = (Config.from_yaml(args.config) if Path(args.config).exists()
           else Config())
    model = atht.init_from_env(0)
    # the committed trained head is full width: a test-size model keeps its
    # own random head, as in the JAX package
    if args.checkpoint or os.environ.get("ATSM_TINY_MODEL") != "1":
        atht.load_params(model, args.checkpoint)
    print("benchmark: no converted checkpoint loaded; models run with random "
          "or .npz weights, so scores are not pretrained-baseline numbers")
    run = dict(device=args.device, kernels=args.kernels)

    registry = {}
    for name in args.models:
        if name == "ours":
            registry[OursModel.name] = OursModel(model, **run)
        elif name == "ours-random":
            # the ablation row: the same towers with the head at its init
            registry["AudioTextHTDemucs (Ours, random head)"] = OursModel(
                atht.init_from_env(0), **run)
        elif name == "htdemucs":
            m = HTDemucsBaseline(model.htdemucs, **run)
            registry[m.name] = m

    with tempfile.TemporaryDirectory(prefix="atsm_bench_") as tmp:
        if args.synthetic:
            tracks = synthetic_tracks(args.synthetic_tracks, seconds=12.0,
                                      cache_dir=tmp)
        else:
            tracks = discover_tracks(args.test_dir or cfg.data.test_dir)
        if not tracks:
            raise SystemExit("no test tracks found")
        all_results = {}
        for name, m in registry.items():
            print(f"evaluating {name} on {len(tracks)} tracks")
            all_results[name] = evaluate_model(m.separate_all, tracks, name,
                                               max_tracks=args.max_tracks)

    print(format_results_table(all_results))
    out = Path(args.output_dir) / "evaluation_results.json"
    save_results(all_results, out)
    print(f"\nresults written to {out}")


COMMANDS = {"train": train_main, "benchmark": benchmark_main}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
