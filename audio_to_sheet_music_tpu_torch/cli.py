"""Command line of the port.

    python -m audio_to_sheet_music_tpu_torch.cli train --config config.yaml \
        [--device cuda|cpu] [--kernels default|opt_in|none] \
        [--max-steps-per-epoch N] [--data-parallel [--world-size N]]

    python -m audio_to_sheet_music_tpu_torch.cli benchmark \
        [--models ours ours-random htdemucs clapsep] [--synthetic \
        [--synthetic-tracks N]] [--test-dir DIR] [--max-tracks N] \
        [--checkpoint model.pt|params.npz|ckpt_dir] [--output-dir results] \
        [--plot-spectrograms] [--use-wandb] [--device cuda|cpu] \
        [--kernels default|opt_in|none]

``train`` is the counterpart of the JAX package's ``cli.train_main``: it
reads the reference-schema YAML config and runs ``train.trainer.train``
(whose model comes from ``training.resume_from`` when that is a reference
``.pt``).  ``--data-parallel`` trains data-parallel
(``train(data_parallel=True)``): one spawned process a visible card (NCCL),
or ``--world-size`` CPU processes with ``--device cpu`` (gloo), joined
through a ``file://`` rendezvous in a temporary directory; launched by
``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set), each process
joins torchrun's group instead, on card ``LOCAL_RANK``.  ``benchmark`` is
the counterpart of ``cli.benchmark_main``: it
scores each model's SDR and SI-SDR on the test tracks (``--test-dir``,
else the config's ``data.test_dir``; ``--synthetic`` writes 12 s
``data/synth.py`` tracks instead), prints the tables and writes
``<output-dir>/evaluation_results.json``; ``--checkpoint`` goes through
``atht.load_params``; CLAPSep is skipped when the weights file it is
told to load is missing; ``--plot-spectrograms``
adds one all-stems PNG a track and model under
``<output-dir>/spectrograms/`` (matplotlib); ``--use-wandb`` logs each
model's aggregates to Weights & Biases where ``wandb`` imports.  Both run
on the card unless
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
    ap.add_argument("--data-parallel", action="store_true",
                    help="one process a card (or a --world-size of CPU "
                         "processes), each with its rows of every batch; "
                         "under torchrun, join its group")
    ap.add_argument("--world-size", type=int, default=None,
                    help="processes for --data-parallel (default: every "
                         "visible card; 1 with --device cpu)")
    args = ap.parse_args(argv)
    if not args.data_parallel:
        print(_train(args, args.device, data_parallel=False))
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        device = ("cpu" if args.device == "cpu"
                  else f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
        _train_rank(None, None, None, args, device)
        return
    import torch
    import torch.multiprocessing as mp

    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    world = args.world_size or (cards if args.device == "cuda" else 1)
    if world < 1 or (args.device == "cuda" and world > cards):
        raise SystemExit(f"train --data-parallel: {world} processes for "
                         f"{cards} visible cards")
    with tempfile.TemporaryDirectory(prefix="atsm_train_dp_") as tmp:
        mp.spawn(_train_rank, args=(world, f"file://{tmp}/rendezvous", args),
                 nprocs=world, join=True)


def _train(args, device: str, data_parallel: bool) -> dict:
    from .config import Config
    from .train.trainer import train

    cfg = (Config.from_yaml(args.config) if Path(args.config).exists()
           else Config())
    return train(cfg, max_steps_per_epoch=args.max_steps_per_epoch,
                 device=device, kernels=args.kernels,
                 data_parallel=data_parallel)


def _train_rank(rank, world, init_method, args, device=None) -> None:
    """One data-parallel process: rank ``rank`` of ``world`` through
    ``init_method`` (spawned), or torchrun's (all three None)."""
    import torch.distributed as dist

    from .parallel import init_data_parallel

    if device is None:
        device = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    rank, _ = init_data_parallel(device, rank, world, init_method)
    try:
        result = _train(args, device, data_parallel=True)
        if rank == 0:
            print(result)
    finally:
        dist.destroy_process_group()


def benchmark_main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="audio_to_sheet_music_tpu_torch.cli benchmark",
        description="Separation benchmark (SDR / SI-SDR per stem)")
    ap.add_argument("--models", nargs="+", default=["ours"],
                    choices=["ours", "ours-random", "htdemucs", "clapsep"])
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--test-dir", default=None)
    ap.add_argument("--output-dir", default="results")
    ap.add_argument("--max-tracks", type=int, default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="reference .pt, .npz of the whole model or a "
                         "training checkpoint directory for 'ours'")
    ap.add_argument("--synthetic", action="store_true",
                    help="run on synthetic tracks instead of a dataset")
    ap.add_argument("--synthetic-tracks", type=int, default=5,
                    help="number of synthetic tracks")
    ap.add_argument("--plot-spectrograms", action="store_true",
                    help="write per-track all-stems spectrogram PNGs")
    ap.add_argument("--use-wandb", action="store_true",
                    help="log aggregates to Weights & Biases")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="default",
                    choices=["default", "opt_in", "none"])
    args = ap.parse_args(argv)

    from .config import Config
    from .data import discover_tracks, synthetic_tracks
    from .eval import evaluate_model, format_results_table, save_results
    from .eval.models import CLAPSepModel, HTDemucsBaseline, OursModel
    from .infer.session import open_device
    from .models import atht

    cfg = (Config.from_yaml(args.config) if Path(args.config).exists()
           else Config())
    open_device(args.device, "benchmark")     # no card: raise, skip nothing
    model = atht.load_from_env(args.checkpoint, device=args.device)
    if not model.pretrained:
        print("benchmark: no converted checkpoint loaded; models run with "
              "random or .npz weights, so scores are not pretrained-baseline "
              "numbers")
    run = dict(device=args.device, kernels=args.kernels)
    out_dir = Path(args.output_dir)

    registry = {}
    for name in args.models:
        if name == "ours":
            registry[OursModel.name] = OursModel(model, **run)
        elif name == "ours-random":
            # the ablation row: the same towers, the head at its init
            registry["AudioTextHTDemucs (Ours, random head)"] = OursModel(
                atht.init_from_env(0, args.device), **run)
        elif name == "htdemucs":
            m = HTDemucsBaseline(model.htdemucs, pretrained=model.pretrained,
                                 **run)
            registry[m.name] = m
        elif name == "clapsep":
            try:            # a named weights file that is missing: skip
                m = CLAPSepModel(clap=model.clap, pretrained=model.pretrained,
                                 device=args.device)
            except RuntimeError as e:
                print(f"skipping {name}: {e}")
                continue
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
            separate_all = m.separate_all
            if args.plot_spectrograms:
                separate_all = _plotting(separate_all, out_dir / "spectrograms"
                                         / name.replace(" ", "_"),
                                         args.device)
            all_results[name] = evaluate_model(separate_all, tracks, name,
                                               max_tracks=args.max_tracks)

    print(format_results_table(all_results))
    out = out_dir / "evaluation_results.json"
    save_results(all_results, out)
    print(f"\nresults written to {out}")
    if args.use_wandb:
        _log_wandb(all_results)


def _log_wandb(all_results) -> None:
    """Each model's aggregate SDR and SI-SDR as one wandb run; without
    ``wandb`` (or when it fails) one line says so."""
    try:
        import wandb

        from .eval import aggregate_results

        run = wandb.init(project="audio-text-htdemucs-benchmark")
        for name, results in all_results.items():
            agg = aggregate_results(results)
            run.log({f"{name}/sdr_{k}": v for k, v in agg["sdr"].items()})
            run.log({f"{name}/sisdr_{k}": v for k, v in agg["sisdr"].items()})
        run.finish()
    except Exception as e:  # noqa: BLE001 - logging must not fail the run
        print(f"wandb logging skipped: {e}")


def _plotting(separate_all, spec_dir: Path, device: str):
    """``separate_all`` that also writes the mixture's and its stems'
    spectrograms as ``spec_dir/track_NNN.png``, one a call."""
    from .utils import plotting

    def wrapped(mixture):
        stems = separate_all(mixture)
        fig = plotting.plot_all_stems(mixture, dict(stems), device=device)
        spec_dir.mkdir(parents=True, exist_ok=True)
        n = len(list(spec_dir.glob("*.png")))
        plotting.save_figure(fig, spec_dir / f"track_{n:03d}.png")
        return stems

    return wrapped


COMMANDS = {"train": train_main, "benchmark": benchmark_main}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
