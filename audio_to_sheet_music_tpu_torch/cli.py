"""Command line of the port.

    python -m audio_to_sheet_music_tpu_torch.cli train --config config.yaml \
        [--device cuda|cpu] [--kernels default|opt_in|none] \
        [--max-steps-per-epoch N]

``train`` is the counterpart of the JAX package's ``cli.train_main``: it
reads the reference-schema YAML config and runs ``train.trainer.train`` on
the card unless ``--device cpu``.  ``--kernels`` picks the hand-written
kernels (``ops/select.py``).  Without ``--config`` the config's defaults
apply.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


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


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] != ["train"]:
        print("usage: python -m audio_to_sheet_music_tpu_torch.cli train "
              "[options]", file=sys.stderr)
        raise SystemExit(2)
    train_main(argv[1:])


if __name__ == "__main__":
    main()
