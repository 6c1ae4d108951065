"""Spectrogram report tool: the counterpart of
``audio_to_sheet_music_tpu/apps/spectrogram_tool.py``.

    python -m audio_to_sheet_music_tpu_torch.apps.spectrogram_tool \\
        --test-dir <tracks> [--tracks name1 name2] [--checkpoint ...] \\
        [--output-dir spectrograms] [--device cuda|cpu] \\
        [--kernels default|opt_in|none]

Separates the named tracks (default: every track found under
``--test-dir``) with ``Separator.separate_all`` and writes, per track, an
all-stems overview PNG and one ground truth / estimate comparison PNG per
stem (matplotlib).  ``ATSM_TINY_MODEL=1`` builds the model at test size.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Generate spectrogram reports")
    ap.add_argument("--test-dir", required=True)
    ap.add_argument("--tracks", nargs="*", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz of the whole param tree (default: seeded "
                         "init + the committed trained head)")
    ap.add_argument("--output-dir", default="spectrograms")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="default",
                    choices=["default", "opt_in", "none"],
                    help="hand-written kernels to run (ops/select.py)")
    args = ap.parse_args(argv)

    from ..data import discover_tracks
    from ..infer.session import Separator
    from ..models import atht
    from ..text.prompts import STEM_NAMES
    from ..utils import plotting

    tracks = discover_tracks(args.test_dir)
    if args.tracks:
        tracks = [t for t in tracks if t.name in set(args.tracks)]
    if not tracks:
        # a --tracks typo (or an empty directory) must not exit 0 having
        # written nothing
        raise SystemExit(f"no matching tracks under {args.test_dir!r}"
                         + (f" for names {args.tracks}" if args.tracks
                            else ""))
    sep = Separator(atht.load_from_env(args.checkpoint, device=args.device),
                    device=args.device,
                    kernels=args.kernels)
    out_root = Path(args.output_dir)
    for track in tracks:
        arr = track.load(mmap=False)
        mixture = arr[0]
        gt = {s: arr[1 + i] for i, s in enumerate(STEM_NAMES)}
        est = sep.separate_all(mixture)
        out_dir = out_root / track.name
        out_dir.mkdir(parents=True, exist_ok=True)
        plotting.save_figure(
            plotting.plot_all_stems(mixture, est, device=sep.device),
            out_dir / "all_stems.png")
        for stem in STEM_NAMES:
            fig = plotting.plot_separation_comparison(
                mixture, gt[stem], est[stem], stem, device=sep.device)
            plotting.save_figure(fig, out_dir / f"{stem}.png")
        print(f"{track.name}: wrote {1 + len(STEM_NAMES)} figures")


if __name__ == "__main__":
    main()
