"""Single-song stem extraction on the card: the counterpart of
``audio_to_sheet_music_tpu/apps/separate.py``.

    python -m audio_to_sheet_music_tpu_torch.apps.separate \\
        --track <track.npy | track_dir | mixture.wav | track.stem.mp4> \\
        [--checkpoint model.pt|params.npz|ckpt_dir] [--stems drums bass other vocals piano] \\
        [--output-dir out] [--plots] \\
        [--device cuda|cpu] [--kernels default|opt_in|none]

Separates every requested stem (free text: zero-shot prompts run like the
canonical four) and writes ``extracted_<stem>.wav`` and ``mixture.wav``.
A track with ground-truth stems (a ``.npy`` cache, a MusDB wav directory,
a ``.stem.mp4``) gets each stem's SDR against its ground truth in
``sdr_report.json``; ``--plots`` writes a spectrogram comparison PNG per
stem (matplotlib).  A plain WAV without ``--plots`` takes the int16 path:
``separate_all_pcm`` at absolute level, the PCM bytes written as they are.
``--checkpoint`` goes through ``atht.load_params`` (a reference ``.pt``, an
``.npz`` of the whole tree, or a directory the trainer wrote); without it
the model is the seeded init with the committed trained head grafted on.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def load_mixture(path: Path) -> np.ndarray:
    """-> (2, T) int16 when the file is 16-bit 44.1 kHz stereo, else
    float32 resampled to 44.1 kHz stereo."""
    from ..utils import audio_io

    sr, pcm = audio_io.read_wav_pcm(path)
    if sr == 44100 and pcm.shape[0] == 2:
        return pcm
    sr, wav = audio_io.read_wav(path)
    return audio_io.to_stereo(audio_io.resample(wav, sr))


def load_track(path: Path):
    """-> (mixture (2, T), {stem: (2, T)} of ground truth, or None)."""
    from ..data.musdb import Track
    from ..text.prompts import STEM_NAMES

    def with_stems(track: Track):
        arr = track.load(mmap=False)
        return arr[0], {s: arr[1 + i] for i, s in enumerate(STEM_NAMES)}

    if path.suffix == ".npy":
        return with_stems(Track(path.stem, path, "npy"))
    if path.is_dir() and (path / "mixture.wav").exists():
        return with_stems(Track(path.name, path, "wav_dir"))
    if path.suffix.lower() == ".wav":
        return load_mixture(path), None
    if path.suffixes[-2:] == [".stem", ".mp4"]:
        return with_stems(Track(path.name, path, "stem_mp4"))
    raise SystemExit(f"unsupported track format: {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Extract stems from one song")
    ap.add_argument("--track", required=True,
                    help=".npy track cache, MusDB wav directory, .wav "
                         "mixture or .stem.mp4")
    ap.add_argument("--checkpoint", default=None,
                    help="reference .pt, .npz of the whole param tree or "
                         "a training checkpoint directory (default: seeded "
                         "init + the committed trained head)")
    ap.add_argument("--stems", nargs="+",
                    default=["drums", "bass", "other", "vocals"])
    ap.add_argument("--output-dir", default="inference_results")
    ap.add_argument("--segment-seconds", type=float, default=6.0)
    ap.add_argument("--overlap-seconds", type=float, default=1.5)
    ap.add_argument("--plots", action="store_true",
                    help="write spectrogram_<stem>.png (matplotlib)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernels", default="default",
                    choices=["default", "opt_in", "none"],
                    help="hand-written kernels to run (ops/select.py)")
    args = ap.parse_args(argv)

    from ..eval.harness import compute_sdr
    from ..infer.session import Separator
    from ..models import atht
    from ..utils import audio_io

    mixture, gt_stems = load_track(Path(args.track))
    model = atht.load_params(atht.init(0), args.checkpoint)
    sep = Separator(model, args.segment_seconds, args.overlap_seconds,
                    device=args.device, kernels=args.kernels)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if mixture.dtype == np.int16:
        audio_io.write_wav_pcm(out_dir / "mixture.wav", mixture)
    else:
        audio_io.write_wav(out_dir / "mixture.wav", mixture)

    report = {}
    if gt_stems is None and not args.plots:
        # the int16 path: PCM quantised on the device at absolute level, so
        # these WAVs play at the float path's loudness
        pcm, scales = sep.separate_all_pcm(mixture, stems=args.stems,
                                           absolute=True)
        for i, stem in enumerate(args.stems):
            audio_io.write_wav_pcm(out_dir / f"extracted_{stem}.wav", pcm[i],
                                   float(scales[i]))
    else:
        if mixture.dtype == np.int16:
            mixture = mixture.astype(np.float32) / 32768.0
        outs = sep.separate_all(mixture, stems=args.stems)
        for stem, est in outs.items():
            audio_io.write_wav(out_dir / f"extracted_{stem}.wav", est)
            if gt_stems and stem in gt_stems:
                t = min(est.shape[-1], gt_stems[stem].shape[-1])
                sdr = compute_sdr(est[:, :t], gt_stems[stem][:, :t])
                report[stem] = sdr
                print(f"{stem:>10}: SDR {sdr:6.2f} dB")
            if args.plots:
                from ..utils import plotting

                tgt = gt_stems[stem] if gt_stems and stem in gt_stems else est
                fig = plotting.plot_separation_comparison(
                    mixture, tgt, est, stem, device=sep.device)
                plotting.save_figure(fig, out_dir / f"spectrogram_{stem}.png")

    (out_dir / "sdr_report.json").write_text(json.dumps(report, indent=2))
    print(f"outputs written to {out_dir}")


if __name__ == "__main__":
    main()
