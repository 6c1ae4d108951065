"""Single-song stem extraction on the card.

    python -m audio_to_sheet_music_tpu_torch.apps.separate \\
        --track mixture.wav [--checkpoint params.npz] \\
        [--stems drums bass other vocals piano] [--output-dir out] \\
        [--device cuda|cpu] [--kernels default|opt_in|none]

Reads a WAV (resampled to 44.1 kHz stereo when it is not), separates every
requested stem (free text: zero-shot prompts run like the canonical four)
and writes ``extracted_<stem>.wav`` as int16 PCM at absolute level plus the
mixture.  Without ``--checkpoint`` the model is the seeded init with the
committed trained head grafted on.
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Extract stems from one song")
    ap.add_argument("--track", required=True, help="mixture .wav")
    ap.add_argument("--checkpoint", default=None,
                    help=".npz of the whole param tree (default: seeded "
                         "init + the committed trained head)")
    ap.add_argument("--stems", nargs="+",
                    default=["drums", "bass", "other", "vocals"])
    ap.add_argument("--output-dir", default="inference_results")
    ap.add_argument("--segment-seconds", type=float, default=6.0)
    ap.add_argument("--overlap-seconds", type=float, default=1.5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernels", default="default",
                    choices=["default", "opt_in", "none"],
                    help="hand-written kernels to run (ops/select.py)")
    args = ap.parse_args(argv)

    from ..infer.session import Separator
    from ..models import atht
    from ..utils import audio_io

    path = Path(args.track)
    if path.suffix.lower() != ".wav":
        raise SystemExit(f"unsupported track format: {path} (expected .wav)")
    mixture = load_mixture(path)
    model = atht.load_params(atht.init(0), args.checkpoint)
    sep = Separator(model, args.segment_seconds, args.overlap_seconds,
                    device=args.device, kernels=args.kernels)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if mixture.dtype == np.int16:
        audio_io.write_wav_pcm(out_dir / "mixture.wav", mixture)
    else:
        audio_io.write_wav(out_dir / "mixture.wav", mixture)
    pcm, _ = sep.separate_all_pcm(mixture, stems=args.stems, absolute=True)
    for i, stem in enumerate(args.stems):
        audio_io.write_wav_pcm(out_dir / f"extracted_{stem}.wav", pcm[i])
    print(f"outputs written to {out_dir}")


if __name__ == "__main__":
    main()
