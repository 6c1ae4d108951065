"""The serving app: the counterpart of ``audio_to_sheet_music_tpu/apps/serve.py``.

    python -m audio_to_sheet_music_tpu_torch.apps.serve [--checkpoint ...] \\
        [--config config.yaml] [--host 0.0.0.0] [--port 7860] \\
        [--ui auto|gradio|http] [--warmup-seconds 60] \\
        [--device cuda|cpu] [--kernels default|opt_in|none]

Upload audio (or give a local file path), type a free-text prompt
("drums", "the vocals", "piano sound"), get the separated stem and the
input and output spectrograms.  The ``Separator`` runs the app protocol:
segment and overlap from the config's ``data`` section (0.1 s overlap in
``config.yaml``).  ``--ui auto`` serves the Gradio demo when Gradio
imports, else the stdlib HTTP server (``apps.serve_http``); Gradio, yt-dlp
and matplotlib are optional and imported only where they are used.
``ATSM_TINY_MODEL=1`` builds the model at test size.
"""

from __future__ import annotations

import argparse
import time
import warnings
from pathlib import Path

import numpy as np

SAMPLE_RATE = 44100


def build_separator(checkpoint: str | None, config: str | None = None,
                    device: str = "cuda", kernels: str = "default"):
    """The app-protocol ``Separator``: segment and overlap from the config's
    ``data`` section (6 s and 0.1 s without a config), the model from
    ``atht.load_from_env`` with ``checkpoint`` (or ``training.resume_from``
    when that exists: a ``.pt``, an ``.npz`` or a training checkpoint
    directory), the tokenizer as the model's ``pretrained`` mark asks, and
    normalised CLAP text features; cuDNN's deterministic algorithms, so a
    request repeats bit for bit.  The config's ``model.device`` is not read: the device is
    ``device``."""
    from ..infer.session import Separator
    from ..models import atht

    segment_s, overlap_s = 6.0, 0.1
    if config and Path(config).exists():
        from ..config import Config

        cfg = Config.from_yaml(config)
        segment_s = cfg.data.segment_seconds
        overlap_s = cfg.data.overlap
        if checkpoint is None and cfg.training.resume_from:
            if Path(cfg.training.resume_from).exists():
                checkpoint = cfg.training.resume_from
            else:
                warnings.warn(
                    f"training.resume_from={cfg.training.resume_from!r} "
                    "does not exist; serving with the default head")
    return Separator(atht.load_from_env(checkpoint),
                     segment_seconds=segment_s, overlap_seconds=overlap_s,
                     device=device, normalize_text=True, kernels=kernels,
                     deterministic=True)


def download_youtube_audio(url: str, out_dir: str = "temp") -> Path:
    """YouTube -> a local WAV through yt-dlp (and ffmpeg).  Raises when
    yt-dlp is not installed."""
    try:
        import yt_dlp
    except ImportError as e:
        raise RuntimeError("yt-dlp is not installed; give a local .wav "
                           "path instead") from e
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    # bestaudio is practically never WAV, and _load_input reads only WAV
    # without ffmpeg: convert the download (yt-dlp reports a missing ffmpeg)
    opts = {"format": "bestaudio/best",
            "outtmpl": str(out / "yt_audio.%(ext)s"), "quiet": True,
            "postprocessors": [{"key": "FFmpegExtractAudio",
                                "preferredcodec": "wav"}]}
    with yt_dlp.YoutubeDL(opts) as ydl:
        info = ydl.extract_info(url, download=True)
        return Path(ydl.prepare_filename(info)).with_suffix(".wav")


def _load_input(audio, path_text):
    from ..utils import audio_io

    if path_text and str(path_text).startswith(("http://", "https://")):
        path_text = str(download_youtube_audio(path_text))
    if audio is not None:
        sr, data = audio                       # Gradio's numpy audio
        data = audio_io.payload_to_float(np.asarray(data))
        wav = data.T if data.ndim == 2 else data[None]
        if np.abs(wav).max() > 1.5:            # float payload in int range
            wav = wav / 32768.0
    elif path_text:
        p = Path(path_text)
        if p.suffix == ".wav":
            sr, wav = audio_io.read_wav(p)
        else:
            raise ValueError("only .wav paths are read without ffmpeg")
    else:
        raise ValueError("provide an upload or a file path")
    return audio_io.to_stereo(audio_io.resample(wav, sr, SAMPLE_RATE))


def create_demo(separator):
    """The Gradio Blocks demo (Gradio imported here)."""
    import gradio as gr

    from ..utils import plotting

    def process(audio, path_text, prompt):
        wav = _load_input(audio, path_text)
        out = separator.separate(wav, prompt or "vocals")
        fig_in = plotting.plot_spectrogram(wav, "input mixture",
                                           device=separator.device)
        fig_out = plotting.plot_spectrogram(out, f"separated: {prompt}",
                                            device=separator.device)
        return ((SAMPLE_RATE, wav.T), (SAMPLE_RATE, out.T), fig_in, fig_out,
                f"separated '{prompt}' from "
                f"{wav.shape[-1] / SAMPLE_RATE:.1f} s of audio")

    with gr.Blocks(title="Audio-Text Stem Separation") as demo:
        gr.Markdown("# Text-conditioned stem separation\n"
                    "Upload audio and describe the sound to extract.")
        with gr.Row():
            audio_in = gr.Audio(label="input audio", type="numpy")
            path_in = gr.Textbox(label="...or local .wav path")
        prompt = gr.Textbox(label="prompt", value="vocals")
        btn = gr.Button("Separate")
        with gr.Row():
            player_in = gr.Audio(label="mixture")
            player_out = gr.Audio(label="separated stem")
        with gr.Row():
            spec_in = gr.Plot(label="input spectrogram")
            spec_out = gr.Plot(label="output spectrogram")
        status = gr.Textbox(label="status")
        btn.click(process, [audio_in, path_in, prompt],
                  [player_in, player_out, spec_in, spec_out, status])
    return demo


def pick_ui(ui: str) -> str:
    """``auto`` -> ``gradio`` when Gradio imports, else ``http`` (with one
    line saying so); ``gradio`` without Gradio exits."""
    if ui not in ("auto", "gradio"):
        return ui
    try:
        import gradio  # noqa: F401
    except ImportError as e:
        if ui == "gradio":
            raise SystemExit("gradio is not installed here; use --ui http "
                             "for the dependency-free HTTP UI") from e
        print("gradio not installed -> the stdlib HTTP UI (same workflow; "
              "install gradio for the Blocks demo)")
        return "http"
    return "gradio"


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def pinned_d2h_gbps(size_mb: float = 64.0) -> float:
    """The card's copy rate into pinned host memory, GB/s (one warm copy
    of ``size_mb`` MB, timed by CUDA events)."""
    import torch

    n = int(size_mb * 1e6 / 4)
    src = torch.ones(n, device="cuda")
    dst = torch.empty(n, pin_memory=True)
    dst.copy_(src, non_blocking=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return src.numel() * 4 / (start.elapsed_time(end) * 1e-3) / 1e9


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Serve the separation demo")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--config", default="config.yaml",
                    help="YAML config for segment/overlap and the default "
                         "checkpoint")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--ui", choices=("auto", "gradio", "http"), default="auto",
                    help="auto = gradio when importable, else the stdlib "
                         "HTTP UI (apps.serve_http): the same workflow, no "
                         "extra dependencies")
    ap.add_argument("--warmup-seconds", type=float, default=60.0,
                    help="separate this many seconds of silence at start-up "
                         "and autotune the streaming block (0 disables)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="default",
                    choices=["default", "opt_in", "none"],
                    help="hand-written kernels to run (ops/select.py)")
    args = ap.parse_args(argv)
    ui = pick_ui(args.ui)
    sep = build_separator(args.checkpoint, args.config, device=args.device,
                          kernels=args.kernels)
    if args.warmup_seconds > 0:
        t = int(args.warmup_seconds * SAMPLE_RATE)
        print(f"warming up on {args.warmup_seconds:.0f} s of silence...")
        t0 = time.perf_counter()
        sep.separate(np.zeros((2, t), np.float32), "vocals")
        msg = f"warm-up done in {time.perf_counter() - t0:.2f} s"
        if sep.device.type == "cuda":
            msg += f"; D2H into pinned memory {pinned_d2h_gbps():.1f} GB/s"
        print(msg)
    if ui == "gradio":
        create_demo(sep).launch(server_name=args.host, server_port=args.port)
        return
    from .serve_http import SeparationService, serve

    spectrograms = _has_matplotlib()
    if not spectrograms:
        print("matplotlib not installed -> /api/separate?format=json "
              "returns no spectrograms (install matplotlib for them)")
    service = SeparationService(sep, pretrained=sep.pretrained,
                                spectrograms=spectrograms)
    if args.warmup_seconds > 0:
        tune = service.autotune_stream_block()
        print(f"stream block auto={tune['block']} "
              f"(floor {tune['floor_s'] * 1e3:.1f} ms + "
              f"{tune['per_chunk_s'] * 1e3:.1f} ms/chunk -> first audio "
              f"~{tune['first_audio_s']:.2f} s)")
    serve(service, args.host, args.port)


if __name__ == "__main__":
    main()
