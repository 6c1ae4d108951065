"""The port's single-song tools, plotting, profiling and the serve app, on
the CPU at test size.

- ``ops.dsp.spectrogram_db`` against the JAX function (max 1e-2 dB);
- the plotting functions write PNGs;
- ``apps.separate`` on a ``.npy`` track with stems writes
  ``sdr_report.json`` (and the ``--plots`` PNGs), and the int16 path
  writes absolute-level PCM through ``write_wav_pcm``;
- ``apps.spectrogram_tool`` on one synthetic track;
- ``cli benchmark --plot-spectrograms``;
- ``apps.serve``: the UI choice, ``build_separator``'s app protocol and
  ``main`` through its warm-up and autotune;
- ``utils.profiling``: ``timed``, ``loop_cost``, ``trace``,
  ``flops_estimate``, ``peak_tflops``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio_to_sheet_music_tpu.ops import dsp as jax_dsp
from audio_to_sheet_music_tpu_torch.apps import separate, serve, serve_http
from audio_to_sheet_music_tpu_torch.apps import spectrogram_tool
from audio_to_sheet_music_tpu_torch.data import synthetic_tracks
from audio_to_sheet_music_tpu_torch.models import atht
from audio_to_sheet_music_tpu_torch.ops import dsp
from audio_to_sheet_music_tpu_torch.utils import audio_io, plotting, profiling

ROOT = Path(__file__).resolve().parents[1]
PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture
def tiny(monkeypatch):
    """The commands build the tiny model with its random head."""
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    monkeypatch.setattr(atht, "init",
                        lambda seed=0, **kw: atht.init_tiny(seed, **kw))
    monkeypatch.setattr(atht, "load_params", lambda model, ckpt=None: model)


@pytest.mark.parametrize("shape,n_fft,hop", [((30000,), 2048, 512),
                                             ((2, 22050), 2048, 512),
                                             ((3, 9000), 512, 128)])
def test_spectrogram_db_matches_jax(shape, n_fft, hop):
    r = np.random.default_rng(0)
    x = (0.3 * r.standard_normal(shape)).astype(np.float32)
    if len(shape) == 2:
        x[-1] *= 1e-3                # a quiet item keeps its own floor
    got = dsp.spectrogram_db(torch.from_numpy(x), n_fft, hop).numpy()
    want = np.asarray(jax_dsp.spectrogram_db(jnp.asarray(x), n_fft, hop))
    assert got.shape == want.shape == (*shape[:-1], n_fft // 2 + 1,
                                       shape[-1] // hop + 1)
    assert np.abs(got - want).max() <= 1e-2
    peak = got.max(axis=(-2, -1), keepdims=True)
    assert np.all(got >= peak - 80.0 - 1e-4)


def test_plotting_writes_pngs(tmp_path):
    r = np.random.default_rng(1)
    mix = (0.2 * r.standard_normal((2, 8000))).astype(np.float32)
    stems = {s: mix * g for s, g in (("drums", 0.5), ("vocals", 0.25))}
    figs = {"one.png": plotting.plot_spectrogram(mix, "x", device="cpu"),
            "cmp.png": plotting.plot_separation_comparison(
                mix, stems["drums"], stems["vocals"], "drums", device="cpu"),
            "all.png": plotting.plot_all_stems(mix, stems, device="cpu")}
    for name, fig in figs.items():
        plotting.save_figure(fig, tmp_path / name)
        assert (tmp_path / name).read_bytes()[:8] == PNG
    png = serve_http._spectrogram_png(mix[0], "mono", "cpu")
    assert png[:8] == PNG


def test_write_wav_pcm_writes_the_bytes_as_they_are(tmp_path):
    pcm = np.array([[1, -2, 32767], [-32768, 0, 5]], np.int16)
    audio_io.write_wav_pcm(tmp_path / "a.wav", pcm, 0.5)
    audio_io.write_wav_pcm(tmp_path / "b.wav", pcm)
    for name in ("a.wav", "b.wav"):
        sr, data = wavfile.read(tmp_path / name)
        assert sr == 44100 and np.array_equal(data, pcm.T)


def _npy_track(path: Path, seconds: float = 0.6) -> np.ndarray:
    (track,) = synthetic_tracks(1, seconds=seconds, cache_dir=path.parent)
    Path(track.path).rename(path)
    return np.load(path)


def test_separate_command_reports_sdr_on_a_track_with_stems(tmp_path, tiny):
    arr = _npy_track(tmp_path / "song.npy")
    out = tmp_path / "out"
    separate.main(["--track", str(tmp_path / "song.npy"), "--output-dir",
                   str(out), "--device", "cpu", "--stems", "drums", "bass",
                   "piano", "--segment-seconds", "0.25",
                   "--overlap-seconds", "0.05", "--plots"])
    report = json.loads((out / "sdr_report.json").read_text())
    assert set(report) == {"drums", "bass"}       # piano has no ground truth
    assert all(np.isfinite(v) and -30 <= v <= 30 for v in report.values())
    for stem in ("drums", "bass", "piano"):
        sr, data = wavfile.read(out / f"extracted_{stem}.wav")
        assert sr == 44100 and data.shape == (arr.shape[-1], 2)
        assert (out / f"spectrogram_{stem}.png").read_bytes()[:8] == PNG
    _, mix = wavfile.read(out / "mixture.wav")
    assert mix.shape == (arr.shape[-1], 2)


def test_separate_command_wav_dir_track(tmp_path, tiny):
    arr = _npy_track(tmp_path / "song.npy")
    d = tmp_path / "track"
    d.mkdir()
    for i, name in enumerate(["mixture", "drums", "bass", "other", "vocals"]):
        audio_io.write_wav(d / f"{name}.wav", arr[i])
    mixture, gt = separate.load_track(d)
    assert mixture.shape == arr[0].shape and set(gt) == {
        "drums", "bass", "other", "vocals"}
    np.testing.assert_allclose(gt["bass"], np.clip(arr[2], -1, 1),
                               atol=2 / 32767)
    out = tmp_path / "out"
    separate.main(["--track", str(d), "--output-dir", str(out), "--device",
                   "cpu", "--stems", "vocals", "--segment-seconds", "0.25",
                   "--overlap-seconds", "0.05"])
    assert set(json.loads((out / "sdr_report.json").read_text())) == {
        "vocals"}


def test_spectrogram_tool_writes_the_report(tmp_path, monkeypatch):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    synthetic_tracks(1, seconds=1.0, cache_dir=tmp_path / "tracks")
    spectrogram_tool.main(["--test-dir", str(tmp_path / "tracks"),
                           "--output-dir", str(tmp_path / "spec"),
                           "--device", "cpu"])
    pngs = sorted(p.name for p in (tmp_path / "spec" / "synth_0").iterdir())
    assert pngs == ["all_stems.png", "bass.png", "drums.png", "other.png",
                    "vocals.png"]
    with pytest.raises(SystemExit):
        spectrogram_tool.main(["--test-dir", str(tmp_path / "tracks"),
                               "--tracks", "nope", "--device", "cpu"])


def test_cli_benchmark_plots_spectrograms(tmp_path):
    env = {**os.environ, "ATSM_TINY_MODEL": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "audio_to_sheet_music_tpu_torch.cli",
         "benchmark", "--synthetic", "--synthetic-tracks", "1", "--device",
         "cpu", "--models", "ours", "htdemucs", "--plot-spectrograms",
         "--output-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    spec = tmp_path / "spectrograms"
    dirs = sorted(p.name for p in spec.iterdir())
    assert dirs == ["AudioTextHTDemucs_(Ours)", "HTDemucs_(random_init)"]
    for d in dirs:
        (png,) = (spec / d).iterdir()
        assert png.name == "track_000.png" and png.read_bytes()[:8] == PNG
    assert (tmp_path / "evaluation_results.json").exists()


def test_serve_ui_choice(monkeypatch):
    """Without Gradio, ``--ui gradio`` exits and ``--ui auto`` serves the
    HTTP UI; ``--ui http`` is taken as asked."""
    import builtins

    real = builtins.__import__

    def no_gradio(name, *a, **kw):
        if name.split(".")[0] == "gradio":
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_gradio)
    with pytest.raises(SystemExit):
        serve.main(["--ui", "gradio", "--device", "cpu"])
    assert serve.pick_ui("auto") == "http"
    assert serve.pick_ui("http") == "http"


def test_build_separator_takes_the_app_protocol(tmp_path, monkeypatch):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    sep = serve.build_separator(None, str(ROOT / "config.yaml"),
                                device="cpu")
    assert sep.segment == 6 * 44100 and sep.overlap == int(0.1 * 44100)
    assert sep.normalize_text and sep.pretrained is False
    assert sep.deterministic
    assert sep.device == torch.device("cpu")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("data:\n  segment_seconds: 0.25\n  overlap: 0.05\n"
                   "training:\n  resume_from: missing.npz\n")
    with pytest.warns(UserWarning, match="does not exist"):
        sep = serve.build_separator(None, str(cfg), device="cpu")
    assert sep.segment == 11025 and sep.overlap == 2205


@pytest.mark.parametrize("app", [True, False])
def test_cudnn_determinism_holds_only_inside_the_chunk_programs(
        app, tmp_path, monkeypatch):
    """The app separator runs its encoder and heads with cuDNN's
    deterministic algorithms and gives the process's setting back; any
    other separator (training's, the benchmark's) leaves it alone."""
    from audio_to_sheet_music_tpu_torch.infer import session
    from audio_to_sheet_music_tpu_torch.models import atht

    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    cfg = tmp_path / "c.yaml"
    cfg.write_text("data:\n  segment_seconds: 0.25\n  overlap: 0.05\n")
    sep = serve.build_separator(None, str(cfg), device="cpu")
    if not app:
        sep = session.Separator(sep.model, segment_seconds=0.25,
                                overlap_seconds=0.05, device="cpu")
    seen = []
    encode = atht.encode_mixture

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        return encode(*args, **kwargs)

    monkeypatch.setattr(atht, "encode_mixture", spy)
    song = (0.3 * np.random.default_rng(0).standard_normal((2, 30000))
            ).astype(np.float32)
    pcm = sep.separate_pcm(song, "vocals")
    assert pcm.shape == song.shape and pcm.dtype == np.int16
    assert seen == [app]
    assert torch.backends.cudnn.deterministic is False


def test_serve_main_warms_up_and_autotunes(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("data:\n  segment_seconds: 0.25\n  overlap: 0.05\n")
    served = {}
    monkeypatch.setattr(serve_http, "serve",
                        lambda service, host, port: served.update(
                            service=service, host=host, port=port))
    serve.main(["--ui", "http", "--device", "cpu", "--config", str(cfg),
                "--warmup-seconds", "0.5", "--port", "0"])
    service = served["service"]
    assert isinstance(service, serve_http.SeparationService)
    assert service.spectrograms is True          # matplotlib is installed
    assert service._stream_auto is not None
    assert service.stream_block_default() == service._stream_auto["block"]
    out = capsys.readouterr().out
    assert "warm-up done" in out and "stream block auto=" in out


def test_serve_main_without_matplotlib_turns_spectrograms_off(monkeypatch,
                                                               capsys):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    monkeypatch.setattr(serve, "_has_matplotlib", lambda: False)
    served = {}
    monkeypatch.setattr(serve_http, "serve",
                        lambda service, host, port: served.update(
                            service=service))
    serve.main(["--ui", "http", "--device", "cpu", "--warmup-seconds", "0"])
    assert served["service"].spectrograms is False
    assert "matplotlib not installed" in capsys.readouterr().out


def test_serve_builds_on_the_card_by_default(monkeypatch):
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_separator(None, None)


def test_profiling_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)

    def fn(a):
        with profiling.span("atsm.test.matmul"):
            return a @ a

    with profiling.trace(str(tmp_path / "tr")) as prof:
        fn(x)
    assert prof is not None
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "atsm.test.matmul"
               for e in events["traceEvents"])
    assert profiling.flops_estimate(fn, x) == 2 * 64 ** 3
    assert profiling.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    with pytest.raises(ValueError, match="no known bf16 peak"):
        profiling.peak_tflops("Some Other Card")
