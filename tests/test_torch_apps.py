"""The port's ``separate`` command and WAV helpers, on the CPU.

The command builds the full-width model; here it gets the tiny family
member instead (same wiring), so the test checks the command's plumbing:
WAV in, ``separate_all_pcm`` at absolute level, one int16 WAV per stem out.
"""

from __future__ import annotations

import numpy as np
import pytest
from scipy.io import wavfile

from audio_to_sheet_music_tpu.utils import audio_io as jax_audio_io
from audio_to_sheet_music_tpu_torch.apps import separate
from audio_to_sheet_music_tpu_torch.models import atht
from audio_to_sheet_music_tpu_torch.utils import audio_io


def test_separate_command_writes_one_wav_per_stem(tmp_path, monkeypatch):
    monkeypatch.setattr(atht, "init", lambda seed, **kw: atht.init_tiny(
        seed, **kw))
    monkeypatch.setattr(atht, "load_params", lambda model, ckpt: model)
    r = np.random.default_rng(0)
    pcm = (0.3 * r.standard_normal((30000, 2)) * 32767).clip(
        -32767, 32767).astype(np.int16)
    track = tmp_path / "mix.wav"
    wavfile.write(track, 44100, pcm)
    out = tmp_path / "out"
    separate.main(["--track", str(track), "--output-dir", str(out),
                   "--device", "cpu", "--stems", "drums", "vocals",
                   "--segment-seconds", "0.25", "--overlap-seconds", "0.05"])
    sr, mix = wavfile.read(out / "mixture.wav")
    assert sr == 44100 and np.array_equal(mix, pcm)
    for stem in ("drums", "vocals"):
        sr, data = wavfile.read(out / f"extracted_{stem}.wav")
        assert sr == 44100 and data.dtype == np.int16
        assert data.shape == pcm.shape and np.abs(data).max() > 0


def test_separate_command_rejects_other_formats(tmp_path):
    with pytest.raises(SystemExit):
        separate.main(["--track", str(tmp_path / "song.mp3"), "--device",
                       "cpu"])


@pytest.mark.parametrize("sr,channels", [(44100, 2), (22050, 1)])
def test_load_mixture(tmp_path, sr, channels):
    r = np.random.default_rng(1)
    data = (0.2 * r.standard_normal((sr // 10, channels)) * 32767).astype(
        np.int16)
    path = tmp_path / "x.wav"
    wavfile.write(path, sr, data if channels > 1 else data[:, 0])
    mix = separate.load_mixture(path)
    assert mix.shape[0] == 2
    if sr == 44100:
        assert mix.dtype == np.int16 and np.array_equal(mix, data.T)
    else:
        assert mix.dtype == np.float32 and mix.shape[1] == 4410


def test_audio_io_matches_the_jax_package(tmp_path):
    r = np.random.default_rng(2)
    wav = (0.5 * r.standard_normal((2, 1000))).astype(np.float32)
    audio_io.write_wav(tmp_path / "a.wav", wav)
    jax_audio_io.write_wav(tmp_path / "b.wav", wav)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    sr, got = audio_io.read_wav(tmp_path / "a.wav")
    _, want = jax_audio_io.read_wav(tmp_path / "a.wav")
    assert sr == 44100 and np.array_equal(got, want)
    np.testing.assert_allclose(audio_io.resample(wav, 32000),
                               jax_audio_io.resample(wav, 32000), atol=1e-6)
