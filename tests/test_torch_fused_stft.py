"""The port's STFT kernel against the JAX Pallas kernel.

``audio_to_sheet_music_tpu_torch.ops.fused_stft.stft`` on a CPU tensor runs
its plain version (framing, periodic Hann window, ``torch.fft.rfft``); it
must equal ``audio_to_sheet_music_tpu.ops.pallas_stft.stft_pallas`` in
interpret mode on the same numpy-seeded signal, to 3e-4 of the spectrum's
peak (the tolerance of the JAX kernel's own test: its four-step DFT runs as
f32 matrix products).  ``dsp.stft`` with the kernel selected must equal the
per-op ``torch.stft`` path and the JAX ``dsp.stft``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.ops import dsp as JD
from audio_to_sheet_music_tpu.ops import pallas_stft
from audio_to_sheet_music_tpu_torch.ops import dsp as TD
from audio_to_sheet_music_tpu_torch.ops import fused_stft

TOL = 3e-4


def _close_complex(got: torch.Tensor, want: np.ndarray, tol: float) -> None:
    scale = np.abs(want).max()
    g = got.numpy()
    np.testing.assert_allclose(g.real, want.real, atol=tol * scale, rtol=0)
    np.testing.assert_allclose(g.imag, want.imag, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("rows,n_frames", [(3, 9), (2, 11)])
def test_plain_matches_pallas_interpret(rows, n_frames):
    n_fft, hop = 256, 128
    x = np.random.default_rng(n_frames).standard_normal(
        (rows, (n_frames - 1) * hop + n_fft)).astype(np.float32)
    want = np.asarray(pallas_stft.stft_pallas(jnp.asarray(x), n_fft, hop,
                                              n_frames, interpret=True))
    got = fused_stft.stft(torch.from_numpy(x), n_fft, hop, n_frames)
    assert got.shape == want.shape == (rows, n_fft // 2 + 1, n_frames)
    assert got.dtype == torch.complex64
    _close_complex(got, want, TOL)


def test_cpu_wrapper_takes_the_plain_version_without_counting():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1000)).astype(np.float32))
    before = fused_stft.stft.launches
    a = fused_stft.stft(x, 256, 128, 6)
    b = fused_stft.stft_plain(x, 256, 128, 6)
    assert fused_stft.stft.launches == before
    assert torch.equal(a, b)


def test_wrapper_refuses_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        fused_stft.stft(torch.zeros((1, 600), device="meta"), 256, 128, 3)


@pytest.mark.parametrize("n_fft,hop", [(4096, 1024), (256, 128), (1024, 480),
                                       (128, 128), (1000, 256)])
def test_supports_is_the_jax_test(n_fft, hop):
    assert fused_stft.supports(n_fft, hop) == pallas_stft.supports(n_fft, hop)


def test_dsp_stft_through_the_kernel_matches_per_op_and_jax():
    """``dsp.stft(kernel=True)``: reflect pad, the kernel's route, the
    ``n_fft ** -0.5`` scale; the same spectrum as ``torch.stft`` and the
    JAX ``dsp.stft`` (centred, normalised)."""
    x = (0.3 * np.random.default_rng(2).standard_normal((2, 2, 3000))
         ).astype(np.float32)
    got = TD.stft(torch.from_numpy(x), 512, 128, kernel=True)
    per_op = TD.stft(torch.from_numpy(x), 512, 128, kernel=False)
    want = np.asarray(JD.stft(jnp.asarray(x), 512, 128))
    assert got.shape == per_op.shape == want.shape
    _close_complex(got, per_op.numpy(), 1e-5)
    _close_complex(got, want, 1e-5)


def test_spec_with_the_kernel_feeds_the_encoder_the_same_input():
    x = torch.from_numpy((0.3 * np.random.default_rng(3).standard_normal(
        (1, 2, 11025))).astype(np.float32))
    a = TD.spec(x, kernel=True)
    b = TD.spec(x, kernel=False)
    _close_complex(a, b.numpy(), 1e-5)
