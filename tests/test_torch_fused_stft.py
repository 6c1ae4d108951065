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


# --- the kernel's algorithm, modelled on the CPU -----------------------------
# The CUDA kernel cannot run here.  What it computes is fixed by the host's
# tables, their layout and the pass schedule (``fused_stft.tables`` /
# ``table_offsets`` / ``passes``), and by
# the index arithmetic of ``csrc/stft.cu:fft_pass``, which the model below
# repeats pass by pass in complex64.

@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096, 8192])
def test_pass_schedule_is_radix_8_or_16_in_at_most_three_passes(n_fft):
    sched = fused_stft.passes(n_fft)
    assert np.prod([r for _, r in sched]) == n_fft // 2
    assert len(sched) <= 3 and all(r <= 16 for _, r in sched)
    ns = 1
    for s, r in sched:
        assert s == ns
        ns *= r
    if n_fft >= 1024:
        assert all(r >= 8 for _, r in sched)
    if n_fft == 4096:
        assert [r for _, r in sched] == [16, 16, 8]
    # the radix bits the launch sends, which the kernel checks against its
    # own schedule (csrc/stft.cu:packed_schedule)
    packed = fused_stft.packed_schedule(n_fft)
    assert [(packed >> (4 * p)) & 15 for p in range(len(sched))] == [
        int(np.log2(r)) for _, r in sched]
    assert packed >> (4 * len(sched)) == 0


@pytest.mark.parametrize("n_fft", [256, 4096, 8192])
def test_tables_match_float64(n_fft):
    """Window pairs, split factors and pass twiddles, against float64 values
    computed here by another route (angles reduced mod 2π first)."""
    m = n_fft // 2
    tab = fused_stft.tables(n_fft, "cpu")
    assert tab.dtype == torch.float32 and tab.shape[1] == 2
    t = tab.numpy().astype(np.float64)
    offs = fused_stft.table_offsets(n_fft)
    sched = fused_stft.passes(n_fft)
    assert offs[:2] == [0, m] and len(offs) == 2 + len(sched) - 1
    n = np.arange(n_fft)
    hann = np.sin(np.pi * n / n_fft) ** 2             # = 0.5 - 0.5 cos(2πn/N)
    np.testing.assert_allclose(t[:m].ravel(), hann, atol=6e-8, rtol=0)
    k = np.arange(m + 1)
    ang = -2 * np.pi * (k % n_fft) / n_fft
    sp = t[offs[1]:offs[1] + m + 1]
    np.testing.assert_allclose(sp[:, 0], np.cos(ang), atol=6e-8, rtol=0)
    np.testing.assert_allclose(sp[:, 1], np.sin(ang), atol=6e-8, rtol=0)
    end = offs[1] + m + 1
    for off, (ns, r) in zip(offs[2:], sched[1:]):
        assert off == end
        q, kk = np.meshgrid(np.arange(r), np.arange(ns), indexing="ij")
        ang = -2 * np.pi * ((q * kk) % (ns * r)) / (ns * r)
        got = t[off:off + ns * r]
        np.testing.assert_allclose(got[:, 0], np.cos(ang).ravel(), atol=6e-8,
                                   rtol=0)
        np.testing.assert_allclose(got[:, 1], np.sin(ang).ravel(), atol=6e-8,
                                   rtol=0)
        end = off + ns * r
    assert end == tab.shape[0]


def _stockham_model(x: np.ndarray, n_fft: int, hop: int, n_frames: int
                    ) -> np.ndarray:
    """``csrc/stft.cu`` in numpy, complex64 between passes: pack the windowed
    frame, run the Stockham passes from the tables, split."""
    m = n_fft // 2
    tab = fused_stft.tables(n_fft, "cpu").numpy()
    c = (tab[:, 0] + 1j * tab[:, 1]).astype(np.complex64)
    offs = fused_stft.table_offsets(n_fft)
    win, split = tab[:m], c[offs[1]:offs[1] + m + 1]
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    fr = x[:, idx]                                    # (rows, frames, N)
    z = (fr[..., 0::2] * win[:, 0] + 1j * (fr[..., 1::2] * win[:, 1])
         ).astype(np.complex64)
    for p, (ns, r) in enumerate(fused_stft.passes(n_fft)):
        nbf = m // r
        j = np.arange(nbf)[:, None]
        q = np.arange(r)[None, :]
        v = z[..., j + q * nbf]                       # (…, butterflies, R)
        if p:                                         # this pass's table
            v = (v * c[offs[1 + p] + q * ns + j % ns]).astype(np.complex64)
        v = np.fft.fft(v, axis=-1).astype(np.complex64)   # the R-point DFT
        out = np.empty_like(z)
        out[..., (j // ns) * ns * r + j % ns + q * ns] = v
        z = out
    k = np.arange(m + 1)
    zk, zm = z[..., k % m], np.conj(z[..., (m - k) % m])
    spec = 0.5 * (zk + zm) + split * (0.5 * (zk - zm) / 1j)
    return np.swapaxes(spec.astype(np.complex64), -1, -2)


@pytest.mark.parametrize("n_fft,hop,n_frames", [
    (256, 128, 9), (256, 256, 1), (4096, 1024, 11), (4096, 1024, 263),
    (8192, 2048, 3), (8192, 1024, 5)])
def test_stockham_model_matches_rfft(n_fft, hop, n_frames):
    """The kernel's schedule and tables give the spectrum to 1e-5 of its
    peak, with frame counts off the 4- and 8-frame blocks."""
    rows = 2 if n_frames < 100 else 1
    x = np.random.default_rng(n_fft + n_frames).standard_normal(
        (rows, (n_frames - 1) * hop + n_fft)).astype(np.float32)
    got = _stockham_model(x, n_fft, hop, n_frames)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    want = np.swapaxes(np.fft.rfft(x.astype(np.float64)[:, idx] * hann,
                                   axis=-1), -1, -2)
    assert got.shape == want.shape == (rows, n_fft // 2 + 1, n_frames)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
