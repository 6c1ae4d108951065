"""The port's DConv-over-rows kernel against the JAX Pallas kernel.

``audio_to_sheet_music_tpu_torch.ops.fused_dconv.dconv_rows`` on a CPU
tensor runs its plain PyTorch version; it must equal
``audio_to_sheet_music_tpu.ops.pallas_dconv.dconv_rows`` in interpret mode
and the JAX per-op ``htdemucs.dconv_apply`` on the same weights and
numpy-seeded rows.  f32; tolerance 1e-5 (unit-scale rows, contraction
depths of at most 3C and C/8, GroupNorm statistics in f32).  Norm biases
and LayerScales are randomised: zero norm biases would hide pad leakage in
the Pallas kernel's lane-padded rows.

With ``dot_dtype=bf16`` the plain version must follow the JAX routine's
own bf16 rule (``pallas_dconv._block_body(..., dot_dtype=bf16)``), and a
torch model of the CUDA kernel's tiling (``csrc/dconv_row.cuh``: frame
tiles, zero halo, three tap K-slices, the hidden padded to the MMA's k,
bf16 operands, per-tile statistics merged by Chan's formula) must equal
the plain version.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_to_sheet_music_tpu.models import htdemucs as JH
from audio_to_sheet_music_tpu.ops import pallas_dconv
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.models import htdemucs as TH
from audio_to_sheet_music_tpu_torch.ops import fused_dconv

TOL = 1e-5


def _dconv_pair(seed: int, c: int):
    """JAX DConv params and the port's module holding the same weights."""
    p = jax.tree.map(np.asarray, JH.dconv_init(jax.random.PRNGKey(seed), c))
    r = np.random.default_rng(seed)
    for blk in p["layers"]:
        for nm in ("norm1", "norm2"):
            n = blk[nm]["bias"].shape[0]
            blk[nm]["bias"] = (0.5 * r.standard_normal(n)).astype(np.float32)
            blk[nm]["weight"] = (1 + 0.1 * r.standard_normal(n)).astype(np.float32)
        blk["scale"]["scale"] = (0.5 * r.standard_normal(c)).astype(np.float32)
    m = TH.DConv(c)
    prefix = ("htdemucs", "encoder", "0", "dconv")
    state = jax_params.state_dict_from_params(p, prefix=prefix)
    cut = len(".".join(prefix)) + 1
    m.load_state_dict({k[cut:]: v for k, v in state.items()}, strict=True)
    return p, m


@pytest.mark.parametrize("r,c,t", [
    (4, 8, 40),        # C/8 = 1
    (6, 16, 100),      # ragged T, off the 128-lane pad and the 64-frame tile
    (3, 32, 33),
    (2, 48, 129),
])
def test_plain_matches_pallas_interpret_and_per_op(r, c, t):
    p, m = _dconv_pair(r * 100 + c + t, c)
    x = np.random.default_rng(t).standard_normal((r, c, t)).astype(np.float32)
    per_op = np.asarray(JH.dconv_apply(p, jnp.asarray(x)))
    pal = np.asarray(pallas_dconv.dconv_rows(p, jnp.asarray(x), interpret=True))
    with torch.no_grad():
        got = fused_dconv.dconv_rows(m, torch.from_numpy(x))
    assert got.shape == (r, c, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pal, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), per_op, atol=TOL, rtol=TOL)


def test_cpu_wrapper_takes_the_plain_version_without_counting():
    _, m = _dconv_pair(1, 16)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 16, 20)).astype(np.float32))
    before = fused_dconv.dconv_rows.launches
    with torch.no_grad():
        a = fused_dconv.dconv_rows(m, x)
        b = fused_dconv.dconv_rows_plain(m, x)
    assert fused_dconv.dconv_rows.launches == before
    assert torch.equal(a, b)


def test_wrapper_refuses_a_device_without_a_kernel():
    _, m = _dconv_pair(3, 8)
    with pytest.raises(ValueError, match="no kernel"):
        fused_dconv.dconv_rows(m, torch.zeros((1, 8, 9), device="meta"))


def test_rows_are_independent():
    _, m = _dconv_pair(4, 16)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (5, 16, 37)).astype(np.float32))
    perm = torch.tensor([3, 0, 4, 1, 2])
    with torch.no_grad():
        a = fused_dconv.dconv_rows(m, x)
        b = fused_dconv.dconv_rows(m, x[perm])
    np.testing.assert_allclose(a[perm].numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("n_rows,t,c", [
    (6144, 336, 48), (96, 336, 384), (7, 336, 48), (8, 336, 12),
    (64, 259, 384), (1024, 259, 96), (8, 5000, 384), (3, 259, 16)])
def test_supports_is_the_jax_test(n_rows, t, c):
    assert fused_dconv.supports(n_rows, t, c) == pallas_dconv.supports(
        n_rows, t, c)


@pytest.mark.parametrize("n_rows,t,c", [
    (64, 259, 392), (8, 100, 392), (2, 100, 512)])
def test_supports_refuses_rows_wider_than_the_kernel(n_rows, t, c):
    """Rows the JAX test takes but the CUDA routine cannot hold."""
    assert c > fused_dconv.MAX_CHANNELS
    assert pallas_dconv.supports(n_rows, t, c)
    assert not fused_dconv.supports(n_rows, t, c)


def test_freq_dconv_routes_by_the_selection():
    """``_dconv_freq`` under the opt-in selection (the plain version on the
    CPU) equals the per-op DConv, and the default selection leaves it per
    op."""
    from audio_to_sheet_music_tpu_torch.ops.select import DEFAULT, NONE, OPT_IN

    _, m = _dconv_pair(6, 16)
    y = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 16, 8, 30)).astype(np.float32))
    with torch.no_grad():
        a = TH._dconv_freq(m, y, OPT_IN)
        b = TH._dconv_freq(m, y, NONE)
        c = TH._dconv_freq(m, y, DEFAULT)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
    assert torch.equal(b, c)


# ---------------------------------------------------------------------------
# bf16 conv operands: the JAX rule, and the CUDA kernel's tiling
# ---------------------------------------------------------------------------

# The kernel's frame tile, read from its source so the model follows it.
TT = int(re.search(r"constexpr int TT = (\d+);", (
    Path(fused_dconv.__file__).parents[1] / "csrc" / "dconv_row.cuh"
).read_text()).group(1))


def _bf16_rows(shape, seed):
    """Unit-scale f32 rows that bf16 holds exactly (the kernel's input)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float()


# bf16 operands are rounded identically on both sides; what differs is the
# f32 summation order (and, against JAX, the GELU: exact erf here, the A&S
# 7.1.26 erf there, 1.5e-7 apart).  Either can flip the bf16 rounding of an
# operand that lies near a rounding boundary: a hidden value, or one of
# block 1's inputs, which block 0 leaves ~1e-5 apart in f32.  A flip moves
# a conv output by one bf16 step of that operand, which GroupNorm, the GLU
# and the LayerScale carry to a few outputs (~0.4 bf16 steps of the peak at
# C = 96); everything else agrees to f32 rounding.  So: max error within one
# bf16 step (2^-8) of max|ref|, rms error within 2^-12 of rms(ref).
def _close_bf16(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    top, rms = np.abs(want).max(), np.sqrt(np.mean(want ** 2))
    assert err.max() <= 2.0 ** -8 * top, (err.max(), top)
    assert np.sqrt(np.mean(err ** 2)) <= 2.0 ** -12 * rms, (
        np.sqrt(np.mean(err ** 2)), rms)


@pytest.mark.parametrize("r,c,t", [(3, 16, 100), (2, 96, 259), (4, 48, 130)])
def test_bf16_plain_matches_jax_block_body(r, c, t):
    """``dconv_rows_plain(dot_dtype=bf16)`` against the JAX routine with
    ``dot_dtype=bf16``, both blocks (dilation 1 then 2), on a ``(C, RB, TP)``
    tile lane-padded past T with its mask."""
    p, m = _dconv_pair(7 * c + t, c)
    x = _bf16_rows((r, c, t), c + t)
    weights = pallas_dconv._flatten_params(p)
    tp = -(-t // 128) * 128
    mask = (jnp.arange(tp) < t).astype(jnp.float32)[None, None, :]
    y = jnp.pad(jnp.asarray(x.numpy()).transpose(1, 0, 2),
                ((0, 0), (0, 0), (0, tp - t)))
    for d in range(2):
        blk = dict(zip(pallas_dconv._WNAMES, weights[9 * d:9 * d + 9]))
        y = pallas_dconv._block_body(y, blk, 2 ** d, mask, float(t),
                                     dot_dtype=jnp.bfloat16)
    want = np.asarray(y)[:, :, :t].transpose(1, 0, 2)
    with torch.no_grad():
        got = fused_dconv.dconv_rows_plain(m, x, dot_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    _close_bf16(got.numpy(), want)


def test_plain_dot_dtype_follows_the_input():
    """bf16 input rounds the conv operands (the kernel's rule); f32 input
    keeps the f32 function every f32 test above holds."""
    _, m = _dconv_pair(11, 32)
    x = _bf16_rows((2, 32, 50), 12)
    with torch.no_grad():
        by_input = fused_dconv.dconv_rows_plain(m, x.to(torch.bfloat16))
        bf = fused_dconv.dconv_rows_plain(m, x, dot_dtype=torch.bfloat16)
        f32 = fused_dconv.dconv_rows_plain(m, x)
        f32_named = fused_dconv.dconv_rows_plain(m, x, dot_dtype=torch.float32)
    assert torch.equal(by_input, bf.to(torch.bfloat16))
    assert torch.equal(f32, f32_named)
    assert not torch.equal(f32, bf)


def _chan(parts, per_t, lens):
    """The kernel's ``row_stats``: per-row (mean, M2) of each tile merged in
    tile order; returns the mean and 1/sqrt(var + eps)."""
    n, m, m2 = 0.0, torch.zeros(parts[0][0].shape), torch.zeros(
        parts[0][0].shape)
    for (mb, qb), ln in zip(parts, lens):
        nb = float(per_t * ln)
        tot, d = n + nb, mb - m
        m = m + d * (nb / tot)
        m2 = m2 + qb + d * d * (n * nb / tot)
        n = tot
    return m, torch.rsqrt(m2 / n + fused_dconv.EPS)


def _two_pass(v):
    """Mean and M2 per row of a (R, ...) tile."""
    v = v.reshape(v.shape[0], -1)
    mean = v.mean(1)
    return mean, ((v - mean[:, None]) ** 2).sum(1)


def _tiled_block(ws, x, dil):
    """One DConv block as ``csrc/dconv_row.cuh`` computes it, from the
    wrapper's kernel weights ``ws`` (w1 (3, C, Hp), w2 (2C, Hp) bf16)."""
    w1, b1, g1, bt1, w2, b2, g2, bt2, s = [w.float() for w in ws]
    r, c, t = x.shape
    h, hp = b1.shape[0], w1.shape[2]
    bf = lambda v: v.to(torch.bfloat16).float()  # noqa: E731
    ntile = -(-t // TT)
    lens = [min(TT, t - k * TT) for k in range(ntile)]
    # frame-major x with a zero halo of dil frames at both row ends
    xs = bf(F.pad(x, (dil, ntile * TT - t + dil))).transpose(1, 2)
    # 1. conv1: three tap K-slices over the tile's x rows
    u, part1 = [], []
    for k, ln in enumerate(lens):
        rows = xs[:, k * TT:k * TT + TT + 2 * dil]
        acc = sum(rows[:, tap * dil:tap * dil + TT] @ w1[tap]
                  for tap in range(3))                   # (R, TT, Hp)
        assert torch.all(acc[:, :, h:] == 0)             # the zero pad
        u.append(acc[:, :ln, :h] + b1)
        part1.append(_two_pass(u[-1]))                   # H x len values
    mean1, rstd1 = _chan(part1, h, lens)

    def z_tile(k):
        hid = F.gelu((u[k] - mean1[:, None, None]) * rstd1[:, None, None]
                     * g1 + bt1)
        hid = F.pad(bf(hid), (0, hp - h, 0, TT - lens[k]))   # (R, TT, Hp)
        return (hid @ w2.T + b2)[:, :lens[k]]            # (R, len, 2C)

    # 2. the statistics of z, tile by tile; 3. z again and the epilogue
    mean2, rstd2 = _chan([_two_pass(z_tile(k)) for k in range(ntile)],
                         2 * c, lens)
    out = x.clone()
    for k, ln in enumerate(lens):
        z = (z_tile(k) - mean2[:, None, None]) * rstd2[:, None, None] * g2 + bt2
        glu = z[:, :, :c] * torch.sigmoid(z[:, :, c:])
        out[:, :, k * TT:k * TT + ln] += (s * glu).transpose(1, 2)
    return out


@pytest.mark.parametrize("c", [16, 96, 384])
@pytest.mark.parametrize("t", [1, TT - 1, TT + 1, 259])
def test_kernel_tiling_model_matches_bf16_plain(c, t):
    """The kernel's tiling, on the wrapper's own weight layout, against the
    plain version with bf16 operands.  C = 96 has H = 12: the padded case."""
    _, m = _dconv_pair(c + 3 * t, c)
    x = _bf16_rows((2, c, t), t)
    hp = -(-c // 128) * 16                   # C/8 rounded up to the MMA's 16
    ws = fused_dconv.kernel_weights(m, torch.device("cpu"), "test", hp)
    assert ws[0].shape == (3, c, hp)
    assert ws[0].dtype == ws[4].dtype == torch.bfloat16
    with torch.no_grad():
        got = _tiled_block(ws[9:], _tiled_block(ws[:9], x, 1), 2)
        want = fused_dconv.dconv_rows_plain(m, x, dot_dtype=torch.bfloat16)
    _close_bf16(got.numpy(), want.numpy())
