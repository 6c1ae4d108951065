"""The port's DConv-over-rows kernel against the JAX Pallas kernel.

``audio_to_sheet_music_tpu_torch.ops.fused_dconv.dconv_rows`` on a CPU
tensor runs its plain PyTorch version; it must equal
``audio_to_sheet_music_tpu.ops.pallas_dconv.dconv_rows`` in interpret mode
and the JAX per-op ``htdemucs.dconv_apply`` on the same weights and
numpy-seeded rows.  f32; tolerance 1e-5 (unit-scale rows, contraction
depths of at most 3C and C/8, GroupNorm statistics in f32).  Norm biases
and LayerScales are randomised: zero norm biases would hide pad leakage in
the Pallas kernel's lane-padded rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    (6, 16, 100),      # ragged T, off the 128-lane pad and the 32-frame tile
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
