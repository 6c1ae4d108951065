"""The port's fused frequency HEncLayer against the JAX Pallas kernel.

``audio_to_sheet_music_tpu_torch.ops.fused_enc.henc_freq_fused`` on a CPU
tensor runs its plain PyTorch version; it must equal
``audio_to_sheet_music_tpu.ops.pallas_enc.henc_freq_fused`` in interpret
mode and the JAX per-op ``htdemucs.henc_layer_apply`` on the same weights and
numpy-seeded input.  f32; tolerance 1e-5 (unit-scale activations, a
contraction depth of at most 32 per product).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.models import htdemucs as JH
from audio_to_sheet_music_tpu.ops import pallas_enc
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.models import htdemucs as TH
from audio_to_sheet_music_tpu_torch.ops import fused_dconv, fused_enc

TOL = 1e-5


def _layer_pair(seed: int, cin: int, cout: int):
    """JAX freq HEncLayer params and the port's module with the same weights.
    The DConv LayerScales are raised from their 1e-3 init so the residual
    branch shows in the output."""
    p = jax.tree.map(np.asarray, JH.henc_layer_init(
        jax.random.PRNGKey(seed), cin, cout, freq=True))
    r = np.random.default_rng(seed)
    for blk in p["dconv"]["layers"]:
        blk["scale"]["scale"] = (0.5 + 0.1 * r.standard_normal(cout)
                                 ).astype(np.float32)
        for nm in ("norm1", "norm2"):
            n = blk[nm]["bias"].shape[0]
            blk[nm]["bias"] = (0.1 * r.standard_normal(n)).astype(np.float32)
    m = TH.HEncLayer(cin, cout, freq=True)
    m.load_state_dict(jax_params.state_dict_from_params(p), strict=True)
    return p, m


@pytest.mark.parametrize("cin,cout,f,t", [
    (4, 8, 32, 87),
    (4, 16, 64, 130),
    (4, 16, 16, 9),
])
def test_plain_matches_pallas_interpret_and_per_op(cin, cout, f, t):
    p, m = _layer_pair(cin * 100 + cout + f, cin, cout)
    x = (0.5 * np.random.default_rng(f + t).standard_normal((2, cin, f, t))
         ).astype(np.float32)
    per_op = np.asarray(JH.henc_layer_apply(p, jnp.asarray(x), freq=True))
    pal = np.asarray(pallas_enc.henc_freq_fused(p, jnp.asarray(x),
                                                interpret=True))
    with torch.no_grad():
        got = fused_enc.henc_freq_fused(m, torch.from_numpy(x))
    assert got.shape == (2, cout, f // 4, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), per_op, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), pal, atol=TOL, rtol=TOL)


def test_layer_apply_routes_layer_zero_through_the_wrapper():
    """``henc_layer_apply`` sends a Cin=4 freq layer to ``henc_freq_fused``
    (the JAX gate's layer-0 rule) and its per-op path gives the same."""
    p, m = _layer_pair(5, 4, 8)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 4, 32, 50)).astype(np.float32))
    with torch.no_grad():
        a = TH.henc_layer_apply(m, x, kernels=True)
        b = TH.henc_layer_apply(m, x, kernels=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)


def test_batch_rows_are_independent():
    p, m = _layer_pair(7, 4, 16)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 4, 32, 41)).astype(np.float32))
    with torch.no_grad():
        full = fused_enc.henc_freq_fused(m, x)
        for b in range(3):
            one = fused_enc.henc_freq_fused(m, x[b:b + 1])
            np.testing.assert_allclose(full[b:b + 1].numpy(), one.numpy(),
                                       atol=1e-6)


def test_wrapper_refuses_a_device_without_a_kernel():
    _, m = _layer_pair(9, 4, 8)
    with pytest.raises(ValueError, match="no kernel"):
        fused_enc.henc_freq_fused(m, torch.zeros((1, 4, 32, 9), device="meta"))


def test_supports_and_profitable():
    assert fused_enc.supports(4, 48, 2048, 259)      # layer 0, 6 s chunk
    assert not fused_enc.supports(4, 48, 30, 259)    # F off the stride grid
    assert not fused_enc.supports(4, 44, 2048, 259)  # C/8 not whole
    assert fused_enc.profitable(4)
    assert not fused_enc.profitable(48)


@pytest.mark.parametrize("cout", [fused_dconv.MAX_CHANNELS,
                                  fused_dconv.MAX_CHANNELS + 8, 512])
def test_supports_stops_at_the_dconv_routine_width(cout):
    """The JAX test, and C no wider than the CUDA DConv routine takes."""
    want = (pallas_enc.supports(4, cout, 256, 100)
            and cout <= fused_dconv.MAX_CHANNELS)
    assert pallas_enc.supports(4, cout, 256, 100)
    assert fused_enc.supports(4, cout, 256, 100) == want


def test_plain_rounds_only_the_dconv_operands_on_bf16_input():
    """On bf16 input the plain version rounds the DConv's conv operands to
    bf16 (the kernel's routine takes them so) and keeps the strided conv and
    the rewrite in f32 (the kernel's stages for them are f32 FMAs)."""
    _, m = _layer_pair(10, 4, 16)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 4, 32, 40)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = fused_enc.henc_freq_plain(m, x)
        y = torch.nn.functional.gelu(torch.nn.functional.conv2d(
            x.float(), m.conv.weight, m.conv.bias, stride=(4, 1),
            padding=(2, 0)))
        b, c, f, t = y.shape
        r = fused_dconv.dconv_rows_plain(
            m.dconv, y.permute(0, 2, 1, 3).reshape(b * f, c, t),
            dot_dtype=torch.bfloat16)
        y = r.reshape(b, f, c, t).permute(0, 2, 1, 3)
        want = torch.nn.functional.glu(torch.nn.functional.conv2d(
            y, m.rewrite.weight, m.rewrite.bias), dim=1).to(torch.bfloat16)
        f32_dconv = fused_enc.henc_freq_plain(m, x, dot_dtype=torch.float32)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert not torch.equal(got, f32_dconv)
