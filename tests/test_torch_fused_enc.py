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
    """On bf16 input the plain version rounds the operands of every product
    to bf16, the JAX ``_kernel``'s rule: x and the strided conv's weight,
    the DConv's conv operands, the rewrite's weight and its input y.  Sums
    and everything between the products stay f32.  With
    ``dot_dtype=float32`` nothing but the input is bf16, and the result
    differs; so does the rule that rounds the DConv's operands alone."""
    _, m = _layer_pair(10, 4, 16)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 4, 32, 40)).astype(np.float32)).to(torch.bfloat16)
    rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    conv2d, gelu = torch.nn.functional.conv2d, torch.nn.functional.gelu

    def layer(rnd_top):
        y = gelu(conv2d(rnd_top(x.float()), rnd_top(m.conv.weight),
                        m.conv.bias, stride=(4, 1), padding=(2, 0)))
        b, c, f, t = y.shape
        r = fused_dconv.dconv_rows_plain(
            m.dconv, y.permute(0, 2, 1, 3).reshape(b * f, c, t),
            dot_dtype=torch.bfloat16)
        y = r.reshape(b, f, c, t).permute(0, 2, 1, 3)
        return torch.nn.functional.glu(conv2d(
            rnd_top(y), rnd_top(m.rewrite.weight), m.rewrite.bias),
            dim=1).to(torch.bfloat16)

    with torch.no_grad():
        got = fused_enc.henc_freq_plain(m, x)
        want = layer(rnd)
        dconv_only = layer(lambda t: t.float())
        f32_dots = fused_enc.henc_freq_plain(m, x, dot_dtype=torch.float32)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert not torch.equal(got, dconv_only)
    assert not torch.equal(got, f32_dots)


@pytest.mark.parametrize("cin,cout,f,t", [
    (4, 8, 32, 87),
    (4, 16, 64, 130),
    (4, 16, 16, 9),
])
def test_plain_matches_pallas_interpret_on_bf16_input(cin, cout, f, t):
    """On bf16 input the plain version computes the JAX kernel's function:
    the same operands rounded to bf16 (``pallas_enc.py:150, 164-165`` and
    the DConv's), f32 sums.  Tolerance: 1 bf16 step (2^-8) of max|ref| and
    2^-11 of rms(ref).  What remains is the f32 summation order, which can
    flip an intermediate bf16 rounding (y before the DConv or the rewrite, a
    hidden value) and the output's own.  At (4, 16, 64, 130) this rule
    measured 0.37 steps and 1.6e-4 of rms(ref); the rule that rounded the
    DConv's operands alone was 1.47 steps and 3.9e-3 off."""
    p, m = _layer_pair(cin * 100 + cout + f, cin, cout)
    x = torch.from_numpy((0.5 * np.random.default_rng(f + t).standard_normal(
        (2, cin, f, t))).astype(np.float32)).to(torch.bfloat16)
    ref = np.asarray(pallas_enc.henc_freq_fused(
        p, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        interpret=True).astype(jnp.float32))
    with torch.no_grad():
        got = fused_enc.henc_freq_fused(m, x)
    assert got.shape == (2, cout, f // 4, t) and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    top, rms = np.abs(ref).max(), np.sqrt(np.mean(ref ** 2))
    assert err.max() <= 2.0 ** -8 * top, (err.max() / top * 2 ** 8)
    assert np.sqrt(np.mean(err ** 2)) <= 2.0 ** -11 * rms, (
        np.sqrt(np.mean(err ** 2)) / rms)


@pytest.mark.parametrize("cin,cout,f,t", [(4, 48, 32, 70), (2, 16, 16, 9)])
def test_kernel_weights_model_the_conv_and_rewrite(cin, cout, f, t):
    """``top_weights`` as ``csrc/henc_freq.cu`` reads them: ``wc`` (C, Kp)
    and ``wr`` (2C, Cp) bf16 with zero pads.  A numpy model of the kernel's
    two GEMMs over them (x staged frame-major at column ``ci * 8 + kf`` from
    input row ``4 fo + kf - 2``, zeros past F; the rewrite's `a` column c
    and gate column c + C from rows c and C + c) gives the plain version's
    bf16-operand conv and rewrite, to f32 summation order."""
    _, m = _layer_pair(20 + cin, cin, cout)
    kp, cp = -(-cin * 8 // 16) * 16, -(-cout // 16) * 16
    wc, bc, wr, br = fused_enc.top_weights(m, torch.device("cpu"), "test",
                                           kp, cp)
    assert wc.dtype == wr.dtype == torch.bfloat16
    assert wc.shape == (cout, kp) and wr.shape == (2 * cout, cp)
    assert not wc[:, cin * 8:].any() and not wr[:, cout:].any()
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((2, cin, f, t)).astype(
        np.float32)).to(torch.bfloat16)
    rnd = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
    with torch.no_grad():
        conv = torch.nn.functional.conv2d(
            x.float(), rnd(m.conv.weight), m.conv.bias, stride=(4, 1),
            padding=(2, 0))
        yv = torch.from_numpy(rng.standard_normal((2, cout, f // 4, t)).astype(
            np.float32))
        rew = torch.nn.functional.conv2d(rnd(yv), rnd(m.rewrite.weight),
                                         m.rewrite.bias)
    xs = np.zeros((2, f // 4, t, kp), np.float32)   # (b, fo) rows: (T, Kp)
    xn = x.float().numpy()
    for fo in range(f // 4):
        for k in range(cin * 8):
            fi = 4 * fo + k % 8 - 2
            if 0 <= fi < f:
                xs[:, fo, :, k] = xn[:, k // 8, fi, :]
    model = xs @ wc.float().numpy().T + bc.numpy()   # (b, fo, t, C)
    np.testing.assert_allclose(model.transpose(0, 3, 1, 2), conv.numpy(),
                               atol=1e-5, rtol=1e-5)
    ys = np.zeros((2, f // 4, t, cp), np.float32)
    ys[..., :cout] = rnd(yv).numpy().transpose(0, 2, 3, 1)
    z = ys @ wr.float().numpy().T + br.numpy()       # (b, fo, t, 2C)
    np.testing.assert_allclose(z.transpose(0, 3, 1, 2), rew.numpy(),
                               atol=1e-5, rtol=1e-5)
