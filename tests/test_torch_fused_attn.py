"""The port's fused layer tail and attention block against the JAX Pallas
kernels.

``audio_to_sheet_music_tpu_torch.ops.fused_attn.layer_tail`` and
``attn_block`` on CPU tensors run their plain PyTorch versions; they must
equal ``audio_to_sheet_music_tpu.ops.pallas_attn.layer_tail`` /
``attn_block`` in interpret mode and the JAX per-op layer
(``_self_layer_apply`` / ``_cross_layer_apply``) on the same numpy-seeded
inputs.  f32 throughout; tolerance 2e-5, the one the JAX kernel's own tests
use against its per-op path.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.models import htdemucs as JH
from audio_to_sheet_music_tpu.ops import pallas_attn
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.models import htdemucs as TH
from audio_to_sheet_music_tpu_torch.ops import fused_attn

D, HEADS, FF = 128, 2, 256
TOL = 2e-5


def _inputs(seed: int, b: int, l: int, s: int):
    """Activations and layer weights from one numpy seed (f32)."""
    r = np.random.default_rng(seed)
    n = lambda *sh, sc=1.0: (sc * r.standard_normal(sh)).astype(np.float32)  # noqa: E731
    acts = dict(h=n(b, l, D), k=n(b, s, D), v=n(b, s, D), x=n(b, l, D))
    w = dict(wq=n(D, D, sc=D ** -0.5), bq=n(D, sc=0.1),
             wo=n(D, D, sc=D ** -0.5), bo=n(D, sc=0.1), g1=n(D, sc=0.5),
             lnw=1.0 + n(D, sc=0.1), lnb=n(D, sc=0.1),
             w1=n(FF, D, sc=D ** -0.5), b1=n(FF, sc=0.1),
             w2=n(D, FF, sc=FF ** -0.5), b2=n(D, sc=0.1), g2=n(D, sc=0.5))
    return acts, w


_ORDER = ("h", "k", "v", "x", "wq", "bq", "wo", "bo", "g1", "lnw", "lnb",
          "w1", "b1", "w2", "b2", "g2")


@pytest.mark.parametrize("l,s", [(100, 188), (188, 100), (128, 128)])
def test_plain_layer_tail_matches_pallas_interpret(l, s):
    acts, w = _inputs(l * 7 + s, 2, l, s)
    args = {**acts, **w}
    want = pallas_attn.layer_tail(*(jnp.asarray(args[n]) for n in _ORDER),
                                  HEADS, interpret=True)
    got = fused_attn.layer_tail(*(torch.from_numpy(args[n]) for n in _ORDER),
                                HEADS)
    assert got.shape == (2, l, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_cpu_wrapper_takes_the_plain_version_without_counting():
    acts, w = _inputs(3, 1, 40, 70)
    args = [torch.from_numpy({**acts, **w}[n]) for n in _ORDER]
    before = fused_attn.layer_tail.launches
    a = fused_attn.layer_tail(*args, HEADS)
    b = fused_attn.layer_tail_plain(*args, HEADS)
    assert fused_attn.layer_tail.launches == before
    assert torch.equal(a, b)


def test_wrapper_refuses_a_device_without_a_kernel():
    acts, w = _inputs(4, 1, 8, 8)
    args = [torch.from_numpy({**acts, **w}[n]).to("meta") for n in _ORDER]
    with pytest.raises(ValueError, match="no kernel"):
        fused_attn.layer_tail(*args, HEADS)


def _layer_pair(seed: int, cross: bool):
    """A JAX transformer layer and the port's, holding the same weights
    (LayerScales moved off their 1e-4 init so the branches matter)."""
    p = JH._transformer_layer_init(jax.random.PRNGKey(seed), D, cross, FF)
    p = jax.tree.map(np.asarray, p)
    r = np.random.default_rng(seed)
    for g in ("gamma_1", "gamma_2"):
        p[g]["scale"] = (0.3 + 0.1 * r.standard_normal(D)).astype(np.float32)
    for nm in ("norm1", "norm2", "norm3", "norm_out"):
        if nm in p:
            p[nm]["bias"] = (0.1 * r.standard_normal(D)).astype(np.float32)
    m = TH.TransformerLayer(D, cross, FF)
    m.load_state_dict(jax_params.state_dict_from_params(p), strict=True)
    return p, m


def test_fused_self_layer_matches_jax_layer_and_pallas():
    p, m = _layer_pair(11, cross=False)
    x = np.random.default_rng(12).standard_normal((2, 100, D)).astype(np.float32)
    want = np.asarray(JH._self_layer_apply(p, jnp.asarray(x)))
    pal = np.asarray(JH._group_norm_tokens(
        p["norm_out"], pallas_attn.fused_self_layer(p, jnp.asarray(x), HEADS,
                                                    interpret=True)))
    with torch.no_grad():
        pre = fused_attn.fused_self_layer(m, torch.from_numpy(x), HEADS)
        got = TH._group_norm_tokens(m.norm_out, pre).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)


def test_fused_cross_layer_matches_jax_layer_and_pallas():
    p, m = _layer_pair(13, cross=True)
    r = np.random.default_rng(14)
    q = r.standard_normal((2, 100, D)).astype(np.float32)
    mem = r.standard_normal((2, 188, D)).astype(np.float32)
    want = np.asarray(JH._cross_layer_apply(p, jnp.asarray(q), jnp.asarray(mem)))
    pal = np.asarray(JH._group_norm_tokens(
        p["norm_out"], pallas_attn.fused_cross_layer(
            p, jnp.asarray(q), jnp.asarray(mem), HEADS, interpret=True)))
    with torch.no_grad():
        pre = fused_attn.fused_cross_layer(m, torch.from_numpy(q),
                                           torch.from_numpy(mem), HEADS)
        got = TH._group_norm_tokens(m.norm_out, pre).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_kernel_and_per_op_port_layers_agree(cross):
    """The port's layer with ``kernels=True`` (plain layer tail on the CPU)
    equals its own per-op layer."""
    p, m = _layer_pair(15 + cross, cross)
    r = np.random.default_rng(17)
    q = torch.from_numpy(r.standard_normal((1, 60, D)).astype(np.float32))
    mem = torch.from_numpy(r.standard_normal((1, 90, D)).astype(np.float32))
    with torch.no_grad():
        if cross:
            a = TH._cross_layer_apply(m, q, mem, kernels=True)
            b = TH._cross_layer_apply(m, q, mem, kernels=False)
        else:
            a = TH._self_layer_apply(m, q, kernels=True)
            b = TH._self_layer_apply(m, q, kernels=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)


def test_supports():
    assert fused_attn.supports(512, 8, 2048)
    assert fused_attn.supports(128, 2, 256)
    assert not fused_attn.supports(512, 4, 2048)     # 128-wide heads
    assert not fused_attn.supports(512, 8, 2000)     # FF off the 64 grid
    assert not fused_attn.supports(1024, 16, 4096)   # beyond the LayerNorm registers


def _block_inputs(seed: int, b: int, l: int, s: int):
    r = np.random.default_rng(seed)
    n = lambda *sh, sc=1.0: (sc * r.standard_normal(sh)).astype(np.float32)  # noqa: E731
    return [n(b, l, D), n(b, s, D), n(b, s, D), n(b, l, D),
            n(D, D, sc=D ** -0.5), n(D, sc=0.1), n(D, sc=0.5)]


@pytest.mark.parametrize("l,s", [(100, 100), (100, 188), (188, 100), (1, 37)])
def test_plain_attn_block_matches_pallas_interpret(l, s):
    """Self (L = S) and cross forms, ragged against the 128-row tiles."""
    args = _block_inputs(l * 3 + s, 2, l, s)
    want = pallas_attn.attn_block(*(jnp.asarray(a) for a in args), HEADS,
                                  interpret=True)
    got = fused_attn.attn_block(*(torch.from_numpy(a) for a in args), HEADS)
    assert got.shape == (2, l, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_attn_block_cpu_wrapper_takes_the_plain_version_without_counting():
    args = [torch.from_numpy(a) for a in _block_inputs(5, 1, 30, 50)]
    before = fused_attn.attn_block.launches
    a = fused_attn.attn_block(*args, HEADS)
    b = fused_attn.attn_block_plain(*args, HEADS)
    assert fused_attn.attn_block.launches == before
    assert torch.equal(a, b)


def test_attn_block_refuses_a_device_without_a_kernel():
    args = [torch.from_numpy(a).to("meta") for a in _block_inputs(6, 1, 8, 8)]
    with pytest.raises(ValueError, match="no kernel"):
        fused_attn.attn_block(*args, HEADS)


@pytest.mark.parametrize("cross", [False, True])
def test_mha_residual_matches_jax(cross):
    """``mha_residual`` (projections + ``attn_block``) against the JAX
    ``pallas_attn.mha_residual`` in interpret mode and the JAX per-op
    ``_attn_residual``."""
    p, m = _layer_pair(21 + cross, cross)
    key = "cross_attn" if cross else "self_attn"
    r = np.random.default_rng(23)
    x = r.standard_normal((2, 70, D)).astype(np.float32)
    q_in = r.standard_normal((2, 70, D)).astype(np.float32)
    kv_in = r.standard_normal((2, 90, D)).astype(np.float32) if cross else q_in
    want = np.asarray(pallas_attn.mha_residual(
        p[key], p["gamma_1"], jnp.asarray(x), jnp.asarray(q_in),
        jnp.asarray(kv_in), HEADS, interpret=True))
    per_op = np.asarray(JH._attn_residual(p, key, jnp.asarray(x),
                                          jnp.asarray(q_in),
                                          jnp.asarray(kv_in)))
    with torch.no_grad():
        got = fused_attn.mha_residual(m.attn, m.gamma_1, torch.from_numpy(x),
                                      torch.from_numpy(q_in),
                                      torch.from_numpy(kv_in), HEADS).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, per_op, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_opt_in_layers_route_attention_through_the_block(cross, monkeypatch):
    """Under the opt-in selection a layer's attention goes through
    ``attn_block`` (``layer`` off), and the result equals the per-op layer;
    under the default selection ``layer_tail`` subsumes it."""
    from audio_to_sheet_music_tpu_torch.ops.select import DEFAULT, NONE, OPT_IN

    p, m = _layer_pair(25 + cross, cross)
    r = np.random.default_rng(27)
    q = torch.from_numpy(r.standard_normal((1, 60, D)).astype(np.float32))
    mem = torch.from_numpy(r.standard_normal((1, 90, D)).astype(np.float32))
    calls = []
    real = fused_attn.attn_block
    monkeypatch.setattr(fused_attn, "attn_block",
                        lambda *a: calls.append(1) or real(*a))

    def run(sel):
        with torch.no_grad():
            if cross:
                return TH._cross_layer_apply(m, q, mem, sel)
            return TH._self_layer_apply(m, q, sel)

    a = run(OPT_IN)
    assert len(calls) == 1
    b = run(NONE)
    run(DEFAULT)
    assert len(calls) == 1
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)


def test_supports_block_is_the_jax_test():
    for d, h in ((512, 8), (128, 2), (64, 1), (256, 3), (256, 64)):
        assert fused_attn.supports_block(d, h) == pallas_attn.supports(d, h)


# --- the flash launch's algorithm, modelled on the CPU -----------------------
# ``csrc/attn_common.cuh:flash_kernel`` cannot run here.  This model repeats
# its tiling and rounding points in torch on bf16 inputs; it must agree with
# ``attn_block_plain`` (which normalises before rounding the probabilities)
# within chip_smoke.py's LAYER_TOL, the tolerance the kernel is held to on
# the card.

LAYER_TOL = (4 * 2.0 ** -8, 2.0 ** -8)    # max and rms, in units of the ref's
KEY_TILE = 128                             # csrc/attn_common.cuh:KT
LOG2E = 1.4426950408889634


def _flash_model(q, k, v, num_heads: int) -> torch.Tensor:
    """Per head: 128-key tiles (zero rows past S, as TMA fills them), scores
    in f32 from bf16 operands, keys past S at -1e30, the online softmax in
    base 2 with the running max in scaled units and each probability
    ``2^(s · scale · log2 e - m)``, P rounded to bf16 unnormalised,
    O += P V in f32, one division by the f32 row sum at the end, the output
    rounded to bf16."""
    b, l, d = q.shape
    s = k.shape[1]
    dh = d // num_heads
    pad = -s % KEY_TILE
    kp = torch.cat([k, k.new_zeros(b, pad, d)], 1).float()
    vp = torch.cat([v, v.new_zeros(b, pad, d)], 1).float()
    heads = lambda t: t.reshape(b, -1, num_heads, dh).transpose(1, 2)  # noqa: E731
    qh, kh, vh = heads(q.float()), heads(kp), heads(vp)
    scale = LOG2E / math.sqrt(dh)
    m = torch.full((b, num_heads, l, 1), -math.inf)
    tot = torch.zeros((b, num_heads, l, 1))
    o = torch.zeros((b, num_heads, l, dh))
    for t0 in range(0, s + pad, KEY_TILE):
        sc = qh @ kh[:, :, t0:t0 + KEY_TILE].transpose(-1, -2)
        keys = torch.arange(t0, t0 + KEY_TILE)
        sc = torch.where(keys < s, sc, torch.tensor(-1e30))
        mnew = torch.maximum(m, sc.amax(-1, keepdim=True) * scale)
        alpha = torch.exp2(m - mnew)
        p = torch.exp2(sc * scale - mnew)
        tot = tot * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vh[:, :, t0:t0 + KEY_TILE]
        m = mnew
    return (o / tot).transpose(1, 2).reshape(b, l, d).to(torch.bfloat16)


@pytest.mark.parametrize("s", [1, 7, 777, 2072])
def test_flash_tiling_model_matches_plain_attn_block(s):
    """The kernel's tiling and rounding, then the out-projection as the
    GEMM launch computes it, against ``attn_block_plain`` in bf16."""
    args = [torch.from_numpy(a) for a in _block_inputs(s, 1, 70, s)]
    bf = [a.to(torch.bfloat16) for a in args[:5]] + [args[5], args[6]]
    q, k, v, x, wo, bo, gamma = bf
    want = fused_attn.attn_block_plain(*bf, HEADS).float()
    attn = _flash_model(q, k, v, HEADS)
    got = (x.float() + gamma * (fused_attn._mm(attn, wo, torch.bfloat16) + bo)
           ).to(torch.bfloat16).float()
    err = (got - want).abs()
    assert float(err.max()) <= LAYER_TOL[0] * float(want.abs().max())
    assert (float(err.pow(2).mean().sqrt())
            <= LAYER_TOL[1] * float(want.pow(2).mean().sqrt()))
    # the attention alone, against the plain attention's bf16 output
    ref = fused_attn.attention_plain(q, k, v, HEADS).float()
    aerr = (attn.float() - ref).abs()
    assert float(aerr.max()) <= LAYER_TOL[0] * float(ref.abs().max())
