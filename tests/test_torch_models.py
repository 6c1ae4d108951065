"""The port's models against the JAX package on shared weights (f32, CPU).

One seeded JAX ``atht.init_tiny`` param tree is loaded into the port's
``init_tiny`` model through ``convert.jax_params``; the same numpy-seeded
inputs go through both.  Tolerances are the JAX goldens' own
(``tests/test_htdemucs_golden.py``): 1e-5 for one layer, 2e-5 for the
transformer, 1e-3 for a whole tower.  The head's output is held to the
whole-tower 1e-3 when each side runs its own encoder: the head divides by
the signed CaC plane + 1e-8, which multiplies the STFT's last-bit
differences at bins where that plane is near 1e-8.  Fed the same encoder
state, the head holds to 2e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.convert.torch_import import export_torch_names
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.models import htdemucs as JH
from audio_to_sheet_music_tpu.ops import dsp as JD
from audio_to_sheet_music_tpu.train.checkpoint import load_params_npz
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.models import htdemucs as TH
from audio_to_sheet_music_tpu_torch.ops import dsp as TD
from audio_to_sheet_music_tpu_torch.nn import prng

LAYER, TRANSFORMER, TOWER = 1e-5, 2e-5, 1e-3


@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    return params, model


@pytest.fixture(scope="module")
def wav():
    return (0.1 * np.random.default_rng(0).standard_normal((2, 2, 11025))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def encoded(pair, wav):
    params, model = pair
    with torch.no_grad():
        enc_t = TA.encode_mixture(model, torch.from_numpy(wav))
    return JA.encode_mixture(params, jnp.asarray(wav)), enc_t


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_bridge_names_equal_jax_export(pair):
    params, model = pair
    assert set(model.state_dict()) == set(export_torch_names(params))


def test_spec_ispec_and_normalize(wav):
    z = TD.spec(torch.from_numpy(wav))
    zj = JD.spec(jnp.asarray(wav))
    _close(torch.view_as_real(z), np.stack([np.real(zj), np.imag(zj)], -1),
           LAYER)
    _close(TD.ispec(z, 11025), JD.ispec(zj, 11025), LAYER)
    got = TH.normalize_inputs(torch.from_numpy(wav))
    want = JH.normalize_inputs(jnp.asarray(wav))
    for g, w in list(zip(got, want))[1:]:          # mag, x, xt and the stats
        _close(g, w, LAYER)


@pytest.mark.parametrize("freq", [True, False])
def test_encoder_layers(pair, freq):
    params, model = pair
    r = np.random.default_rng(3)
    shape = (2, 4, 256, 11) if freq else (2, 2, 1001)   # odd T pads to stride
    x = r.standard_normal(shape).astype(np.float32)
    key = "encoder" if freq else "tencoder"
    for idx in (0, 1):
        p, m = params["htdemucs"][key][idx], model.htdemucs.__getattr__(key)[idx]
        want = JH.henc_layer_apply(p, jnp.asarray(x), freq=freq)
        with torch.no_grad():
            got = TH.henc_layer_apply(m, torch.from_numpy(x))
        _close(got, want, LAYER)
        x = np.array(want)


def test_crosstransformer(pair):
    params, model = pair
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 64, 8, 11)).astype(np.float32)
    xt = r.standard_normal((2, 64, 44)).astype(np.float32)
    want = JH.crosstransformer_apply(params["htdemucs"]["crosstransformer"],
                                     jnp.asarray(x), jnp.asarray(xt))
    with torch.no_grad():
        got = TH.crosstransformer_apply(model.htdemucs.crosstransformer,
                                        torch.from_numpy(x),
                                        torch.from_numpy(xt))
    for g, w in zip(got, want):
        _close(g, w, TRANSFORMER)


def test_encode_mixture(encoded):
    enc_j, enc_t = encoded
    for k in ("z", "mag"):
        want = np.asarray(enc_j[k])
        got = enc_t[k]
        if got.is_complex():
            got, want = torch.view_as_real(got), np.stack(
                [want.real, want.imag], -1)
        _close(got, want, LAYER)
    for k in ("meant", "stdt"):
        _close(enc_t[k], enc_j[k], LAYER)
    _close(enc_t["x_enc"], enc_j["x_enc"], TRANSFORMER)
    _close(enc_t["xt_enc"], enc_j["xt_enc"], TRANSFORMER)
    for k in ("saved", "saved_t"):
        for g, w in zip(enc_t[k], enc_j[k]):
            _close(g, w, LAYER)
    assert enc_t["lengths"] == enc_j["lengths"]
    assert enc_t["lengths_t"] == enc_j["lengths_t"]


def test_apply_head_multi(pair, encoded):
    params, model = pair
    enc_j, enc_t = encoded
    emb = (np.random.default_rng(5).standard_normal((3, 512)) / np.sqrt(512)
           ).astype(np.float32)
    want = np.asarray(JA.apply_head_multi(params, enc_j, jnp.asarray(emb)))
    with torch.no_grad():
        got = TA.apply_head_multi(model, enc_t, torch.from_numpy(emb))
    assert got.shape == want.shape == (3, 2, 2, 11025)
    _close(got, want, TOWER)


def test_apply_head_on_the_same_encoder_state(pair, encoded):
    """The head alone, fed the JAX encoder state: no STFT rounding enters
    through the signed-plane divide, so it holds to 2e-5."""
    params, model = pair
    enc_j, _ = encoded
    enc = {k: (torch.from_numpy(np.array(v)) if hasattr(v, "shape") else v)
           for k, v in enc_j.items() if k not in ("saved", "saved_t")}
    for k in ("saved", "saved_t"):
        enc[k] = [torch.from_numpy(np.array(a)) for a in enc_j[k]]
    emb = (np.random.default_rng(7).standard_normal((2, 512)) / np.sqrt(512)
           ).astype(np.float32)
    want = JA.apply_head(params, enc_j, jnp.asarray(emb))
    with torch.no_grad():
        got = TA.apply_head(model, enc, torch.from_numpy(emb))
    _close(got, want, TRANSFORMER)


def test_forward_with_text_emb(pair, wav):
    params, model = pair
    emb = (np.random.default_rng(6).standard_normal((2, 512)) / np.sqrt(512)
           ).astype(np.float32)
    want = JA.forward_with_text_emb(params, jnp.asarray(wav), jnp.asarray(emb))
    with torch.no_grad():
        got = TA.forward_with_text_emb(model, torch.from_numpy(wav),
                                       torch.from_numpy(emb))
    _close(got, want, TOWER)


@pytest.mark.parametrize("normalize", [False, True])
def test_encode_text(pair, normalize):
    params, model = pair
    ids = np.array([[0, 5, 7, 2, 1, 1], [0, 9, 11, 13, 8, 2]], np.int32)
    mask = (ids != 1).astype(np.int32)
    want = JA.encode_text(params, jnp.asarray(ids), jnp.asarray(mask),
                          normalize)
    with torch.no_grad():
        got = TA.encode_text(model, torch.from_numpy(ids),
                             torch.from_numpy(mask), normalize)
    _close(got, want, TOWER)


def test_trained_head_graft_matches_jax_loader():
    """``graft_head`` loads ``artifacts/trained_head.npz`` into exactly the
    arrays the JAX ``load_params_npz`` gives for ``params["head"]``."""
    template = jax.eval_shape(JA.head_init, jax.random.PRNGKey(0))
    head_params = jax.tree.map(np.asarray,
                               load_params_npz(TA.DEFAULT_HEAD, template))
    want = {k[len("head."):]: v for k, v in
            export_torch_names({"head": head_params}).items()}
    head = TA.Head(key=None)
    model = TA.AudioTextHTDemucs(TH.HTDemucs(channels=(8, 16, 24, 32),
                                             bottom_channels=64, t_layers=2),
                                 torch.nn.Module(), head)
    TA.graft_head(model)
    got = head.state_dict()
    assert set(got) == set(want) and len(got) == 50
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k])


def test_resize_taps_made_in_inference_mode_serve_autograd():
    """The linear resize's taps are kept per geometry and device; a sweep
    under inference mode may make them, and a training step's backward
    then goes through them."""
    from audio_to_sheet_music_tpu_torch.nn import core as L

    with torch.inference_mode():
        first = L.interpolate_linear(torch.ones(1, 1, 37), 41)
    x = torch.randn(1, 2, 37, requires_grad=True)
    L.interpolate_linear(x, 41).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    torch.testing.assert_close(first, torch.ones(1, 1, 41))


@pytest.mark.parametrize("b,n_fft,hop,frames,length", [
    (3, 4096, 1024, 20, 16000), (2, 256, 64, 9, 500),
    (4, 4096, 1024, 15, 11025 + 3 * 1024)])
def test_istft_is_torch_istft_bit_for_bit(b, n_fft, hop, frames, length):
    """``dsp.istft`` is ``torch.istft`` without its host-side envelope
    check: the same values and gradients, bit for bit."""
    torch.manual_seed(0)
    z = torch.randn(b, n_fft // 2 + 1, frames, dtype=torch.complex64,
                    requires_grad=True)
    g = torch.randn(b, length)
    got = TD.istft(z, length, n_fft, hop)
    (got * g).sum().backward()
    grad, z.grad = z.grad.clone(), None
    want = torch.istft(z, n_fft, hop, window=torch.hann_window(n_fft),
                       win_length=n_fft, center=True, normalized=True,
                       length=length)
    (want * g).sum().backward()
    assert torch.equal(got, want) and torch.equal(grad, z.grad)


@pytest.mark.parametrize("dim,ff,fused", [(64, 256, True), (96, 384, False),
                                          (128, 200, False)])
def test_layer_selection_routes_by_the_kernels_widths(monkeypatch, dim, ff,
                                                      fused):
    """Under the ``layer`` selection a transformer layer goes to
    ``layer_tail`` only at widths the kernel takes (64-wide heads, D and FF
    in 64-column tiles), as the JAX ``_use_pallas_layer`` routes by its
    kernel's ``supports_layer``; other widths run per op."""
    from audio_to_sheet_music_tpu_torch.ops import fused_attn

    calls = []

    def spy(kind):
        real = getattr(fused_attn, kind)
        monkeypatch.setattr(fused_attn, kind,
                            lambda *a: calls.append(kind) or real(*a))

    spy("fused_self_layer")
    spy("fused_cross_layer")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 5, dim), generator=g)
    mem = torch.randn((1, 7, dim), generator=g)
    k1, k2 = prng.split(prng.PRNGKey(0))
    with torch.inference_mode():
        TH._self_layer_apply(TH.TransformerLayer(dim, False, ff, k1), x,
                             "default")
        TH._cross_layer_apply(TH.TransformerLayer(dim, True, ff, k2), x, mem,
                              "default")
    assert calls == (["fused_self_layer", "fused_cross_layer"] if fused
                     else [])
