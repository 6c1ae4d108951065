"""The ATHT head's decoder join (``ops/fused_norm.decoder_join`` over
``csrc/group_norm.cu``'s ``gn1_join``) and the decoders that call it.

On the CPU:

- ``decoder_join`` (the plain version on a CPU tensor) bit for bit the
  chain the decoders ran before (``nn.core.group_norm`` with GELU, the
  resizes, the scaled skip added), at the geometry of each freq and
  time layer at small widths, with and without a norm, with the skip's
  batch equal to x's and dividing it, in f32 and bf16;
- ``freq_decoder_apply`` and ``time_decoder_apply`` of the tiny model give
  the bytes the old loops gave;
- the /4 layers' taps are exactly (4i+1, 4i+2, 1/2);
- with gradients on, the decoders take the old chain (the join is never
  called) and their gradients are the old chain's;
- ``dec_join`` is among the launch counters and in ``/api/metrics``' text;
- the geometries the join does not take are refused.

On the card (marked ``cuda``: each test skips without one, decided in the
fixture; this file imports no JAX, so it runs there with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_dec_join.py``): the kernel against the plain version at
the songs group's eight layers, the stream block's and a whole-song
sweep's, in bf16 within one bf16 rounding of the f32 computation, and
against the bf16 chain; a captured graph's replay equal to the eager call
with its launch booked; the refusals.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu_torch.apps import serve_http
from audio_to_sheet_music_tpu_torch.infer import programs
from audio_to_sheet_music_tpu_torch.models import atht
from audio_to_sheet_music_tpu_torch.nn import core as L
from audio_to_sheet_music_tpu_torch.ops import fused_norm, select

SCALE = atht.SKIP_SCALE


def _norm(c: int, gen: torch.Generator, device="cpu") -> L.Norm:
    m = L.Norm(c)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=gen))
        m.bias.copy_(0.3 * torch.randn(c, generator=gen))
    return m.to(device)


def _tensors(y_shape, skip_shape, dtype, device="cpu", seed=0):
    """y with a mean off zero (the norm's centring matters), a skip of unit
    scale, a norm's affine near (1, 0)."""
    gen = torch.Generator().manual_seed(seed)
    y = 0.7 + 2.0 * torch.randn(y_shape, generator=gen)
    skip = torch.randn(skip_shape, generator=gen)
    return (y.to(device, dtype), skip.to(device, dtype),
            _norm(y_shape[1], gen, device))


def _old_skip_add(x, skip):
    """``x + skip * SKIP_SCALE``, the skip's batch dividing x's, as the
    decoders added it before the join."""
    b, b0 = x.shape[0], skip.shape[0]
    contrib = skip.to(x.dtype) * SCALE
    if b == b0:
        return x + contrib
    xr = x.reshape(b // b0, b0, *x.shape[1:])
    return (xr + contrib[None]).reshape(b, *x.shape[1:])


def _chain(y, norm, skip, size):
    """The decoders' join as they composed it before the kernel."""
    x = y
    if norm is not None:
        x = L.group_norm(norm, x, 1, act="gelu")
    if x.ndim == 4:
        if x.shape[2] != size:
            x = L.interpolate_bilinear(x, (size, x.shape[3]))
        s = L.interpolate_bilinear(skip[:, : x.shape[1]], x.shape[2:])
    else:
        if x.shape[2] != size:
            x = L.interpolate_linear(x, size)
        s = L.interpolate_linear(skip[:, : x.shape[1]], x.shape[2])
    return _old_skip_add(x, s)


def _join(y, norm, skip, size):
    affine = (None, None) if norm is None else (norm.weight, norm.bias)
    return fused_norm.decoder_join(y, *affine, skip, size, SCALE)


# each decoder layer's geometry at small widths: (y's rows a plane, skip's
# rows a plane, size, norm?, the axes after the resized one); the freq
# decoder's F takes T's lengths, so layers 1-3 decimate by 4
LAYERS = {
    "freq0": (32, 8, 37, True, (11,)),       # upsample 32 -> 37
    "freq1": (148, 32, 37, True, (11,)),     # exact /4; skip up
    "freq2": (148, 128, 37, True, (11,)),
    "freq3": (148, 512, 37, False, (11,)),   # no norm; skip down
    "time0": (44, 11, 43, True, ()),         # 44 -> 43; skip x4
    "time1": (172, 43, 171, True, ()),
    "time2": (684, 171, 683, True, ()),
    "time3": (2732, 683, 2732, False, ()),   # no resize of x
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,b0", [(4, 4), (4, 2)])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_plain_join_is_the_old_chain_bit_for_bit(layer, b, b0, dtype):
    a, a_skip, size, has_norm, rest = LAYERS[layer]
    y, skip, norm = _tensors((b, 3, a, *rest), (b0, 5, a_skip, *rest), dtype)
    norm = norm if has_norm else None
    got = _join(y, norm, skip, size)
    want = _chain(y, norm, skip, size)
    assert got.dtype == dtype and got.shape == (b, 3, size, *rest)
    assert torch.equal(got, want)


def _old_freq_decoder(p, x, skips, target_lengths):
    for i, layer in enumerate(p.layers):
        x = L.conv_transpose2d(layer.conv, x, stride=(4, 1), padding=(2, 0))
        if hasattr(layer, "norm"):
            x = L.group_norm(layer.norm, x, 1, act="gelu")
        if i < len(target_lengths) and x.shape[2] != target_lengths[i]:
            x = L.interpolate_bilinear(x, (target_lengths[i], x.shape[3]))
        if i < len(skips):
            skip = skips[i][:, : x.shape[1]]
            skip = L.interpolate_bilinear(skip, x.shape[2:])
            x = _old_skip_add(x, skip)
    return x


def _old_time_decoder(p, x, skips, target_lengths):
    for i, layer in enumerate(p.layers):
        x = L.conv_transpose1d(layer.conv, x, stride=4, padding=2)
        if hasattr(layer, "norm"):
            x = L.group_norm(layer.norm, x, 1, act="gelu")
        if i < len(target_lengths) and x.shape[2] != target_lengths[i]:
            x = L.interpolate_linear(x, target_lengths[i])
        if i < len(skips):
            skip = skips[i][:, : x.shape[1]]
            skip = L.interpolate_linear(skip, x.shape[2])
            x = _old_skip_add(x, skip)
    return x


@pytest.fixture(scope="module")
def tiny():
    return atht.init_tiny(0)


@pytest.fixture(scope="module")
def encoded(tiny):
    """The tiny encoder's state of two 1 s chunks, in f32 and in bf16."""
    wav = torch.from_numpy(0.1 * np.random.default_rng(0).standard_normal(
        (2, 2, 44100)).astype(np.float32))
    with torch.inference_mode():
        return {dt: atht.encode_mixture(tiny, wav, dt, "none")
                for dt in (torch.float32, torch.bfloat16)}


def _decoder_args(enc, branch, stems):
    x = enc["x_enc"] if branch == "freq" else enc["xt_enc"]
    skips = enc["saved"] if branch == "freq" else enc["saved_t"]
    lengths = enc["lengths"] if branch == "freq" else enc["lengths_t"]
    # the multi-stem head tiles x; the skips stay at the encoder's batch
    return torch.cat([x] * stems), skips[::-1], lengths[::-1]


@pytest.mark.parametrize("stems", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("branch", ["freq", "time"])
def test_decoders_give_the_bytes_they_gave(tiny, encoded, branch, dtype,
                                           stems):
    p = getattr(tiny.head, f"{branch}_decoder")
    new = {"freq": atht.freq_decoder_apply,
           "time": atht.time_decoder_apply}[branch]
    old = {"freq": _old_freq_decoder, "time": _old_time_decoder}[branch]
    args = _decoder_args(encoded[dtype], branch, stems)
    with torch.inference_mode():
        got = new(p, *args)
        want = old(p, *args)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("size", [8, 37, 259, 345])
def test_the_quarter_layers_taps_are_4i_plus_1_and_2_at_one_half(size):
    i0, i1, frac = fused_norm.lerp_taps(4 * size, size, torch.device("cpu"))
    i = torch.arange(size)
    assert torch.equal(i0, 4 * i + 1) and torch.equal(i1, 4 * i + 2)
    assert torch.equal(frac, torch.full((size,), 0.5))


@pytest.mark.parametrize("rows_y,rows_skip,size,width", [
    (1036, 32, 259, 259), (32, 8, 259, 259), (1036, 512, 259, 259),
    (4136, 1034, 4135, 1), (264600, 66150, 264600, 1)])
def test_the_kernels_tap_records_are_the_taps_times_the_row(rows_y, rows_skip,
                                                            size, width):
    """``join_table``: each output row's first elements of y's two taps and
    the skip's two (``lerp_taps``, or the row itself where the sizes
    agree), and the second taps' weights."""
    cpu = torch.device("cpu")
    tab, frac = fused_norm.join_table(rows_y, rows_skip, size, width, cpu)
    assert tab.dtype == torch.int32 and tab.shape == (size, 4)
    assert frac.dtype == torch.float32 and frac.shape == (size, 2)
    for cols, n in (((0, 1), rows_y), ((2, 3), rows_skip)):
        if n == size:
            want = (torch.arange(size), torch.arange(size),
                    torch.zeros(size))
        else:
            want = fused_norm.lerp_taps(n, size, cpu)
        assert torch.equal(tab[:, cols[0]].long(), want[0] * width)
        assert torch.equal(tab[:, cols[1]].long(), want[1] * width)
        assert torch.equal(frac[:, cols[0] // 2], want[2])


@pytest.mark.parametrize("branch", ["freq", "time"])
def test_training_takes_the_old_chain_and_its_gradients(tiny, encoded,
                                                        branch, monkeypatch):
    """With gradients on, the decoders never call the join (it has no
    backward), and their output and gradients are the old chain's."""
    def refuse(*args, **kwargs):
        raise AssertionError("the join was called under autograd")

    p = getattr(tiny.head, f"{branch}_decoder")
    new = {"freq": atht.freq_decoder_apply,
           "time": atht.time_decoder_apply}[branch]
    old = {"freq": _old_freq_decoder, "time": _old_time_decoder}[branch]
    x, skips, lengths = _decoder_args(encoded[torch.float32], branch, 2)
    x, skips = x.clone(), [s.clone() for s in skips]
    params = list(p.parameters())
    monkeypatch.setattr(fused_norm, "decoder_join", refuse)
    try:
        for t in params:
            t.requires_grad_(True)
        outs, grads = [], []
        for fn in (new, old):
            y = fn(p, x, skips, lengths)
            outs.append(y)
            grads.append(torch.autograd.grad(y.square().mean(), params))
    finally:
        for t in params:
            t.requires_grad_(False)
    assert torch.equal(outs[0], outs[1])
    for g_new, g_old in zip(*grads):
        assert torch.equal(g_new, g_old)


def test_dec_join_is_counted_and_exported():
    assert "dec_join" in select.launch_counts()
    before = fused_norm.decoder_join.launches
    y, skip, norm = _tensors((2, 3, 16, 5), (2, 4, 4, 5), torch.float32)
    _join(y, norm, skip, 4)
    assert fused_norm.decoder_join.launches == before   # the CPU launches none
    text = serve_http.ServiceMetrics().prometheus()
    assert "# TYPE atsm_launches_dec_join_total counter" in text


@pytest.mark.parametrize("y_shape,skip_shape,size,affine", [
    ((4, 3, 8), (3, 3, 8), 8, True),        # the skip's batch does not divide
    ((4, 3, 8), (2, 2, 8), 8, True),        # fewer skip channels than y's
    ((4, 3, 8, 5), (2, 3, 8, 6), 8, True),  # the axes after the resized one
    ((4, 3, 8), (2, 3, 8, 1), 8, True),     # ranks differ
    ((4, 3), (2, 3), 2, True),              # no resized axis
    ((4, 3, 8), (2, 3, 8), 0, True),        # nothing to resize to
    ((4, 3, 8), (2, 3, 8), 8, "half"),      # a weight without a bias
    ((4, 3, 8), (2, 3, 8), 8, "wide"),      # an affine of other channels
])
def test_geometries_the_join_does_not_take_are_refused(y_shape, skip_shape,
                                                       size, affine):
    y, skip, norm = _tensors(y_shape, skip_shape, torch.float32)
    w, b = norm.weight, norm.bias
    if affine == "half":
        b = None
    elif affine == "wide":
        w, b = torch.ones(y_shape[1] + 1), torch.zeros(y_shape[1] + 1)
    with pytest.raises(ValueError):
        fused_norm.decoder_join(y, w, b, skip, size, SCALE)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _songs(b, b0):
    """The head's eight joins of ``b`` rows, the skips at batch ``b0``:
    (name, y shape, skip shape, size, norm?)."""
    return [
        ("freq0", (b, 192, 32, 259), (b0, 384, 8, 259), 259, True),
        ("freq1", (b, 96, 1036, 259), (b0, 192, 32, 259), 259, True),
        ("freq2", (b, 48, 1036, 259), (b0, 96, 128, 259), 259, True),
        ("freq3", (b, 4, 1036, 259), (b0, 48, 512, 259), 259, False),
        ("time0", (b, 192, 4136), (b0, 384, 1034), 4135, True),
        ("time1", (b, 96, 16540), (b0, 192, 4135), 16538, True),
        ("time2", (b, 48, 66152), (b0, 96, 16538), 66150, True),
        ("time3", (b, 4, 264600), (b0, 48, 66150), 264600, False),
    ]


# the songs group (4 chunks x 4 stems), a stream block of 8 chunks (one
# stem), a whole-song sweep of 32 chunks (one stem: the largest layers)
CARD_CASES = ([("songs",) + c for c in _songs(16, 4)]
              + [("stream",) + c for c in _songs(8, 8)
                 if c[0] in ("freq0", "freq1", "time2")]
              + [("sweep",) + c for c in _songs(32, 32)
                 if c[0] in ("freq1", "time2")])
# against the bf16 chain: it rounds to bf16 after the norm, the GELU, each
# resize, the skip's scaling and the add (at most half a step, 2^-8 of the
# value, each), the kernel once
CHAIN_TOL = (8e-3, 4e-3)   # (max err / max|ref|, rms err / rms ref)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _card_tensors(y_shape, skip_shape, card, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    y = (0.7 + 2.0 * torch.randn(y_shape, generator=gen, device=card)
         ).to(torch.bfloat16)
    skip = torch.randn(skip_shape, generator=gen, device=card).to(
        torch.bfloat16)
    return y, skip, _norm(y_shape[1], torch.Generator().manual_seed(seed),
                          card)


@pytest.mark.cuda
@pytest.mark.parametrize("path,layer,y_shape,skip_shape,size,has_norm",
                         CARD_CASES)
def test_kernel_within_one_rounding_at_the_main_path_shapes(
        card, path, layer, y_shape, skip_shape, size, has_norm):
    """Within one bf16 rounding of the same algebra in f32 (the plain
    version on f32 copies of the operands): |err| <= 2^-8 |ref| (bf16 keeps
    8 significant bits, so half a step is at most 2^-8 of the value) +
    1e-5 max|ref| (the f32 statistics and sums, taken in another order,
    where the sum cancels); and against the bf16 chain within
    ``CHAIN_TOL``."""
    y, skip, norm = _card_tensors(y_shape, skip_shape, card)
    norm = norm if has_norm else None
    affine = (None, None) if norm is None else (norm.weight, norm.bias)
    with torch.inference_mode():
        got = fused_norm.decoder_join(y, *affine, skip, size, SCALE)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert got.shape == (y_shape[0], y_shape[1], size, *y_shape[3:])
        g = got.float()
        assert torch.isfinite(g).all()
        ref = fused_norm.decoder_join_plain(y.float(), *affine, skip.float(),
                                            size, SCALE)
        err = (g - ref).abs()
        limit = 2.0 ** -8 * ref.abs() + 1e-5 * float(ref.abs().max())
        worst = float((err - limit).max())
        assert worst <= 0, (f"{path} {layer}: max err {float(err.max()):.4g}"
                            f", over the limit by {worst:.4g}")
        del ref, err, limit
        chain = fused_norm.decoder_join_plain(y, *affine, skip, size,
                                              SCALE).float()
        err = (g - chain).abs()
        max_rel, rms_rel = CHAIN_TOL
        msg = (f"{path} {layer}: max err {float(err.max()):.4g} vs max|ref| "
               f"{float(chain.abs().max()):.4g}, rms err "
               f"{float(err.pow(2).mean().sqrt()):.4g} vs rms "
               f"{float(chain.pow(2).mean().sqrt()):.4g}")
        assert float(err.max()) <= max_rel * float(chain.abs().max()), msg
        assert (float(err.pow(2).mean().sqrt())
                <= rms_rel * float(chain.pow(2).mean().sqrt())), msg


@pytest.mark.cuda
def test_a_replay_equals_the_eager_call_and_books_its_launch(card):
    (_, y_shape, skip_shape, size, _), = [
        c for c in _songs(16, 4) if c[0] == "freq1"]
    y, skip, norm = _card_tensors(y_shape, skip_shape, card, seed=1)

    def body(t, s):
        return fused_norm.decoder_join(t, norm.weight, norm.bias, s, size,
                                       SCALE)

    with torch.inference_mode():
        eager = body(y, skip)
        again = body(y, skip)
        assert torch.equal(eager, again)
        prog = programs.Program(body, [y, skip], card)
        assert prog.launches == {"dec_join": 1}
        before = select.launch_counts()["dec_join"]
        out = prog(y, skip)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert select.launch_counts()["dec_join"] - before == 1


@pytest.mark.cuda
def test_the_card_refuses_what_the_kernel_does_not_take(card):
    y, skip, norm = _card_tensors((4, 3, 16, 5), (2, 4, 4, 5), card)
    w, b = norm.weight, norm.bias
    with torch.inference_mode():
        with pytest.raises(ValueError):        # the skip's batch
            fused_norm.decoder_join(y, w, b, skip[:1].expand(3, -1, -1, -1),
                                    4, SCALE)
        with pytest.raises(TypeError):         # dtypes differ
            fused_norm.decoder_join(y, w, b, skip.float(), 4, SCALE)
        with pytest.raises(TypeError):         # half
            fused_norm.decoder_join(y.half(), w, b, skip.half(), 4, SCALE)
        with pytest.raises(ValueError):        # the skip on another device
            fused_norm.decoder_join(y, w, b, skip.cpu(), 4, SCALE)
    with pytest.raises(RuntimeError):          # autograd would record
        fused_norm.decoder_join(y.float().requires_grad_(), w, b,
                                skip.float(), 4, SCALE)
