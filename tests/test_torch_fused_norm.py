"""The GroupNorm kernel pair (``ops/fused_norm.py`` over
``csrc/group_norm.cu``) and ``nn.core.group_norm``, which routes every norm
of the model to it on the card.

On the CPU:

- ``group_norm_plain`` against ``F.group_norm`` (+ ``F.gelu`` / ``F.glu``)
  in f32 at 1e-5, over ``(B, C, T)``, ``(B, C, F, T)`` and the token form
  ``(B, L, C)``, one group and several, rows cut into 1, 2 and 7 slices
  (the last one ragged) and the partition the card would take;
- the token form, normalised in place, against the transposed form the
  model used before;
- ``nn.core.group_norm`` on a CPU tensor, bit for bit the expression it
  was (``F.group_norm`` on f32, rounded to x's dtype, then the activation);
- the partition, the refusals, and ``GroupNormFunction``'s backward
  (PyTorch's GroupNorm backward with the forward's statistics) against
  ``F.group_norm``'s gradients.

On the card (marked ``cuda``: each test skips without one, decided in the
fixture; this file imports no JAX, so it runs there with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_fused_norm.py``): the kernel pair against the plain
version at the main path's four shapes in bf16 and f32 (a bf16 output
step: both round an f32 value once; f32: the statistics' summation order),
two calls bitwise equal, a captured graph's replay equal to the eager
call with its launches booked, the gradients through
``GroupNormFunction`` against ``F.group_norm``'s, and the refusals.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from audio_to_sheet_music_tpu_torch.infer import programs
from audio_to_sheet_music_tpu_torch.nn import core as L
from audio_to_sheet_music_tpu_torch.ops import fused_norm, select

TOL = 1e-5


def _inputs(shape, c, seed=0, dtype=torch.float32, device="cpu"):
    """x with a mean off zero (so the statistics' centring matters), and
    an affine near (1, 0)."""
    g = torch.Generator().manual_seed(seed)
    x = 0.7 + 2.0 * torch.randn(shape, generator=g)
    w = 1.0 + 0.2 * torch.randn(c, generator=g)
    b = 0.3 * torch.randn(c, generator=g)
    return (x.to(device, dtype), w.to(device), b.to(device))


def _reference(x, w, b, groups, act, layout, eps=fused_norm.EPS):
    """``F.group_norm`` in f32, through transposes for the token form."""
    tokens = layout == "tokens"
    xc = x.float().transpose(1, 2) if tokens else x.float()
    y = F.group_norm(xc, groups, w.float(), b.float(), eps)
    y = y.transpose(1, 2) if tokens else y
    if act == "gelu":
        return F.gelu(y)
    if act == "glu":
        return F.glu(y, dim=1)
    return y


def _channels(shape, layout):
    return shape[-1] if layout == "tokens" else shape[1]


# (shape, groups, act, layout): every layout with every activation it takes
CASES = [
    ((3, 8, 50), 1, "none", "channels"),
    ((3, 8, 50), 1, "gelu", "channels"),
    ((3, 8, 50), 1, "glu", "channels"),
    ((2, 12, 77), 3, "gelu", "channels"),
    ((2, 12, 77), 4, "glu", "channels"),
    ((2, 6, 9, 31), 1, "none", "channels"),
    ((2, 6, 9, 31), 1, "gelu", "channels"),
    ((2, 6, 9, 31), 1, "glu", "channels"),
    ((2, 8, 5, 19), 2, "none", "channels"),
    ((3, 40, 24), 1, "none", "tokens"),
    ((3, 40, 24), 1, "gelu", "tokens"),
]


@pytest.mark.parametrize("splits", [1, 2, 7, None])
@pytest.mark.parametrize("shape,groups,act,layout", CASES)
def test_plain_matches_f_group_norm(shape, groups, act, layout, splits):
    x, w, b = _inputs(shape, _channels(shape, layout))
    got = fused_norm.group_norm_plain(x, w, b, groups, act=act,
                                      layout=layout, splits=splits)
    want = _reference(x, w, b, groups, act, layout)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,groups,layout", [
    ((3, 8, 50), 1, "channels"), ((2, 12, 77), 3, "channels"),
    ((2, 6, 9, 31), 1, "channels"), ((3, 40, 24), 1, "tokens")])
def test_seven_splits_leave_a_ragged_last_slice(shape, groups, layout):
    rows, n, _, _ = fused_norm.geometry(shape, groups, "none", layout)
    splits, chunk = fused_norm.cut(n, 7)
    assert splits > 1 and 0 < n - (splits - 1) * chunk < chunk


@pytest.mark.parametrize("shape,act", [((2, 37, 512), "none"),
                                       ((4, 21, 16), "none"),
                                       ((4, 21, 16), "gelu"),
                                       ((1, 300, 8), "none")])
def test_token_form_equals_the_transposed_form(shape, act):
    """The token stream normalised in place equals the form the model
    used before: GroupNorm over (B, C, L) between two transposes."""
    x, w, b = _inputs(shape, shape[-1], seed=1)
    got = fused_norm.group_norm_plain(x, w, b, 1, act=act, layout="tokens")
    old = F.group_norm(x.transpose(1, 2), 1, w, b, fused_norm.EPS)
    old = old.transpose(1, 2)
    old = F.gelu(old) if act == "gelu" else old
    torch.testing.assert_close(got, old, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,act,layout", [
    ((2, 8, 40), "none", "channels"), ((2, 8, 40), "gelu", "channels"),
    ((2, 8, 40), "glu", "channels"), ((2, 6, 5, 11), "gelu", "channels"),
    ((2, 30, 16), "none", "tokens")])
def test_core_group_norm_on_the_cpu_is_what_it_was(shape, act, layout,
                                                   dtype):
    x, w, b = _inputs(shape, _channels(shape, layout), seed=2, dtype=dtype)
    m = L.Norm(w.shape[0])
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
    got = L.group_norm(m, x, 1, act=act, layout=layout)
    tokens = layout == "tokens"
    xc = x.transpose(1, 2) if tokens else x
    old = F.group_norm(xc.float(), 1, m.weight.float(), m.bias.float(),
                       1e-5).to(x.dtype)
    old = old.transpose(1, 2) if tokens else old
    old = (L.gelu(old) if act == "gelu" else L.glu(old, dim=1)
           if act == "glu" else old)
    assert got.dtype == dtype and torch.equal(got, old)


@pytest.mark.parametrize("segments,length,sms", [
    (16, 96 * 1036 * 259, 132), (4, 96 * 66150, 132), (4, 2072 * 512, 132),
    (2048, 6 * 259, 132), (3, 1000, 132), (1, 8, 1)])
def test_partition_covers_each_row_in_aligned_chunks(segments, length, sms):
    blocks, chunk = fused_norm.partition(segments, length, sms)
    assert chunk % fused_norm.ALIGN == 0
    assert (blocks - 1) * chunk < length <= blocks * chunk
    if blocks > 1:
        assert chunk >= fused_norm.MIN_CHUNK
    if segments >= sms * fused_norm.BLOCKS_PER_SM:
        assert blocks == 1
    elif length >= sms * fused_norm.BLOCKS_PER_SM * fused_norm.MIN_CHUNK:
        # a long row fills the card: several blocks an SM
        assert segments * blocks >= sms * fused_norm.BLOCKS_PER_SM


@pytest.mark.parametrize("shape,groups,act,layout", [
    ((2, 10, 4), 1, "glu", "tokens"), ((2, 10, 4), 2, "none", "tokens"),
    ((2, 7, 4), 1, "glu", "channels"), ((2, 12, 4), 3, "glu", "channels"),
    ((2, 10, 4), 3, "none", "channels"), ((2, 10, 4), 1, "relu", "channels"),
    ((2, 10, 4), 1, "none", "nhwc"), ((2, 10, 4, 3), 1, "none", "tokens")])
def test_shapes_the_kernel_does_not_take_are_refused(shape, groups, act,
                                                     layout):
    x, w, b = _inputs(shape, _channels(shape, layout))
    with pytest.raises(ValueError):
        fused_norm.group_norm(x, w, b, groups, act=act, layout=layout)
    m = L.Norm(w.shape[0])
    with pytest.raises(ValueError):
        L.group_norm(m, x, groups, act=act, layout=layout)


@pytest.mark.parametrize("shape,groups,layout", [
    ((3, 8, 50), 1, "channels"), ((2, 12, 7, 11), 3, "channels"),
    ((3, 40, 24), 1, "tokens")])
def test_function_gradients_match_f_group_norm(shape, groups, layout):
    """``GroupNormFunction``'s backward (the CPU forward is the plain
    version) against autograd through ``F.group_norm``."""
    x, w, b = _inputs(shape, _channels(shape, layout), seed=3)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(4))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = fused_norm.GroupNormFunction.apply(*leaves, groups, fused_norm.EPS,
                                           layout)
    got = torch.autograd.grad(y, leaves, g)
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(
        _reference(*ref, groups, "none", layout), ref, g)
    torch.testing.assert_close(y, _reference(x, w, b, groups, "none", layout),
                               rtol=TOL, atol=TOL)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)


def test_the_cpu_wrapper_launches_nothing_and_is_counted_by_name():
    assert "group_norm" in select.launch_counts()
    before = fused_norm.group_norm.launches
    x, w, b = _inputs((2, 8, 30), 8)
    fused_norm.group_norm(x, w, b, 1, act="gelu")
    assert fused_norm.group_norm.launches == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# the main path's shapes: the freq decoder's widest norm, the time DConv's
# widest GLU, a transformer norm_out's token stream, the freq DConv's
# narrowest hidden norm (folded rows)
MAIN_PATH = [((16, 96, 1036, 259), "gelu", "channels"),
             ((4, 96, 66150), "glu", "channels"),
             ((4, 2072, 512), "none", "tokens"),
             ((2048, 6, 259), "gelu", "channels")]
CARD_TOL = {torch.bfloat16: (8e-3, 2e-3), torch.float32: (1e-5, 1e-5)}
# gradients: two bf16 steps (the forward's rounding moves GELU's slope too);
# f32 sums over millions of elements in the backward
GRAD_TOL = {torch.bfloat16: (1.6e-2, 4e-3), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _close(got, want, dtype, tol=CARD_TOL):
    max_rel, rms_rel = tol[dtype]
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    msg = (f"max err {float(err.max()):.4g} vs max|ref| "
           f"{float(w.abs().max()):.4g}, rms err "
           f"{float(err.pow(2).mean().sqrt()):.4g}")
    assert float(err.max()) <= max_rel * float(w.abs().max()), msg
    assert (float(err.pow(2).mean().sqrt())
            <= rms_rel * float(w.pow(2).mean().sqrt())), msg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,act,layout", MAIN_PATH)
def test_kernel_matches_plain_at_the_main_path_shapes(card, shape, act,
                                                      layout, dtype):
    x, w, b = _inputs(shape, _channels(shape, layout), dtype=dtype,
                      device=card)
    with torch.inference_mode():
        got = fused_norm.group_norm(x, w, b, 1, act=act, layout=layout)
        torch.cuda.synchronize()
        want = fused_norm.group_norm_plain(x, w, b, 1, act=act, layout=layout)
    assert got.dtype == dtype and got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,act", [
    ((3, 12, 5, 1001), 3, "gelu"), ((5, 8, 4, 333), 4, "glu"),
    ((2, 10, 9001), 1, "glu"), ((7, 6, 259), 1, "none")])
def test_kernel_matches_plain_over_groups_and_ragged_rows(card, shape, groups,
                                                         act):
    """Several groups, GLU over group rows, and rows whose length is no
    multiple of a 16-byte vector (the scalar head and tail)."""
    x, w, b = _inputs(shape, shape[1], seed=5, dtype=torch.bfloat16,
                      device=card)
    with torch.inference_mode():
        got = fused_norm.group_norm(x, w, b, groups, act=act)
        want = fused_norm.group_norm_plain(x, w, b, groups, act=act)
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_two_calls_are_bitwise_equal(card):
    x, w, b = _inputs((4, 96, 66150), 96, dtype=torch.bfloat16, device=card)
    with torch.inference_mode():
        first = fused_norm.group_norm(x, w, b, 1, act="glu")
        second = fused_norm.group_norm(x, w, b, 1, act="glu")
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_a_misaligned_view_is_normalised(card):
    x, w, b = _inputs((1 + 3 * 8 * 501,), 8, dtype=torch.bfloat16,
                      device=card)
    view = x[1:].view(3, 8, 501)
    assert view.data_ptr() % 16
    with torch.inference_mode():
        got = fused_norm.group_norm(view, w, b, 1, act="gelu")
        want = fused_norm.group_norm_plain(view, w, b, 1, act="gelu")
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_a_replay_equals_the_eager_call_and_books_its_launches(card):
    x, w, b = _inputs((4, 2072, 512), 512, dtype=torch.bfloat16, device=card)

    def body(t):
        y = fused_norm.group_norm(t, w, b, 1, layout="tokens")
        return fused_norm.group_norm(y, w, b, 1, act="gelu", layout="tokens")

    with torch.inference_mode():
        eager = body(x)
        prog = programs.Program(body, [x], card)
        assert prog.launches == {"group_norm": 2}
        before = select.launch_counts()["group_norm"]
        out = prog(x)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert select.launch_counts()["group_norm"] - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,layout", [((8, 48, 1036, 33), "channels"),
                                          ((4, 1034, 512), "tokens")])
def test_gradients_through_the_function_match_f_group_norm(card, shape,
                                                           layout, dtype):
    x, w, b = _inputs(shape, _channels(shape, layout), seed=6, dtype=dtype,
                      device=card)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(
        card, dtype)
    m = L.Norm(w.shape[0]).to(card)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
    leaves = [x.clone().requires_grad_(), m.weight, m.bias]
    before = fused_norm.group_norm.launches
    y = L.group_norm(m, leaves[0], 1, act="gelu", layout=layout)
    assert fused_norm.group_norm.launches == before + 1
    got = torch.autograd.grad(y, leaves, g)
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    tokens = layout == "tokens"
    xr = ref[0].transpose(1, 2) if tokens else ref[0]
    yr = F.group_norm(xr.float(), 1, ref[1], ref[2], fused_norm.EPS).to(dtype)
    yr = F.gelu(yr.transpose(1, 2) if tokens else yr)
    want = torch.autograd.grad(yr, ref, g)
    _close(y, yr, dtype)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype
        _close(a, e, dtype, GRAD_TOL)


@pytest.mark.cuda
def test_the_card_refuses_what_the_kernel_does_not_take(card):
    x, w, b = _inputs((2, 8, 40), 8, dtype=torch.float16, device=card)
    with pytest.raises(TypeError):
        fused_norm.group_norm(x, w, b, 1)
    with pytest.raises(ValueError):
        fused_norm.group_norm(x.to(torch.bfloat16), w[:4], b[:4], 1)
