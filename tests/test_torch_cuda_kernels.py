"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a card (decided in the fixture, not
at import).  On a machine with one, run them without the JAX test
configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

They cover the shapes the serving and training paths do not reach (short
and ragged sequences, one key, single rows, odd T, a frame count off the
kernel's frame block), the flash launch's tile edges (S at and one past a
128-key tile, L one 64-row query tile, grids of more blocks than the card
has SMs), the GEMM's edges (a partial 128-column tile, M off the 128-row
tile), the four serving forms at B = 4 and the eval path's four (2688
freq and 1344 time tokens, self and cross; T = 336 frames through
``henc_freq_fused`` and the freq decoders' ``dconv_rows``; the whole
4-source tower at tiny width with and without kernels), the henc conv's K
chunks and channel slices, a 30 s chunk through ``henc_freq_fused``, the DConv
routine over the T and C edges of its tiles (T around the 64-frame tile,
C whose hidden C/8 is padded to the MMA's 16, the widest C it takes) and
in place, and the refusals (a tensor that requires grad, a wrong dtype, rows wider than the
DConv routine holds); ``chip_smoke.py`` covers the paths' own
shapes.  Tolerances are those of ``chip_smoke.py``,
for the same reasons: a few bf16 output steps for ``layer_tail`` and
``attn_block``, two for ``henc_freq_fused`` and ``dconv_rows`` (f32 sums
over bf16 product operands, which the plain versions round alike),
and an f32 FFT's rounding for ``stft``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu_torch.models import htdemucs
from audio_to_sheet_music_tpu_torch.nn import prng
from audio_to_sheet_music_tpu_torch.ops import (fused_attn, fused_dconv,
                                                fused_enc, fused_stft)

pytestmark = pytest.mark.cuda
# the seeded modules' key (drawn on the CPU, moved to the card)
KEY = prng.PRNGKey(0)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _close(got, want, max_rel, rms_rel):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    top, rms = float(w.abs().max()), float(w.pow(2).mean().sqrt())
    msg = (f"max err {float(err.max()):.4g} vs max|ref| {top:.4g}, rms err "
           f"{float(err.pow(2).mean().sqrt()):.4g} vs rms(ref) {rms:.4g}")
    assert float(err.max()) <= max_rel * top, msg
    assert float(err.pow(2).mean().sqrt()) <= rms_rel * rms, msg


def _layer_args(b, l, s, d, ff, gen):
    def n(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale
    bf = lambda t: t.to("cuda", torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda t: t.to("cuda", torch.float32).contiguous()  # noqa: E731
    return [bf(n(b, l, d)), bf(n(b, s, d)), bf(n(b, s, d)), bf(n(b, l, d)),
            bf(n(d, d, scale=d ** -0.5)), f32(n(d, scale=0.1)),
            bf(n(d, d, scale=d ** -0.5)), f32(n(d, scale=0.1)),
            f32(0.5 + 0.1 * n(d)), f32(1.0 + 0.1 * n(d)), f32(n(d, scale=0.1)),
            bf(n(ff, d, scale=d ** -0.5)), f32(n(ff, scale=0.1)),
            bf(n(d, ff, scale=ff ** -0.5)), f32(n(d, scale=0.1)),
            f32(0.5 + 0.1 * n(d))]


# (B, L, S) at the flash launch's edges: 128-key tiles, 64-row query
# tiles, grids past 132 SMs
FLASH_EDGES = [
    (2, 100, 128),               # S exactly one key tile
    (2, 100, 129),               # S one past a tile
    (3, 64, 300),                # L one query tile
    (40, 128, 200),              # L two query tiles; 640 blocks
    (24, 300, 257),              # 24 x 8 heads x 5 tiles: 960 blocks
]
# (B, L, S, D, FF) at the GEMM's edges: D = 192 and FF = 320 end in a
# 64-column part of a 128-wide N tile, and M = B L off the 128-row tile
GEMM_EDGES = [(1, 130, 7, 192, 320), (3, 257, 200, 384, 1536)]
# the four serving forms of one group of four 6 s chunks
SERVING_FORMS = [(4, 2072, 2072), (4, 1034, 1034), (4, 2072, 1034),
                 (4, 1034, 2072)]
# the eval path's forms (the HTDemucs baseline's 7.8 s chunks): 2688 freq
# tokens (8 x 336), 1344 time tokens, self and cross; 1344 keys end
# half-way through a 128-key tile
EVAL_FORMS = [(2, 2688, 2688), (2, 1344, 1344), (2, 2688, 1344),
              (2, 1344, 2688)]
EVAL_T = 336                     # spectrogram frames of a 7.8 s chunk


@pytest.mark.parametrize("b,l,s,d,ff", [
    (1, 1, 1, 512, 2048),        # one query, one key
    (2, 63, 65, 512, 2048),      # both sides off the 64-row tile
    (1, 130, 7, 128, 256),       # narrow model, fewer keys than a tile
    (3, 64, 200, 256, 1024),
] + GEMM_EDGES + [(b, l, s, 512, 2048) for b, l, s in FLASH_EDGES +
                  SERVING_FORMS + EVAL_FORMS])
def test_layer_tail_matches_plain(gen, b, l, s, d, ff):
    args = _layer_args(b, l, s, d, ff, gen)
    before = fused_attn.layer_tail.launches
    with torch.inference_mode():
        got = fused_attn.layer_tail(*args, d // 64)
        want = fused_attn.layer_tail_plain(*args, d // 64)
    torch.cuda.synchronize()
    assert fused_attn.layer_tail.launches == before + 1
    assert got.shape == (b, l, d) and got.dtype == torch.bfloat16
    _close(got, want, 4 * 2.0 ** -8, 2.0 ** -8)


def test_layer_tail_refuses_f32_on_the_card(gen):
    args = _layer_args(1, 8, 8, 128, 256, gen)
    args[0] = args[0].float()
    with pytest.raises(TypeError):
        fused_attn.layer_tail(*args, 2)


@pytest.mark.parametrize("b,cin,c,f,t", [
    (1, 4, 48, 64, 9),
    (2, 4, 48, 256, 130),
    (1, 2, 16, 32, 300),
    (4, 4, 48, 2048, 259),
    (2, 4, 48, 2048, EVAL_T),    # T = 5 x 64 + 16 frames
    (1, 12, 96, 32, 70),         # the conv's K in two chunks, C in two slices
    (2, 4, 40, 64, 65),          # C off the 16-column tile and the pair slice
])
def test_henc_matches_plain(gen, b, cin, c, f, t):
    layer = htdemucs.HEncLayer(cin, c, freq=True, key=KEY)
    for blk in layer.dconv.layers:
        blk.scale.scale.data.fill_(0.5)
    layer = layer.cuda()
    x = torch.randn((b, cin, f, t), generator=gen).to("cuda", torch.bfloat16)
    before = fused_enc.henc_freq_fused.launches
    with torch.inference_mode():
        got = fused_enc.henc_freq_fused(layer, x)
        want = fused_enc.henc_freq_plain(layer, x)
    torch.cuda.synchronize()
    assert fused_enc.henc_freq_fused.launches == before + 1
    assert got.shape == (b, c, f // 4, t) and got.dtype == torch.bfloat16
    _close(got, want, 2 * 2.0 ** -8, 2.0 ** -9)


def test_henc_refuses_a_strided_input(gen):
    layer = htdemucs.HEncLayer(4, 16, freq=True, key=KEY).cuda()
    x = torch.randn((1, 4, 32, 20), device="cuda",
                    dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError), torch.no_grad():
        fused_enc.henc_freq_fused(layer, x)


@pytest.mark.parametrize("b,t", [(1, 1300), (2, 1077)])
def test_henc_takes_chunks_past_25_seconds(gen, b, t):
    """T > 1076 frames: the first design's shared-memory limit is gone."""
    layer = htdemucs.HEncLayer(4, 48, freq=True, key=KEY)
    for blk in layer.dconv.layers:
        blk.scale.scale.data.fill_(0.5)
    layer = layer.cuda()
    x = torch.randn((b, 4, 2048, t), generator=gen).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        got = fused_enc.henc_freq_fused(layer, x)
        want = fused_enc.henc_freq_plain(layer, x)
    torch.cuda.synchronize()
    _close(got, want, 2 * 2.0 ** -8, 2.0 ** -9)


def test_separator_serves_30_second_chunks_through_henc(gen):
    from audio_to_sheet_music_tpu_torch.infer.session import Separator
    from audio_to_sheet_music_tpu_torch.models import atht

    model = atht.init_tiny(0)
    sep = Separator(model, segment_seconds=30.0, overlap_seconds=1.5)
    song = (0.1 * np.random.default_rng(0).standard_normal((2, 44100 * 40))
            ).astype(np.float32)
    before = fused_enc.henc_freq_fused.launches
    pcm, scales = sep.separate_all_pcm(song, stems=["drums", "vocals"])
    assert fused_enc.henc_freq_fused.launches > before
    assert pcm.shape == (2, 2, song.shape[-1]) and np.isfinite(scales).all()


def _narrow_model(seed: int = 0):
    """The tiny towers with a 512-wide transformer (8 heads of 64): the
    narrowest model whose transformer layers route to ``layer_tail``."""
    from audio_to_sheet_music_tpu_torch.models import atht, clap_text

    k1, k2, k3 = prng.split(prng.PRNGKey(seed), 3)
    return atht.AudioTextHTDemucs(
        htdemucs.HTDemucs(channels=(8, 16, 24, 32), bottom_channels=512,
                          t_layers=2, key=k1),
        clap_text.ClapText(num_layers=2, hidden=128, key=k2),
        atht.Head(decoder_channels=(32, 16, 8, 8, 4), key=k3))


@pytest.mark.parametrize("block", [1, 3])
def test_stream_on_the_card_matches_offline(gen, block):
    """The stream's blocks run other batch sizes than the offline sweep, so
    cuBLAS and cuDNN may pick other algorithms: held to the path-rms gate
    (1e-3) away from the two edge samples, as ``chip_smoke.py``'s phase 6
    holds the full-width stream."""
    from audio_to_sheet_music_tpu_torch.infer import (Separator,
                                                      StreamingSeparator)

    sep = Separator(_narrow_model(), segment_seconds=1.0,
                    overlap_seconds=0.1)
    song = (0.3 * np.random.default_rng(0).standard_normal((2, 44100 * 5))
            ).astype(np.float32)
    offline = sep.separate(song, "vocals")
    stream = StreamingSeparator(sep, stems=("vocals",), block_chunks=block)
    pieces = []
    for start in range(0, song.shape[-1], 30000):
        pieces += stream.feed(song[:, start:start + 30000])
    out = np.concatenate(pieces + [stream.flush()], axis=-1)[0]
    assert stream._acc is None and out.shape == song.shape
    rms = np.sqrt(np.mean((out[:, 1:-1] - offline[:, 1:-1]) ** 2))
    assert np.isfinite(out).all() and rms < 1e-3, rms


def test_separate_pcm_repeats_bit_for_bit_on_the_card(gen):
    """A separator with ``deterministic=True`` (the serving app's) runs
    its chunk programs on cuDNN's deterministic algorithms: two calls on
    one song give the same bytes, and the process's setting comes back."""
    from audio_to_sheet_music_tpu_torch.infer import Separator

    sep = Separator(_narrow_model(), segment_seconds=1.0,
                    overlap_seconds=0.1, deterministic=True)
    before = torch.backends.cudnn.deterministic
    song = (0.3 * np.random.default_rng(2).standard_normal((2, 44100 * 4))
            ).astype(np.float32)
    np.testing.assert_array_equal(sep.separate_pcm(song, "bass"),
                                  sep.separate_pcm(song, "bass"))
    assert torch.backends.cudnn.deterministic == before


def test_separate_stream_on_the_card_runs_the_kernels(gen):
    from audio_to_sheet_music_tpu_torch.apps import serve_http
    from audio_to_sheet_music_tpu_torch.infer import Separator

    sep = Separator(_narrow_model(), segment_seconds=1.0,
                    overlap_seconds=0.1)
    service = serve_http.SeparationService(sep, spectrograms=False)
    song = (0.3 * np.random.default_rng(1).standard_normal((2, 44100 * 4))
            ).astype(np.float32)
    wav = serve_http.encode_wav_bytes(song)
    service.separate_stream(wav, "vocals", lambda n: None, lambda b: None,
                            block_chunks=2)        # warm
    fused_attn.layer_tail.launches = fused_enc.henc_freq_fused.launches = 0
    body = []
    service.separate_stream(wav, "vocals", body.append, body.append,
                            block_chunks=2)
    steps = 3                 # 4 s at a 0.9 s hop: 5 chunks, blocks of 2
    assert fused_attn.layer_tail.launches == 4 * steps   # 2 layers a branch
    assert fused_enc.henc_freq_fused.launches == steps
    total = body[0]
    assert total == 44 + 4 * song.shape[-1] == sum(map(len, body[1:]))


def _dconv(c, gen):
    d = htdemucs.DConv(c, KEY)
    for blk in d.layers:
        blk.scale.scale.data.fill_(0.5)
        blk.norm1.bias.data.normal_(generator=gen)
        blk.norm2.bias.data.normal_(generator=gen)
    return d.cuda()


# T: one frame, either side of 32 and of the routine's 64-frame tile, a 6 s
# segment, a 30 s chunk; C: H = 2 (padded to the MMA's 16), 12 (padded),
# 24, 48
@pytest.mark.parametrize("t", [1, 31, 33, 63, 64, 65, 259, 1292])
@pytest.mark.parametrize("c", [16, 96, 192, fused_dconv.MAX_CHANNELS])
def test_dconv_rows_matches_plain(gen, c, t):
    d = _dconv(c, gen)
    x = torch.randn((3, c, t), generator=gen).to("cuda", torch.bfloat16)
    before = fused_dconv.dconv_rows.launches
    with torch.inference_mode():
        got = fused_dconv.dconv_rows(d, x)
        want = fused_dconv.dconv_rows_plain(d, x)
    torch.cuda.synchronize()
    assert fused_dconv.dconv_rows.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    _close(got, want, 2 * 2.0 ** -8, 2.0 ** -9)


@pytest.mark.parametrize("c", [16, 96, 192, fused_dconv.MAX_CHANNELS])
def test_libraries_pad_the_hidden_as_the_tiling_model(gen, c):
    """Both libraries pad C/8 to the MMA's 16, as the CPU model of the
    tiling (tests/test_torch_fused_dconv.py) assumes; ``henc_freq`` pads C
    and the conv's Cin x 8 taps to 16 as the CPU model of its conv and
    rewrite (tests/test_torch_fused_enc.py) assumes."""
    pad16 = lambda n: -(-n // 16) * 16  # noqa: E731
    assert fused_dconv._lib().dconv_rows_hidden_pad(c) == pad16(c // 8)
    assert fused_enc._lib().henc_freq_hidden_pad(c) == pad16(c // 8)
    assert fused_enc._lib().henc_freq_channel_pad(c) == pad16(c)
    assert fused_enc._lib().henc_freq_conv_depth(c // 8) == pad16(c)


def test_henc_at_the_widest_channels(gen):
    """C = MAX_CHANNELS runs the DConv routine at its widest rows."""
    c = fused_dconv.MAX_CHANNELS
    layer = htdemucs.HEncLayer(4, c, freq=True, key=KEY)
    for blk in layer.dconv.layers:
        blk.scale.scale.data.fill_(0.5)
        blk.norm1.bias.data.normal_(generator=gen)
    layer = layer.cuda()
    x = torch.randn((1, 4, 32, 70), generator=gen).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        got = fused_enc.henc_freq_fused(layer, x)
        want = fused_enc.henc_freq_plain(layer, x)
    torch.cuda.synchronize()
    _close(got, want, 2 * 2.0 ** -8, 2.0 ** -9)


def test_dconv_routine_refuses_rows_wider_than_it_holds(gen):
    """C past MAX_CHANNELS does not fit conv1's shared memory: both
    wrappers refuse it before the launch."""
    c = fused_dconv.MAX_CHANNELS + 8
    d = _dconv(c, gen)
    x = torch.randn((2, c, 40), generator=gen).to("cuda", torch.bfloat16)
    with pytest.raises(ValueError, match="at most"), torch.no_grad():
        fused_dconv.dconv_rows(d, x)
    layer = htdemucs.HEncLayer(4, c, freq=True, key=KEY).cuda()
    x = torch.randn((1, 4, 32, 40), generator=gen).to("cuda", torch.bfloat16)
    with pytest.raises(ValueError, match="at most"), torch.no_grad():
        fused_enc.henc_freq_fused(layer, x)


@pytest.mark.parametrize("which", ["dconv_rows", "henc_freq_fused"])
def test_dconv_routine_in_place_is_repeatable(gen, which):
    """Block 1 of ``dconv_rows`` reads the f32 scratch block 0 wrote, and
    ``henc_freq_fused`` runs both blocks in place on its f32 ``y``: over
    many tiles with a ragged last one, two launches agree bit for bit and
    match the plain version."""
    if which == "dconv_rows":
        mod = _dconv(96, gen)
        x = torch.randn((5, 96, 301), generator=gen).to("cuda", torch.bfloat16)
        fn, plain = fused_dconv.dconv_rows, fused_dconv.dconv_rows_plain
    else:
        mod = htdemucs.HEncLayer(4, 48, freq=True, key=KEY)
        for blk in mod.dconv.layers:
            blk.scale.scale.data.fill_(0.5)
            blk.norm1.bias.data.normal_(generator=gen)
        mod = mod.cuda()
        x = torch.randn((2, 4, 64, 301), generator=gen).to("cuda",
                                                           torch.bfloat16)
        fn, plain = fused_enc.henc_freq_fused, fused_enc.henc_freq_plain
    with torch.inference_mode():
        a, b = fn(mod, x), fn(mod, x)
        want = plain(mod, x)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a, want, 2 * 2.0 ** -8, 2.0 ** -9)


# the freq decoders' DConv on the eval path, two 7.8 s chunks:
# (rows = 2 x F, C) of decoders 0-3; C = 384 is the widest the routine holds
@pytest.mark.parametrize("rows,c", [(2 * 8, 384), (2 * 32, 192),
                                    (2 * 128, 96), (2 * 512, 48)])
def test_dconv_rows_at_the_decoders(gen, rows, c):
    assert fused_dconv.supports(rows, EVAL_T, c)
    d = _dconv(c, gen)
    x = torch.randn((rows, c, EVAL_T), generator=gen).to("cuda",
                                                          torch.bfloat16)
    with torch.inference_mode():
        got = fused_dconv.dconv_rows(d, x)
        want = fused_dconv.dconv_rows_plain(d, x)
    torch.cuda.synchronize()
    _close(got, want, 2 * 2.0 ** -8, 2.0 ** -9)


@pytest.mark.parametrize("kernels,used", [
    ("default", ("layer_tail", "henc_freq_fused")),
    ("opt_in", ("henc_freq_fused", "dconv_rows", "stft")),
])
def test_htdemucs_forward_with_kernels_matches_per_op(gen, kernels, used):
    """The whole 4-source tower at tiny width on two 7.8 s chunks, bf16:
    the kernel selection against the per-op path, within the kernel gate's
    1e-3 rms (``attn_block`` takes 128-wide models only, so the opt-in
    transformer at D = 64 is per op)."""
    fns = {"layer_tail": fused_attn.layer_tail,
           "henc_freq_fused": fused_enc.henc_freq_fused,
           "dconv_rows": fused_dconv.dconv_rows, "stft": fused_stft.stft}
    ht = htdemucs.HTDemucs(channels=(8, 16, 24, 32), bottom_channels=64,
                           t_layers=2, key=KEY).cuda().requires_grad_(False)
    mix = (0.1 * torch.randn((2, 2, 343980), generator=gen)).cuda()
    before = {k: f.launches for k, f in fns.items()}
    with torch.inference_mode():
        got = htdemucs.forward(ht, mix, torch.bfloat16, kernels)
        torch.cuda.synchronize()
        ran = {k: f.launches - before[k] for k, f in fns.items()}
        want = htdemucs.forward(ht, mix, torch.bfloat16, False)
    assert got.shape == (2, 4, 2, 343980) and got.dtype == torch.float32
    assert all(ran[k] > 0 for k in used), ran
    assert torch.isfinite(got).all()
    assert float((got - want).pow(2).mean().sqrt()) < 1e-3


def _block_args(b, l, s, d, gen):
    def n(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale
    bf = lambda t: t.to("cuda", torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda t: t.to("cuda", torch.float32).contiguous()  # noqa: E731
    return [bf(n(b, l, d)), bf(n(b, s, d)), bf(n(b, s, d)), bf(n(b, l, d)),
            bf(n(d, d, scale=d ** -0.5)), f32(n(d, scale=0.1)),
            f32(0.5 + 0.1 * n(d))]


@pytest.mark.parametrize("b,l,s,d", [
    (1, 1, 1, 512),
    (2, 63, 65, 512),
    (1, 130, 7, 128),
    (3, 64, 200, 256),
] + [(b, l, s, d) for b, l, s, d, _ in GEMM_EDGES]
  + [(b, l, s, 512) for b, l, s in FLASH_EDGES + SERVING_FORMS + EVAL_FORMS])
def test_attn_block_matches_plain(gen, b, l, s, d):
    args = _block_args(b, l, s, d, gen)
    before = fused_attn.attn_block.launches
    with torch.inference_mode():
        got = fused_attn.attn_block(*args, d // 64)
        want = fused_attn.attn_block_plain(*args, d // 64)
    torch.cuda.synchronize()
    assert fused_attn.attn_block.launches == before + 1
    assert got.shape == (b, l, d) and got.dtype == torch.bfloat16
    _close(got, want, 4 * 2.0 ** -8, 2.0 ** -8)


@pytest.mark.parametrize("rows,n_fft,hop,frames", [
    (3, 256, 128, 9),
    (2, 4096, 1024, 11),     # frames off the 4-frame block
    (1, 8192, 2048, 3),
    (2, 512, 128, 13),
    (3, 2048, 512, 17),
    (1, 4096, 1024, 263),    # a training row: 263 = 65 x 4 + 3
])
def test_stft_matches_plain(gen, rows, n_fft, hop, frames):
    x = torch.randn((rows, (frames - 1) * hop + n_fft + 5),
                    generator=gen).cuda()
    before = fused_stft.stft.launches
    got = fused_stft.stft(x, n_fft, hop, frames)
    want = fused_stft.stft_plain(x, n_fft, hop, frames)
    torch.cuda.synchronize()
    assert fused_stft.stft.launches == before + 1
    assert got.shape == want.shape == (rows, n_fft // 2 + 1, frames)
    _close(torch.view_as_real(got), torch.view_as_real(want), 1e-4, 1e-5)


def test_kernels_refuse_inputs_that_require_grad(gen):
    layer = htdemucs.HEncLayer(4, 16, freq=True, key=KEY).cuda()
    layer.requires_grad_(True)
    x = torch.randn((1, 4, 32, 20), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_enc.henc_freq_fused(layer, x)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_dconv.dconv_rows(layer.dconv, torch.randn(
            (2, 16, 20), device="cuda", dtype=torch.bfloat16))
    args = _block_args(1, 8, 8, 128, gen)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_attn.attn_block(*args, 2)
    sig = torch.randn((1, 600), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_stft.stft(sig, 256, 128, 3)
    with torch.no_grad():            # no autograd: the same calls launch
        fused_stft.stft(sig, 256, 128, 3)


@torch.no_grad()
def test_new_kernels_refuse_a_wrong_dtype(gen):
    d = _dconv(16, gen)
    with pytest.raises(TypeError):
        fused_dconv.dconv_rows(d, torch.randn((2, 16, 20), device="cuda"))
    args = _block_args(1, 8, 8, 128, gen)
    args[0] = args[0].float()
    with pytest.raises(TypeError):
        fused_attn.attn_block(*args, 2)
    with pytest.raises(TypeError):
        fused_stft.stft(torch.randn((1, 600), device="cuda",
                                    dtype=torch.float64), 256, 128, 3)


def test_kernels_launch_on_their_inputs_card(gen):
    """Each kernel with its inputs on card 0 while the last card is the
    current device: every launch must run on the input's card (with that
    card's shared-memory attributes and SM count).  On a machine with one
    card the two are the same card, and this shows only that the guarded
    path runs."""
    first = torch.device("cuda", 0)
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    with torch.cuda.device(first):
        layer = _layer_args(2, 100, 80, 512, 2048, gen)
        block = _block_args(2, 100, 80, 512, gen)
        enc = htdemucs.HEncLayer(4, 48, freq=True, key=KEY).cuda()
        xe = torch.randn((1, 4, 256, 70), generator=gen).to(
            "cuda", torch.bfloat16)
        dconv = _dconv(96, gen)
        xd = torch.randn((3, 96, 70), generator=gen).to("cuda",
                                                         torch.bfloat16)
        xs = torch.randn((2, 10 * 1024 + 4096), generator=gen).cuda()
    calls = [
        (fused_attn.layer_tail, fused_attn.layer_tail_plain,
         (*layer, 8), (4 * 2.0 ** -8, 2.0 ** -8)),
        (fused_attn.attn_block, fused_attn.attn_block_plain,
         (*block, 8), (4 * 2.0 ** -8, 2.0 ** -8)),
        (fused_enc.henc_freq_fused, fused_enc.henc_freq_plain, (enc, xe),
         (2 * 2.0 ** -8, 2.0 ** -9)),
        (fused_dconv.dconv_rows, fused_dconv.dconv_rows_plain, (dconv, xd),
         (2 * 2.0 ** -8, 2.0 ** -9)),
        (fused_stft.stft, fused_stft.stft_plain, (xs, 4096, 1024, 11),
         (1e-4, 1e-5)),
    ]
    for kernel, plain, args, tol in calls:
        before = kernel.launches
        with torch.inference_mode(), torch.cuda.device(last):
            got = kernel(*args)
        with torch.inference_mode():
            want = plain(*args)
        torch.cuda.synchronize(first)
        assert kernel.launches == before + 1
        assert got.device == first
        if got.is_complex():
            got, want = torch.view_as_real(got), torch.view_as_real(want)
        _close(got, want, *tol)


def test_istft_is_torch_istft_on_the_card(gen):
    """``ops.dsp.istft`` (the heads' inverse STFT, without ``torch.istft``'s
    host-side envelope check) against ``torch.istft`` on the card: the
    same steps, so the same values and gradients, and no wait for the
    card."""
    from audio_to_sheet_music_tpu_torch.ops import dsp

    z = torch.randn((8, 2049, 14), generator=gen,
                    dtype=torch.complex64).cuda().requires_grad_(True)
    g = torch.randn((8, 11025), generator=gen).cuda()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dsp.istft(z, 11025)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    (got * g).sum().backward()
    grad, z.grad = z.grad.clone(), None
    want = torch.istft(z, 4096, 1024, window=dsp._window(4096, z.device),
                       win_length=4096, center=True, normalized=True,
                       length=11025)
    (want * g).sum().backward()
    assert torch.equal(got, want) and torch.equal(grad, z.grad)


def test_parity_gate_reads_its_kernel_pass_on_the_card(gen, monkeypatch):
    """The gate's kernel pass on the card, read by the launch counters: a
    512-wide transformer routes to ``layer_tail``, so the default gate
    runs and passes; widths no kernel takes (a 96-wide transformer, encoder
    channels that are not multiples of 8) run per op, launch nothing, and
    the gate is kept as skipped.  Each model has its own gate: the results
    are kept a (selection, card), so they are cleared in between."""
    from audio_to_sheet_music_tpu_torch.models import atht, clap_text
    from audio_to_sheet_music_tpu_torch.ops import kernel_gate

    monkeypatch.setattr(kernel_gate, "_RESULTS", {})
    res = kernel_gate.ensure_layer_parity(_narrow_model().cuda(),
                                          torch.bfloat16)
    assert res is not None and res["ok"] and "skipped" not in res
    assert res["launches"].get("layer_tail", 0) > 0
    k1, k2, k3 = prng.split(KEY, 3)
    narrow = atht.AudioTextHTDemucs(
        htdemucs.HTDemucs(channels=(12, 20, 28, 36), bottom_channels=96,
                          t_layers=2, key=k1),
        clap_text.ClapText(num_layers=2, hidden=128, key=k2),
        atht.Head(decoder_channels=(36, 20, 12, 12, 4), key=k3)).cuda()
    monkeypatch.setattr(kernel_gate, "_RESULTS", {})
    assert kernel_gate.ensure_layer_parity(narrow, torch.bfloat16) is None
    res = kernel_gate.last_result()
    assert res["launches"] == {} and "skipped" in res
