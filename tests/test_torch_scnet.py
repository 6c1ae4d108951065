"""SCNet in the port against the benchmark's plain reference, on the CPU.

The port's ``models.scnet`` in f32 at a tiny size (blocks 8-16-32 wide,
2 dual-path layers, n_fft 256, seeded random weights, GroupNorm affines off
(1, 0)) against ``port_bench/reference/scnet.py``, which imports neither
the port nor JAX and writes each LSTM as its equations: the whole forward,
an SD block and a dual-path layer alone, and ``Separator.separate_all_pcm``
against the reference's chunked overlap-add.  Each tolerance is written
with its reason; each is at least 30x under what bf16 operands read (the
same reference with ``Prec("bf16")``, asserted beside it).  Also: the
reference's LSTM against ``torch.nn.LSTM``; the published widths' band
lengths, frame count and parameter count; the rectangular STFT and its
inverse against ``torch.stft`` / ``torch.istft`` with no window; the
GroupNorm's SiLU; the Separator's int16 bytes composed by hand; its
refusals; the span and the ``dual_path`` counter through a program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_to_sheet_music_tpu_torch.infer import chunked
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.infer.streaming import StreamingSeparator
from audio_to_sheet_music_tpu_torch.models import scnet
from audio_to_sheet_music_tpu_torch.nn import core
from audio_to_sheet_music_tpu_torch.ops import dsp, fused_norm, select
from audio_to_sheet_music_tpu_torch.parallel.mesh import make_mesh
from audio_to_sheet_music_tpu_torch.utils import profiling
from port_bench.reference import protocols
from port_bench.reference import scnet as ref
from port_bench.reference.layers import Prec

TWO_STEMS = dataclasses.replace(scnet.TINY, sources=("vocals", "other"))
# f32 against f32 with the sums in another order (cuDNN-free nn.LSTM
# against the equations, the decoder's repeat folded into its weights, the
# channels-last separation net): readings 2e-7 to 1e-6; bf16 operands read
# 2e-3 to 3e-3 at these widths
F32_REL = 2e-5


def _ref_cfg(cfg: scnet.Config) -> dict:
    return {"sources": list(cfg.sources), "dims": list(cfg.dims),
            "nfft": cfg.nfft, "hop_size": cfg.hop,
            "band_SR": list(cfg.band_sr), "band_stride": list(cfg.band_stride),
            "band_kernel": list(cfg.band_kernel),
            "conv_depths": list(cfg.conv_depths), "compress": cfg.compress,
            "conv_kernel": cfg.conv_kernel, "num_dplayer": cfg.num_dplayer,
            "expand": cfg.expand}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes are many small ops, which more threads only slow down
    where the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[scnet.TINY, TWO_STEMS],
                ids=["4stems", "2stems"])
def model(request):
    m = scnet.init(request.param, seed=3)
    # GroupNorm affines off (1, 0), so a norm whose affine went missing shows
    gen = torch.Generator().manual_seed(5)
    for name, mod in m.named_modules():
        if isinstance(mod, core.Norm):
            mod.weight.data = 1.0 + 0.2 * (torch.rand(mod.weight.shape,
                                                      generator=gen) - 0.5)
            mod.bias.data = 0.2 * (torch.rand(mod.bias.shape,
                                              generator=gen) - 0.5)
    return m


def _wav(b: int, t: int, seed: int = 0) -> torch.Tensor:
    return 0.1 * torch.randn((b, 2, t), generator=torch.Generator()
                             .manual_seed(seed))


def test_forward_matches_the_reference(model):
    wav = _wav(2, 3001)
    p, cfg = model.state_dict(), _ref_cfg(model.cfg)
    with torch.no_grad():
        got = scnet.forward(model, wav)
        want = ref.forward(p, wav, cfg)
        bf16 = ref.forward(p, wav, cfg, Prec("bf16"))
    assert got.shape == (2, len(model.stems), 2, 3001)
    assert _rel(got, want) < F32_REL
    assert _rel(bf16, want) > 30 * F32_REL


def test_sd_block_and_dual_path_match_the_reference(model):
    p, cfg = model.state_dict(), _ref_cfg(model.cfg)
    x = torch.randn((2, 4, 129, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = scnet.sd_block(model.encoder[0], x, model.cfg)
        want = ref.sd_block(p, "encoder.0.", x, cfg, Prec())
        bf16 = ref.sd_block(p, "encoder.0.", x, cfg, Prec("bf16"))
    assert got[2:] == want[2:] == ([30, 12, 4], [30, 48, 51])
    # convolutions of at most 8 x 16 terms and GroupNorms over 8 x 40
    for g, w, b in zip(got[:2], want[:2], bf16[:2]):
        assert _rel(g, w) < 1e-6 < 30 * 1e-6 < _rel(b, w)
    d = model.cfg.dims[-1]
    h = torch.randn((2, d, 8, 14), generator=torch.Generator().manual_seed(2))
    pre = "separation_net.dp_modules.0."
    with torch.no_grad():
        # the port holds the separation net channels-last: (B, F, T, C)
        got = scnet.dual_path(model.separation_net.dp_modules[0],
                              h.permute(0, 2, 3, 1).contiguous())
        want = ref.dual_path(p, pre, h, Prec())
        bf16 = ref.dual_path(p, pre, h, Prec("bf16"))
    got = got.permute(0, 3, 1, 2)
    # two LSTMs of 14 and 8 steps, 32 wide, and their Linear layers
    assert _rel(got, want) < 1e-6 < 30 * 1e-6 < _rel(bf16, want)


@pytest.mark.parametrize("dim,hidden,length", [(16, 24, 13), (32, 32, 1)])
def test_reference_lstm_is_torch_lstm(dim, hidden, length):
    torch.manual_seed(dim)
    lstm = torch.nn.LSTM(dim, hidden, batch_first=True, bidirectional=True)
    x = torch.randn((5, length, dim))
    with torch.no_grad():
        want = lstm(x)[0]
        got = ref.lstm(dict(lstm.state_dict()), "", x, Prec())
    # f32 on both sides, the gates' sums in another order
    assert got.shape == (5, length, 2 * hidden)
    assert _rel(got, want) < 1e-6


def test_published_widths():
    cfg = scnet.PUBLISHED
    # 2049 bins through three SD layers: 705, 243, then 85 rows
    assert scnet.band_rows(cfg) == [[462, 191, 52], [159, 66, 18],
                                    [55, 23, 7]]
    assert scnet.band_splits(2049, cfg.band_sr) == [(0, 462), (462, 1224),
                                                    (1224, 2049)]
    # an 11 s chunk: 1,300 samples of pad, 476 frames (even), 486,400
    # samples out of the inverse STFT
    pad = scnet.right_pad(485100, cfg.hop)
    assert pad == 1300 and (485100 + pad) // cfg.hop + 1 == 476
    with torch.device("meta"):
        m = scnet.SCNet(cfg)
    sd = m.state_dict()
    assert sum(t.numel() for t in sd.values()) == 42_181_232
    # the published module's state_dict names and shapes
    for name, shape in {
            "encoder.0.SDlayer.convs.2.weight": (64, 4, 16, 1),
            "encoder.2.conv_modules.0.layers.2.1.weight": (128, 256, 3),
            "encoder.2.conv_modules.0.layers.2.3.weight": (64, 1, 3),
            "encoder.2.conv_modules.0.layers.2.6.weight": (256, 64, 1),
            "encoder.2.globalconv.weight": (256, 256, 3, 3),
            "separation_net.dp_modules.5.lstm_layers.1.weight_hh_l0_reverse":
                (2048, 512),
            "separation_net.dp_modules.4.lstm_layers.0.weight_ih_l0":
                (1024, 256),
            "separation_net.dp_modules.5.linear_layers.0.weight": (512, 1024),
            "separation_net.dp_modules.0.norm_layers.1.weight": (256,),
            "decoder.0.0.conv.weight": (512, 512, 3, 3),
            "decoder.2.1.convtrs.1.weight": (64, 16, 4, 1)}.items():
        assert tuple(sd[name].shape) == shape


def test_rectangular_stft_is_torch_stft_with_no_window():
    n_fft, hop, length = 4096, 1024, 486400
    x = 0.1 * torch.randn((2, length), generator=torch.Generator()
                          .manual_seed(1))
    z = dsp.stft(x, n_fft, hop, window="rect")
    with pytest.warns(UserWarning):
        want = torch.stft(x, n_fft, hop, win_length=n_fft, window=None,
                          center=True, pad_mode="reflect", normalized=True,
                          return_complex=True)
    assert z.shape == (2, 2049, 476) and torch.equal(z, want)
    got = dsp.istft(z, hop * 475, n_fft, hop, window="rect")
    with pytest.warns(UserWarning):
        back = torch.istft(want, n_fft, hop, win_length=n_fft, window=None,
                           center=True, normalized=True)
    assert torch.equal(got, back)
    # Hann stays the default, bit for bit
    hann = torch.stft(x, n_fft, hop, win_length=n_fft,
                      window=torch.hann_window(n_fft), center=True,
                      pad_mode="reflect", normalized=True, return_complex=True)
    assert torch.equal(dsp.stft(x, n_fft, hop), hann)
    assert torch.equal(dsp.istft(hann, length, n_fft, hop),
                       dsp.istft(hann, length, n_fft, hop, window="hann"))
    with pytest.raises(ValueError, match="window"):
        dsp.stft(x, n_fft, hop, window="hamming")


@pytest.mark.parametrize("shape,layout", [((6, 8, 50), "channels"),
                                          ((3, 40, 24), "tokens")])
def test_group_norm_silu(shape, layout):
    g = torch.Generator().manual_seed(0)
    x = 0.5 + torch.randn(shape, generator=g)
    c = shape[-1] if layout == "tokens" else shape[1]
    w, b = 1 + 0.2 * torch.randn(c, generator=g), 0.3 * torch.randn(c,
                                                                   generator=g)
    xc = x.transpose(1, 2) if layout == "tokens" else x
    want = F.silu(F.group_norm(xc, 1, w, b, fused_norm.EPS))
    want = want.transpose(1, 2) if layout == "tokens" else want
    got = fused_norm.group_norm_plain(x, w, b, 1, act="silu", layout=layout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    norm = core.Norm(c)
    norm.weight.data, norm.bias.data = w, b
    torch.testing.assert_close(core.group_norm(norm, x, 1, act="silu",
                                               layout=layout), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (4, 4), (16, 16),
                                           (2, 2)])
def test_transposed_rows_are_conv_transpose2d(kernel, stride):
    m = core.ConvTranspose2d(8, 5, (kernel, 1), scnet.prng.PRNGKey(kernel))
    x = torch.randn((2, 8, 7, 11), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = scnet.conv_transpose_rows(m, x, stride)
        want = core.conv_transpose2d(m, x, stride=(stride, 1))
    # the same sums of 8 terms a tap: f32 rounding in another order
    assert got.shape == want.shape == (2, 5, 6 * stride + kernel, 11)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_config_takes_only_the_strides_conv_transpose_rows_runs():
    with pytest.raises(ValueError, match="each stride is 1 or its kernel"):
        scnet.Config(band_stride=(1, 2, 16))
    assert scnet.Config(band_stride=(1, 1, 16)).band_stride == (1, 1, 16)


def _separator(model, **kw) -> Separator:
    return Separator(model, device="cpu", segment_seconds=0.25,
                     overlap_seconds=0.1875, **kw)


def test_separate_all_pcm_matches_the_reference(model):
    sep = _separator(model)
    rng = np.random.default_rng(4)
    song = np.round(np.clip(0.1 * rng.standard_normal((2, 15001)), -1, 1)
                    * 32767).astype(np.int16)
    stems = list(reversed(model.stems))
    pcm, scales = sep.separate_all_pcm(song, stems, group_chunks=4)
    assert pcm.shape == (len(stems), 2, 15001) and pcm.dtype == np.int16
    scale = protocols.pcm_scale(song)
    np.testing.assert_allclose(scales, scale, rtol=1e-6)
    x = torch.from_numpy(song).float() / 32768.0
    p, cfg = model.state_dict(), _ref_cfg(model.cfg)
    order = [model.stems.index(s) for s in stems]
    want_q = protocols.quantise(ref.stems(p, cfg, x, sep.segment,
                                          sep.overlap)[order], scale).numpy()
    bf16_q = protocols.quantise(ref.stems(p, cfg, x, sep.segment, sep.overlap,
                                          Prec("bf16"))[order], scale).numpy()
    diff = np.abs(pcm.astype(np.int64) - want_q)
    # f32 against f32: a sample sits within one int16 step (a rounding that
    # falls the other way), and few do (mean 4e-6 to 2e-5 steps); bf16
    # operands move the stems ~0.3 %, at these levels (|level| ~70 steps
    # on average) 0.18-0.24 steps on average
    assert diff.max() <= 1 and diff.mean() < 0.001
    assert np.abs(bf16_q - want_q).mean() > 30 * 0.001


def test_pcm_is_the_model_over_the_groups_bit_for_bit():
    """``separate_all_pcm`` equals ``scnet.forward`` over the same groups,
    overlap-added and quantised here by hand: the seam adds nothing."""
    model = scnet.init(scnet.TINY, seed=1)
    sep = _separator(model)
    song = (0.1 * np.random.default_rng(7).standard_normal((2, 20000))
            ).astype(np.float32)
    stems = ["vocals", "drums"]
    pcm, _ = sep.separate_all_pcm(song, stems, group_chunks=4)
    n = song.shape[-1]
    grid = chunked.plan_chunks(n, sep.segment, sep.overlap, sep.bucket)
    hop, seg = grid.hop, grid.segment
    scale = max(2.0 * float(np.abs(song).max()), 1e-8)
    picks = torch.tensor([model.stems.index(s) for s in stems])
    acc = torch.zeros((4, seg - hop))
    w = torch.zeros((seg - hop,))
    want = np.empty((4, n), np.int16)
    start = 0
    with torch.inference_mode():
        for g in sep._group_schedule(grid, 4):
            take = min(g * hop, n - start)
            if take <= 0:
                break
            span = (g - 1) * hop + seg
            piece = torch.zeros((2, span))
            got = torch.from_numpy(song[:, start:start + span])
            piece[:, :got.shape[-1]] = got
            ggrid = chunked.ChunkGrid(seg, hop, g, span)
            out = scnet.forward(model, chunked.frame_song(piece, ggrid,
                                                          padded=True))
            flat = out.index_select(1, picks).reshape(g, 4, -1)
            valid = (start + torch.arange(g) * hop) < n
            a, ws = chunked.overlap_add_weighted(flat, ggrid, sep.overlap,
                                                 valid, normalize=False)
            a[:, :acc.shape[-1]] += acc
            ws[:w.shape[-1]] += w
            emit = a[:, :g * hop] / torch.clamp(ws[:g * hop], min=1e-8)
            q = torch.clamp(torch.round(emit / scale * 32767.0), -32768,
                            32767).to(torch.int16)
            want[:, start:start + take] = q[:, :take].numpy()
            acc, w = a[:, g * hop:], ws[g * hop:]
            start += g * hop
    np.testing.assert_array_equal(pcm.reshape(4, n), want)


def test_separator_refuses_what_scnet_does_not_have():
    model = scnet.init(scnet.TINY, seed=0)
    sep = _separator(model)
    song = np.zeros((2, 8000), np.float32)
    with pytest.raises(ValueError, match="no stem"):
        sep.separate_all_pcm(song, ["vocals", "piano"])
    with pytest.raises(ValueError, match="no stem"):
        sep.separate_pcm(song, "the vocals")
    with pytest.raises(TypeError, match="stem names"):
        sep.text_embedding("vocals")
    with pytest.raises(ValueError, match="whole-song only"):
        StreamingSeparator(sep, stems=("vocals",))
    with pytest.raises(ValueError, match="no mesh"):
        Separator(model, mesh=make_mesh(["cpu"] * 2))


def test_separate_pcm_is_one_stem_of_the_sweep():
    model = scnet.init(scnet.TINY, seed=2)
    sep = _separator(model)
    song = (0.1 * np.random.default_rng(6).standard_normal((2, 12000))
            ).astype(np.float32)
    one = sep.separate_pcm(song, "bass")
    flat = sep.separate(song, "bass")
    assert one.shape == (2, 12000) and one.dtype == np.int16
    np.testing.assert_array_equal(
        one, np.clip(np.round(flat * 32767.0), -32767, 32767))


def test_span_and_the_dual_path_counter():
    model = scnet.init(scnet.TINY, seed=0)
    with torch.profiler.profile() as prof:
        scnet.forward(model, _wav(1, 3000))
    assert "atsm.model.scnet" in {e.name for e in prof.events()}
    sep = _separator(model)
    song = np.zeros((2, 12000), np.float32)
    grid = chunked.plan_chunks(12000, sep.segment, sep.overlap, sep.bucket)
    groups = len(sep._group_schedule(grid, 4))
    before = profiling.counts()["launches.dual_path"]
    sep.separate_all_pcm(song, ["vocals"], group_chunks=4)
    sep.separate_all_pcm(song, ["vocals"], group_chunks=4)
    # the layers of each group's program, each call (programs on the CPU
    # run their body eagerly at every call)
    assert (profiling.counts()["launches.dual_path"] - before
            == 2 * model.cfg.num_dplayer * groups)
    assert select.LAYERS["dual_path"] is scnet.DUAL_PATH
    assert "dual_path" in select.launch_counts()


def test_the_gate_pair_runs_kernels_against_plain():
    from audio_to_sheet_music_tpu_torch.ops import kernel_gate

    # a hop of 256 bins' worth: the gate's 6 s chunk in 1,034 frames
    model = scnet.init(dataclasses.replace(scnet.TINY, hop=256), seed=0)
    res = kernel_gate.verify_layer_parity(model, torch.float32,
                                          kernels="default")
    # on the CPU both sides take the plain GroupNorm: equal up to the
    # summation order of F.group_norm against the kernel's partition
    assert res["ok"] and res["rms"] < 1e-6 < res["ref_rms"]
    assert kernel_gate.ensure_layer_parity(model, torch.float32) is None


def test_lstm_takes_a_flattened_copy_in_the_compute_dtype():
    model = scnet.init(scnet.TINY, seed=0)
    lstm = model.separation_net.dp_modules[0].lstm_layers[0]
    x = torch.randn((3, 5, lstm.input_size))
    assert scnet._lstm_in(lstm, x) is lstm
    xb = x.bfloat16()
    cast = scnet._lstm_in(lstm, xb)
    assert cast is not lstm and cast.weight_hh_l0.dtype == torch.bfloat16
    assert scnet._lstm_in(lstm, xb) is cast
    torch.testing.assert_close(cast.weight_ih_l0_reverse.float(),
                               lstm.weight_ih_l0_reverse, rtol=4e-3, atol=0)
    with torch.no_grad():
        lstm.weight_hh_l0.mul_(0.5)
    assert scnet._lstm_in(lstm, xb) is not cast
