"""BS-RoFormer in the port against the benchmark's plain reference, on the CPU.

The port's ``models.bs_roformer`` in f32 at a tiny size (2 layers, 2 heads
of 64, n_fft 256 in ragged bands with a 1-bin and odd-width ones, stereo,
1 and 2 stems, seeded random weights) against
``port_bench/reference/bs_roformer.py``, which imports neither the port
nor JAX: the whole forward, the band split and the mask estimator alone,
RoPE against the rotation written out, and ``Separator.separate_all_pcm``
against the reference's chunked overlap-add.  Each tolerance is written
with its reason; each is at least 30x under what bf16 operands read (the
same reference with ``Prec("bf16")``, asserted beside it).  Also: the
unnormalised inverse STFT the model uses is ``torch.istft``'s, the
Separator's refusals, the published widths' parameter count, and ATHT's
int16 output through the Separator is, bit for bit, its encoder and heads
composed by hand.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu_torch.infer import chunked
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.infer.streaming import StreamingSeparator
from audio_to_sheet_music_tpu_torch.models import atht
from audio_to_sheet_music_tpu_torch.models import bs_roformer as br
from audio_to_sheet_music_tpu_torch.nn import core
from audio_to_sheet_music_tpu_torch.ops import dsp
from audio_to_sheet_music_tpu_torch.parallel.mesh import make_mesh
from port_bench.reference import bs_roformer as ref
from port_bench.reference import protocols
from port_bench.reference.layers import Prec

TWO_STEMS = dataclasses.replace(br.TINY, stems=("vocals", "other"))
# f32 against f32 with the sums in another order (batched bands, one
# complex product for RoPE, the STFT by another route): readings 3e-7 to
# 1e-6; bf16 operands read 4e-3 to 8e-3 at these widths
F32_REL = 2e-5


def _ref_cfg(cfg: br.Config) -> dict:
    return {"dim": cfg.dim, "depth": cfg.depth, "heads": cfg.heads,
            "dim_head": cfg.dim_head,
            "freqs_per_bands": list(cfg.freqs_per_bands),
            "num_stems": len(cfg.stems),
            "mask_estimator_depth": 2,
            "stft_n_fft": cfg.n_fft, "stft_hop_length": cfg.hop}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


@pytest.fixture(scope="module", params=[br.TINY, TWO_STEMS],
                ids=["1stem", "2stems"])
def model(request):
    m = br.init(request.param, seed=3)
    # gammas off 1, so a norm whose gamma went missing shows
    gen = torch.Generator().manual_seed(5)
    for name, p in m.named_parameters():
        if name.endswith("gamma"):
            p.data = 1.0 + 0.2 * (torch.rand(p.shape, generator=gen) - 0.5)
    return m


def _wav(b: int, t: int, seed: int = 0) -> torch.Tensor:
    return 0.1 * torch.randn((b, 2, t), generator=torch.Generator()
                             .manual_seed(seed))


def test_forward_matches_the_reference(model):
    wav = _wav(2, 6001)
    p, cfg = model.state_dict(), _ref_cfg(model.cfg)
    with torch.no_grad():
        got = br.forward(model, wav)
        want = ref.forward(p, wav, cfg)
        bf16 = ref.forward(p, wav, cfg, Prec("bf16"))
    assert got.shape == (2, len(model.stems), 2, 6001)
    assert _rel(got, want) < F32_REL
    assert _rel(bf16, want) > 30 * F32_REL


def test_band_split_matches_the_reference(model):
    cfg = _ref_cfg(model.cfg)
    p = model.state_dict()
    _, feats = ref.features(_wav(2, 3000, 1), cfg)
    with torch.no_grad():
        got = br.band_split(model.band_split, feats, model.cfg,
                            torch.float32)
        want = ref.band_split(p, feats, cfg)
        bf16 = ref.band_split(p, feats, cfg, Prec("bf16"))
    assert got.shape == (2, feats.shape[1], len(model.cfg.freqs_per_bands),
                         model.cfg.dim)
    # one product a band: f32 rounding of sums of at most 4 x 65 terms
    assert _rel(got, want) < 1e-6 < 30 * 1e-6 < _rel(bf16, want)


def test_mask_estimator_matches_the_reference(model):
    cfg = _ref_cfg(model.cfg)
    p = model.state_dict()
    x = torch.randn((2, 9, len(model.cfg.freqs_per_bands), model.cfg.dim),
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        # gamma 1: the reference's mask features take the normed x as is
        one = torch.ones(model.cfg.dim)
        got = torch.stack([br.mask_estimator(me, x, model.cfg, one)
                           for me in model.mask_estimators], dim=1)
        want = ref.mask_features(p, x, cfg)
        bf16 = ref.mask_features(p, x, cfg, Prec("bf16"))
    # two products of at most 512 terms in f32
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-6 < 30 * 1e-6 < _rel(bf16, want)


@pytest.mark.parametrize("length,heads,dh", [(1, 1, 64), (62, 2, 64),
                                             (801, 8, 64), (37, 3, 8)])
def test_rope_is_the_interleaved_rotation(length, heads, dh):
    x = torch.randn((2, length, heads * dh),
                    generator=torch.Generator().manual_seed(length))
    # the rotation written out in float64: pair j of a head at position p
    # turns by p / 10000^(2j / dh)
    xd = x.double().reshape(2, length, heads, dh // 2, 2)
    ang = (torch.arange(length, dtype=torch.float64)[:, None]
           / 10000.0 ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh))
    c, s = ang.cos()[:, None], ang.sin()[:, None]
    a, b = xd[..., 0], xd[..., 1]
    want = torch.stack((a * c - b * s, a * s + b * c), -1).reshape(x.shape)
    # the angles in f32 as rotary_embedding_torch computes them: at
    # position 800 an angle of 800 rad carries ~3e-5 rad of rounding
    tol = 1e-6 + 4e-8 * length
    for got in (core.rope(x, heads), ref.rotate(x, heads)):
        assert got.is_contiguous()
        err = (got.double() - want).abs().max() / want.abs().max()
        assert float(err) < tol
    bf16 = core.rope(x.bfloat16(), heads).double()
    assert float((bf16 - want).abs().max() / want.abs().max()) > 10 * tol


def test_rope_takes_the_attention_block_slices():
    qkv = torch.randn((3, 20, 3 * 128))
    got = core.rope(qkv[..., 128:256], 2)
    torch.testing.assert_close(got, core.rope(qkv[..., 128:256].clone(), 2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("length", [352800, 352800 - 37])
def test_unnormalised_istft_is_torch_istft(length):
    """The model's inverse STFT: n_fft 2048, hop 441 (which does not divide
    the window), unnormalised, centred; the forward ``dsp.stft`` with
    ``normalized=False`` is ``torch.stft``'s."""
    n_fft, hop = 2048, 441
    x = 0.1 * torch.randn((2, length), generator=torch.Generator()
                          .manual_seed(1))
    win = torch.hann_window(n_fft)
    z = dsp.stft(x, n_fft, hop, normalized=False)
    want_z = torch.stft(x, n_fft, hop, win_length=n_fft, window=win,
                        center=True, pad_mode="reflect", normalized=False,
                        return_complex=True)
    assert z.shape == (2, 1025, length // hop + 1)
    torch.testing.assert_close(z, want_z, rtol=0, atol=0)
    got = dsp.istft(z, length, n_fft, hop, normalized=False)
    want = torch.istft(z, n_fft, hop, win_length=n_fft, window=win,
                       center=True, normalized=False, length=length)
    assert torch.equal(got, want)
    # the round trip gives the signal back
    torch.testing.assert_close(got, x, rtol=0, atol=1e-6)
    # the orthonormal path is unchanged by the new argument
    assert torch.equal(dsp.istft(z, length, n_fft, hop),
                       dsp.istft(z, length, n_fft, hop, normalized=True))


def _separator(model, **kw) -> Separator:
    return Separator(model, device="cpu", segment_seconds=0.5,
                     overlap_seconds=0.375, **kw)


def test_separate_all_pcm_matches_the_reference(model):
    sep = _separator(model)
    rng = np.random.default_rng(4)
    song = np.round(np.clip(0.1 * rng.standard_normal((2, 30001)), -1, 1)
                    * 32767).astype(np.int16)
    stems = list(reversed(model.stems))
    pcm, scales = sep.separate_all_pcm(song, stems, group_chunks=4)
    assert pcm.shape == (len(stems), 2, 30001) and pcm.dtype == np.int16
    scale = protocols.pcm_scale(song)
    np.testing.assert_allclose(scales, scale, rtol=1e-6)
    x = torch.from_numpy(song).float() / 32768.0
    want = ref.stems(model.state_dict(), _ref_cfg(model.cfg), x, sep.segment,
                     sep.overlap)
    order = [model.stems.index(s) for s in stems]
    want_q = protocols.quantise(want[order], scale).numpy()
    bf16_q = protocols.quantise(ref.stems(
        model.state_dict(), _ref_cfg(model.cfg), x, sep.segment, sep.overlap,
        Prec("bf16"))[order], scale).numpy()
    diff = np.abs(pcm.astype(np.int64) - want_q)
    # f32 against f32: a sample sits within one int16 step (a rounding that
    # falls the other way), and few do; bf16 operands move the stems ~0.5 %,
    # a step or more on most samples at these levels
    assert diff.max() <= 1 and diff.mean() < 0.01
    assert np.abs(bf16_q - want_q).mean() > 30 * 0.01


def test_separate_pcm_is_one_stem_of_the_sweep(model):
    sep = _separator(model)
    song = (0.1 * np.random.default_rng(6).standard_normal((2, 12000))
            ).astype(np.float32)
    stem = model.stems[-1]
    one = sep.separate_pcm(song, stem)
    flat = sep.separate(song, stem)
    assert one.shape == (2, 12000) and one.dtype == np.int16
    np.testing.assert_array_equal(
        one, np.clip(np.round(flat * 32767.0), -32767, 32767))


def test_separator_refuses_what_bs_roformer_does_not_have():
    model = br.init(br.TINY, seed=0)
    sep = _separator(model)
    song = np.zeros((2, 8000), np.float32)
    with pytest.raises(ValueError, match="no stem"):
        sep.separate_all_pcm(song, ["vocals", "drums"])
    with pytest.raises(ValueError, match="no stem"):
        sep.separate_pcm(song, "the vocals")
    with pytest.raises(TypeError, match="stem names"):
        sep.text_embedding("vocals")
    with pytest.raises(ValueError, match="whole-song only"):
        StreamingSeparator(sep, stems=("vocals",))
    with pytest.raises(ValueError, match="no mesh"):
        Separator(model, mesh=make_mesh(["cpu"] * 2))


def test_published_widths():
    with torch.device("meta"):
        m = br.BSRoformer(br.PUBLISHED)
    sd = m.state_dict()
    assert sum(t.numel() for t in sd.values()) == 159_758_028
    assert len(br.PUBLISHED.freqs_per_bands) == 62
    # lucidrains' state_dict names and shapes
    for name, shape in {
            "band_split.to_features.61.0.gamma": (516,),
            "band_split.to_features.61.1.weight": (512, 516),
            "layers.11.0.layers.0.0.to_qkv.weight": (1536, 512),
            "layers.11.1.layers.0.0.to_gates.weight": (8, 512),
            "layers.0.1.layers.0.0.to_out.0.weight": (512, 512),
            "layers.0.0.layers.0.1.net.4.weight": (512, 2048),
            "final_norm.gamma": (512,),
            "mask_estimators.0.to_freqs.61.0.0.weight": (2048, 512),
            "mask_estimators.0.to_freqs.61.0.2.weight": (1032, 2048)}.items():
        assert tuple(sd[name].shape) == shape


def test_forward_records_its_span():
    model = br.init(br.TINY, seed=0)
    with torch.profiler.profile() as prof:
        br.forward(model, _wav(1, 2000))
    assert "atsm.model.bs_roformer" in {e.name for e in prof.events()}


def test_atht_pcm_is_its_encoder_and_heads_bit_for_bit():
    """The seam BS-RoFormer added to the Separator leaves ATHT's path as it
    was: ``separate_all_pcm`` equals ``encode_mixture`` then
    ``apply_head_multi`` over the same groups, composed here by hand."""
    model = atht.init_tiny(0)
    sep = Separator(model, device="cpu", segment_seconds=0.5,
                    overlap_seconds=0.05)
    song = (0.1 * np.random.default_rng(7).standard_normal((2, 50000))
            ).astype(np.float32)
    stems = ["vocals", "bass"]
    pcm, _ = sep.separate_all_pcm(song, stems, group_chunks=4)

    n = song.shape[-1]
    grid = chunked.plan_chunks(n, sep.segment, sep.overlap, sep.bucket)
    hop, seg = grid.hop, grid.segment
    scale = max(2.0 * float(np.abs(song).max()), 1e-8)
    embs = torch.stack([sep.text_embedding(s) for s in stems])
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
            chunks = chunked.frame_song(piece, ggrid, padded=True)
            enc = atht.encode_mixture(model, chunks, torch.float32, True)
            out = atht.apply_head_multi(model, enc, embs)    # (S, g, 2, L)
            flat = out.permute(1, 0, 2, 3).reshape(g, 4, -1)
            valid = (start + torch.arange(g) * hop) < n
            a, ws = chunked.overlap_add_weighted(flat, ggrid, sep.overlap,
                                                 valid, normalize=False)
            a[:, :acc.shape[-1]] += acc
            ws[:w.shape[-1]] += w
            emit = a[:, :g * hop] / torch.clamp(ws[:g * hop], min=1e-8)
            q = torch.clamp(torch.round(emit / scale * 32767.0), -32768,
                            32767).to(torch.int16)
            want[:, start:start + take] = q.numpy()[:, :take]
            acc, w = a[:, g * hop:], ws[g * hop:]
            start += g * hop
    np.testing.assert_array_equal(pcm, want.reshape(2, 2, n))
