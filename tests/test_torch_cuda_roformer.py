"""BS-RoFormer's gated attention on the card, and the shared flash launch
left as it was for ATHT.

Marked ``cuda``: each test skips without a card (decided in a fixture, not
at import).  On a machine with one, run them without the JAX test
configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_roformer.py

- ``attn_gated`` against ``attn_gated_plain`` at the serving group's two
  shapes (four 8 s chunks: 248 sequences of 801 frames on the time axis,
  3,204 of 62 bands on the band axis, width 512) and at the flash launch's
  tile edges, with ``attn_block``'s tolerance (a few bf16 output steps);
  ``rope_qkv`` against ``rope_qkv_plain`` at the same shapes, within one
  bf16 step (the same f32 rotation, one rounding, a product that may
  contract to a fused multiply-add);
- ``layer_tail`` and ``attn_block`` at a serving form give the bytes they
  gave before the gated form joined the flash launch: SHA-256 digests of
  their outputs on seeded inputs, read on an NVIDIA H100 80GB HBM3 from the
  kernels as they were (``python tests/test_torch_cuda_roformer.py`` from a
  checkout, with the checkout on ``PYTHONPATH``, prints them);
- the kernel parity gate on the full-width model, and a ``Separator``'s
  group programs booking ``attn_gated`` and ``rope_qkv`` through their
  replays.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu_torch.ops import fused_attn, fused_rope

pytestmark = pytest.mark.cuda

# (B, L) of the serving group's two axes, and the flash launch's edges:
# one key tile, one past it, one query tile, a ragged band tile
GATED_FORMS = [(4 * 62, 801), (4 * 801, 62), (2, 128), (3, 129), (5, 64),
               (7, 1)]
# digests of the ATHT launches on seeded inputs, from the kernels before
# the gated form (NVIDIA H100 80GB HBM3, 700 W)
ATHT_SHA256 = {
    "layer_tail":
        "c0bee0d2c665b77fe07860441c28eecbd17da7727b3dd06fe0bce2db4f5ac5f1",
    "attn_block":
        "66639303e08fc29f5949085e00071f1bc3ac4cc2e2a1cf9d413c3d5eea840ca4"}


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


def _gated_args(b, l, d, gen):
    def bf(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            "cuda", torch.bfloat16).contiguous()
    return [bf(b, l, d), bf(b, l, d), bf(b, l, d), bf(b, l, d // 64),
            bf(b, l, d), bf(d, d, scale=d ** -0.5)]


@pytest.mark.parametrize("b,l", GATED_FORMS)
def test_attn_gated_matches_plain(gen, b, l):
    args = _gated_args(b, l, 512, gen)
    before = fused_attn.attn_gated.launches
    with torch.inference_mode():
        got = fused_attn.attn_gated(*args, 8)
        want = fused_attn.attn_gated_plain(*args, 8)
    torch.cuda.synchronize()
    assert fused_attn.attn_gated.launches == before + 1
    assert got.shape == (b, l, 512) and got.dtype == torch.bfloat16
    _close(got, want, 4 * 2.0 ** -8, 2.0 ** -8)


@pytest.mark.parametrize("b,l,heads", [(4 * 62, 801, 8), (4 * 801, 62, 8),
                                       (3, 1, 8), (2, 37, 2)])
def test_rope_qkv_matches_plain(gen, b, l, heads):
    qkv = torch.randn((b, l, 3 * 64 * heads), generator=gen).to(
        "cuda", torch.bfloat16)
    before = fused_rope.rope_qkv.launches
    with torch.inference_mode():
        got = fused_rope.rope_qkv(qkv, heads)
        want = fused_rope.rope_qkv_plain(qkv, heads)
    torch.cuda.synchronize()
    assert fused_rope.rope_qkv.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.shape == w.shape
        step = torch.where(w == 0, torch.ones_like(w.float()),
                           w.float().abs()) * 2.0 ** -7
        assert bool(((g.float() - w.float()).abs() <= step).all())
    assert torch.equal(got[2], want[2])                  # v: copied


def test_rope_qkv_refuses_what_it_cannot_take(gen):
    qkv = torch.randn((1, 5, 3 * 128), device="cuda")
    with pytest.raises(TypeError):
        fused_rope.rope_qkv(qkv, 2)
    with pytest.raises(ValueError):
        fused_rope.rope_qkv(qkv.bfloat16()[..., :-3], 2)


def test_attn_gated_gates_each_head(gen):
    """A gate of -inf shuts a head out, +inf lets it through whole: the
    kernel's gate is per row and head, not per column block."""
    q, k, v, gate, x, wo = _gated_args(2, 300, 512, gen)
    gate = torch.full_like(gate, 30.0)
    gate[:, :, 3] = -30.0
    with torch.inference_mode():
        got = fused_attn.attn_gated(q, k, v, gate, x, wo, 8)
        wo_cut = wo.clone()
        wo_cut[:, 3 * 64:4 * 64] = 0
        want = fused_attn.attn_gated_plain(q, k, v, torch.full_like(gate, 30),
                                           x, wo_cut, 8)
    _close(got, want, 4 * 2.0 ** -8, 2.0 ** -8)


def test_attn_gated_refuses_what_it_cannot_take(gen):
    args = _gated_args(1, 8, 128, gen)
    bad = list(args)
    bad[3] = bad[3].float()
    with pytest.raises(TypeError):
        fused_attn.attn_gated(*bad, 2)
    with pytest.raises(ValueError):
        fused_attn.attn_gated(*args, 4)          # 32-wide heads
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_attn.attn_gated(*args, 2)


def atht_digests() -> dict:
    """SHA-256 of ``layer_tail`` (a freq self form of a serving group) and
    ``attn_block`` (its cross form) on seeded inputs."""
    g = torch.Generator().manual_seed(17)

    def n(*shape, scale=1.0, dt=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to("cuda", dt)

    b, lq, lk, d, ff = 4, 2072, 1034, 512, 2048
    f32 = torch.float32
    layer = [n(b, lq, d), n(b, lq, d), n(b, lq, d), n(b, lq, d),
             n(d, d, scale=d ** -0.5), n(d, scale=0.1, dt=f32),
             n(d, d, scale=d ** -0.5), n(d, scale=0.1, dt=f32),
             n(d, scale=0.1, dt=f32) + 0.5, n(d, scale=0.1, dt=f32) + 1.0,
             n(d, scale=0.1, dt=f32), n(ff, d, scale=d ** -0.5),
             n(ff, scale=0.1, dt=f32), n(d, ff, scale=ff ** -0.5),
             n(d, scale=0.1, dt=f32), n(d, scale=0.1, dt=f32) + 0.5]
    block = [n(b, lq, d), n(b, lk, d), n(b, lk, d), n(b, lq, d),
             n(d, d, scale=d ** -0.5), n(d, scale=0.1, dt=f32),
             n(d, scale=0.1, dt=f32) + 0.5]
    with torch.inference_mode():
        outs = {"layer_tail": fused_attn.layer_tail(*layer, 8),
                "attn_block": fused_attn.attn_block(*block, 8)}
    torch.cuda.synchronize()
    return {k: hashlib.sha256(v.view(torch.int16).cpu().numpy().tobytes())
            .hexdigest() for k, v in outs.items()}


def test_atht_launches_give_the_bytes_they_gave(gen):
    assert atht_digests() == ATHT_SHA256


@pytest.fixture(scope="module")
def roformer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from audio_to_sheet_music_tpu_torch.models import bs_roformer

    return bs_roformer.init(bs_roformer.PUBLISHED, seed=0, device="cuda")


def test_parity_gate_passes_on_the_full_width_model(roformer):
    from audio_to_sheet_music_tpu_torch.ops import kernel_gate

    res = kernel_gate.verify_layer_parity(roformer, torch.bfloat16,
                                          kernels="default")
    assert res["ok"], res
    # one layer: the time and the band transformer's launches
    assert res["launches"] == {"attn_gated": 2, "rope_qkv": 2}


def test_group_programs_book_the_gated_launches(roformer):
    from audio_to_sheet_music_tpu_torch.infer import Separator, chunked
    from audio_to_sheet_music_tpu_torch.ops import select

    sep = Separator(roformer, device="cuda", segment_seconds=8.0,
                    overlap_seconds=6.0, deterministic=True)
    song = (0.3 * np.random.default_rng(0).standard_normal((2, 20 * 44100))
            ).astype(np.float32)
    grid = chunked.plan_chunks(song.shape[-1], sep.segment, sep.overlap,
                               sep.bucket)
    schedule = sep._group_schedule(grid, 4)
    assert schedule == [2, 4, 4]
    first, _ = sep.separate_all_pcm(song, ["vocals"])
    before = select.launch_counts()
    second, _ = sep.separate_all_pcm(song, ["vocals"])
    after = select.launch_counts()
    for kernel in ("attn_gated", "rope_qkv"):
        assert after[kernel] - before[kernel] == 24 * 3
    np.testing.assert_array_equal(first, second)
    assert np.abs(first).max() > 0


if __name__ == "__main__":
    print(json.dumps(atht_digests()))
