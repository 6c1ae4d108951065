"""SCNet on the card: the GroupNorm pair's SiLU, GELU and GLU left as they
were, the parity gate, the group programs and the recurrence's kernel
names.

Marked ``cuda``: each test skips without a card (decided in a fixture, not
at import).  On a machine with one, run them without the JAX test
configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_scnet.py

- ``gn1_apply``'s SiLU against ``group_norm_plain(act="silu")`` at the
  convolution modules' shapes of a songs group (four 11 s chunks: the
  three blocks' band rows, 16-64 channels of 476 frames), with the GroupNorm
  tests' bf16 tolerance (both round an f32 value once); the separation
  net's token norms likewise;
- the GELU and GLU forms give the bytes they gave before SiLU joined the
  kernel: SHA-256 digests of their outputs on seeded inputs, read on an
  NVIDIA H100 80GB HBM3 from the kernel as it was (``python
  tests/test_torch_cuda_scnet.py`` from a checkout, with the checkout on
  ``PYTHONPATH``, prints them);
- the kernel parity gate on the full-width model (the GroupNorm pair
  against its plain version through SD block 0 and dual-path layer 0);
- a ``Separator``'s group programs booking ``dual_path`` through their
  replays, two sweeps bit for bit alike; ``separate_pcm``'s whole-song
  program against them;
- the kernel-name fragments of ``scnet_rnn_roofline_pct.serve``: in an
  eager group of 2 and of 4 chunks they match cuDNN's per-step kernels
  inside the LSTM calls and no kernel launched outside them.
"""

from __future__ import annotations

import hashlib
import json
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu_torch.ops import fused_norm

pytestmark = pytest.mark.cuda

# digests of the GroupNorm pair's GELU and GLU forms on seeded inputs, from
# the kernel before SiLU joined it (NVIDIA H100 80GB HBM3, 700 W)
NORM_SHA256 = {
    "gelu": "7b136f07bc26d1d9cc42afdfb246b491070716e4745dc35de46d6e74d84516e7",
    "glu": "6b77d9248675f7982332c9400a1b1e7a49aa3f0f91bc4504a2fffdc661ac31dc",
    "none": "82c834ef8b38a6bad6b3253a8d68a3c859bc76915b3abf97a965bd4077d9281a"}
# (rows, channels, frames) of a songs group's convolution modules: band
# rows x 4 chunks of the three blocks' low bands, 476 frames
SILU_FORMS = [(4 * 462, 16, 476), (4 * 159, 32, 476), (4 * 55, 64, 476),
              (4 * 7, 64, 476)]
BF16_TOL = (8e-3, 2e-3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, max_rel, rms_rel):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    msg = (f"max err {float(err.max()):.4g} vs max|ref| "
           f"{float(w.abs().max()):.4g}, rms err "
           f"{float(err.pow(2).mean().sqrt()):.4g}")
    assert float(err.max()) <= max_rel * float(w.abs().max()), msg
    assert (float(err.pow(2).mean().sqrt())
            <= rms_rel * float(w.pow(2).mean().sqrt())), msg


def _norm_inputs(shape, c, seed):
    g = torch.Generator().manual_seed(seed)
    x = 0.7 + 2.0 * torch.randn(shape, generator=g)
    w = 1.0 + 0.2 * torch.randn(c, generator=g)
    b = 0.3 * torch.randn(c, generator=g)
    return x.to("cuda", torch.bfloat16), w.cuda(), b.cuda()


@pytest.mark.parametrize("shape", SILU_FORMS)
def test_silu_matches_plain(card, shape):
    x, w, b = _norm_inputs(shape, shape[1], 1)
    with torch.inference_mode():
        got = fused_norm.group_norm(x, w, b, 1, act="silu")
        want = fused_norm.group_norm_plain(x, w, b, 1, act="silu")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close(got, want, *BF16_TOL)


@pytest.mark.parametrize("shape", [(4, 85 * 476, 256), (4, 85 * 239, 512)])
def test_token_norms_match_plain(card, shape):
    x, w, b = _norm_inputs(shape, shape[-1], 2)
    with torch.inference_mode():
        got = fused_norm.group_norm(x, w, b, 1, layout="tokens")
        want = fused_norm.group_norm_plain(x, w, b, 1, layout="tokens")
    _close(got, want, *BF16_TOL)


def norm_digests() -> dict:
    """SHA-256 of the pair's GELU (a (B, C, F, T) decoder form), GLU (a
    DConv form) and plain (a token form) outputs on seeded inputs."""
    forms = {"gelu": ((4, 96, 259, 259), "channels"),
             "glu": ((4, 96, 66150), "channels"),
             "none": ((4, 2072, 512), "tokens")}
    out = {}
    with torch.inference_mode():
        for i, (act, (shape, layout)) in enumerate(forms.items()):
            c = shape[-1] if layout == "tokens" else shape[1]
            x, w, b = _norm_inputs(shape, c, 10 + i)
            y = fused_norm.group_norm(x, w, b, 1, act=act, layout=layout)
            out[act] = hashlib.sha256(
                y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    return out


def test_gelu_and_glu_give_the_bytes_they_gave(card):
    assert norm_digests() == NORM_SHA256


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from audio_to_sheet_music_tpu_torch.models import scnet

    return scnet.init(scnet.PUBLISHED, seed=0, device="cuda")


def test_parity_gate_passes_on_the_full_width_model(model):
    from audio_to_sheet_music_tpu_torch.ops import kernel_gate

    res = kernel_gate.verify_layer_parity(model, torch.bfloat16,
                                          kernels="default")
    assert res["ok"], res
    # SD block 0's 6 convolution module steps, 2 norms each, and the
    # dual-path layer's 2
    assert res["launches"] == {"group_norm": 14}


def test_group_programs_book_the_dual_path_layers(model):
    from audio_to_sheet_music_tpu_torch.infer import Separator, chunked
    from audio_to_sheet_music_tpu_torch.ops import select

    sep = Separator(model, device="cuda", segment_seconds=11.0,
                    overlap_seconds=8.25, deterministic=True)
    song = (0.3 * np.random.default_rng(0).standard_normal((2, 20 * 44100))
            ).astype(np.float32)
    grid = chunked.plan_chunks(song.shape[-1], sep.segment, sep.overlap,
                               sep.bucket)
    assert sep._group_schedule(grid, 4) == [2, 4, 4]
    stems = list(model.stems)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first, _ = sep.separate_all_pcm(song, stems)
    # the LSTMs' bf16 weights are one buffer each: cuDNN copies none of them
    assert not [w for w in caught if "contiguous chunk" in str(w.message)]
    before = select.launch_counts()
    second, _ = sep.separate_all_pcm(song, stems)
    after = select.launch_counts()
    assert after["dual_path"] - before["dual_path"] == 6 * 3
    np.testing.assert_array_equal(first, second)
    assert first.shape == (4, 2, song.shape[-1]) and np.abs(first).max() > 0


def test_separate_pcm_serves_a_stem_through_the_song_program(model):
    """``separate_pcm``'s whole-song program (one batch of the song's
    chunks, captured) gives the stem the group programs give, within the
    bf16 differences of another batch size's algorithms."""
    from audio_to_sheet_music_tpu_torch.infer import Separator

    sep = Separator(model, device="cuda", segment_seconds=11.0,
                    overlap_seconds=8.25, deterministic=True)
    song = (0.2 * np.random.default_rng(1).standard_normal((2, 20 * 44100))
            ).astype(np.float32)
    one = sep.separate_pcm(song, "bass")
    assert np.array_equal(one, sep.separate_pcm(song, "bass"))
    pcm, scales = sep.separate_all_pcm(song, ["bass"])
    got = one.astype(np.float64) / 32767.0
    want = pcm[0].astype(np.float64) * scales[0] / 32767.0
    assert one.shape == (2, song.shape[-1]) and one.dtype == np.int16
    rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    # both bf16; the int16 steps of the two scales and the convolutions'
    # algorithms at batches of 8 and of 2 or 4 chunks (the stems sit ~1 %
    # from the f32 reference, PERF.md §2)
    assert rel < 2e-2, rel


def _kernels_under(fn, name: str):
    """(kernels launched inside ranges called ``name``, kernels launched
    outside them) by name and count, from ``torch.profiler``'s link of
    each kernel to the host op that launched it."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    inside, outside = Counter(), Counter()
    for ev in prof.events():
        for k in ev.kernels:
            node = ev
            while node is not None and node.name != name:
                node = node.cpu_parent
            (inside if node is not None else outside)[k.name] += 1
    return inside, outside


def _fragments():
    from port_bench import harness

    path = (Path(__file__).resolve().parents[1] / "port_bench" / "metrics"
            / "scnet_rnn_roofline_pct.serve.py")
    return harness._module(path, "scnet_rnn_roofline_fragments").FRAGMENTS


@pytest.mark.parametrize("g", [2, 4])
def test_recurrence_fragments_match_only_the_lstm_calls(model, g,
                                                        monkeypatch):
    from audio_to_sheet_music_tpu_torch.models import scnet

    real = scnet.bilstm

    def marked(m, x):
        with torch.profiler.record_function("scnet.bilstm"):
            return real(m, x)

    monkeypatch.setattr(scnet, "bilstm", marked)
    chunks = 0.1 * torch.randn((g, 2, 485100), generator=torch.Generator()
                               .manual_seed(g)).cuda()
    with torch.inference_mode():
        scnet.forward(model, chunks, torch.bfloat16)        # warm
        inside, outside = _kernels_under(
            lambda: scnet.forward(model, chunks, torch.bfloat16),
            "scnet.bilstm")
    frags = _fragments()

    def hit(name):
        return any(f in name for f in frags)

    assert not [k for k in outside if hit(k)], outside
    # a step's kernels: the product and the cell update, once a step and
    # direction (3 x (476 + 85) + 3 x (239 + 85) steps, two directions)
    steps = 2 * (3 * (476 + 85) + 3 * (239 + 85))
    per_step = {k: n for k, n in inside.items() if n >= 2 * 85}
    assert all(hit(k) for k in per_step), per_step
    assert sum(n for k, n in inside.items() if "elemWiseRNNcell" in k) == steps
    assert sum(n for k, n in per_step.items()
               if "elemWiseRNNcell" not in k) == steps


if __name__ == "__main__":
    print(json.dumps(norm_digests()))
