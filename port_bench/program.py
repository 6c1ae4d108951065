"""The system under test, built from a configuration file and the
benchmark's seeded weights: the port's modules are made on the meta device
(no storage, no draws) and take the weights by ``load_state_dict(strict=
True, assign=True)``, so the parameters are the tensors drawn on the card.
Also the pieces every driver shares: a seeded pool of songs, the sample of
finished requests the reference checks, and the check's arithmetic."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import synth, weights


def _atht_modules(cfg: Dict):
    from audio_to_sheet_music_tpu_torch.models import atht, clap_text, htdemucs

    return atht.AudioTextHTDemucs(
        htdemucs.HTDemucs(channels=tuple(cfg["channels"]),
                          bottom_channels=cfg["bottom_channels"],
                          t_layers=cfg["transformer_layers"]),
        clap_text.ClapText(num_layers=cfg["text_layers"],
                           hidden=cfg["text_hidden"], ff=cfg["text_ff"],
                           vocab_size=cfg["text_vocab"],
                           projection_dim=cfg["projection_dim"]),
        atht.Head(decoder_channels=tuple(cfg["decoder_channels"]),
                  text_dim=cfg["projection_dim"]))


def build(cfg: Dict, seed: int, device) -> tuple:
    """(port module, weights by name) for the configuration's ``model``
    (``atht``)."""
    make = {"atht": _atht_modules}[cfg["model"]]
    with torch.device("meta"):
        module = make(cfg)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    params = weights.make(shapes, seed, device)
    module.load_state_dict(params, strict=True, assign=True)
    return module, params


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for the traffic, apart from the weights'."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 7919 * (stream + 1)) % (2 ** 63))
    return gen


def balanced(k: int, seed: int) -> List[int]:
    """0..k-1 in bit-reversed order (every run of consecutive entries
    spreads over the whole range), rotated by an offset drawn from the
    seed: each seed gets the same set in its own order, and a window that
    ends anywhere has served an even spread of it."""
    bits = max(1, (k - 1).bit_length())
    rev = sorted(range(2 ** bits),
                 key=lambda i: int(format(i, f"0{bits}b")[::-1], 2))
    order = [i for i in rev if i < k]
    off = int(np.random.default_rng(int(seed) + 29).integers(k))
    return order[off:] + order[:off]


def songs(seed: int, device, lo: float, hi: float, k: int,
          dtype: str = "float32") -> List[Dict]:
    """``k`` songs with the stratified lengths of [lo, hi] s, in the
    seed's ``balanced`` order: each ``{"seconds", "mixture" (2, T) host
    array}``; int16 mixtures are ``round(x * 32767)``."""
    gen = generator(seed, device, 1)
    out = []
    # made in the order of their lengths, so the card's allocations are the
    # same for every seed; served in the seed's order
    for seconds in synth.stratified(lo, hi, k):
        s = synth.song(seconds, gen, device)
        mix = s[0]
        if dtype == "int16":
            mix = torch.round(mix * 32767).to(torch.int16)
        out.append({"seconds": seconds, "mixture": mix.cpu().numpy()})
    return [out[i] for i in balanced(k, seed)]


def sample(records: List[Dict], key: str, n: int, seed: int) -> List[Dict]:
    """Up to ``n`` finished records holding ``key`` (their output), drawn
    from the seed, the longest (by ``seconds``) always among them."""
    done = [r for r in records if not r.get("failed") and key in r]
    if not done:
        return []
    longest = max(done, key=lambda r: r["seconds"])
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(int(seed) + 17)
    pick = list(rng.choice(len(rest), size=min(n - 1, len(rest)),
                           replace=False)) if rest and n > 1 else []
    return [longest] + [rest[i] for i in sorted(pick)]


def rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    """rms(got - want) / rms(want) in float64 over the samples both hold
    as finite numbers; inf where one side is finite and the other not (the
    reference's own non-finite samples, where the model divides by zero,
    must come out non-finite in the program too)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    fg, fw = np.isfinite(g), np.isfinite(w)
    if not np.array_equal(fg, fw):
        return math.inf
    g, w = g[fw], w[fw]
    return float(np.sqrt(np.mean((g - w) ** 2)) / max(
        np.sqrt(np.mean(w ** 2)), 1e-30))


def gap(got: float, want: float) -> float:
    """|got - want|; 0 where both are non-finite alike, inf where only one
    is."""
    if not math.isfinite(got) or not math.isfinite(want):
        same = (math.isnan(got) and math.isnan(want)) or got == want
        return 0.0 if same else math.inf
    return abs(got - want)


def worst(values: Sequence[float]) -> float:
    return float(max(values)) if values else math.inf


def dtype(cfg: Dict) -> torch.dtype:
    """The configuration's compute dtype."""
    return getattr(torch, cfg["compute_dtype"])


def separator(model, cfg: Dict, traffic: Dict, device):
    """The app protocol's ``Separator`` (``apps/serve.build_separator``)
    with the benchmark's model: segment and overlap from the traffic,
    normalised text features, deterministic cuDNN, the default kernels."""
    from audio_to_sheet_music_tpu_torch.infer.session import Separator

    return Separator(model, segment_seconds=traffic["segment_seconds"],
                     overlap_seconds=traffic["overlap_seconds"],
                     compute_dtype=dtype(cfg), device=device,
                     normalize_text=True,
                     kernels=traffic.get("kernels", "default"),
                     deterministic=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> Dict[str, int]:
    """The port's kernel launch counters (``ops.select``), replays booked."""
    from audio_to_sheet_music_tpu_torch.ops import select

    return select.launch_counts()


def count_flops(fn) -> float:
    """Operations of ``fn()`` as ``torch.utils.flop_counter`` counts them
    (matrix products, convolutions, attention)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def atht_chunk_flops(params, cfg: Dict, segment: int, n_stems: int,
                     device) -> float:
    """Operations of one chunk through the reference's encoder and
    ``n_stems`` heads (the text tower not included)."""
    from .reference import atht as ref_atht

    gen = generator(0, device, 9)
    chunk = 0.1 * torch.randn((1, 2, segment), generator=gen, device=device)
    embs = torch.randn((n_stems, cfg["projection_dim"]), generator=gen,
                       device=device)
    with torch.no_grad():
        return count_flops(lambda: ref_atht.forward(params, chunk, embs, cfg))


def text_flops(params, prompt: str, device) -> float:
    """Operations of one prompt through the reference's text tower."""
    from .reference import text

    ids, mask = text.tokenize([prompt])
    with torch.no_grad():
        return count_flops(lambda: text.embed(
            params, torch.from_numpy(ids).to(device),
            torch.from_numpy(mask).to(device), True))


def serve_bound(cfg: Dict, segment: int, batches, kernel: str) -> float:
    """Summed bound seconds of ``kernel``'s work over forwards of the chunk
    counts in ``batches``: ``layer_tail`` the transformer's layers,
    ``henc_freq_fused`` the first frequency encoder layer."""
    from . import common

    frames = math.ceil(segment / cfg["hop"])
    if kernel == "layer_tail":
        lf, lt = common.token_counts(segment, cfg["hop"],
                                     len(cfg["channels"]))
        return sum(common.transformer_bound(
            b, lf, lt, cfg["transformer_layers"], cfg["bottom_channels"],
            cfg["transformer_ff"])[0] for b in batches)
    if kernel == "henc_freq_fused":
        return sum(common.bound(*common.henc_work(
            b, frames, 4, cfg["nfft"] // 2, cfg["channels"][0]))["bound_s"]
            for b in batches)
    raise KeyError(kernel)
