"""Operations and bytes of BS-RoFormer's hand-written launches, the
numerators of ``roformer_attn_roofline_pct`` and
``roformer_rope_roofline_pct``.

- ``attn_gated`` (``ops.fused_attn``): one transformer's attention over
  ``b`` sequences of ``l`` tokens, width ``d`` in ``heads`` heads:
  ``4·l·l·d`` operations a sequence for ``q kᵀ`` and ``P v`` over all
  heads, plus the out-projection's ``2·l·d·d``; bytes are q, k, v, the
  gate's logits and the residual read once and the output written once,
  all bf16 (the scratch between the flash launch and the GEMM is not
  counted).
- ``rope_qkv`` (``ops.fused_rope``): the packed projection (``b·l`` rows of
  ``3·d`` bf16) read once and q, k, v written once; 6 operations a turned
  pair (q and k: ``b·l·d`` pairs).

A chunk group of ``g`` chunks makes, a layer, one launch of each on the
time axis (``g·bands`` sequences of ``frames`` tokens) and one on the band
axis (``g·frames`` sequences of ``bands``)."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from . import common


def gated_attn_work(b: int, l: int, d: int, heads: int
                    ) -> Tuple[float, float]:
    """(operations, bytes) of one ``attn_gated`` launch."""
    flops = b * (4.0 * l * l * d + 2.0 * l * d * d)
    nbytes = b * l * (5 * d + heads) * 2.0
    return flops, nbytes


def rope_work(b: int, l: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of one ``rope_qkv`` launch."""
    rows = b * l
    return 6.0 * rows * d, 2 * rows * 3 * d * 2.0


def frames(cfg: Dict, segment: int) -> int:
    """STFT frames of a ``segment``-sample chunk (centred: T // hop + 1)."""
    return segment // cfg["stft_hop_length"] + 1


def launches_per_group(cfg: Dict) -> int:
    """Launches of each kernel a chunk group: one a transformer."""
    return 2 * cfg["depth"]


def window_bound(cfg: Dict, segment: int, groups: Iterable[int],
                 kernel: str) -> float:
    """Summed bound seconds of ``kernel``'s launches (``attn_gated`` or
    ``rope_qkv``) for chunk groups of the given sizes, at the bf16 tensor
    peak and the memory rate."""
    t, nb = frames(cfg, segment), len(cfg["freqs_per_bands"])
    d, heads = cfg["heads"] * cfg["dim_head"], cfg["heads"]
    work = {"attn_gated": lambda b, l: gated_attn_work(b, l, d, heads),
            "rope_qkv": lambda b, l: rope_work(b, l, d)}[kernel]
    total = 0.0
    for g in groups:
        per_layer = (common.bound(*work(g * nb, t))["bound_s"]
                     + common.bound(*work(g * t, nb))["bound_s"])
        total += cfg["depth"] * per_layer
    return total
