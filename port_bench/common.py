"""The benchmark's yardstick: statistics, the table of peaks, work arithmetic,
kernel groups, the trace reduction and the module guard.

Several pieces are copies, frozen here so that a change to the program
cannot move the yardstick:

- ``busy_union``, ``KERNEL_GROUPS`` / ``kernel_group`` and
  ``HOST_LAUNCHES``: from ``chip_smoke.py`` (``_device_busy_us``,
  ``KERNEL_GROUPS``, ``kernel_group``, ``HOST_LAUNCHES``; the graph
  launch added, since a replay is one ``cudaGraphLaunch``);
- ``bound``, ``layer_work`` and ``henc_work``: from ``chip_smoke.py``
  (``bound``, ``_layer_work``, and the operations and bytes of
  ``_henc_form``), with its peaks (``MEMORY_BYTES_PER_S`` and the bf16
  tensor rate, NVIDIA's H100 SXM data sheet).
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
MEMORY_BYTES_PER_S = 3.35e12

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "audio_to_sheet_music_tpu")

HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")

# kernel-name fragments -> the layer of the path they belong to (first match)
KERNEL_GROUPS = [("layer_tail / attn_block", ("gemm_kernel<", "flash_kernel",
                                               "ln_kernel")),
                 ("henc_freq_fused", ("henc_",)),
                 ("DConv routine (henc_freq_fused, dconv_rows)", ("dconv::",)),
                 ("STFT kernel", ("stft_kernel",)),
                 ("GroupNorm statistics", ("RowwiseMoments",)),
                 ("cuDNN convolution", ("cudnn", "conv", "implicit", "dgrad",
                                        "fprop")),
                 ("matrix products", ("gemm", "cutlass", "xmma", "sm90",
                                      "nvjet")),
                 ("FFT", ("fft",)),
                 ("copies to the host", ("Memcpy DtoH",)),
                 ("copies to the card", ("Memcpy HtoD",)),
                 ("casts and copies", ("copy",)),
                 ("elementwise", ("elementwise",)),
                 ("reductions", ("reduce",))]

# the device kernels of each hand-written kernel's launch
LAYER_TAIL_KERNELS = ("gemm_kernel<", "flash_kernel", "ln_kernel")
HENC_KERNELS = ("henc_", "dconv::")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The modules among ``names`` whose top-level name (before the first
    dot) is one of ``FORBIDDEN_MODULES``, compared whole: the port's
    ``audio_to_sheet_music_tpu_torch`` passes."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def check_no_jax(where: str) -> None:
    """Exit with code 3, naming what was found, if the process holds JAX
    or the JAX package."""
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"port_bench: {where}: forbidden modules loaded: "
              f"{', '.join(found[:20])}", file=sys.stderr)
        raise SystemExit(3)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def median(values: Sequence[float]) -> float:
    return float(statistics.median(values))


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by ``statistics.quantiles(method=
    'inclusive')``: linear between the order statistics."""
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=1000, method="inclusive")
    k = int(round(q * 10))
    return float(cuts[k - 1]) if 0 < k < 1000 else float(
        min(values) if k <= 0 else max(values))


def window_rate(amounts: Sequence[float], starts: Sequence[float],
                ends: Sequence[float]) -> Tuple[float, float]:
    """(sum of ``amounts`` / wall, wall): the wall runs from the first
    start to the last end."""
    wall = max(ends) - min(starts)
    return sum(amounts) / wall, wall


# ---------------------------------------------------------------------------
# work arithmetic
# ---------------------------------------------------------------------------

def bound(flops: float, nbytes: float, flop_rate: float = PEAK_BF16_FLOPS
          ) -> Dict:
    """The least time the chip could take, in seconds, and which of the
    two bounds sets it."""
    t_ops, t_bytes = flops / flop_rate, nbytes / MEMORY_BYTES_PER_S
    return {"bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def layer_work(b: int, l: int, s: int, d: int, ff: int) -> Tuple[float, float]:
    """Operations and bytes of one ``layer_tail`` launch: ``b`` rows of
    ``l`` query tokens over ``s`` key tokens, width ``d``, FF ``ff``; bf16
    activations and weights, f32 vectors, each read once."""
    flops = 2.0 * b * l * (2 * d * d + 2 * s * d + 2 * d * ff)
    nbytes = (2 * (2 * b * l * d + 2 * b * s * d) + 2 * (2 * d * d + 2 * d * ff)
              + 4 * (8 * d + ff) + 2 * b * l * d)
    return flops, float(nbytes)


def henc_work(b: int, t: int, cin: int = 4, f: int = 2048, c: int = 48
              ) -> Tuple[float, float]:
    """Operations and bytes of one ``henc_freq_fused`` launch: ``b`` rows of
    a (cin, f, t) CaC spectrogram -> (c, f / 4, t), the strided conv, the
    DConv (hidden c / 8) and the rewrite; bf16 in and out."""
    fo, h = f // 4, c // 8
    flops = 2.0 * b * fo * t * (c * cin * 8 + 2 * (h * c * 3 + 2 * c * h)
                                + 2 * c * c)
    nbytes = 2.0 * (b * cin * f * t + b * c * fo * t)
    return flops, nbytes


def token_counts(segment: int, hop: int, depth: int = 4) -> Tuple[int, int]:
    """(frequency tokens, time tokens) at the transformer for a chunk of
    ``segment`` samples: ceil(segment / hop) frames times 2048 / 4**depth
    bins; the waveform divided by 4 ``depth`` times, padded up each time."""
    frames = math.ceil(segment / hop)
    t = segment
    for _ in range(depth):
        t = math.ceil(t / 4)
    return (2048 // 4 ** depth) * frames, t


def transformer_bound(b: int, lf: int, lt: int, layers: int, d: int, ff: int
                      ) -> Tuple[float, int]:
    """Summed bound seconds and launch count of the cross-domain
    transformer's ``layer_tail`` launches for ``b`` chunks: per layer index,
    one launch a branch; self attention at even indices, cross at odd."""
    total, n = 0.0, 0
    for i in range(layers):
        pairs = [(lf, lf), (lt, lt)] if i % 2 == 0 else [(lf, lt), (lt, lf)]
        for l, s in pairs:
            total += bound(*layer_work(b, l, s, d, ff))["bound_s"]
            n += 1
    return total, n


# ---------------------------------------------------------------------------
# trace reduction
# ---------------------------------------------------------------------------

def busy_union(spans: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, parts in KERNEL_GROUPS:
        if any(p.lower() in low for p in parts):
            return group
    return "other"


def idle_gaps(spans: Sequence[Tuple[float, float]], t0: float, t1: float
              ) -> List[Tuple[float, float]]:
    """The intervals of ``[t0, t1]`` no span covers, longest first."""
    gaps, end = [], t0
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
    if end < t1:
        gaps.append((end, t1))
    return sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])
