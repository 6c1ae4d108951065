"""Timing and profiling helpers: the counterpart of
``audio_to_sheet_music_tpu/utils/profiling.py``.

- ``timed``: warm-up calls, then the wall of ``iters`` calls, each ending
  in ``torch.cuda.synchronize`` when the card is in use.
- ``loop_cost``: the per-call seconds of a body as the slope between two
  loop counts, which cancels the fixed cost of launching and synchronising.
- ``trace``: ``torch.profiler`` around a block, a Chrome trace written into
  ``log_dir``.
- ``flops_estimate``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  for one call.
- ``peak_tflops``: the card's dense bf16 tensor peak, the denominator of a
  utilisation and of ``chip_smoke.py``'s bounds.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

#: dense bf16 tensor-core peaks (TFLOP/s) from the vendor's data sheet,
#: keyed by a substring of ``torch.cuda.get_device_name``: the H100 SXM
#: (the PCIe card, a lower peak, is not listed)
PEAK_BF16_TFLOPS = {"H100 80GB HBM3": 989.0, "H100 SXM": 989.0}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> dict:
    """-> ``{"mean_s", "best_s", "iters"}``: wall seconds per call after
    ``warmup`` calls, each call ending in a device synchronise."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return {"mean_s": sum(times) / len(times), "best_s": min(times),
            "iters": iters}


def loop_cost(body: Callable, *args, n1: int = 4, n2: int = 24,
              iters: int = 3) -> float:
    """Seconds per call of ``body(*args)`` without the fixed cost of a
    timed region: the best wall of ``n1`` and of ``n2`` calls in a row
    (interleaved ``iters`` times), and their slope
    ``(T(n2) - T(n1)) / (n2 - n1)``."""
    def run(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            body(*args)
        _sync()
        return time.perf_counter() - t0

    run(n1)
    best1 = best2 = float("inf")
    for _ in range(iters):
        best1 = min(best1, run(n1))
        best2 = min(best2, run(n2))
    return (best2 - best1) / (n2 - n1)


@contextlib.contextmanager
def trace(log_dir: str = "atsm_trace"):
    """``with trace(d): step()`` profiles the CPU and, where a card is in
    use, CUDA activity, and writes ``trace.json`` (Chrome trace format)
    into ``d``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def flops_estimate(fn: Callable, *args) -> float:
    """Floating-point operations of one call of ``fn(*args)`` as PyTorch's
    ``FlopCounterMode`` counts them (matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops())


def peak_tflops(device_name: str | None = None) -> float:
    """Dense bf16 tensor peak of the card (``torch.cuda.get_device_name``
    unless ``device_name`` is given), in TFLOP/s: 989 for the H100 SXM.
    Raises on a card it does not know."""
    name = device_name or torch.cuda.get_device_name(0)
    for key, peak in PEAK_BF16_TFLOPS.items():
        if key in name:
            return peak
    raise ValueError(f"no known bf16 peak for {name!r}")
