"""Tracing, counting and profiling: the counterpart of
``audio_to_sheet_music_tpu/utils/profiling.py``.

- ``span``: a named host interval at a layer boundary of the program.
  While a ``torch.profiler`` session records it is
  ``torch.profiler.record_function``, so it lands in the profiler's trace
  beside the kernels, on their clock, nested by the calling thread's
  stack; otherwise it is ``OFF``, one shared no-op.  The profiler is the
  only switch.  Every name starts with ``atsm.``.  A thread the profiler
  does not follow (the loader's producer, unless the profiler was started
  with ``profile_all_threads``) records nothing.
- ``count``, ``counts``, ``reset_counts``: process-wide event counters
  (``counts()`` also carries the kernels' launch counters of
  ``ops.select.launch_counts`` as ``launches.<kernel>``), which
  ``apps/serve_http``'s ``/api/metrics`` exports.
- ``trace``: ``torch.profiler`` around a block, a Chrome trace written into
  ``log_dir``.
- ``flops_estimate``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  for one call.
- ``peak_tflops``: the card's dense bf16 tensor peak, the denominator of a
  utilisation and of ``chip_smoke.py``'s bounds.

Spans and the counters they sit beside, by layer:

- ``infer.session``: ``atsm.separate_all_pcm`` over the call, inside it
  ``atsm.pcm.scale`` (the mixture's peak, the group schedule and the
  groups' inputs), ``atsm.pcm.group`` a group (stage, program, clone, the
  copy to the host enqueued), then a piece at a time ``atsm.pcm.wait``
  (the wait on that piece's copy) and ``atsm.pcm.assemble`` (the piece
  into the int16 array, while later groups run on the card); counters
  ``chunks.computed`` (the chunks of the groups run), ``chunks.padded``
  (those starting at or past the song's end), ``pcm.pieces`` (pieces
  filled) and ``pcm.pieces_early`` (those whose fill started before the
  call's last copy had landed: the fills that overlap the card; none on
  the CPU).
  ``atsm.sweep``: a whole-song program and its copy to the host.
  ``text.cache_hits``: prompts whose embedding came from the cache.
- ``models.atht.encode_text``: ``atsm.model.text_tower``;
  ``text.tower_runs``.
- ``models.bs_roformer.forward``: ``atsm.model.bs_roformer`` on an eager
  forward (warm-up, the CPU, eager callers; none while a CUDA graph
  captures it); its attention launches are ``launches.attn_gated``.
- ``infer.programs.Program``: ``atsm.program.capture`` (construction: on
  a card the warm-up runs and the capture), ``atsm.program.replay`` (the
  inputs' copies and the replay); ``program.captures`` (programs built)
  and ``program.replays``.
- ``infer.streaming.StreamingSeparator``: ``atsm.stream.open``,
  ``atsm.stream.feed``, ``atsm.stream.block`` (one block's program, its
  carry and its piece) and ``atsm.stream.flush``; ``stream.blocks``.
- ``train.step``: ``atsm.train.step`` over ``atsm.train.forward``,
  ``atsm.train.backward`` and ``atsm.train.optimizer`` (clip, AdamW,
  schedule); ``train.trainer.put_batch``: ``atsm.train.put_batch``.
- ``data.musdb.BatchLoader``: ``atsm.data.wait`` (the consumer waiting for
  a batch) and ``atsm.data.make_batch`` (the producer thread).

No span sits inside a captured program's body: a replay runs no Python.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import Counter
from typing import Callable, ContextManager, Dict

import torch
from torch.autograd import profiler as _autograd_profiler

#: dense bf16 tensor-core peaks (TFLOP/s) from the vendor's data sheet,
#: keyed by a substring of ``torch.cuda.get_device_name``: the H100 SXM
#: (the PCIe card, a lower peak, is not listed)
PEAK_BF16_TFLOPS = {"H100 80GB HBM3": 989.0, "H100 SXM": 989.0}

#: what ``span`` returns while no profiler records
OFF = contextlib.nullcontext()

_counts: Counter = Counter()
_counts_lock = threading.Lock()


def span(name: str) -> ContextManager:
    """``with span("atsm.<layer>.<what>"):`` marks the block in a recording
    profiler's trace; with none recording, the shared no-op ``OFF``."""
    # the process-wide flag, not the calling thread's profiler state: a
    # thread the profiler follows only under ``profile_all_threads`` (the
    # loader's producer) reads its own state as off
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    with _counts_lock:
        _counts[name] += n


def counts() -> Dict[str, int]:
    """Every counter of the process by name, the kernels' launch counters
    (``ops.select.launch_counts``) among them as ``launches.<kernel>``."""
    from ..ops import select

    with _counts_lock:
        out = dict(_counts)
    out.update({f"launches.{k}": n for k, n in select.launch_counts().items()})
    return out


def reset_counts() -> None:
    """Set every counter, the kernels' launch counters too, to 0."""
    from ..ops import select

    with _counts_lock:
        _counts.clear()
    select.zero_launch_counts()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
