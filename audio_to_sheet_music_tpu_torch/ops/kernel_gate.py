"""Parity gate for the hand-written kernels, on the card they run on.

Counterpart of ``audio_to_sheet_music_tpu/ops/kernel_gate.py``.  The
kernels' tests compare each one with its plain version at chosen shapes;
this gate runs the model's own forward of a 6 s chunk (``gate_pair``)
twice on the live device, per op (``kernels="none"``) and with the
separator's selection, same inputs and weights, and compares the outputs.

On divergence beyond the threshold (1e-3 rms on a ~0.1-rms stem) it
**raises** ``KernelParityError``, naming the rms, the reference's rms, the
threshold, the selection and the card.  The JAX gate vetoes the kernel and
falls back to the per-op path; the port allows no fallback that hides a
kernel, so a session whose kernels diverge does not start.

The gate runs once per process for each (selection, device, model class)
and covers whatever selection it is given (the JAX gate covers ``layer`` +
``enc``, its default).  It skips where no kernel would run or be checked:
a CPU device (the wrappers take their plain versions there), the ``none``
selection, a card where the kernel pass launched no kernel (the model's
own routing found no width a kernel of the selection takes: the wrappers'
launch counters say so, ``select.launch_counts``), and
``ATSM_SKIP_PARITY_GATE=1``, the JAX package's own opt-out.
``verify_layer_parity`` reads no environment: the selection is an
argument.

Call site: ``infer.session.Separator`` construction, on each distinct
device of its mesh.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .select import (NONE, Kernels, KernelSelection, launch_counts, name,
                     resolve)

RMS_THRESHOLD = 1e-3      # ~0.1 dB-budget grade on unit-order stems
GATE_SECONDS = 6.0        # one serving chunk (the shapes that matter)
SAMPLE_RATE = 44100

# (selection, device, model class) -> the gate's result, once per process:
# ATHT and BS-RoFormer launch different kernels
_RESULTS: Dict[Tuple[KernelSelection, str, str], Dict] = {}
_LAST: Optional[Dict] = None


class KernelParityError(RuntimeError):
    """The kernel path's stems differ from the per-op path's by more than
    the gate's threshold."""


def last_result() -> Optional[Dict]:
    """The outcome of the gate that ran last in this process (None: none
    has run)."""
    return _LAST


def _device_of(model, args) -> torch.device:
    if model is not None:
        return next(model.parameters()).device
    for a in args or ():
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def verify_layer_parity(model, compute_dtype: torch.dtype = torch.bfloat16,
                        threshold: float = RMS_THRESHOLD,
                        kernels: Kernels = True,
                        forward: Callable | None = None,
                        args: tuple | None = None) -> Dict:
    """Run the per-op and the kernel forward on the live device; compare.

    Returns ``{"rms", "ref_rms", "ok", "threshold", "selection", "device",
    "card", "seconds", "launches"}`` (``launches``: the kernels the kernel
    pass launched, by name, with their counts, leaving out those the per-op
    pass launched too, such as GroupNorm's, which no selection chooses);
    raises nothing (that is ``ensure_layer_parity``'s job).
    ``forward(selection, *args)`` / ``args`` replace the model's own pair,
    ``model.gate_pair(compute_dtype)`` (tests inject a divergent path)."""
    sel = resolve(kernels)
    if forward is None or args is None:
        forward, args = model.gate_pair(compute_dtype)
    device = _device_of(model, args)
    t0 = time.perf_counter()
    with torch.inference_mode():
        start = launch_counts()
        ref = forward(NONE, *args).detach().float().cpu().numpy()
        before = launch_counts()
        ker = forward(sel, *args).detach().float().cpu().numpy()
        launched = {k: n - before[k] for k, n in launch_counts().items()
                    if n > before[k] and before[k] == start[k]}
    rms = float(np.sqrt(np.mean((ref - ker) ** 2)))
    return {
        "rms": rms,
        "ref_rms": float(np.sqrt(np.mean(ref ** 2))),
        "ok": bool(np.isfinite(rms) and rms < threshold),
        "threshold": threshold,
        "selection": name(sel),
        "device": str(device),
        "card": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else device.type),
        "seconds": time.perf_counter() - t0,
        "launches": launched,
    }


def ensure_layer_parity(model, compute_dtype: torch.dtype = torch.bfloat16,
                        threshold: float = RMS_THRESHOLD,
                        kernels: Kernels = True,
                        forward: Callable | None = None,
                        args: tuple | None = None) -> Optional[Dict]:
    """Gate ``kernels`` on the model's device once per process; raise
    ``KernelParityError`` if they diverge.

    Returns None where the gate skips (``ATSM_SKIP_PARITY_GATE=1``, the
    ``none`` selection, the model's own pair on a CPU device, and a card
    where the kernel pass launched nothing: that result is kept with a
    ``skipped`` reason), else the result (cached after the first run for
    the same selection, device and model class; a cached failure raises
    again)."""
    global _LAST
    if os.environ.get("ATSM_SKIP_PARITY_GATE") == "1":
        return None
    sel = resolve(kernels)
    if sel == NONE:
        return None
    device = _device_of(model, args)
    if forward is None and device.type == "cpu":
        return None
    key = (sel, str(device), type(model).__name__)
    res = _RESULTS.get(key)
    if res is None:
        res = verify_layer_parity(model, compute_dtype, threshold, sel,
                                  forward=forward, args=args)
        if device.type == "cuda" and not res["launches"]:
            res["skipped"] = "the kernel pass launched no kernel"
        _RESULTS[key] = res
        _LAST = res
    if "skipped" in res:
        return None
    if not res["ok"]:
        raise KernelParityError(
            f"kernel parity gate: the {res['selection']!r} kernels diverge "
            f"from the per-op path on {res['card']} ({res['device']}): rms "
            f"{res['rms']:.3e} (ref_rms {res['ref_rms']:.3e}) >= threshold "
            f"{res['threshold']:.0e}.  Nothing falls back: run with "
            "kernels='none', or set ATSM_SKIP_PARITY_GATE=1 to start "
            "anyway")
    return res
