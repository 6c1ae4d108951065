"""Parity gate for the hand-written kernels, on the card they run on.

Counterpart of ``audio_to_sheet_music_tpu/ops/kernel_gate.py``.  The
kernels' tests compare each one with its plain version at chosen shapes;
this gate runs one whole text-conditioned forward of a 6 s chunk twice on
the live device, per op (``kernels="none"``) and with the separator's
selection, same inputs and weights, and compares the stems.

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

For a BS-RoFormer (``models.bs_roformer``) the forward is one of its
layers, whose RoPE and attention the selection sends to
``fused_rope.rope_qkv`` and ``fused_attn.attn_gated``
(``_roformer_pair``).

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


def _roformer_pair(model, compute_dtype) -> Tuple[Callable, tuple]:
    """``(forward, args)`` for a BS-RoFormer: its first layer (the time and
    the band transformer, every kernel launch of a layer) over the
    seeded unit-rms token grid of a 6 s chunk.  The layer's output is of
    unit order (its branches read RMS-normed tokens), so the gate compares
    a tenth of it, the scale of the stems the threshold was set on."""
    from ..models import bs_roformer

    device = _device_of(model, None)
    cfg = model.cfg
    frames = int(GATE_SECONDS * SAMPLE_RATE) // cfg.hop + 1
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (1, frames, len(cfg.freqs_per_bands), cfg.dim)).astype(np.float32))

    def fwd(sel, m, tokens):
        return 0.1 * bs_roformer.layer_forward(m, 0, tokens, sel).float()

    return fwd, (model, x.to(device, compute_dtype))


def _default_pair(model, compute_dtype) -> Tuple[Callable, tuple]:
    """``(forward, args)`` for the gate: the text-conditioned forward of one
    seeded 6 s chunk at 0.1 rms and a seeded unit-scale embedding, on the
    model's device; ``forward(selection, *args)``.  A BS-RoFormer takes
    ``_roformer_pair``."""
    from ..models import atht, bs_roformer

    if isinstance(model, bs_roformer.BSRoformer):
        return _roformer_pair(model, compute_dtype)
    device = _device_of(model, None)
    rng = np.random.default_rng(0)
    t = int(GATE_SECONDS * SAMPLE_RATE)
    wav = torch.from_numpy(
        (0.1 * rng.standard_normal((1, 2, t))).astype(np.float32))
    emb = torch.from_numpy(
        (rng.standard_normal((1, 512)) / np.sqrt(512)).astype(np.float32))

    def fwd(sel, m, w, e):
        return atht.forward_with_text_emb(m, w, e, compute_dtype, sel)

    return fwd, (model, wav.to(device), emb.to(device))


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
    raises nothing (that is
    ``ensure_layer_parity``'s job).  ``forward(selection, *args)`` / ``args`` replace the default
    pair (tests inject a divergent path this way)."""
    sel = resolve(kernels)
    if forward is None or args is None:
        forward, args = _default_pair(model, compute_dtype)
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
    ``none`` selection, the default pair on a CPU device, and a card where
    the kernel pass launched nothing: that result is kept with a
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
