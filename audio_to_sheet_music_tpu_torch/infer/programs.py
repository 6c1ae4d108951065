"""Program: one eager function of static-shaped tensors, captured once as a
CUDA graph and replayed.

The port's counterpart of the JAX package's ``jax.jit`` programs, which its
``Separator`` caches one per chunk geometry (``_sweep_cache``).  Eager
PyTorch launches every kernel of a sweep from Python, about 1,200 a chunk
group of the full-width model whatever its chunk count; a captured program
replays them with one ``cudaGraphLaunch``.

On a card, construction

1. allocates static input buffers of the example arguments' shapes and
   types on the device and copies the examples in;
2. runs the function twice on a side stream, as PyTorch's CUDA-graph notes
   ask: this fills the caches the function keeps (the resize taps, the
   fade window, the STFT tables), lets cuDNN and cuFFT choose their
   algorithms and plans, and lets the kernels' launchers make their
   one-time host calls (``cudaFuncSetAttribute``, the TMA entry point);
3. captures one run into a ``torch.cuda.CUDAGraph`` in ``pool`` (a
   ``torch.cuda.graph_pool_handle()`` that one ``Separator`` shares among
   its programs, which replay one at a time).

A call copies its arguments into the static buffers on the current stream
(asynchronous from pinned host memory or from another device tensor), then
replays the graph: no kernel is launched from the host.  It returns the
static outputs, the same tensors on every call, which the next replay of
any program in the pool may rewrite: a caller reads or copies what it keeps
before then.  A capture that fails raises; nothing falls back to running
the function eagerly.

On the CPU the function runs on the static buffers at each call and its
results are copied into static outputs made on the first call: the data
flow of a replay, so the CPU tests exercise the buffer protocol the card
runs.

Launch counts: each kernel's wrapper counts its launches as it is called
(``ops.select.launch_counts``).  A capture calls the wrappers without
running anything, so the program takes the capture's counts back, keeps
them, and adds them again at every replay.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from ..ops import select

WARMUP_RUNS = 2


def launch_delta(run: Callable[[], object]) -> Tuple[object, Dict[str, int]]:
    """``run()``'s result and the launches it counted, by kernel (only the
    kernels it counted); the counters are left as ``run`` left them."""
    before = select.launch_counts()
    out = run()
    after = select.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


class Program:
    """``fn(*tensors) -> tensor | tuple of tensors`` captured for the
    shapes and types of ``args`` (see the module notes).  ``device`` is
    where the static buffers live; ``args`` may be host tensors (pinned
    ones for a card).  ``capture_s`` is the seconds construction took
    (warm-up included, 0 on the CPU); ``launches`` the kernel launches of
    one replay; ``replays`` the calls so far."""

    def __init__(self, fn: Callable, args: Sequence[torch.Tensor],
                 device: torch.device, pool=None):
        self.device = torch.device(device)
        self.inputs = tuple(torch.empty(a.shape, dtype=a.dtype,
                                        device=self.device) for a in args)
        self.outputs: Tuple[torch.Tensor, ...] | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.replays = 0
        self._single = False
        self._fn: Callable | None = fn
        if self.device.type == "cuda":
            self._capture(args, pool)

    def _pack(self, out) -> Tuple[torch.Tensor, ...]:
        self._single = isinstance(out, torch.Tensor)
        outs = (out,) if self._single else tuple(out)
        # contiguous outputs: a caller's copy of one is a plain memcpy
        return tuple(o.contiguous() for o in outs)

    def _load(self, args: Sequence[torch.Tensor]) -> None:
        if len(args) != len(self.inputs):
            raise TypeError(f"Program: {len(args)} arguments, captured with "
                            f"{len(self.inputs)}")
        for buf, a in zip(self.inputs, args):
            if a.shape != buf.shape or a.dtype != buf.dtype:
                raise ValueError(f"Program: argument {tuple(a.shape)} "
                                 f"{a.dtype}, captured for "
                                 f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(a, non_blocking=True)

    def _capture(self, args: Sequence[torch.Tensor], pool) -> None:
        t0 = time.perf_counter()
        fn = self._fn
        with torch.cuda.device(self.device):
            self._load(args)
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    fn(*self.inputs)
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()

            def capture():
                with torch.cuda.graph(graph, pool=pool):
                    return self._pack(fn(*self.inputs))

            self.outputs, self.launches = launch_delta(capture)
        # the capture ran nothing: its counts come back at each replay
        select.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph = graph
        self._fn = None         # the graph holds the work; no cycle to fn
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, *args: torch.Tensor):
        self._load(args)
        if self.graph is not None:
            self.graph.replay()
            select.add_launch_counts(self.launches)
        else:
            outs = self._pack(self._fn(*self.inputs))
            if self.outputs is None:
                self.outputs = tuple(torch.empty_like(o) for o in outs)
            for static, o in zip(self.outputs, outs):
                static.copy_(o)
        self.replays += 1
        return self.outputs[0] if self._single else self.outputs
