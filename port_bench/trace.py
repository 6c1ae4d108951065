"""The traced run's reduction: ``torch.profiler`` over the measured window
(device activity and the host's runtime calls and ops), read from the raw
Kineto events without building the profiler's event tree, into device
busy time, kernel time by name, host launch calls and idle gaps."""

from __future__ import annotations

import contextlib
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

from . import common

WINDOW_SPAN = "bench.window"


def _is_device(ev) -> bool:
    """A kernel, copy or fill on the card: not the projection of a host
    annotation (``record_function``) onto the device's timeline."""
    return (str(ev.device_type()).endswith("CUDA")
            and not ev.name().startswith("bench.")
            and not getattr(ev, "is_user_annotation", lambda: False)())


class Trace:
    """What the traced window left: device spans (ns), kernel time by name
    (s), host runtime calls by name, and the idle gaps with what the host
    was doing in each."""

    def __init__(self, events):
        win = [e for e in events if e.name() == WINDOW_SPAN
               and not str(e.device_type()).endswith("CUDA")]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.t0 = win[0].start_ns()
        self.t1 = self.t0 + win[0].duration_ns()
        spans: List[Tuple[int, int]] = []
        self.kernel_s: Dict[str, float] = defaultdict(float)
        self.host_calls: Counter = Counter()
        host: List[Tuple[int, int, str]] = []
        for e in events:
            a = e.start_ns()
            b = a + e.duration_ns()
            if b <= self.t0 or a >= self.t1:
                continue
            if _is_device(e):
                a, b = max(a, self.t0), min(b, self.t1)
                spans.append((a, b))
                self.kernel_s[e.name()] += (b - a) * 1e-9
            else:
                name = e.name()
                if name.startswith(("cuda", "cu")):
                    self.host_calls[name] += 1
                host.append((a, b, name))
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.busy_s = common.busy_union(spans) * 1e-9
        self._gaps = common.idle_gaps(spans, self.t0, self.t1)
        self._host = host

    def kernel_time(self, fragments) -> float:
        """Device seconds of the kernels whose name holds a fragment."""
        return sum(s for n, s in self.kernel_s.items()
                   if any(f in n for f in fragments))

    def host_launches(self) -> int:
        return sum(n for name, n in self.host_calls.items()
                   if name.startswith(common.HOST_LAUNCHES))

    def device_ops(self, top: int = 10) -> List[List]:
        """The kernel groups that took most device time: [[group, s]]."""
        by = defaultdict(float)
        for name, s in self.kernel_s.items():
            by[common.kernel_group(name)] += s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:top]

    def idle_breakdown(self, top: int = 10) -> List[List]:
        """The longest idle gaps, named by the innermost ``bench.`` span and
        the shortest host event that covers the gap's middle: [[name, s]]."""
        out = []
        for a, b in self._gaps[:top]:
            mid = (a + b) // 2
            cover = [(hb - ha, n) for ha, hb, n in self._host if ha <= mid <= hb]
            spans = sorted(c for c in cover if c[1].startswith("bench."))
            ops = sorted(c for c in cover if not c[1].startswith("bench."))
            label = " / ".join(x for x in (
                spans[0][1] if spans else "", ops[0][1] if ops else "no host op")
                if x)
            out.append([label, (b - a) * 1e-9])
        return out


@contextlib.contextmanager
def traced(enabled: bool):
    """Yields a holder whose ``trace`` is set after the block when
    ``enabled``; the block marks its window with ``WINDOW_SPAN``."""
    holder = type("TraceHolder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.trace = Trace(prof.profiler.kineto_results.events())
