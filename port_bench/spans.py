"""Readers of the program's own spans in a traced window: the ``atsm.``
ranges the port records at its layer boundaries
(``audio_to_sheet_music_tpu_torch/utils/profiling.py``), which land in the
profiler's trace beside the kernels, on their clock.

``trace.Trace`` keeps every non-device event of the window in ``_host`` as
``(start_ns, end_ns, name)`` and the device's idle gaps in ``_gaps``.  The
profiler adds each range a second time, as its projection onto the
device's timeline under the same name, and that projection is in ``_host``
too.  So a name is measured as the union of all its intervals (clipped to
the window), and its occurrences are the union's connected components.

Every reader returns None without a trace, and None where the window holds
no ``atsm.`` range at all: a program that records no spans reads nothing,
not zero."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

PREFIX = "atsm."


def _instrumented(run) -> bool:
    return any(n.startswith(PREFIX) for _, _, n in run.trace._host)


def union(run, names: Iterable[str]) -> Optional[List[Tuple[int, int]]]:
    """The union of every interval of ``names`` inside the window, as
    disjoint ``(start_ns, end_ns)`` in time order; intervals that touch
    merge."""
    if run.trace is None:
        return None
    names = set(names)
    t0, t1 = run.trace.t0, run.trace.t1
    merged: List[List[int]] = []
    for a, b in sorted((max(a, t0), min(b, t1))
                       for a, b, n in run.trace._host if n in names):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _ready(run, per) -> bool:
    return run.trace is not None and bool(per) and _instrumented(run)


def span_ms(run, names: Iterable[str], per: float) -> Optional[float]:
    """The length of ``names``' union (ms) / ``per``."""
    if not _ready(run, per):
        return None
    return sum(b - a for a, b in union(run, names)) * 1e-6 / per


def idle_under_ms(run, names: Iterable[str], per: float) -> Optional[float]:
    """The device's idle time (ms) that falls inside ``names``' union /
    ``per``."""
    if not _ready(run, per):
        return None
    spans = union(run, names)
    gaps = sorted(run.trace._gaps)
    total, i = 0, 0
    for a, b in gaps:
        while i < len(spans) and spans[i][1] <= a:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < b:
            total += min(b, spans[j][1]) - max(a, spans[j][0])
            j += 1
    return total * 1e-6 / per


def occurrences(run, name: str) -> Optional[int]:
    """How many separate times ``name`` ran in the window: the connected
    components of its union."""
    if run.trace is None or not _instrumented(run):
        return None
    return len(union(run, [name]))
