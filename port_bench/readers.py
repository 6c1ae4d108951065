"""The arithmetic the metric files under ``metrics/`` share.  Each reader
takes a ``harness.Run`` and returns a number, or None where the run holds
nothing for it to read (no trace, no launch of the kernel, no sample)."""

from __future__ import annotations

import sys
from typing import Optional

from . import common


def wall(run) -> float:
    ok = run.ok()
    return max(r["end"] for r in ok) - min(r["start"] for r in ok)


def rate(run, key: str) -> Optional[float]:
    ok = run.ok()
    if not ok:
        return None
    return common.window_rate([r[key] for r in ok], [r["start"] for r in ok],
                              [r["end"] for r in ok])[0]


def idle_pct(run) -> Optional[float]:
    """100 x (1 - device busy / traced window), the busy time the union of
    the device's activity intervals."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run) -> Optional[float]:
    """100 x the operations the window's completed work needs (counted on
    the reference at the cell's shapes; bucket padding not counted) /
    the window's wall / the bf16 tensor peak."""
    if run.trace is None or not run.ok():
        return None
    flops = run.driver.window_flops(run.ok())
    return 100.0 * flops / wall(run) / common.PEAK_BF16_FLOPS


SCHEDULED = ("layer_tail", "henc_freq_fused")


def schedule_holds(run) -> bool:
    """Whether the chunk groups the driver worked out for the window (its
    copy of the program's schedule, ``window_launches``) launch what the
    program's own counters booked: each kernel of ``SCHEDULED``, one count
    a launch.  A driver without a schedule holds."""
    if not hasattr(run.driver, "window_launches"):
        return True
    counted = run.counters.get("launches", {})
    held = True
    for kernel in SCHEDULED:
        want = run.driver.window_launches(run.ok(), kernel)
        if counted.get(kernel, 0) != want:
            print(f"port_bench: {kernel} launched {counted.get(kernel, 0)} "
                  f"times in the window; the schedule's copy gives {want}",
                  file=sys.stderr)
            held = False
    return held


def roofline_pct(run, kernel: str, fragments) -> Optional[float]:
    """100 x the summed bound of the ``kernel`` launches the window ran (at
    their shapes) / the device time of their kernels in the trace; None
    where the kernel did not launch or the driver's schedule does not
    match the launches."""
    if run.trace is None:
        return None
    if run.counters.get("launches", {}).get(kernel, 0) <= 0:
        return None
    if not schedule_holds(run):
        return None
    device_s = run.trace.kernel_time(fragments)
    if device_s <= 0:
        return None
    return 100.0 * run.driver.window_bound(run.ok(), kernel) / device_s


def launches_per(run, key: str) -> Optional[float]:
    """Host launch calls in the trace / ``key`` summed over the records
    (chunks computed) or, for ``steps``, the steps completed."""
    if run.trace is None or not run.ok():
        return None
    if key == "computed" and not schedule_holds(run):
        return None
    if key == "steps":
        n = len(run.ok())
    else:
        n = sum(r[key] for r in run.ok())
    return run.trace.host_launches() / n if n else None
