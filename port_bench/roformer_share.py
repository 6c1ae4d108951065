"""The reader the BS-RoFormer kernels' roofline shares share: the summed
bound of a kernel's launches in the window (the driver's
``window_bound``, from ``roformer_work``) / the device time of its
kernels in the trace, in %."""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def read(run, kernel: str, fragments: Sequence[str]) -> Optional[float]:
    """None without a trace, where ``kernel`` did not launch (its counter,
    replays booked, reads 0 or is absent), where the counter disagrees
    with the driver's copy of the group schedule, or where the trace holds
    no device time for ``fragments``."""
    if run.trace is None or not run.ok():
        return None
    launched = run.counters.get("launches", {}).get(kernel, 0)
    if launched <= 0:
        return None
    want = run.driver.window_launches(run.ok(), kernel)
    if launched != want:
        print(f"port_bench: {kernel} launched {launched} times in the "
              f"window; the schedule's copy gives {want}", file=sys.stderr)
        return None
    device_s = run.trace.kernel_time(fragments)
    if device_s <= 0:
        return None
    return 100.0 * run.driver.window_bound(run.ok(), kernel) / device_s
