"""stream_step_ms: the median host wall of a feed call that runs a block,
ending when its piece is on the host (ms)."""

from port_bench import common


def read(run):
    vals = [s for r in run.ok() for s in r["steps_s"]]
    return 1e3 * common.median(vals) if vals else None
