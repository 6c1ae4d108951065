"""new_prompt_open_ms: the median host wall of a session's construction
when its prompt was never seen (one text-tower pass) (ms)."""

from port_bench import common


def read(run):
    vals = [r["open_s"] for r in run.ok() if r["new_prompt"]]
    return 1e3 * common.median(vals) if vals else None
