"""first_audio_p90_s: the 90th percentile over the window's sessions of
session start (construction, which embeds the prompt) to the first
separated piece on the host (s)."""

from port_bench import common


def read(run):
    vals = [r["first_audio_s"] for r in run.ok()]
    return common.percentile(vals, 90.0) if vals else None
