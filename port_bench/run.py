"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up draws the weights and the traffic from the seed on the card,
builds the program (``audio_to_sheet_music_tpu_torch``) and warms every
shape the traffic uses; the window then runs the cell's closed loop for
``--seconds``; after it the program is freed and the plain reference
(``port_bench/reference``) checks a seeded sample of what the window
produced.  ``--trace 1`` runs the window under ``torch.profiler`` and
reports the per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, ``notes`` where the driver has any (numbers it reports
beside the checks, such as training steps whose loss was not finite), and
last ``checks``: each compared number with its limit);
the checks are also the last lines of standard error.  Without a card, or
with JAX or the JAX package loaded, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or its libraries write stays inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

from port_bench import common, harness  # noqa: E402

HOST_THREADS = 4


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, clock=time.perf_counter, t0: float = T0) -> dict:
    """Set-up, the window, the readers and the check of one cell on
    ``device``: the result line as a dict (``checks`` last)."""
    import torch

    from port_bench import program
    from port_bench import trace as tracing

    cuda = torch.device(device).type == "cuda"
    # one process with few threads: the host's share of the work (the
    # loader, the copies) does not fight the card's driver
    torch.set_num_threads(HOST_THREADS)
    driver = cell.driver.Driver({"cell": cell, "seed": seed,
                                 "device": torch.device(device)})
    driver.setup()
    common.check_no_jax("after set-up")
    program.sync(device)
    setup_s = clock() - t0

    with tracing.traced(trace) as held:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            records = harness.run_window(driver.request, seconds, clock)
        program.sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counters = driver.counters(records)
    driver.release()
    if cuda:
        torch.cuda.empty_cache()

    run = harness.Run(cell, driver, records, setup_s, counters, held.trace)
    metrics = harness.read_metrics(
        run, cell.per_layer if trace else cell.end_to_end)
    t_check = clock()
    checks = driver.check(records)
    common.check_no_jax("after the window")
    print(f"port_bench: set-up {setup_s:.3f} s, {len(records)} requests, "
          f"readers and check {clock() - t_check:.3f} s", file=sys.stderr)

    failed = sum(1 for r in records if r.get("failed"))
    result = {
        "correct": failed == 0 and all(v <= lim for _, v, lim in checks),
        "attempted": len(records), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(peak)},
    }
    notes = driver.notes(records) if hasattr(driver, "notes") else {}
    if notes:
        result["notes"] = notes
    if held.trace is not None:
        result["device"]["busy_s"] = held.trace.busy_s
        result["device"]["window_s"] = held.trace.window_s
        result["breakdown"] = {"device_ops": held.trace.device_ops(),
                               "idle_gaps": held.trace.idle_breakdown()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload)

    import torch

    chips = int(cell.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0")
    for name, v in result.get("notes", {}).items():
        print(f"note {name}: {v!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
