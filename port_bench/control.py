"""The readings a cell's correctness limits are set from, on the chip.

    python3 port_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 15

For each seed, in one process (with ``--fault``, a training cell's step
broken first, so the program's readings are the fault's): the cell's set-up and a window of
``--seconds`` at its own load, then the program's reading of each compared
number (what a run's check reads) and the control's: the plain reference
put in the program's place one precision below the configuration's (fp8
operands for a bf16 configuration), on the same sample.  One JSON line a
seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from port_bench import harness, program  # noqa: E402


def plant(fault: str) -> None:
    """Break the training step the train driver builds, in this process:
    ``half_batch`` steps on the first half of each batch's rows (the mean
    over them); ``unchanged`` runs the step and puts the head back as it
    was, so the state never changes."""
    import torch

    from audio_to_sheet_music_tpu_torch.train import step as steps

    real = steps.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(state, batch):
            return step(state, {k: v[: v.shape[0] // 2]
                                for k, v in batch.items()})

        def unchanged(state, batch):
            keep = [p.detach().clone() for p in state.optimizer.params]
            out = step(state, batch)
            with torch.no_grad():
                for p, k in zip(state.optimizer.params, keep):
                    p.copy_(k)
            return out

        return {"half_batch": half, "unchanged": unchanged}[fault]

    steps.make_train_step = make


def readings(cell, seed: int, seconds: float, device,
             clock=time.perf_counter) -> dict:
    import torch

    driver = cell.driver.Driver({"cell": cell, "seed": seed,
                                 "device": torch.device(device)})
    driver.setup()
    records = harness.run_window(driver.request, seconds, clock)
    program.sync(device)
    driver.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "requests": len(records),
           "program": {n: v for n, v, _ in driver.check(records)},
           "control": dict(driver.control(records))}
    if hasattr(driver, "notes"):
        out["notes"] = driver.notes(records)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--fault", choices=("half_batch", "unchanged"),
                    help="plant a fault in the training step first")
    args = ap.parse_args(argv)
    if args.fault:
        plant(args.fault)
    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, "cuda:0")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
