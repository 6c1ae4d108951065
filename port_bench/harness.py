"""The benchmark's machinery, driven by ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``), and the mix names its driver
(``drivers/<driver>.py``); every metric is read by ``metrics/<name>.py``.
All of them are found by name, so a new cell or metric is new files and
new entries, and no edit.

A driver module defines ``Driver(ctx)`` with ``setup()`` (build the
program, warm every shape the cell's traffic uses), ``request(i)`` (one
closed-loop request, returning its record with ``start`` and ``end`` on
the host clock), ``release()`` (free the program once the window has
closed), ``check(records)`` (the comparison with the plain reference:
``[(name, value, limit)]``, each value at or under its limit) and
``counters(records)`` (what the per-layer readers read).  A metric module
defines ``read(run) -> float | None``: None leaves the metric out.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"port_bench: no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    workload: Dict
    config: Dict
    traffic: Dict
    driver: ModuleType
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def find_cell(bench: Dict, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench``, its configuration, traffic, driver
    and the metrics it reports."""
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"port_bench: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((bench_dir.parent / conf["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{work['traffic']}.json").read_text())
    driver = _module(bench_dir / "drivers" / f"{traffic['driver']}.py",
                     f"port_bench_driver_{traffic['driver']}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(work, config, traffic, driver, e2e, per_layer)


def reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return _module(bench_dir / "metrics" / f"{name}.py",
                   "port_bench_metric_" + name.replace(".", "_")).read


@dataclasses.dataclass
class Run:
    """What the readers read: the window's records, its trace (traced runs
    only), the driver's counters, the set-up seconds and the cell."""

    cell: Cell
    driver: Any
    records: List[Dict]
    setup_s: float
    counters: Dict[str, Any]
    trace: Optional[Any] = None

    def ok(self) -> List[Dict]:
        return [r for r in self.records if not r.get("failed")]


def run_window(request: Callable[[int], Dict], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> List[Dict]:
    """Closed loop: request ``i`` starts when request ``i - 1`` has ended,
    until a request would start ``seconds`` after the first one did.  A
    request that raises is recorded as failed (its traceback printed)."""
    import traceback

    records: List[Dict] = []
    first = None
    i = 0
    while True:
        now = clock()
        if first is not None and now - first >= seconds:
            break
        first = now if first is None else first
        try:
            rec = request(i)
        except Exception:  # noqa: BLE001 - a failed request is counted
            traceback.print_exc()
            rec = {"start": now, "end": clock(), "failed": True}
        records.append(rec)
        i += 1
    return records


def read_metrics(run: Run, metrics: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
