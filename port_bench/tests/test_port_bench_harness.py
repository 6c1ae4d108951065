"""The harness finds every piece of a cell by name from BENCHMARK.json, a
new cell and metric need only new files and entries, and ``run.py`` fails
without a card."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from port_bench import harness

import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(work):
    cell = harness.find_cell(BENCH, work["name"])
    assert hasattr(cell.driver, "Driver")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    all_names = ([c["name"] for c in BENCH["configs"]]
                 + [w["name"] for w in BENCH["workloads"]]
                 + [m["name"] for m in metrics])
    assert all(NAME.match(n) for n in all_names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("port_bench/")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A stand-in cell with its own traffic file and driver, and a stand-in
    metric with its own reader, added beside copies of the benchmark's
    files: the harness finds and runs them, no existing file edited."""
    bench_dir = tmp_path / "port_bench"
    shutil.copytree(ROOT / "port_bench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "traffic" / "echo-mix.json").write_text(
        json.dumps({"driver": "echo", "items": 3}))
    (bench_dir / "drivers" / "echo.py").write_text(textwrap.dedent('''
        class Driver:
            def __init__(self, ctx):
                self.n = ctx["cell"].traffic["items"]
            def setup(self):
                pass
            def request(self, i):
                return {"start": float(i), "end": float(i) + 1.0,
                        "audio_s": float(self.n)}
            def release(self):
                pass
            def counters(self, records):
                return {"seen": len(records)}
            def check(self, records):
                return [("echo_gap", 0.0, 1.0)]
        '''))
    (bench_dir / "metrics" / "echo_count.stand_in.py").write_text(
        "def read(run):\n    return run.counters['seen']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "atht.echo", "config": "atht",
                               "traffic": "echo-mix", "chips": 1,
                               "why": "stand-in"})
    bench["end_to_end"][0]["workloads"].append("atht.echo")
    bench["per_layer"].append({"name": "echo_count.stand_in", "unit": "n",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "audio_s_per_s",
                               "workloads": ["atht.echo"]})
    cell = harness.find_cell(bench, "atht.echo", bench_dir)
    assert [m["name"] for m in cell.per_layer] == ["echo_count.stand_in"]
    drv = cell.driver.Driver({"cell": cell})
    records = harness.run_window(drv.request, 2.0, tiny.clock(0.5))
    assert len(records) == 4
    run = harness.Run(cell, drv, records, 1.0, drv.counters(records))
    got = {m["name"]: harness.reader(m["name"], bench_dir)(run)
           for m in cell.end_to_end + cell.per_layer}
    assert got["audio_s_per_s"] == pytest.approx(12.0 / 4.0)
    assert got["echo_count.stand_in"] == 4


def test_run_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "atht.songs-4stem",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_fails_in_a_directory_of_only_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "atht.songs-4stem",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
