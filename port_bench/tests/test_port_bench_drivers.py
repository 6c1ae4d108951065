"""Each cell's driver runs its request loop at test width on the CPU with a
stand-in clock, through the same set-up, window, readers and check as a
run on the card, and the plain reference agrees with the port there in
f32."""

import pytest

from port_bench import harness
from port_bench import run as bench_run

import tiny

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_agrees_with_the_reference(name):
    cell = tiny.cell(name)
    result = bench_run.run_cell(cell, tiny.SEED, 1.0, False, tiny.CPU,
                                clock=tiny.clock(0.5), t0=0.0)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == 2                 # ticks 0 and 0.5 of 1.0 s
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "checks"
    for check in result["checks"].values():
        # f32 port against the f32 reference: rounding only (int16 levels
        # for the PCM cells, whose scale is twice the mixture's peak)
        assert check["value"] < 5e-5


def test_window_counts_a_failed_request():
    def request(i):
        if i == 1:
            raise RuntimeError("boom")
        return {"start": float(i), "end": float(i) + 0.1}

    recs = harness.run_window(request, 1.0, tiny.clock(0.25))
    # the failed request reads the clock once more, for its end
    assert [bool(r.get("failed")) for r in recs] == [False, True, False]


def test_reference_cuts_the_loaders_batches():
    """The reference's frozen copy of the loader's sampling plan, cut from
    the npy tracks, gives the batches the port's loader gives, over more
    than one epoch."""
    import numpy as np

    cell = tiny.cell("atht.train-8x6s")
    driver = cell.driver.Driver({"cell": cell, "seed": tiny.SEED,
                                 "device": tiny.CPU})
    feed = driver._batches()
    n = 30                                   # 12 batches an epoch here
    got = [next(feed) for _ in range(n)]
    want = driver._batches_at(list(range(n)))
    for g, w in zip(got, want):
        for key in ("mixture", "target", "input_ids", "attention_mask"):
            np.testing.assert_array_equal(g[key], w[key])
