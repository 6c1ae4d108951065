"""The yardstick's arithmetic on known inputs: percentiles, spreads, the
window's rate, the busy-interval union, the idle gaps and the work and
bound formulas behind the rooflines and the MFU."""

import math
import statistics

import pytest

from port_bench import common, readers


def test_percentile_rule():
    vals = list(range(1, 101))              # 1..100
    assert common.percentile(vals, 50) == pytest.approx(50.5)
    assert common.percentile(vals, 90) == pytest.approx(90.1)
    assert common.percentile([7.0], 90) == 7.0


@pytest.mark.parametrize("q", [50.0, 75.0, 90.0])
def test_percentile_matches_inclusive_quantiles(q):
    vals = [0.3, 0.1, 0.25, 0.12, 0.5, 0.2, 0.14, 0.33, 0.29, 0.18, 0.4]
    cuts = statistics.quantiles(vals, n=100, method="inclusive")
    assert common.percentile(vals, q) == pytest.approx(cuts[int(q) - 1])


def test_window_rate():
    rate, wall = common.window_rate([10, 20, 30], [0.0, 1.0, 2.0],
                                    [1.0, 2.0, 4.0])
    assert wall == 4.0 and rate == pytest.approx(15.0)


def test_busy_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 7), (10, 11)]
    assert common.busy_union(spans) == pytest.approx(3 + 2 + 1)
    gaps = common.idle_gaps(spans, 0, 12)
    assert gaps == [(7, 10), (3, 5), (11, 12)]


def test_layer_work_and_bound():
    flops, nbytes = common.layer_work(2, 10, 20, 8, 32)
    assert flops == 2.0 * 2 * 10 * (2 * 64 + 2 * 20 * 8 + 2 * 8 * 32)
    assert nbytes == (2 * (2 * 2 * 10 * 8 + 2 * 2 * 20 * 8)
                      + 2 * (2 * 64 + 2 * 8 * 32) + 4 * (64 + 32)
                      + 2 * 2 * 10 * 8)
    b = common.bound(989e12, 0.0)
    assert b["bound_s"] == pytest.approx(1.0) and b["bound_by"] == "operations"
    b = common.bound(0.0, 3.35e12)
    assert b["bound_s"] == pytest.approx(1.0) and b["bound_by"] == "bytes"


def test_token_counts_of_the_cells():
    # 6 s serving chunks and 7.8 s eval chunks at hop 1024
    assert common.token_counts(264600, 1024) == (2072, 1034)
    assert common.token_counts(343980, 1024) == (2688, 1344)


def test_transformer_bound_counts_ten_launches():
    total, n = common.transformer_bound(4, 2072, 1034, 5, 512, 2048)
    assert n == 10
    by_hand = 0.0
    for i in range(5):
        pairs = ([(2072, 2072), (1034, 1034)] if i % 2 == 0
                 else [(2072, 1034), (1034, 2072)])
        for l, s in pairs:
            by_hand += common.bound(*common.layer_work(4, l, s, 512, 2048))[
                "bound_s"]
    assert total == pytest.approx(by_hand)


def test_henc_work_is_bytes_bound_at_the_serving_shape():
    flops, nbytes = common.henc_work(4, 259)
    assert common.bound(flops, nbytes)["bound_by"] == "bytes"
    assert nbytes == 2.0 * (4 * 4 * 2048 * 259 + 4 * 48 * 512 * 259)


class _Run:
    def __init__(self, records, flops, trace=True):
        self.records = records
        self.trace = object() if trace else None
        self.counters = {}
        self.driver = type("D", (), {"window_flops":
                                     staticmethod(lambda recs: flops)})

    def ok(self):
        return [r for r in self.records if not r.get("failed")]


def test_mfu_arithmetic():
    recs = [{"start": 0.0, "end": 1.0}, {"start": 1.0, "end": 2.0}]
    run = _Run(recs, 989e12 * 0.02)        # 2 % of a second of peak, over 2 s
    assert readers.mfu_pct(run) == pytest.approx(1.0)
    assert readers.mfu_pct(_Run(recs, 1.0, trace=False)) is None


def test_rate_reader_skips_failed_requests():
    recs = [{"start": 0.0, "end": 1.0, "audio_s": 10.0},
            {"start": 1.0, "end": 2.0, "failed": True},
            {"start": 2.0, "end": 4.0, "audio_s": 30.0}]
    run = _Run(recs, 0.0)
    assert readers.rate(run, "audio_s") == pytest.approx(10.0)
    assert math.isfinite(readers.wall(run))


class _Trace:
    def kernel_time(self, fragments):
        return 1.0

    def host_launches(self):
        return 100


@pytest.mark.parametrize("layer_tail,holds", [(30, True), (40, False)])
def test_schedule_copy_is_held_against_the_launch_counters(layer_tail, holds):
    """The songs driver's copy of the group schedule feeds the rooflines and
    launches a chunk only while it books what the program's counters
    booked: here 3 groups, so 3 henc_freq_fused and 30 layer_tail."""
    from port_bench.drivers import songs

    driver = songs.Driver.__new__(songs.Driver)
    driver.cfg = {"transformer_layers": 5, "transformer_ff": 2048,
                  "bottom_channels": 512, "channels": [48, 96, 192, 384],
                  "hop": 1024, "nfft": 4096}
    driver.segment = 6 * 44100
    recs = [{"start": 0.0, "end": 1.0, "groups": [2, 4, 4], "computed": 10}]
    run = _Run(recs, 0.0)
    run.driver, run.trace = driver, _Trace()
    run.counters = {"launches": {"layer_tail": layer_tail,
                                 "henc_freq_fused": 3}}
    assert readers.schedule_holds(run) is holds
    assert (readers.launches_per(run, "computed") is not None) is holds
    assert (readers.roofline_pct(run, "layer_tail",
                                 common.LAYER_TAIL_KERNELS) is not None) is holds
