"""The SCNet cell at test width on the CPU: its driver's set-up, window,
readers and check through ``run.run_cell``, and the work arithmetic of its
recurrence's roofline share."""

import pytest

from port_bench import common, harness, scnet_work
from port_bench import run as bench_run

import tiny

NAME = "scnet.songs-4stem"
# the port's TINY widths: blocks 8-16-32 wide, 2 dual-path layers, n_fft 256
TINY = {"model": "scnet", "sources": ["drums", "bass", "other", "vocals"],
        "audio_channels": 2, "dims": [4, 8, 16, 32], "nfft": 256,
        "hop_size": 64, "band_SR": [0.225, 0.372, 0.403],
        "band_stride": [1, 4, 16], "band_kernel": [3, 4, 16],
        "conv_depths": [3, 2, 1], "compress": 4, "conv_kernel": 3,
        "num_dplayer": 2, "expand": 1, "compute_dtype": "float32"}
PUBLISHED = {"dims": [4, 64, 128, 256], "nfft": 4096, "hop_size": 1024,
             "band_SR": [0.225, 0.372, 0.403], "band_stride": [1, 4, 16],
             "band_kernel": [3, 4, 16], "num_dplayer": 6, "expand": 1}


def cell() -> harness.Cell:
    c = harness.find_cell(harness.load_benchmark(), NAME)
    c.config = dict(TINY)
    c.traffic = dict(c.traffic, song_seconds=[2.0, 4.0], distinct_songs=3,
                     segment_seconds=0.5, overlap_seconds=0.375,
                     check_span_seconds=1.0)
    return c


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_agrees_with_the_reference(trace):
    c = cell()
    result = bench_run.run_cell(c, tiny.SEED, 1.0, trace, tiny.CPU,
                                clock=tiny.clock(0.5), t0=0.0)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == 2
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    # on the CPU no cuDNN kernel runs: the recurrence's share reads nothing
    share = "scnet_rnn_roofline_pct.serve"
    assert set(result["metrics"]) >= want - {share, "window_captures.serve"}
    assert share not in result["metrics"]
    for check in result["checks"].values():
        # f32 port against the f32 reference: int16 rounding only, a step
        # on a few samples of a quiet stem (bf16 operands read ~1e-2)
        assert check["value"] < 2e-4


def test_the_separation_net_shapes():
    # 2049 bins through three SD layers: 705, 243, then 85 rows; an 11 s
    # chunk padded to an even 476 frames
    assert scnet_work.rows(PUBLISHED) == 85
    assert scnet_work.frames(PUBLISHED, 485100) == 476
    calls = scnet_work.lstm_calls(PUBLISHED, 485100, 4)
    assert calls[:4] == [(4 * 476, 85, 256), (4 * 85, 476, 256),
                         (4 * 239, 85, 512), (4 * 85, 239, 512)]
    assert len(calls) == 12 and scnet_work.launches_per_group(PUBLISHED) == 6


def test_recurrence_work():
    flops, nbytes = scnet_work.recurrence_work(340, 476, 256)
    assert flops == 2 * 476 * (8 * 340 * 256 * 256 + 8 * 340 * 256)
    assert nbytes == 2 * (476 * 340 * 5 * 256 * 2 + 4 * 256 * 256 * 2)
    # a group of 4 chunks: 2,655 dependent steps a direction;
    # both paths of a layer do the same work, bound by its bytes at width
    # 256 and by its operations at 512
    calls = scnet_work.lstm_calls(PUBLISHED, 485100, 4)
    assert sum(s for _, s, _ in calls) == 3 * (476 + 85) + 3 * (239 + 85)
    by = [common.bound(*scnet_work.recurrence_work(*c))["bound_by"]
          for c in calls]
    assert by == ["bytes", "bytes", "operations", "operations"] * 3
    # the gate products over a chunk: ~0.77 TFLOP of recurrence
    per_chunk = sum(scnet_work.recurrence_work(m // 4, s, h)[0]
                    for m, s, h in calls)
    assert 0.76e12 < per_chunk < 0.78e12
