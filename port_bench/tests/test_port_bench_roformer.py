"""The BS-RoFormer cell at test width on the CPU: its driver's set-up,
window, readers and span check through ``run.run_cell``, and the work
arithmetic of its roofline share."""

import pytest

from port_bench import harness, roformer_work
from port_bench import run as bench_run

import tiny

NAME = "bs_roformer.songs-vocals"
# the port's TINY widths: 2 layers, 2 heads of 64, n_fft 256 in 8 bands
TINY = {"model": "bs_roformer", "dim": 128, "depth": 2, "stereo": True,
        "num_stems": 1, "stems": ["vocals"], "heads": 2, "dim_head": 64,
        "ff_mult": 4, "freqs_per_bands": [1, 2, 3, 5, 8, 13, 32, 65],
        "mask_estimator_depth": 2, "mlp_expansion_factor": 4,
        "stft_n_fft": 256, "stft_hop_length": 60,
        "compute_dtype": "float32"}


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
    # on the CPU no kernel launches: the roofline shares read nothing
    shares = {"roformer_attn_roofline_pct.serve",
              "roformer_rope_roofline_pct.serve"}
    assert set(result["metrics"]) >= want - shares - {"window_captures.serve"}
    assert not shares & set(result["metrics"])
    for check in result["checks"].values():
        # f32 port against the f32 reference: int16 rounding only, a step
        # on a few samples of a quiet stem (bf16 operands read ~1e-2)
        assert check["value"] < 2e-4


def test_gated_attention_work():
    flops, nbytes = roformer_work.gated_attn_work(3, 801, 512, 8)
    assert flops == 3 * (4 * 801 * 801 * 512 + 2 * 801 * 512 * 512)
    assert nbytes == 3 * 801 * (5 * 512 + 8) * 2
    cfg = {"depth": 12, "heads": 8, "dim_head": 64, "stft_hop_length": 441,
           "freqs_per_bands": [0] * 62}
    assert roformer_work.frames(cfg, 352800) == 801
    # a group of 4 chunks: 24 launches, the time axis well above the ridge
    t = roformer_work.window_bound(cfg, 352800, [4], "attn_gated")
    time_ops = 12 * 4 * 62 * (4 * 801 * 801 * 512 + 2 * 801 * 512 * 512)
    assert t > time_ops / 989e12
    # RoPE: bytes, 12 bytes a row and column, both axes alike
    rows = 4 * 801 * 62
    assert roformer_work.window_bound(cfg, 352800, [4], "rope_qkv") == \
        24 * rows * 12 * 512 / 3.35e12
