"""``Separator.sweep_flops`` of the port, on the CPU at tiny width.

The cases of ``tests/test_separator.py``'s ``TestSweepFlops`` (positive,
monotone in the song's length, 4 stems between 1x and 2x of 2 stems: the
encoder is shared), the count as the schedule's sum (each group size once,
times its groups), and two JAX counts at the same weights.

The independent one: the JAX group programs' matrix products and
convolutions, counted from their jaxprs as ``FlopCounterMode`` counts them
(2 x multiply-adds; a transposed convolution over its input), with the
JAX linear resize on its two-tap lerp (``nn.core._RESIZE_MATMUL_MAX = 0``:
the dense interpolation matmul it takes for small axes computes the same
values with far more products; the port always lerps).  The port counts
0.77 % less: the JAX decoders run each transposed convolution as four
polyphase convolutions that compute one frame more than they keep.  The
test holds the port within 1 % below that count.

The other: the JAX ``sweep_flops`` (XLA's cost analysis, which also counts
every elementwise operation, the resize matmuls and the FFTs), of which
the port's count is ~31 % at tiny width (``PERF.md`` §6); held
below it and above a quarter of it, a sanity bound only.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from audio_to_sheet_music_tpu.infer import Separator as JaxSeparator
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.nn import core as JC
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.infer import chunked
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.ops.select import NONE
from audio_to_sheet_music_tpu_torch.utils import profiling

KW = dict(segment_seconds=0.25, overlap_seconds=0.05)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    workers on the host's cores, and each taking all of them slows every
    worker several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def seps():
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(3)))
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    return (Separator(model, device="cpu", **KW),
            JaxSeparator(params, compute_dtype=jnp.float32, **KW), params)


def test_positive_and_monotonic_in_length(seps):
    sep = seps[0]
    short, long = sep.sweep_flops(22050), sep.sweep_flops(44100)
    assert 0 < short < long


def test_scales_with_stem_count(seps):
    sep = seps[0]
    fl2, fl4 = sep.sweep_flops(22050, n_stems=2), sep.sweep_flops(22050)
    assert fl2 < fl4 < 2.0 * fl2


def test_count_is_the_schedule_sum(seps):
    """A 2 s song: the 10-chunk grid in groups [2, 4, 4]."""
    sep = seps[0]
    length = 88200
    grid = chunked.plan_chunks(length, sep.segment, sep.overlap, sep.bucket)
    assert sep._group_schedule(grid, 4) == [2, 4, 4]
    hop, seg = grid.hop, grid.segment

    def group(g):
        return profiling.flops_estimate(
            sep._group, torch.zeros((2, (g - 1) * hop + seg)),
            torch.zeros((4, 512)), g, hop, 0, length, 1.0,
            torch.zeros((8, seg - hop)), torch.zeros((seg - hop,)), NONE)

    assert sep.sweep_flops(length) == group(2) + 2 * group(4)


def test_against_the_jax_count(seps):
    sep, jsep, _ = seps
    got, want = sep.sweep_flops(22050), jsep.sweep_flops(22050)
    assert 0.25 * want < got < want


def _products(jaxpr, times: int = 1) -> int:
    """Operations of the matrix products and convolutions in ``jaxpr`` and
    the jaxprs inside it, as ``FlopCounterMode`` counts them."""
    total = 0
    for eq in jaxpr.eqns:
        shape = [v.aval.shape for v in eq.invars[:2]]
        out = eq.outvars[0].aval.shape
        if eq.primitive.name == "dot_general":
            (contract, _), _ = eq.params["dimension_numbers"]
            total += times * 2 * math.prod(out) * math.prod(
                shape[0][i] for i in contract)
        elif eq.primitive.name == "conv_general_dilated":
            dn = eq.params["dimension_numbers"]
            transposed = any(d > 1 for d in eq.params["lhs_dilation"])
            spatial = ([shape[0][i] for i in dn.lhs_spec[2:]] if transposed
                       else [out[i] for i in dn.out_spec[2:]])
            total += (times * 2 * shape[0][dn.lhs_spec[0]]
                      * math.prod(shape[1]) * math.prod(spatial))
        n = eq.params.get("length", 1) if eq.primitive.name == "scan" else 1
        for value in eq.params.values():
            for sub in (value if isinstance(value, (tuple, list))
                        else (value,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    total += _products(sub.jaxpr, times * n)
                elif isinstance(sub, jcore.Jaxpr):
                    total += _products(sub, times * n)
    return total


def test_against_the_jax_products(seps, monkeypatch):
    """A 2 s song, groups [2, 4, 4], 4 stems: the port's count against the
    JAX programs' products, each group program counted once a group."""
    sep, _, params = seps
    length = 88200
    monkeypatch.setattr(JC, "_RESIZE_MATMUL_MAX", 0)
    jsep = JaxSeparator(params, compute_dtype=jnp.float32, **KW)
    grid = chunked.plan_chunks(length, sep.segment, sep.overlap, sep.bucket)
    hop, seg = grid.hop, grid.segment
    want = 0
    for g in sep._group_schedule(grid, 4):
        jaxpr = jax.make_jaxpr(jsep._get_group_fn(g, seg, hop, 4))(
            params, jnp.zeros((2, (g - 1) * hop + seg), jnp.int16),
            jnp.zeros((4, 512)), 1.0, 0, length, jnp.zeros((8, seg - hop)),
            jnp.zeros((seg - hop,)))
        want += _products(jaxpr.jaxpr)
    got = sep.sweep_flops(length)
    assert 0.99 * want < got <= want
