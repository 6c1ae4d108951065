"""The port's mesh helpers and the chunk-sharded ``Separator`` on the CPU.

``parallel/mesh.py``'s helpers, then the cases of
``tests/test_mesh_separator.py`` with the same seeded ``init_tiny`` weights
in both packages (``convert/jax_params.py``), f32: a port ``Separator`` on
a mesh of 8 ``cpu`` entries (each chunk group split into 8 slices through
one replica) against

- the port's single-device ``Separator``: within 1e-5 of the stems' peak
  (measured: the slices compute the same chunks, ~2e-7 of the peak);
- the JAX ``Separator`` on conftest's 8-device mesh: the JAX test's
  tolerances, 2e-3, and 2e-3 + 1.5 int16 steps for PCM.

The cases: ``separate`` at 0.25 s chunks, the full-shape 6 s / 1.5 s sweep
(3 real chunks padded to 8), ``separate_all_pcm`` (one group of 8 chunks,
no half-size first group) against ``separate_all``, streaming (the block
rounds 5 -> 8), and ``autotune_stream_block``'s ``"skipped": "mesh"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.apps import serve_http as JH
from audio_to_sheet_music_tpu.infer import Separator as JaxSeparator
from audio_to_sheet_music_tpu.infer.streaming import (
    StreamingSeparator as JaxStreaming)
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.parallel import make_mesh as jax_mesh
from audio_to_sheet_music_tpu_torch.apps.serve_http import SeparationService
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.infer import chunked
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.infer.streaming import StreamingSeparator
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.parallel import mesh as meshlib

SHORT = dict(segment_seconds=0.25, overlap_seconds=0.05)
FULL = dict(segment_seconds=6.0, overlap_seconds=1.5)
SELF_TOL = 1e-5       # of the peak, against the port's single device
JAX_TOL = 2e-3        # tests/test_mesh_separator.py


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs several
    workers on the host's cores, and each taking all of them slows every
    worker several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_make_mesh_keeps_order_and_repeats():
    mesh = meshlib.make_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert mesh.size == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.distinct() == [torch.device("cpu")]


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.make_mesh()


def test_shard_batch_splits_axis_0():
    mesh = meshlib.make_mesh(["cpu"] * 4)
    x = torch.arange(24.0).reshape(8, 3)
    parts = meshlib.shard_batch(x, mesh)
    assert len(parts) == 4
    torch.testing.assert_close(torch.cat(parts), x)
    assert all(p.shape == (2, 3) for p in parts)
    batch = meshlib.shard_batch({"a": x, "b": torch.arange(8)}, mesh)
    assert [b["b"].tolist() for b in batch] == [[0, 1], [2, 3], [4, 5],
                                                [6, 7]]
    with pytest.raises(ValueError, match="equal slices"):
        meshlib.shard_batch(torch.zeros(6, 2), mesh)


def test_replicate_gives_one_model_per_distinct_device():
    model = torch.nn.Linear(3, 2)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    reps = meshlib.replicate(model, meshlib.make_mesh(["cpu"] * 3))
    assert list(reps) == [cpu] and reps[cpu] is model
    reps = meshlib.replicate(model, meshlib.make_mesh(["cpu", "meta", "cpu"]))
    assert list(reps) == [cpu, meta] and reps[cpu] is model
    assert reps[meta].weight.device == meta
    assert model.weight.device == cpu


def test_pad_to_multiple():
    assert [meshlib.pad_to_multiple(n, 8) for n in (1, 8, 9)] == [8, 8, 16]


# ---------------------------------------------------------------------------
# the sharded Separator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    model = TA.init_tiny(materialize=False)
    model.load_state_dict(jax_params.state_dict_from_params(params),
                          strict=True)
    return params, model


def _port(model, kw, n=8):
    single = Separator(model, device="cpu", **kw)
    sharded = Separator(model, mesh=meshlib.make_mesh(["cpu"] * n), **kw)
    return single, sharded


def _close(got, want, tol):
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"max err {err:.3g} vs {tol} x peak {peak:.3g}"


def test_sharded_separator_setup(weights):
    single, sharded = _port(weights[1], SHORT)
    assert sharded.bucket == 8 and sharded.device == torch.device("cpu")
    assert sharded.model is single.model is weights[1]
    grid = chunked.plan_chunks(90000, sharded.segment, sharded.overlap,
                               sharded.bucket)
    assert sharded._group_schedule(grid, 4) == [8, 8]
    with pytest.raises(ValueError, match="first device"):
        Separator(weights[1], device="meta",
                  mesh=meshlib.make_mesh(["cpu"] * 2))


def test_mesh_separate_matches(weights):
    params, model = weights
    single, sharded = _port(model, SHORT)
    song = (0.3 * np.random.default_rng(0).standard_normal((2, 30000))
            ).astype(np.float32)
    got = sharded.separate(song, "vocals")
    _close(got, single.separate(song, "vocals"), SELF_TOL)
    jsep = JaxSeparator(params, mesh=jax_mesh(), compute_dtype=jnp.float32,
                        wire_dtype=np.float32, **SHORT)
    want = jsep.separate(song, "vocals")
    np.testing.assert_allclose(got[:, 1:-1], want[:, 1:-1], atol=JAX_TOL)


def test_mesh_full_shape_sweep_matches(weights):
    """6 s chunks (2048 bins, 259 frames), 3 real chunks of a 12 s song
    padded to 8, one per slice."""
    params, model = weights
    single, sharded = _port(model, FULL)
    song = (0.3 * np.random.default_rng(7).standard_normal((2, 12 * 44100))
            ).astype(np.float32)
    got = sharded.separate(song, "vocals")
    assert got.shape == song.shape
    _close(got, single.separate(song, "vocals"), SELF_TOL)
    jsep = JaxSeparator(params, mesh=jax_mesh(), compute_dtype=jnp.float32,
                        wire_dtype=np.float32, **FULL)
    np.testing.assert_allclose(got, jsep.separate(song, "vocals"),
                               atol=JAX_TOL)


def test_mesh_pcm_matches_separate_all(weights):
    params, model = weights
    single, sharded = _port(model, SHORT)
    song = (0.3 * np.random.default_rng(4).standard_normal((2, 90000))
            ).astype(np.float32)
    stems = ("drums", "vocals")
    pcm, scales = sharded.separate_all_pcm(song, stems=stems)
    assert pcm.shape == (2, 2, 90000) and pcm.dtype == np.int16
    dq = pcm.astype(np.float32) * (scales[:, None, None] / 32767.0)
    ref = single.separate_all(song, stems=stems)
    step = float(scales.max()) / 32767
    for i, s in enumerate(stems):
        np.testing.assert_allclose(dq[i], ref[s], atol=SELF_TOL + 0.5 * step)
    jpcm, jscales = JaxSeparator(
        params, mesh=jax_mesh(), compute_dtype=jnp.float32,
        **SHORT).separate_all_pcm(song, stems=stems)
    np.testing.assert_allclose(scales, jscales, rtol=1e-6)
    jdq = jpcm.astype(np.float32) * (jscales[:, None, None] / 32767.0)
    np.testing.assert_allclose(dq[:, :, 1:-1], jdq[:, :, 1:-1],
                               atol=JAX_TOL + 1.5 * step)


def _stream(sep, song, block, cls):
    st = cls(sep, stems=("vocals",), block_chunks=block)
    pieces = st.feed(song)
    pieces.append(st.flush())
    return st.block_chunks, np.concatenate([p[0] for p in pieces], axis=-1)


def test_mesh_streaming_matches(weights):
    params, model = weights
    single, sharded = _port(model, SHORT)
    song = (0.3 * np.random.default_rng(2).standard_normal((2, 3 * 11025))
            ).astype(np.float32)
    _, want = _stream(single, song, 8, StreamingSeparator)
    block, got = _stream(sharded, song, 5, StreamingSeparator)
    assert block == 8 and got.shape == song.shape
    _close(got, want, SELF_TOL)
    jsep = JaxSeparator(params, mesh=jax_mesh(), compute_dtype=jnp.float32,
                        **SHORT)
    jblock, jgot = _stream(jsep, song, 5, JaxStreaming)
    assert jblock == block
    np.testing.assert_allclose(got, jgot, atol=JAX_TOL)


def test_autotune_skips_on_a_mesh(weights):
    _, sharded = _port(weights[1], SHORT)
    out = SeparationService(sharded, spectrograms=False
                            ).autotune_stream_block()
    assert out == {"block": JH.SeparationService.STATIC_STREAM_BLOCK,
                   "skipped": "mesh"}
