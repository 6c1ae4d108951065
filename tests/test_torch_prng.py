"""The port's threefry keys and draws against ``jax.random`` (CPU).

``PRNGKey``, ``split``, ``random_bits`` and ``uniform`` must equal
``jax.random``'s bit for bit; ``normal`` must stay within
``prng.NORMAL_RTOL`` (1e-5) of ``jax.random.normal`` elementwise, relative
to each value (XLA's f32 ``erf_inv`` polynomial is reproduced; what is left
is the order of its f32 operations, ~2 ulps).  Seeds cover 0, small ones,
one at 2**31 and beyond 2**32 (JAX keeps a seed's low 32 bits with 64-bit
types off, its default), and a negative one; shapes are odd, 1-D and 3-D,
and one spans several of the CPU's draw chunks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_to_sheet_music_tpu_torch.nn import prng

SEEDS = (0, 1, 7, 2 ** 31 + 5, 2 ** 32 + 3, -5)
SHAPES = ((1,), (7,), (3, 5, 2), (129, 33), (prng.CHUNK["cpu"] * 2 + 3,))


def _words(key) -> tuple:
    return tuple(int(v) for v in np.asarray(key))


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert (key.hi, key.lo) == _words(jkey)
    for n in (1, 2, 3, 7):
        got = [(k.hi, k.lo) for k in prng.split(key, n)]
        assert got == [tuple(map(int, r)) for r in
                       np.asarray(jax.random.split(jkey, n))]
    # a chain of splits, as the model inits walk their key trees
    k, jk = key, jkey
    for _ in range(4):
        k, _ = prng.split(k)
        jk, _ = jax.random.split(jk)
    assert (k.hi, k.lo) == _words(jk)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[::2])
def test_bits_and_uniform_are_bit_exact(seed, shape):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    bits = prng.random_bits(key, shape)
    assert bits.shape == shape and bits.dtype == torch.int64
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (-0.125, 0.125), (-0.0721, 0.0721)):
        got = prng.uniform(key, shape, lo, hi)
        assert got.dtype == torch.float32 and got.shape == shape
        want = jax.random.uniform(jkey, shape, jnp.float32, lo, hi)
        np.testing.assert_array_equal(_f32_bits(got.numpy()), _f32_bits(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[1::2])
def test_normal_within_tolerance(seed, shape):
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.shape == shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=prng.NORMAL_RTOL, atol=0)


def test_erfinv_matches_xla_at_the_ends():
    """The polynomial's two branches, the clamp at nextafter(-1, 0) and the
    exact +-1 (whose image is +-inf)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.array([lo, -0.999, -0.9, -0.5, -1e-6, 0.0, 1e-6, 0.5, 0.9, 0.999,
                  np.nextafter(np.float32(1), np.float32(0)), 1.0],
                 np.float32)
    got = prng.erfinv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.isinf(got[-1]) and np.isinf(want[-1])
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=prng.NORMAL_RTOL)


def test_draws_land_on_the_keys_device():
    key = prng.PRNGKey(3, "cpu")
    assert all(k.device == torch.device("cpu") for k in prng.split(key, 3))
    assert prng.uniform(key, (4,)).device == torch.device("cpu")
    assert prng.normal(key, (4,)).device == torch.device("cpu")
    # a key is a value: the same key draws the same numbers again
    assert torch.equal(prng.uniform(key, (9,)), prng.uniform(key, (9,)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 300),
       bound=st.floats(1e-3, 10.0, allow_nan=False))
def test_uniform_property(seed, n, bound):
    """Any 32-bit seed, length and bound: split-then-draw is bit exact."""
    key = prng.split(prng.PRNGKey(seed), 3)[2]
    jkey = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    got = prng.uniform(key, (n,), -bound, bound)
    want = jax.random.uniform(jkey, (n,), jnp.float32, -bound, bound)
    np.testing.assert_array_equal(_f32_bits(got.numpy()), _f32_bits(want))
