"""The port's threefry2x32 streams against ``jax.random``, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simple_spectral_torch import random as trandom

SEEDS = (0, 1, 7, 12345, 2**31 + 5)
SHAPES = ((1,), (7,), (130,), (2049,), (3, 5))


def _key_words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    k, t = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    np.testing.assert_array_equal(trandom.PRNGKey(seed).numpy(), _key_words(k))
    for num in (1, 2, 3, 7):
        np.testing.assert_array_equal(trandom.split(t, num).numpy(), _key_words(jax.random.split(k, num)))
    for data in (0, 1, 9, 2**31 - 1):
        np.testing.assert_array_equal(trandom.fold_in(t, data).numpy(), _key_words(jax.random.fold_in(k, data)))
    # chained: the integrator's fold_in(split(...)) pattern
    a = jax.random.split(jax.random.fold_in(jax.random.split(k, 3)[2], 4))
    b = trandom.split(trandom.fold_in(trandom.split(t, 3)[2], 4))
    np.testing.assert_array_equal(b.numpy(), _key_words(a))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_bitwise(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32))
    got = trandom.uniform(trandom.PRNGKey(seed), shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bounds", [(0, 2), (0, 7), (3, 1000), (-5, 5)], ids=str)
def test_randint_bitwise(seed, shape, bounds):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, *bounds))
    got = trandom.randint(trandom.PRNGKey(seed), shape, *bounds).numpy()
    np.testing.assert_array_equal(got, want)
