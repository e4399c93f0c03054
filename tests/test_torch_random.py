"""The port's threefry2x32 streams against ``jax.random``, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _split_int64_tensors(key, num):
    """``split`` as the port computed it on int64 tensors, one op per word
    operation: the host-integer ``split`` must give the same keys."""
    k1, k2 = (int(w) for w in key.tolist())
    lo = torch.arange(num, dtype=torch.int64)
    b1, b2 = trandom.threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_split_matches_the_tensor_path_and_jax(seed):
    k, t = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    for num in (1, 2, 3, 64, 1000):
        got = trandom.split(t, num)
        assert got.dtype == torch.int64 and tuple(got.shape) == (num, 2)
        np.testing.assert_array_equal(got.numpy(), _split_int64_tensors(t, num).numpy())
        np.testing.assert_array_equal(got.numpy(), _key_words(jax.random.split(k, num)))


@pytest.mark.parametrize("kind", [trandom.BITS, trandom.UNIFORM, trandom.RANDINT], ids=["bits", "uniform", "randint"])
def test_kernel_wrapper_refuses_a_cpu_device(kind):
    with pytest.raises(ValueError, match="CUDA device"):
        trandom.draw_cuda(kind, (0, 1, 2, 3), (4,), "cpu")


@pytest.mark.parametrize("shape", [(2**32,), (2**16, 2**16), (3, 2**31)], ids=str)
def test_kernel_wrapper_refuses_2_to_the_32_elements_before_allocating(shape):
    # a CUDA device descriptor needs no card: the count is refused first
    with pytest.raises(ValueError, match="fewer than 2"):
        trandom.draw_cuda(trandom.UNIFORM, (0, 1), shape, torch.device("cuda"))


def test_cpu_draws_take_the_twins_and_launch_nothing():
    key = trandom.PRNGKey(42)
    before = trandom.LAUNCHES
    assert torch.equal(trandom.random_bits(key, (3, 5)), trandom.random_bits_plain(key, (3, 5)))
    assert torch.equal(trandom.uniform(key, (9,), "cpu"), trandom.uniform_plain(key, (9,), "cpu"))
    assert torch.equal(trandom.randint(key, (9,), -5, 5, torch.device("cpu")), trandom.randint_plain(key, (9,), -5, 5))
    assert trandom.LAUNCHES == before
