"""The port's threefry draws (`spark_sklearn_tpu_torch/ops/random.py`)
against `jax.random` on the CPU: PRNGKey, split, fold_in, uniform and
poisson(lam=1), bit for bit, over a few seeds and shapes (an odd length
and a 2-D shape among them).  jax runs with its default
``jax_threefry_partitionable=True``, which these draws reproduce."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_sklearn_tpu_torch.ops import random as jr

SEEDS = [0, 1, 42, 2 ** 31 + 7]
SHAPES = [(1,), (7,), (1001,), (3, 17)]


def test_jax_uses_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    key, ours = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), ours)
    for num in (2, 5, 200):
        np.testing.assert_array_equal(np.asarray(jax.random.split(key, num)),
                                      jr.split(ours, num))
    for data in (0, 7, 9, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(key, data)),
            jr.fold_in(ours, data))
    # a chain of the two, as the tree families derive their keys
    k_t = jax.random.split(key, 5)[3]
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(jax.random.fold_in(k_t, 7), 2)),
        jr.fold_in(jr.fold_in(jr.split(ours, 5)[3], 7), 2))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_bitwise(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = jr.uniform(jr.PRNGKey(seed), shape).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES + [(20000,)], ids=str)
def test_poisson_one_bitwise(seed, shape):
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), 1.0,
                                         shape))
    got = jr.poisson_one(jr.PRNGKey(seed), shape).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_batched_draws_match_one_at_a_time():
    keys = jr.split(jr.PRNGKey(3), 5)
    assert keys.dtype == np.uint32 and keys.shape == (5, 2)
    many = jr.uniform_many(keys, (2, 9))
    assert many.shape == (5, 2, 9) and many.dtype == torch.float32
    for k, row in zip(keys, many):
        assert torch.equal(row, jr.uniform(k, (2, 9)))
        np.testing.assert_array_equal(
            row.numpy().view(np.uint32),
            np.asarray(jax.random.uniform(jnp.asarray(k), (2, 9))).view(
                np.uint32))


@pytest.mark.parametrize("rounds", [1, 3])
def test_poisson_rounds_past_a_batch(monkeypatch, rounds):
    """Batches of fewer rounds than the draw needs (here 1 and 3 against
    a maximum of ~8) chain into one another: still jax's draw."""
    monkeypatch.setattr(jr, "POISSON_ROUNDS", rounds)
    shape = (20000,)
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(5), 1.0, shape))
    assert want.max() > 2 * rounds      # three batches or more
    np.testing.assert_array_equal(jr.poisson_one(jr.PRNGKey(5), shape)
                                  .numpy(), want)
