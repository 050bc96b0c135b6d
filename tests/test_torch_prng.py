"""The port's threefry keys and draws vs ``jax.random``, on the CPU.

Keys, ``fold_in`` and the ``uniform`` bits must be EXACTLY JAX's (the
partitionable counter layout this JAX uses); the Gumbel noise built from
them, ``-log(-log(u))``, goes through two logs whose last bit differs
between XLA's CPU ``log`` and torch's, so it is held to 4 ulps of
``max(1, |g|)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu_torch import prng


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 3, 12345, 2 ** 31 - 1, -5])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed,data", [(0, 0), (3, 5), (7, 2 ** 31 + 9),
                                       (42, 511), (1, -1)])
def test_fold_in_matches_jax(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                         np.uint32(data & 0xFFFFFFFF)))
    got = prng.fold_in(prng.PRNGKey(seed), data)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    # a tensor key gives the same words as an int64 tensor
    t = prng.fold_in(torch.as_tensor(prng.PRNGKey(seed).astype(np.int64)),
                     data)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), want.astype(np.int64))


def test_fold_in_vectorised_over_keys_and_data():
    base = jax.random.PRNGKey(9)
    keys = np.stack([np.asarray(jax.random.fold_in(base, i))
                     for i in range(5)])
    data = np.array([0, 17, 511, 2 ** 20, 3], np.int64)
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k),
                                                   np.uint32(d)))
                     for k, d in zip(keys, data)])
    got = prng.fold_in(torch.as_tensor(keys.astype(np.int64)),
                       torch.as_tensor(data))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", [(1, 32768), (1, 1001), (3, 77), (2, 5, 7),
                                   (4,)])
@pytest.mark.parametrize("minval", [0.0, 1e-20])
def test_uniform_bits_match_jax(shape, minval):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    want = jax.random.uniform(key, shape, minval=minval)
    got = prng.uniform(np.asarray(key), shape, minval)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_uniform_one_key_per_row():
    """The serving tick's draw: a ``(1, V)`` uniform per row, each with its
    own key, as one ``(N, 1, V)`` call."""
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(2), i))
                     for i in range(6)])
    got = prng.uniform(torch.as_tensor(keys.astype(np.int64)), (1, 333),
                       1e-20)
    assert tuple(got.shape) == (6, 1, 333)
    for i, k in enumerate(keys):
        want = jax.random.uniform(jnp.asarray(k), (1, 333), minval=1e-20)
        np.testing.assert_array_equal(_bits(got[i].numpy()), _bits(want))


def test_gumbel_within_ulps_of_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    u = jax.random.uniform(key, (2, 32768), minval=1e-20)
    want = np.asarray(-jnp.log(-jnp.log(u)))
    got = prng.gumbel(np.asarray(key), (2, 32768)).numpy()
    eps = np.finfo(np.float32).eps
    err = np.abs(got - want)
    assert (err <= 4 * eps * np.maximum(1.0, np.abs(want))).all(), err.max()
    assert np.isfinite(got).all()
