"""The port's threefry (repro_torch.common.prng) against jax.random, bit for
bit: keys, splits, raw bits, uniforms and Bernoulli masks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.common import prng

SEEDS = (0, 1549775860, 2**32 - 1)
SHAPES = ((1,), (7,), (3, 128), (624, 128), (4, 128))


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    k = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert np.array_equal(_words(k), tk.numpy())
    for n in (2, 3, 4, 10):
        assert np.array_equal(_words(jax.random.split(k, n)),
                              prng.split(tk, n).numpy())
    # a split of a split: the simulator's key stream
    k2 = jax.random.split(k)[1]
    assert np.array_equal(_words(jax.random.split(k2, 4)),
                          prng.split(prng.split(tk)[1], 4).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    k = jax.random.split(jax.random.PRNGKey(seed))[1]
    tk = torch.from_numpy(_words(k))
    assert np.array_equal(
        np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64),
        prng.bits(tk, shape).numpy())
    u = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    tu = prng.uniform(tk, shape)
    assert tu.dtype == torch.float32 and tuple(tu.shape) == shape
    assert np.array_equal(u.view(np.int32), tu.numpy().view(np.int32))
    assert np.array_equal(np.asarray(jax.random.bernoulli(k, 0.9, shape)),
                          prng.bernoulli(tk, 0.9, shape).numpy())


def test_prngkey_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError):
        prng.PRNGKey(2**32)
