"""The port's copy of ``jax.random`` (``utils/prng.py``) against the
installed JAX on the same seeds and keys: keys, split chains, bits and
uniforms bit-equal; normals at the draw's tolerance
(``torch_port_helpers.assert_normal_matches``: at least 99% of entries
bit-equal, none more than 4 ulp apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_normal_matches

from gaussiansplattingmlx_tpu_torch.utils import prng

SHAPES = [(1,), (7,), (512, 3), (4097, 3), (2 ** 16, 3)]
# The trainer's first densify key for seed 0, and a key far from it.
KEYS = [np.asarray(jax.random.split(jax.random.PRNGKey(0))[1]),
        np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)]


def test_threefry_partitionable_is_on():
    """utils/prng.py reproduces the partitionable threefry (JAX's default
    since 0.5); a JAX whose default flips must fail here, not drift."""
    assert jax.config.jax_threefry_partitionable is True
    assert str(jax.random.key_impl(jax.random.key(0))) == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1, -1, 2 ** 32 + 5])
def test_prng_key_matches_jax(seed):
    got = prng.prng_key(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3])
def test_split_chain_matches_jax(num):
    """Six splits deep, following the last key of each split."""
    want, got = jax.random.PRNGKey(7), prng.prng_key(7)
    for _ in range(6):
        want, got = np.asarray(jax.random.split(want, num)), prng.split(got, num)
        assert got.dtype == np.uint32 and got.shape == (num, 2)
        np.testing.assert_array_equal(got, want)
        want, got = want[-1], got[-1]


@pytest.mark.parametrize("key", range(len(KEYS)))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_bit_equal(shape, key):
    key = KEYS[key]
    bits = prng.random_bits(key, shape)
    assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(bits.numpy(), want)
    got = prng.uniform(key, shape)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_uniform_range_bit_equal():
    """A range whose scaling rounds: JAX's fused multiply-add, one rounding."""
    key = KEYS[1]
    got = prng.uniform(key, (4097, 3), -1.7, 2.3)
    want = np.asarray(jax.random.uniform(key, (4097, 3), jnp.float32, -1.7, 2.3))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("key", range(len(KEYS)))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_matches_jax(shape, key):
    key = KEYS[key]
    got = prng.normal(key, shape)
    assert tuple(got.shape) == shape
    assert_normal_matches(got, jax.random.normal(key, shape, jnp.float32))


def test_ulp_distance():
    a = torch.tensor([1.0, -1.0, 0.0, -0.0, 1.0])
    b = torch.tensor([np.nextafter(np.float32(1), np.float32(2)), -1.0, -0.0,
                      np.float32(-1e-45), -1.0], dtype=torch.float32)
    assert prng.ulp_distance(a, b).tolist() == [1, 0, 0, 1, 2 * 0x3F800000]
