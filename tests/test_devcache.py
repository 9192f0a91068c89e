"""utils/devcache: content-keyed upload cache for tiny device constants
(the warm single-scene localize path re-ships the same geometry/material
constants every call; see api.py/_seed_keys and models/simulator)."""

import jax
import jax.numpy as jnp
import numpy as np

from pyaudiolocalization_tpu.utils import devcache
from pyaudiolocalization_tpu.utils.devcache import dev_const


def test_same_content_returns_cached_buffer():
    a = dev_const(np.array([1.0, 2.0, 3.0]), jnp.float32)
    b = dev_const(np.array([1.0, 2.0, 3.0]), jnp.float32)
    assert a is b
    np.testing.assert_array_equal(np.asarray(a), [1.0, 2.0, 3.0])


def test_distinct_content_dtype_and_shape_miss():
    a = dev_const(np.array([1.0, 2.0]), jnp.float32)
    b = dev_const(np.array([1.0, 3.0]), jnp.float32)
    c = dev_const(np.array([1.0, 2.0]), jnp.float64)
    d = dev_const(np.array([[1.0, 2.0]]), jnp.float32)
    assert a is not b and a is not c and a is not d
    assert c.dtype == jnp.float64 and d.shape == (1, 2)


def test_device_arrays_bypass_the_cache():
    """np.asarray on a device array would FETCH it to the host —
    dev_const must pass jax arrays straight through."""
    x = jnp.arange(4, dtype=jnp.float32)
    before = len(devcache._CACHE)
    y = dev_const(x, jnp.float32)
    assert y is x            # same-dtype asarray is the identity
    assert len(devcache._CACHE) == before


def test_large_arrays_bypass_the_cache():
    big = np.zeros(4096, np.float32)  # > 4096 bytes
    before = len(devcache._CACHE)
    out = dev_const(big, jnp.float32)
    assert out.shape == (4096,)
    assert len(devcache._CACHE) == before


def test_values_identical_to_uncached_build():
    v = np.array([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]])
    np.testing.assert_array_equal(np.asarray(dev_const(v, jnp.float32)),
                                  np.asarray(jnp.asarray(v, jnp.float32)))
