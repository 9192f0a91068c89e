"""Exact order statistics without sorting — bit-space bisection.

``jnp.median`` sorts the whole array, here a (scenes, pairs, 131072)
correlation tensor.  For non-negative floats the IEEE bit pattern is
monotone in value, so the k-th smallest element can be found EXACTLY with a
binary search over bit patterns — ~31 (f32) / ~63 (f64) fused
compare-and-count passes, each one reduction, instead of a sort.  (The
cheap statistic for thresholds that tolerate approximation is
models/tdoa.py's 'gaussian' scaled mean-|x|.)

``k`` may carry extra LEADING batch axes to resolve several order statistics
of one array in a single search (used by the even-length median).

Used for the GCC-PHAT peak thresholds (reference utils.py:144-149: median of
|corr|), where |corr| >= 0 always holds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _int_dtype(dtype):
    return {4: jnp.int32, 8: jnp.int64}[jnp.dtype(dtype).itemsize]


def kth_smallest_nonneg(x: jnp.ndarray, k, axis: int = -1) -> jnp.ndarray:
    """Exact k-th smallest (1-indexed, broadcastable k) along ``axis`` for
    non-negative floats, via bit-pattern bisection.

    ``k`` may have extra leading batch axes relative to ``x``'s batch shape
    (e.g. shape (2, 1, ..., 1)): every requested order statistic resolves in
    the same fused search.
    """
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    idt = _int_dtype(x.dtype)
    nbits = jnp.dtype(idt).itemsize * 8 - 1  # sign bit is always 0
    bits = jax.lax.bitcast_convert_type(x, idt)
    k = jnp.asarray(k)
    shape = jnp.broadcast_shapes(x.shape[:-1], k.shape)

    def body(i, state):
        lo, hi = state
        mid = lo + ((hi - lo) >> 1)  # (lo+hi)>>1 overflows int64
        cnt = jnp.sum(bits <= mid[..., None], axis=-1)
        ge = cnt >= k
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    lo = jnp.zeros(shape, idt)
    hi = jnp.full(shape, (1 << nbits) - 1, idt)  # Python int: no i64 overflow
    lo, hi = jax.lax.fori_loop(0, nbits + 1, body, (lo, hi))
    return jax.lax.bitcast_convert_type(hi, x.dtype)


def median_nonneg(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Exact ``np.median`` of non-negative floats along ``axis``: the middle
    order statistic, or the mean of the two middle ones for even length
    (both resolved in ONE fused search via a stacked k)."""
    n = x.shape[axis]
    if n % 2 == 1:
        return kth_smallest_nonneg(x, (n + 1) // 2, axis)
    ks = jnp.asarray([n // 2, n // 2 + 1]).reshape((2,) + (1,) * (x.ndim - 1))
    ab = kth_smallest_nonneg(x, ks, axis)
    return (ab[0] + ab[1]) / 2
