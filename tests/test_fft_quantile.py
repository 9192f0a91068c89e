"""Golden tests for the exact-length real transforms (ops/fftutils.py) and
the sort-free exact order statistics (ops/quantile.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyaudiolocalization_tpu.ops import fftutils as fu
from pyaudiolocalization_tpu.ops.quantile import kth_smallest_nonneg, median_nonneg


@pytest.mark.parametrize("n_in,n", [(100, 173), (50, 64), (44100, 88199),
                                    (44100, 88200), (333, 999)])
def test_rfft_n_matches_numpy(rng, n_in, n):
    """Any length, including the reference's n1+n2-1 = 88199 = 89 * 991."""
    x = rng.standard_normal((3, n_in))
    got = np.asarray(fu.rfft_n(jnp.asarray(x), n))
    ref = np.fft.rfft(x, n=n)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("n", [173, 88199, 999])
def test_irfft_n_roundtrip(rng, n):
    x = rng.standard_normal((2, n))
    spec = jnp.asarray(np.fft.rfft(x, n=n))
    got = np.asarray(fu.irfft_n(spec, n))
    np.testing.assert_allclose(got, x, atol=1e-10)


def test_rfft_n_float32_accuracy(rng):
    """float32 at the odd parity length stays ~1e-6 relative."""
    x = rng.standard_normal(44100).astype(np.float32)
    got = np.asarray(fu.rfft_n(jnp.asarray(x), 88199))
    ref = np.fft.rfft(x.astype(np.float64), n=88199)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 3e-6


def test_fft_length_modes():
    assert fu.fft_length(44100, 44100, "exact") == 88199
    assert fu.fft_length(44100, 44100, "pow2") == 131072
    with pytest.raises(ValueError):
        fu.fft_length(4, 4, "bogus")


# ---------------------------------------------------------------------------
# quantile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 8, 1001, 4096])
def test_median_matches_numpy(rng, n):
    x = np.abs(rng.standard_normal((4, n)))
    got = np.asarray(median_nonneg(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.median(x, -1))


def test_median_float32_exact(rng):
    x = np.abs(rng.standard_normal((2, 1000))).astype(np.float32)
    got = np.asarray(median_nonneg(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.median(x, -1).astype(np.float32))


def test_median_with_duplicates_and_zeros():
    x = np.array([[0.0, 0.0, 1.0, 1.0, 2.0, 2.0],
                  [5.0, 5.0, 5.0, 5.0, 5.0, 5.0]])
    got = np.asarray(median_nonneg(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.median(x, -1))


def test_kth_smallest(rng):
    x = np.abs(rng.standard_normal((3, 101)))
    s = np.sort(x, -1)
    for k in [1, 5, 50, 101]:
        got = np.asarray(kth_smallest_nonneg(jnp.asarray(x), k))
        np.testing.assert_array_equal(got, s[:, k - 1])


def test_kth_smallest_broadcast_k(rng):
    """Per-row k (used nowhere yet but part of the contract)."""
    x = np.abs(rng.standard_normal((3, 11)))
    s = np.sort(x, -1)
    ks = np.array([1, 6, 11])
    got = np.asarray(kth_smallest_nonneg(jnp.asarray(x), jnp.asarray(ks)))
    np.testing.assert_array_equal(got, s[np.arange(3), ks - 1])


def test_kth_stacked_k_single_search(rng):
    """A leading k axis resolves several order statistics in one search."""
    x = np.abs(rng.standard_normal((5, 200))).astype(np.float32)
    ks = jnp.asarray([100, 101]).reshape(2, 1)
    got = np.asarray(kth_smallest_nonneg(jnp.asarray(x), ks))
    srt = np.sort(x, -1)
    np.testing.assert_array_equal(got[0], srt[:, 99])
    np.testing.assert_array_equal(got[1], srt[:, 100])


def test_even_length_median_exact(rng):
    """Even lengths average the two middle order statistics exactly."""
    for n in (2, 100, 4096):
        x = np.abs(rng.standard_normal(n)).astype(np.float32)
        got = float(median_nonneg(jnp.asarray(x)))
        srt = np.sort(x)
        assert got == (srt[n // 2 - 1] + srt[n // 2]) / 2
