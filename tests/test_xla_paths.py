"""The XLA paths of the GCC, TDOA, render and bootstrap stages against plain
NumPy float64 oracles written independently of the code under test.

Every test uses a PRIVATE seeded RNG: the conftest ``rng`` fixture is
session-scoped, and consuming it reshuffles later tests' data."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyaudiolocalization_tpu.models import tdoa as tdoa_ops
from pyaudiolocalization_tpu.models.simulator import render_scene
from pyaudiolocalization_tpu.ops import gccphat
from pyaudiolocalization_tpu.ops.delay import delay_and_sum

PI = np.array([0, 0, 0, 1, 1, 2], np.int32)
PJ = np.array([1, 2, 3, 2, 3, 3], np.int32)


def _gcc_oracle(x, n, band=None, fs=None):
    spec = np.fft.rfft(np.asarray(x, np.float64), n, axis=-1)
    cross = spec[..., PI, :] * np.conj(spec[..., PJ, :])
    white = cross / (np.abs(cross) + gccphat.PHAT_EPS)
    if band is not None:
        freqs = np.fft.rfftfreq(n, 1.0 / fs)
        white = white * ((freqs >= band[0]) & (freqs <= band[1]))
    return np.fft.irfft(white, n, axis=-1)


def _fade(n):
    """Reference fade (signal_processing.py:75-78): linear ramps over the
    first/last int(0.01 n) samples."""
    w = np.ones(n)
    f = int(0.01 * n)
    if f:
        ramp = np.linspace(0.0, 1.0, f)
        w[:f] *= ramp
        w[n - f:] *= ramp[::-1]
    return w


def _delay_sum_oracle(base, delays, gains, fs, length, fade=True):
    n = base.shape[-1]
    spec = np.fft.rfft(np.asarray(base, np.float64), length)
    freqs = np.fft.rfftfreq(length, 1.0 / fs)
    out = np.zeros((delays.shape[0], n))
    for m in range(delays.shape[0]):
        for p in range(delays.shape[1]):
            ramp = np.exp(-2j * np.pi * freqs * delays[m, p])
            out[m] += gains[m, p] * np.fft.irfft(spec * ramp, length)[:n]
    return out * _fade(n) if fade else out


def _finalize_oracle(x):
    """normalize -> log compression -> renormalize (signal_processing.py:
    82-94), per row."""
    x = x / np.max(np.abs(x), -1, keepdims=True)
    y = np.sign(x) * np.log1p(np.abs(x) / 0.8 + 1e-8)
    return y / np.max(np.abs(y), -1, keepdims=True)


@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192, 65536])
@pytest.mark.parametrize("band", [None, (300.0, 3400.0)])
@pytest.mark.parametrize("case", ["linear-f64", "short-f32"])
def test_gcc_all_pairs_matches_float64_oracle(n, band, case):
    """All-pairs GCC-PHAT at power-of-two lengths, full-band and
    band-limited: float64 input at the linear-correlation length (n//2
    samples) to 1e-9, and short float32 input (n//4 samples, the zero-padded
    majority case) to float32 rounding with identical peak lags."""
    rng = np.random.default_rng(n + (band is not None))
    fs = 8000.0 if band is not None else None
    if case == "linear-f64":
        x = rng.standard_normal((2, 4, n // 2))
    else:
        x = rng.standard_normal((2, 4, n // 4)).astype(np.float32)
    got = np.asarray(gccphat.gcc_phat_all_pairs(
        jnp.asarray(x), PI, PJ, nfft=n, band=band, fs=fs))
    want = _gcc_oracle(x, n, band, fs)
    assert got.shape == (2, 6, n) and got.dtype == x.dtype
    if case == "linear-f64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    else:
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4
        np.testing.assert_array_equal(np.argmax(got, -1),
                                      np.argmax(want, -1))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_physical_ladder_matches_oracle_peak_lags(seed):
    """The full physical-mode ladder (band-limited GCC -> gaussian threshold
    -> max_expected_delay window) picks the oracle correlation's in-window
    peak, which sits within one sample of the true TDOA."""
    rng = np.random.default_rng(100 + seed)
    fs, n, nfft, c = 16000.0, 3200, 4096, 343.0
    mics = np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.], [0., 0., 1.]])
    src = rng.uniform(0.1, 0.9, 3)
    dist = np.linalg.norm(mics - src, axis=-1)
    base = rng.standard_normal(2 * n)
    sigs = np.stack([
        _delay_sum_oracle(base, np.array([[d / c]]), np.ones((1, 1)), fs,
                          2 * n, fade=False)[0][:n] for d in dist])
    sigs = sigs + 0.01 * rng.standard_normal(sigs.shape)
    band = (300.0, 3400.0)
    max_td = 1.25 * np.sqrt(2) / c
    corr = gccphat.gcc_phat_all_pairs(jnp.asarray(sigs), PI, PJ, nfft=nfft,
                                      band=band, fs=fs)
    res = tdoa_ops.time_delays_from_corr(
        corr, n, n, fs, num_peaks=1, threshold_method="gaussian",
        max_expected_delay=max_td, lag_mode="physical")
    got = np.asarray(res.delays[..., 0])
    oracle = np.roll(_gcc_oracle(sigs, nfft, band, fs), nfft // 2, -1)
    lags = np.arange(nfft) - nfft // 2
    inwin = np.abs(lags) <= max_td * fs
    want = lags[inwin][np.argmax(oracle[:, inwin], -1)] / fs
    np.testing.assert_allclose(got, want, atol=1e-9)
    true_lag = (dist[PI] - dist[PJ]) / c          # peak lag = -(t_j - t_i)
    assert np.max(np.abs(got - true_lag)) * fs <= 1.0


@pytest.mark.parametrize("pad_mode,length", [
    ("exact", lambda n: 2 * n), ("pow2", lambda n: 4096),
    ("pow2-circular", lambda n: 2048)])
def test_delay_and_sum_matches_numpy_oracle(pad_mode, length):
    """Frequency-domain multipath render == per-path phase-ramp delays
    summed in float64 (the reference's per-path loop, main.py:104-118),
    at each transform length, Nyquist bin included."""
    rng = np.random.default_rng(7)
    fs, n = 8000.0, 2000
    base = rng.standard_normal(n)
    d = rng.uniform(0.0, 0.005, (4, 3))
    g = rng.uniform(0.1, 1.0, (4, 3))
    got = np.asarray(delay_and_sum(jnp.asarray(base), jnp.asarray(d),
                                   jnp.asarray(g), fs, pad_mode=pad_mode))
    want = _delay_sum_oracle(base, d, g, fs, length(n))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("pad_mode", ["exact", "pow2"])
def test_render_scene_finalize_matches_numpy_oracle(pad_mode):
    """render_scene(finalize=True): pad -> delay-and-sum -> trim ->
    normalize + log compression, against the NumPy chain ('pow2' renders
    circularly at next_pow2(total_samples))."""
    rng = np.random.default_rng(11)
    fs, n_base, total, out = 8000.0, 3000, 3500, 3000
    base = rng.standard_normal(n_base)
    d = rng.uniform(0.0, 0.02, (4, 2))
    g = rng.uniform(0.3, 1.0, (4, 2))
    got = np.asarray(render_scene(jnp.asarray(base), jnp.asarray(d),
                                  jnp.asarray(g), fs, total, out,
                                  pad_mode=pad_mode, finalize=True))
    padded = np.zeros(total)
    padded[:n_base] = base
    length = 2 * total if pad_mode == "exact" else 4096
    want = _finalize_oracle(
        _delay_sum_oracle(padded, d, g, fs, length)[:, :out])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n,rows", [(2048, 5), (2048, 64), (1999, 5),
                                    (1999, 64)])
def test_bootstrap_null_peaks_match_numpy(n, rows):
    """The bootstrap null statistic max(irfft(W / (|W| + eps))),
    W = rfft(sig1) * conj(rfft(row)), at a power-of-two and at an odd
    exact (parity) length, for odd and chunk-sized row counts."""
    rng = np.random.default_rng(n + rows)
    sig1 = rng.standard_normal(1000)
    shuf = rng.standard_normal((rows, 1000))
    s1 = jnp.fft.rfft(jnp.asarray(sig1), n=n)
    got = np.asarray(tdoa_ops._null_peaks(s1, jnp.asarray(shuf), n))
    w = np.fft.rfft(sig1, n)[None] * np.conj(np.fft.rfft(shuf, n, axis=-1))
    want = np.max(np.fft.irfft(w / (np.abs(w) + gccphat.PHAT_EPS), n,
                               axis=-1), -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
