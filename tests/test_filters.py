"""Golden tests: filter designs and filtering vs the SciPy oracle
(reference: signal_processing.py:109-138)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from pyaudiolocalization_tpu.ops import filters as flt


def test_butter_design_matches_scipy():
    fs = 44100.0
    nyq = 0.5 * fs
    b, a = flt.butter_bandpass(5, 300 / nyq, 3400 / nyq)
    b_ref, a_ref = scipy.signal.butter(5, [300 / nyq, 3400 / nyq], btype="band")
    np.testing.assert_allclose(np.array(b), b_ref, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(np.array(a), a_ref, rtol=1e-9, atol=1e-14)


def test_firwin_design_matches_scipy():
    fs = 44100.0
    nyq = 0.5 * fs
    taps = flt.firwin_bandpass(101, 300 / nyq, 3400 / nyq)
    ref = scipy.signal.firwin(101, [300 / nyq, 3400 / nyq], pass_zero=False)
    np.testing.assert_allclose(np.array(taps), ref, rtol=1e-9, atol=1e-14)


def test_lfilter_zi_matches_scipy():
    b, a = scipy.signal.butter(5, [0.02, 0.2], btype="band")
    zi_ref = scipy.signal.lfilter_zi(b, a)
    zi = flt.lfilter_zi(tuple(b), tuple(a))
    np.testing.assert_allclose(np.array(zi), zi_ref, rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("method", ["scan", "prefix"])
def test_lfilter_matches_scipy(rng, method):
    b, a = scipy.signal.butter(3, [0.05, 0.4], btype="band")
    x = rng.normal(size=800)
    zi = scipy.signal.lfilter_zi(b, a) * x[0]
    y_ref, _ = scipy.signal.lfilter(b, a, x, zi=zi)
    y = np.asarray(flt.lfilter(b, a, jnp.asarray(x), jnp.asarray(zi), method=method))
    np.testing.assert_allclose(y, y_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("method", ["scan", "prefix"])
def test_filtfilt_butterworth_matches_scipy(rng, method):
    fs = 8000.0
    nyq = 0.5 * fs
    b, a = scipy.signal.butter(5, [300 / nyq, 3400 / nyq], btype="band")
    x = rng.normal(size=2048)
    y_ref = scipy.signal.filtfilt(b, a, x)
    y = np.asarray(flt.filtfilt(b, a, jnp.asarray(x), method=method))
    np.testing.assert_allclose(y, y_ref, rtol=1e-6, atol=1e-9)


def test_filtfilt_fir_matches_scipy(rng):
    fs = 8000.0
    nyq = 0.5 * fs
    taps = scipy.signal.firwin(101, [300 / nyq, 3400 / nyq], pass_zero=False)
    x = rng.normal(size=2048)
    y_ref = scipy.signal.filtfilt(taps, [1.0], x)
    y = np.asarray(flt.filtfilt(tuple(taps), (1.0,), jnp.asarray(x)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-7, atol=1e-10)


def test_fir_lfilter_matches_scipy(rng):
    taps = scipy.signal.firwin(31, 0.3)
    x = rng.normal(size=500)
    zi = scipy.signal.lfilter_zi(taps, [1.0]) * x[0]
    y_ref, _ = scipy.signal.lfilter(taps, [1.0], x, zi=zi)
    y = np.asarray(flt.lfilter(tuple(taps), (1.0,), jnp.asarray(x), jnp.asarray(zi)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-8, atol=1e-12)


def test_wiener_matches_scipy(rng):
    x = rng.normal(size=1000) + np.sin(np.linspace(0, 30, 1000))
    y_ref = scipy.signal.wiener(x)
    y = np.asarray(flt.wiener(jnp.asarray(x)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("method", ["butterworth", "fir", "wiener"])
def test_noise_reduction_dispatch_matches_scipy(rng, method):
    fs = 8000.0
    x = rng.normal(size=4096)
    got = np.asarray(flt.noise_reduction(jnp.asarray(x), fs, method=method))
    nyq = 0.5 * fs
    if method == "butterworth":
        b, a = scipy.signal.butter(5, [300 / nyq, 3400 / nyq], btype="band")
        ref = scipy.signal.filtfilt(b, a, x)
    elif method == "fir":
        taps = scipy.signal.firwin(101, [300 / nyq, 3400 / nyq], pass_zero=False)
        ref = scipy.signal.filtfilt(taps, [1.0], x)
    else:
        ref = scipy.signal.wiener(x)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError):
        flt.noise_reduction(jnp.asarray(x), fs, method="bogus")


def test_batched_filtfilt(rng):
    """Filtering must carry leading batch axes (mics, scenes)."""
    fs = 8000.0
    nyq = 0.5 * fs
    b, a = scipy.signal.butter(5, [300 / nyq, 3400 / nyq], btype="band")
    x = rng.normal(size=(3, 1024))
    y = np.asarray(flt.filtfilt(b, a, jnp.asarray(x)))
    for i in range(3):
        np.testing.assert_allclose(y[i], scipy.signal.filtfilt(b, a, x[i]),
                                   rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# Second-order sections (the float32-stable realization)
# ---------------------------------------------------------------------------

def test_butter_sos_composes_to_direct_form():
    """The biquad cascade must multiply out to the same transfer function as
    the direct-form design."""
    nyq = 22050.0
    sos = flt.butter_bandpass_sos(5, 300 / nyq, 3400 / nyq)
    b_ref, a_ref = scipy.signal.butter(5, [300 / nyq, 3400 / nyq], btype="band")
    b = np.array([1.0])
    a = np.array([1.0])
    for sec in sos:
        b = np.polymul(b, np.asarray(sec[:3]))
        a = np.polymul(a, np.asarray(sec[3:]))
    np.testing.assert_allclose(b, b_ref, atol=1e-12)
    np.testing.assert_allclose(a, a_ref, atol=1e-12)


@pytest.mark.parametrize("method", ["prefix", "scan"])
def test_filtfilt_sos_matches_scipy_long_signal(rng, method):
    """Full 1 s @ 44.1 kHz — the length at which the order-10 direct form
    overflows (even in float64 for the prefix evaluation).  The tolerance is
    bounded by scipy's OWN error: its composed-form zi solve has condition
    ~1e10, so the scipy oracle itself is only ~1e-6 accurate."""
    nyq = 22050.0
    x = rng.standard_normal(44100)
    b, a = scipy.signal.butter(5, [300 / nyq, 3400 / nyq], btype="band")
    y_ref = scipy.signal.filtfilt(b, a, x)
    sos = flt.butter_bandpass_sos(5, 300 / nyq, 3400 / nyq)
    y = np.asarray(flt.filtfilt_sos(sos, jnp.asarray(x), method=method))
    np.testing.assert_allclose(y, y_ref, atol=5e-6)


@pytest.mark.parametrize("method", ["prefix", "scan"])
def test_filtfilt_sos_float32_stable(rng, method):
    """float32 must stay finite and close to the f64 oracle — this is the
    dtype the device path runs in."""
    nyq = 22050.0
    x = rng.standard_normal(44100)
    b, a = scipy.signal.butter(5, [300 / nyq, 3400 / nyq], btype="band")
    y_ref = scipy.signal.filtfilt(b, a, x)
    sos = flt.butter_bandpass_sos(5, 300 / nyq, 3400 / nyq)
    y = np.asarray(flt.filtfilt_sos(sos, jnp.asarray(x, jnp.float32),
                                    method=method))
    assert np.all(np.isfinite(y))
    assert np.max(np.abs(y - y_ref)) < 5e-3


def test_noise_reduction_butterworth_uses_sos(rng):
    """The dispatcher's butterworth branch must match scipy's
    butter+filtfilt (reference signal_processing.py:124-128) through the SOS
    path."""
    fs = 44100.0
    nyq = fs / 2
    x = rng.standard_normal(int(fs))
    got = np.asarray(flt.noise_reduction(jnp.asarray(x), fs))
    b, a = scipy.signal.butter(5, [300 / nyq, 3400 / nyq], btype="band")
    ref = scipy.signal.filtfilt(b, a, x)
    np.testing.assert_allclose(got, ref, atol=5e-6)
