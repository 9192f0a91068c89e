"""Signal generators and amplitude processing, as pure jittable JAX ops.

Counterpart of the reference's L1 layer
(reference: signal_processing.py:11-103).  Differences by design:

  * every stochastic generator takes an explicit ``jax.random`` key — the
    reference draws from the unseeded global NumPy RNG
    (signal_processing.py:13,30,56);
  * sample counts are static Python ints so generated shapes are static under
    jit;
  * everything runs in the caller's dtype (float32 by default, float64
    under x64 for golden tests against the SciPy oracle).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .fftutils import rfft_n, irfft_n
import numpy as np


def _float_dtype(dtype):
    return jnp.dtype(dtype) if dtype is not None else jnp.result_type(float)


def time_axis(fs: float, num_samples: int, dtype=None) -> jnp.ndarray:
    """t = linspace(0, duration, N, endpoint=False) as in
    signal_processing.py:26 — i.e. arange(N)/fs."""
    dt = _float_dtype(dtype)
    return (jnp.arange(num_samples, dtype=dt) / jnp.asarray(fs, dt))


def normalize_signal(signal: jnp.ndarray) -> jnp.ndarray:
    """Peak-normalize; silent signals pass through unchanged
    (signal_processing.py:82-86)."""
    max_val = jnp.max(jnp.abs(signal), axis=-1, keepdims=True)
    return jnp.where(max_val == 0, signal, signal / jnp.where(max_val == 0, 1, max_val))


def dynamic_range_compression(signal: jnp.ndarray,
                              threshold: float = 0.8,
                              epsilon: float = 1e-8) -> jnp.ndarray:
    """Logarithmic compression, re-peak-normalized
    (signal_processing.py:88-94)."""
    x = normalize_signal(signal)
    compressed = jnp.sign(x) * jnp.log1p(jnp.abs(x) / threshold + epsilon)
    max_val = jnp.max(jnp.abs(compressed), axis=-1, keepdims=True)
    return jnp.where(max_val > 0, compressed / jnp.where(max_val == 0, 1, max_val),
                     compressed)


def dynamic_range_compression_soft_clip(signal: jnp.ndarray,
                                        threshold: float = 0.8) -> jnp.ndarray:
    """Piecewise soft clip above threshold (signal_processing.py:96-103).
    Dead code in the reference (imported but never called) — provided for
    API completeness."""
    x = normalize_signal(signal)
    return jnp.where(
        jnp.abs(x) > threshold,
        jnp.sign(x) * (threshold + (jnp.abs(x) - threshold) * 0.5),
        x)


def sine(fs: float, num_samples: int, freq: float, dtype=None) -> jnp.ndarray:
    t = time_axis(fs, num_samples, dtype)
    return jnp.sin(2 * jnp.pi * freq * t)


def white_noise(key: jax.Array, num_samples: int, dtype=None) -> jnp.ndarray:
    return jax.random.normal(key, (num_samples,), _float_dtype(dtype))


def chirp_linear(fs: float, num_samples: int, f0: float, f1: float,
                 t1: float, dtype=None) -> jnp.ndarray:
    """Linear chirp with scipy.signal.chirp semantics (phi=0):
    cos(2*pi*(f0*t + (f1-f0)/(2*t1)*t^2)) (signal_processing.py:32)."""
    t = time_axis(fs, num_samples, dtype)
    phase = 2 * jnp.pi * (f0 * t + 0.5 * (f1 - f0) / t1 * t * t)
    return jnp.cos(phase)


def pink_noise(key: jax.Array, fs: float, num_samples: int,
               dtype=None) -> jnp.ndarray:
    """White noise shaped by 1/sqrt(f) in the rFFT domain, DC zeroed, then
    normalized + compressed (signal_processing.py:11-23)."""
    dt = _float_dtype(dtype)
    white = jax.random.normal(key, (num_samples,), dt)
    spec = rfft_n(white, num_samples)
    freqs = jnp.fft.rfftfreq(num_samples, d=1.0 / fs).astype(dt)
    scaling = jnp.where(freqs > 0, 1.0 / jnp.sqrt(jnp.where(freqs > 0, freqs, 1.0)),
                        0.0)
    pink = irfft_n(spec * scaling, num_samples).astype(dt)
    return dynamic_range_compression(normalize_signal(pink))


def realistic_speech(key: jax.Array, fs: float, num_samples: int, duration: float,
                     dtype=None) -> jnp.ndarray:
    """Synthetic speech: 3 Hann-windowed formants + random Hann-windowed noise
    transients + 5% pink noise (signal_processing.py:38-64)."""
    dt = _float_dtype(dtype)
    t = time_axis(fs, num_samples, dt)
    f = jnp.array([800.0, 1150.0, 2900.0], dt)
    a = jnp.array([1.0, 0.8, 0.5], dt)
    phi = jnp.array([0.0, jnp.pi / 4, jnp.pi / 2], dt)
    # scipy get_window('hann') defaults to fftbins=True — the PERIODIC Hann
    # (cos over N), unlike np/jnp.hanning's symmetric cos over N-1.
    n_idx = jnp.arange(num_samples, dtype=dt)
    window = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * n_idx / num_samples)
    s_formant = jnp.sum(
        a[:, None] * jnp.sin(2 * jnp.pi * f[:, None] * t[None, :] + phi[:, None]),
        axis=0) * window

    num_transients = int(duration * 5)
    transient_samples = int(0.01 * fs)
    k_start, k_noise, k_pink = jax.random.split(key, 3)
    s_transient = jnp.zeros(num_samples, dt)
    if num_transients > 0 and transient_samples > 0:
        starts = jax.random.randint(
            k_start, (num_transients,), 0, num_samples - transient_samples)
        bursts = (jax.random.normal(k_noise, (num_transients, transient_samples), dt)
                  * jnp.hanning(transient_samples).astype(dt)[None, :])

        def add_burst(sig, args):
            start, burst = args
            idx = start + jnp.arange(transient_samples)
            return sig.at[idx].add(burst), None

        s_transient, _ = jax.lax.scan(add_burst, s_transient, (starts, bursts))

    s_pink = pink_noise(k_pink, fs, num_samples, dt) * 0.05
    s = s_formant + s_transient + s_pink
    return dynamic_range_compression(normalize_signal(s))


def generate_signal(signal_type: str, fs: float, duration: float, freq: float,
                    key: Optional[jax.Array] = None, dtype=None) -> jnp.ndarray:
    """Dispatcher matching generate_signal (signal_processing.py:25-36).
    `key` is required for the stochastic types ('noise', 'speech')."""
    num_samples = int(fs * duration)
    if signal_type == "sine":
        return sine(fs, num_samples, freq, dtype)
    if signal_type == "noise":
        if key is None:
            raise ValueError("signal_type 'noise' requires a PRNG key")
        return white_noise(key, num_samples, dtype)
    if signal_type == "chirp":
        return chirp_linear(fs, num_samples, freq, freq * 5, duration, dtype)
    if signal_type == "speech":
        if key is None:
            raise ValueError("signal_type 'speech' requires a PRNG key")
        return realistic_speech(key, fs, num_samples, duration, dtype)
    raise ValueError(
        "Unknown signal type. Available types: 'sine', 'noise', 'chirp', 'speech'")
