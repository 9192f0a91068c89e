"""FFT length helpers and exact-length real transforms.

The reference always transforms at exactly n1+n2-1 samples (utils.py:112-114)
and fractional delays at exactly 2N (signal_processing.py:69) — large
non-power-of-2 lengths such as 88199 = 89·991.  XLA's FFT (cuFFT on the GPU,
DUCC on the CPU) takes any length, so ``rfft_n`` / ``irfft_n`` are plain
``jnp.fft`` calls at that length; ``fft_length`` picks the transform length
for each path (exact for reference parity, power-of-two on the physical
paths).
"""

from __future__ import annotations

import jax.numpy as jnp


def next_pow2(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def fft_length(n1: int, n2: int, mode: str = "pow2") -> int:
    """Linear-correlation FFT length for signals of length n1 and n2.

    mode='exact' reproduces the reference's n1+n2-1; mode='pow2' rounds up to
    a power of two (peak positions are unchanged; per-bin whitening weights
    differ slightly — see SURVEY.md §5.7).
    """
    n = n1 + n2 - 1
    if mode == "exact":
        return n
    if mode == "pow2":
        return next_pow2(n)
    if mode == "circular":
        # next_pow2(max(n1, n2)): the correlation is circular — lag l
        # aliases with l -/+ nfft.  For whitened (PHAT) correlations the
        # aliased background is noise-level, so windowed peak picking at
        # small |l| is unaffected while the FFTs halve in size.  Physical
        # mode only; never used for reference parity.
        return next_pow2(max(n1, n2))
    raise ValueError(f"unknown fft length mode {mode!r}")


def rfft_n(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """``jnp.fft.rfft(x, n=n)`` over the last axis (zero-pad or truncate)."""
    return jnp.fft.rfft(x, n=n)


def irfft_n(spec: jnp.ndarray, n: int) -> jnp.ndarray:
    """``jnp.fft.irfft(spec, n=n)`` over the last axis."""
    return jnp.fft.irfft(spec, n=n)
