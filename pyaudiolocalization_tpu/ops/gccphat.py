"""GCC-PHAT cross-correlation — the estimation kernel of the framework.

Batched counterpart of ``phat_correlation`` (reference: utils.py:108-119):
``corr = ifft( (F s1 · conj F s2) / (|·| + 1e-10) ).real``.  Design:

  * real-input rfft/irfft (identical math for real signals — the whitened
    spectrum stays Hermitian);
  * all-pairs form: one rfft per *mic* (M transforms), then gather the
    (i, j) pair spectra and whiten/invert per pair — instead of the
    reference's 3 full FFTs per pair inside a Python loop (utils.py:112-118);
  * everything carries leading batch axes (scenes, pairs) so one XLA graph
    correlates thousands of pairs;
  * two lag conventions (SURVEY.md Q1): the raw ifft output is circular —
    lag 0 at index 0, negative lags wrapped at the end.  'physical' decodes
    that correctly; 'reference' reproduces the scipy-'full' index mapping the
    reference applies to it (utils.py:141-142), off by n2-1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .fftutils import fft_length, rfft_n, irfft_n

PHAT_EPS = 1e-10

#: Generalized cross-correlation weightings (Knapp & Carter 1976).  The
#: reference implements only PHAT (utils.py:108-119); the rest are
#: physical-mode extensions.  'cc' = unweighted cross-correlation;
#: 'roth' divides by the first channel's auto-spectrum (the Wiener/
#: least-squares weighting); 'scot' divides by the geometric mean of both
#: auto-spectra (per-channel gain/coloration invariant); 'ml' is the
#: Hannan-Thomson maximum-likelihood weighting |g|^2/(|S12|(1-|g|^2)) —
#: only meaningful with spectrally AVERAGED estimates (streaming/Welch
#: path): a single-snapshot periodogram has coherence identically 1, so
#: the clamped 'ml' collapses to a scaled PHAT there.
GCC_WEIGHTINGS = ("phat", "scot", "roth", "cc", "ml")


def _weight_cross(cross: jnp.ndarray,
                  auto_i: Optional[jnp.ndarray],
                  auto_j: Optional[jnp.ndarray],
                  weighting: str, eps: float) -> jnp.ndarray:
    """Apply a GCC frequency weighting to a cross-spectrum.

    auto_i/auto_j are the (real, >=0) auto power spectra of the two
    channels on the same bin axis; only consulted for the weightings that
    need them.  All denominators are eps-regularized the same way the
    reference regularizes PHAT (utils.py:116), and every constant here is
    a normal float32 number (no 1e-300-style guards, which float32 would
    flush to zero)."""
    if weighting == "phat":
        return _whiten(cross, eps)
    if weighting == "cc":
        return cross
    if weighting == "roth":
        return cross / (auto_i + eps)
    if weighting == "scot":
        return cross / (jnp.sqrt(auto_i * auto_j) + eps)
    if weighting == "ml":
        mag2 = jnp.real(cross) ** 2 + jnp.imag(cross) ** 2
        # Magnitude-squared coherence, clamped away from 1: the HT weight
        # diverges as coherence -> 1, and averaged f32 estimates can land
        # within rounding of 1.  The 1e-4 cap bounds the per-bin boost at
        # ~1e4x — far above any physically averaged coherence.
        coh2 = jnp.minimum(mag2 / jnp.maximum(auto_i * auto_j, eps),
                           1.0 - 1e-4)
        return cross * (coh2 / (jnp.sqrt(mag2) * (1.0 - coh2) + eps))
    raise ValueError(f"unknown GCC weighting {weighting!r}; expected one of "
                     f"{GCC_WEIGHTINGS}")


def _whiten(spec: jnp.ndarray, eps: float) -> jnp.ndarray:
    """spec / (|spec| + eps), elementwise over a complex array."""
    re, im = jnp.real(spec), jnp.imag(spec)
    inv = 1.0 / (jnp.sqrt(re * re + im * im) + eps)
    return spec * inv


def phat_correlation(sig1: jnp.ndarray, sig2: jnp.ndarray,
                     nfft: Optional[int] = None, eps: float = PHAT_EPS,
                     weighting: str = "phat") -> jnp.ndarray:
    """Weighted cross-correlation of two signals (leading axes broadcast).

    With nfft=None the exact reference length n1+n2-1 is used; the output is
    in circular order exactly like the reference's (utils.py:118).
    ``weighting`` selects the GCC frequency weighting (GCC_WEIGHTINGS);
    'phat' is the reference's estimator.
    """
    n1, n2 = sig1.shape[-1], sig2.shape[-1]
    n = nfft if nfft is not None else fft_length(n1, n2, "exact")
    s1 = rfft_n(sig1, n)
    s2 = rfft_n(sig2, n)
    cross = s1 * jnp.conj(s2)
    if weighting in ("phat", "cc"):
        auto1 = auto2 = None
    else:
        auto1 = jnp.real(s1) ** 2 + jnp.imag(s1) ** 2
        auto2 = jnp.real(s2) ** 2 + jnp.imag(s2) ** 2
    r = _weight_cross(cross, auto1, auto2, weighting, eps)
    return irfft_n(r, n).astype(sig1.dtype)


def gcc_phat_all_pairs(signals: jnp.ndarray,
                       pairs_i: np.ndarray,
                       pairs_j: np.ndarray,
                       nfft: Optional[int] = None,
                       eps: float = PHAT_EPS,
                       band: Optional[Tuple[float, float]] = None,
                       fs: Optional[float] = None,
                       weighting: str = "phat") -> jnp.ndarray:
    """GCC for every mic pair at once (PHAT-weighted by default).

    signals: (..., M, N); pairs_i/pairs_j: static int arrays of length P
    (i < j, reference loop order main.py:202-203).  Returns (..., P, n).
    One rfft batch of M transforms replaces the reference's 3 FFTs per pair.

    ``band=(lo_hz, hi_hz)`` (with ``fs``) enables band-limited PHAT: bins
    outside the band are zeroed after whitening.  After bandpass filtering,
    out-of-band bins hold only filter transients / noise that are common
    across channels; plain PHAT boosts them to unit weight, planting a
    spurious peak at lag 0 (the reference's defect Q5, SURVEY.md).  Band
    limiting is the physically-correct estimator and is used by the sweep
    path; the reference-parity path leaves it off.
    """
    n_samp = signals.shape[-1]
    n = nfft if nfft is not None else fft_length(n_samp, n_samp, "exact")
    spec = rfft_n(signals, n)
    cross = jnp.take(spec, pairs_i, axis=-2) * jnp.conj(
        jnp.take(spec, pairs_j, axis=-2))                  # (..., P, F)
    if weighting in ("phat", "cc"):
        auto_i = auto_j = None
    else:
        auto = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2   # (..., M, F)
        auto_i = jnp.take(auto, pairs_i, axis=-2)
        auto_j = jnp.take(auto, pairs_j, axis=-2)
    white = _weight_cross(cross, auto_i, auto_j, weighting, eps)
    if band is not None:
        if fs is None:
            raise ValueError("band-limited PHAT requires fs")
        freqs = np.fft.rfftfreq(n, d=1.0 / fs)
        mask = jnp.asarray((freqs >= band[0]) & (freqs <= band[1]),
                           signals.dtype)
        white = white * mask
    return irfft_n(white, n).astype(signals.dtype)


def gcc_phat_streaming(signals: jnp.ndarray,
                       pairs_i: np.ndarray,
                       pairs_j: np.ndarray,
                       frame: int = 8192,
                       hop: Optional[int] = None,
                       max_lag: Optional[int] = None,
                       eps: float = PHAT_EPS,
                       window: str = "hann",
                       weighting: str = "phat") -> Tuple[jnp.ndarray, np.ndarray]:
    """Blockwise GCC for long recordings (SURVEY.md §5.7; PHAT default).

    The reference transforms at the full signal length (utils.py:112-114) —
    O(T) memory per pair and a single giant FFT.  For long captures this
    framing estimator accumulates Welch-averaged cross-power spectra over
    windowed frames and whitens the AVERAGE — O(frame) memory per pair,
    power-of-two FFTs, and statistically a *better*
    TDOA estimator than one long correlation (averaging suppresses
    noise-induced phase jitter).  Physical lags only (there is no reference
    semantics to mirror — this subsystem is new design space).

    ``weighting`` selects the GCC frequency weighting (GCC_WEIGHTINGS).
    This is the path where the Hannan-Thomson 'ml' weighting is
    statistically meaningful: the Welch-averaged cross/auto spectra give a
    non-degenerate coherence estimate, so 'ml' down-weights bins where the
    channels decohere (low SNR, reverberant smearing) by exactly the
    inverse phase-variance — the Cramér-Rao-optimal weighting.

    signals: (..., M, T); frame must be a power of two; hop defaults to
    frame//2.  Returns (corr (..., P, 2*max_lag+1), lags (2*max_lag+1,))
    with lag 0 centered; max_lag defaults to frame//4 and must satisfy
    max_lag < frame//2 (beyond that, circular aliasing).
    """
    if frame & (frame - 1):
        raise ValueError("frame must be a power of two")
    hop = frame // 2 if hop is None else hop
    max_lag = frame // 4 if max_lag is None else max_lag
    if not 0 < max_lag < frame // 2:
        # < frame//2: the centered slice needs 2*max_lag+1 <= frame, and at
        # exactly frame//2 the +max_lag label would alias -max_lag.
        raise ValueError("max_lag must be in (0, frame//2)")
    t = signals.shape[-1]
    if t < frame:
        raise ValueError("signal shorter than one frame")
    num_frames = 1 + (t - frame) // hop
    starts = np.arange(num_frames) * hop

    if window == "hann":
        n_ = jnp.arange(frame, dtype=signals.dtype)
        win = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * n_ / frame)
    elif window == "rect":
        win = jnp.ones(frame, signals.dtype)
    else:
        raise ValueError("window must be 'hann' or 'rect'")

    # (..., M, F, frame) frames; static frame count keeps this one gather.
    idx = starts[:, None] + np.arange(frame)[None, :]
    frames = jnp.take(signals, jnp.asarray(idx), axis=-1) * win
    spec = jnp.fft.rfft(frames, n=frame)                    # (..., M, F, bins)
    cross = jnp.mean(
        jnp.take(spec, pairs_i, axis=-3) *
        jnp.conj(jnp.take(spec, pairs_j, axis=-3)), axis=-2)  # (..., P, bins)
    if weighting in ("phat", "cc"):
        auto_i = auto_j = None
    else:
        auto = jnp.mean(jnp.real(spec) ** 2 + jnp.imag(spec) ** 2,
                        axis=-2)                            # (..., M, bins)
        auto_i = jnp.take(auto, pairs_i, axis=-2)
        auto_j = jnp.take(auto, pairs_j, axis=-2)
    white = _weight_cross(cross, auto_i, auto_j, weighting, eps)
    corr = jnp.fft.irfft(white, n=frame).astype(signals.dtype)
    # Circular order -> centered slice of +-max_lag.
    centered = jnp.roll(corr, max_lag, axis=-1)[..., : 2 * max_lag + 1]
    lags = np.arange(-max_lag, max_lag + 1)
    return centered, lags


def tdoa_from_streaming(corr: jnp.ndarray, lags: np.ndarray, fs: float):
    """Peak lag (seconds) of a centered streaming correlation, with
    parabolic sub-sample refinement."""
    idx = jnp.argmax(corr, axis=-1)
    i = jnp.clip(idx, 1, corr.shape[-1] - 2)
    ym = jnp.take_along_axis(corr, (i - 1)[..., None], -1)[..., 0]
    y0 = jnp.take_along_axis(corr, i[..., None], -1)[..., 0]
    yp = jnp.take_along_axis(corr, (i + 1)[..., None], -1)[..., 0]
    denom = ym - 2.0 * y0 + yp
    frac = jnp.where(jnp.abs(denom) > 1e-12,
                     0.5 * (ym - yp) / jnp.where(denom == 0, 1.0, denom), 0.0)
    base = jnp.take(jnp.asarray(lags, corr.dtype), idx)
    return (base + jnp.where(idx == i, frac, 0.0)) / fs


# ---------------------------------------------------------------------------
# Lag conventions
# ---------------------------------------------------------------------------

def lags_reference(n1: int, n2: int, n: int) -> np.ndarray:
    """The reference's (defective, Q1) lag axis: scipy correlation_lags
    'full' values indexed positionally against the circular array
    (utils.py:141-142): lag[k] = k - (n2 - 1), extended to length n."""
    return np.arange(n) - (n2 - 1)


def lags_physical(n1: int, n: int) -> np.ndarray:
    """Correct circular decoding: index k holds linear-correlation lag
    m = k for k < n1 and m = k - n otherwise."""
    k = np.arange(n)
    return np.where(k < n1, k, k - n)


def lag_axis(mode: str, n1: int, n2: int, n: int) -> np.ndarray:
    if mode in ("reference", "compat"):
        return lags_reference(n1, n2, n)
    if mode == "physical":
        return lags_physical(n1, n)
    raise ValueError(f"unknown lag mode {mode!r}")
