"""TDOA extraction from GCC-PHAT correlations, with the reference's full
fallback ladder and significance statistics — batched and branchless.

Counterpart of ``get_time_delays_phat`` (reference: utils.py:121-181) and the
significance stack (utils.py:183-271).  The ladder — median threshold ->
mean threshold -> global argmax, then the optional max_expected_delay window
with its own re-run — becomes per-row masked selection over precomputed
candidate sets, so a whole (scenes, pairs) batch resolves in one XLA graph
with no data-dependent Python control flow.

Lag semantics are mode-switched (SURVEY.md Q1): 'reference' reproduces the
scipy-'full' positional mapping defect; 'physical' decodes the circular
correlation correctly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import gccphat
from ..ops import peaks as peaks_ops
from ..ops.quantile import median_nonneg
from ..ops.fftutils import rfft_n, irfft_n


class TdoaResult(NamedTuple):
    delays: jnp.ndarray       # (..., num_peaks) seconds
    valid: jnp.ndarray        # (..., num_peaks) bool
    corr: jnp.ndarray         # (..., n) whitened correlation (circular order)
    time_lags: jnp.ndarray    # (n,) lag axis in seconds (mode-dependent)


def _first_k_valid(pos, heights, keep, k):
    pos, heights, keep = peaks_ops.compact_valid(pos, heights, keep)
    return pos[..., :k], heights[..., :k], keep[..., :k]


def time_delays_from_corr(corr: jnp.ndarray,
                          n1: int,
                          n2: int,
                          fs: float,
                          num_peaks: int = 1,
                          threshold_method: str = "median",
                          threshold_multiplier: float = 1.0,
                          max_expected_delay: Optional[float] = None,
                          lag_mode: str = "reference",
                          num_candidates: int = 128,
                          threshold_subsample: int = 7) -> TdoaResult:
    """Extract up to ``num_peaks`` delays per row of ``corr`` (circular-order
    whitened correlation, last axis length n)."""
    n = corr.shape[-1]
    num_candidates = min(num_candidates, n)  # top_k requires k <= length
    if lag_mode == "physical":
        # Center lag 0 so true peaks near zero delay are interior samples —
        # on the raw circular array they sit at the edges, where local-maxima
        # detection (like scipy's, utils.py:152) cannot see them.
        # Alias-free transforms (n >= n1+n2-1) hold linear lags in
        # [-(n2-1), n1-1]: rolling by n2-1 labels every index exactly (n//2
        # would mislabel unequal-length pairs whose |lag| exceeds n//2).
        # Shorter (circular-mode) transforms wrap, so split symmetrically.
        shift = n2 - 1 if n >= n1 + n2 - 1 else n // 2
        corr = jnp.roll(corr, shift, axis=-1)
        lags = np.arange(n) - shift
    else:
        lags = gccphat.lag_axis(lag_mode, n1, n2, n)
    time_lags = jnp.asarray(lags, corr.dtype) / fs

    abs_corr = jnp.abs(corr)
    if threshold_method == "adaptive":
        thr_primary = threshold_multiplier * (
            jnp.mean(abs_corr, -1, keepdims=True) + jnp.std(abs_corr, -1, keepdims=True))
    elif threshold_method == "gaussian":
        # Gaussian-calibrated median estimate (new design space, not a
        # reference mode): whitened correlation bins off the peak are
        # ~zero-mean Gaussian, where median|x| = 0.6745*sigma and
        # mean|x| = 0.7979*sigma, so 0.84535*mean|x| estimates the median in
        # ONE reduction pass instead of an order-statistic search.  The few
        # genuine peak bins shift the mean by O(peaks/n) — negligible at the
        # 2^16-bin correlations this gates.  Only the threshold ladder sees
        # the difference; selected peaks are the in-window maxima either way.
        thr_primary = (threshold_multiplier * 0.84535
                       * jnp.mean(abs_corr, -1, keepdims=True))
    else:  # 'median' and the reference's unknown-method fallback (utils.py:149)
        # Exact median via bit-bisection (ops/quantile.py): a reduction pass
        # instead of sorting the whole (scenes, pairs, n) tensor.  In
        # physical mode (new design space) the bisection runs on a strided
        # subsample — the threshold is a statistic over ~n/7 whitened bins
        # whose sampling error is far below the peak/threshold gap; parity
        # mode stays exact.  The stride is PRIME so tonal sources whose
        # |corr| period divides an even stride cannot phase-lock the
        # subsample onto a single point of the oscillation.
        stride = threshold_subsample if (lag_mode == "physical"
                                         and threshold_subsample > 1
                                         and n >= 64 * threshold_subsample) \
            else 1
        thr_primary = (threshold_multiplier
                       * median_nonneg(abs_corr[..., ::stride])[..., None])
    thr_alt = jnp.mean(abs_corr, -1, keepdims=True)  # utils.py:155

    distance = int(fs * 0.001)  # min 1 ms peak spacing (utils.py:151)

    if lag_mode == "physical" and max_expected_delay is not None:
        # Fast path: after centering, the lag window is one contiguous
        # STATIC slice around n//2 — run candidate selection there instead of
        # top-k over the full correlation.  Threshold-existence tests
        # (utils.py:153-160 ladder) still scan the full array (cheap masks),
        # and the argmax fallback is global, so semantics are preserved.
        # The slice is dilated by 8 peak-distances so suppression chains of
        # in-window candidates are present (longer chains of ever-taller
        # peaks marching out of the window are pathological; documented
        # approximation).
        half = int(np.ceil(max_expected_delay * fs)) + 8 * max(distance, 1)
        c0 = max(0, shift - half)
        c1 = min(n, shift + half + 1)
        corr_s = corr[..., c0:c1]
        lm = peaks_ops.local_maxima(corr)
        any_a = jnp.any(lm & (corr >= thr_primary), -1, keepdims=True)
        any_b = jnp.any(lm & (corr >= thr_alt), -1, keepdims=True)
        pos_s, h_s, keep_a, keep_b = peaks_ops.select_peaks_two(
            corr_s, thr_primary, thr_alt, distance,
            min(num_candidates, c1 - c0))
        set_a = (pos_s + c0, h_s, keep_a)
        set_b = (pos_s + c0, h_s, keep_b)
        cnt_a = any_a.astype(jnp.int32)
        cnt_b = any_b.astype(jnp.int32)
    else:
        window_mask = None
        if max_expected_delay is not None:
            # Dilated by a few peak-distances so suppressors of in-window
            # candidates are present in the candidate set (see select_peaks).
            dilated = max_expected_delay + 4.0 * distance / fs
            window_mask = jnp.abs(time_lags) <= dilated
        # Parity mode is bit-exact scipy find_peaks, plateau midpoints
        # included (utils.py:152); physical mode keeps the strict (cheaper)
        # local-maxima test — plateaus are measure-zero on whitened
        # correlations.
        plateaus = lag_mode == "reference"
        set_a = peaks_ops.select_peaks(corr, thr_primary, distance,
                                       num_candidates, window_mask=window_mask,
                                       plateaus=plateaus)
        set_b = peaks_ops.select_peaks(corr, thr_alt, distance,
                                       num_candidates, window_mask=window_mask,
                                       plateaus=plateaus)
        cnt_a = jnp.sum(set_a[2], -1, keepdims=True)
        cnt_b = jnp.sum(set_b[2], -1, keepdims=True)

    use_a = cnt_a > 0
    stage1 = tuple(jnp.where(use_a, xa, xb) for xa, xb in zip(set_a, set_b))
    # Ladder bottom: neither threshold found peaks -> argmax of corr
    # (utils.py:157-160).
    argmax_fallback = (cnt_a == 0) & (cnt_b == 0)

    if max_expected_delay is not None:
        cand_lags = jnp.take(time_lags, stage1[0])
        w1 = stage1[2] & (jnp.abs(cand_lags) <= max_expected_delay)
        cand_lags_b = jnp.take(time_lags, set_b[0])
        w2 = set_b[2] & (jnp.abs(cand_lags_b) <= max_expected_delay)
        have1 = jnp.sum(w1, -1, keepdims=True) > 0
        have2 = jnp.sum(w2, -1, keepdims=True) > 0
        final = tuple(
            jnp.where(have1, s1, jnp.where(have2, s2, s1))
            for s1, s2 in zip((stage1[0], stage1[1], w1), (set_b[0], set_b[1], w2)))
        # No peaks in-window anywhere -> argmax fallback (utils.py:169-172),
        # but only on rows that had peaks at all (otherwise already argmax).
        argmax_fallback = argmax_fallback | (~have1 & ~have2)
    else:
        final = stage1

    pos, heights, keep = _first_k_valid(*final, num_peaks)
    delays = jnp.take(time_lags, pos)
    valid = keep

    # Argmax fallback overrides slot 0 with time_lags[argmax(corr)].
    am = jnp.argmax(corr, axis=-1)
    am_delay = jnp.take(time_lags, am)
    fb = argmax_fallback[..., 0] if argmax_fallback.ndim == delays.ndim else argmax_fallback
    slot = jnp.arange(num_peaks) == 0
    delays = jnp.where(fb[..., None] & slot, am_delay[..., None], delays)
    valid = jnp.where(fb[..., None], slot, valid)
    return TdoaResult(delays, valid, corr, time_lags)


def get_time_delays_phat(sig1: jnp.ndarray, sig2: jnp.ndarray, fs: float,
                         num_peaks: int = 1,
                         threshold_method: str = "median",
                         threshold_multiplier: float = 1.0,
                         max_expected_delay: Optional[float] = None,
                         lag_mode: str = "reference",
                         nfft: Optional[int] = None) -> TdoaResult:
    """Single-pair convenience matching the reference call shape
    (utils.py:121-181)."""
    corr = gccphat.phat_correlation(sig1, sig2, nfft=nfft)
    return time_delays_from_corr(
        corr, sig1.shape[-1], sig2.shape[-1], fs, num_peaks,
        threshold_method, threshold_multiplier, max_expected_delay, lag_mode)


# ---------------------------------------------------------------------------
# Correlation quality metrics (reference utils.py:228-271)
# ---------------------------------------------------------------------------

def peak_to_peak_ratio(corr: jnp.ndarray) -> jnp.ndarray:
    """max / |min|; inf when the trough is exactly zero (utils.py:228-236)."""
    peak = jnp.max(corr, -1)
    trough = jnp.min(corr, -1)
    return jnp.where(trough == 0, jnp.inf, peak / jnp.abs(jnp.where(trough == 0, 1, trough)))


def correlation_snr(corr: jnp.ndarray) -> jnp.ndarray:
    """Peak over the std of the correlation outside a ±1%-length window
    around the peak (utils.py:238-250), as masked statistics."""
    n = corr.shape[-1]
    peak = jnp.max(corr, -1)
    peak_idx = jnp.argmax(corr, -1)
    window = max(1, int(0.01 * n))
    start = jnp.maximum(0, peak_idx - window)
    end = jnp.minimum(n, peak_idx + window)
    idx = jnp.arange(n)
    outside = (idx < start[..., None]) | (idx >= end[..., None])
    count = jnp.sum(outside, -1)
    safe = jnp.maximum(count, 1)
    mean = jnp.sum(jnp.where(outside, corr, 0), -1) / safe
    var = jnp.sum(jnp.where(outside, (corr - mean[..., None]) ** 2, 0), -1) / safe
    noise = jnp.sqrt(var)
    return jnp.where(noise == 0, jnp.inf, peak / jnp.where(noise == 0, 1, noise))


def bootstrap_significance(sig1: jnp.ndarray, sig2: jnp.ndarray,
                           key: jax.Array,
                           num_bootstrap: int = 1000,
                           alpha: float = 0.05,
                           bootstrap_mode: str = "permutation",
                           block_size: int = 50,
                           nfft: Optional[int] = None,
                           chunk: int = 64) -> jnp.ndarray:
    """Null distribution threshold for the PHAT peak (utils.py:183-216).

    The reference's dominant cost — 1000 serial resample+3-FFT iterations
    per pair (~258 s of the 274 s default run, SURVEY.md §6) — becomes
    batched device FFTs: FFT(sig1) once, then chunks of shuffled sig2
    transformed together.

    ``bootstrap_mode='noise'`` is a physical-mode SURROGATE for
    'permutation': a permuted row is exchangeable, so its padded-window
    spectrum is asymptotically complex Gaussian with the SAME
    Dirichlet-kernel bin covariance as a length-n white-noise burst, and
    PHAT whitening cancels the amplitude spectrum — the permutation null
    equals the white-noise null within Monte-Carlo error
    (tests/test_bootstrap_noise.py; a full-band phase surrogate, which
    ignores the zero-padding DOF structure, measured 12% low and was
    rejected).  Each draw therefore synthesizes a fresh length-n noise
    row with ``jax.random`` (no permutation sort) and runs the same
    fwd/whiten/inverse/max pipeline.  Parity callers keep 'permutation'.
    """
    n2 = sig2.shape[-1]
    n = nfft if nfft is not None else sig1.shape[-1] + n2 - 1
    if bootstrap_mode == "noise":
        peaks = _noise_null_peaks(sig1, sig2, key, num_bootstrap, n)
        return jnp.percentile(peaks, 100.0 * (1.0 - alpha))
    # rfft_n truncates signals longer than n, like the reference's np.fft.
    s1 = rfft_n(sig1, n)

    def resample(k):
        if bootstrap_mode == "permutation":
            return jax.random.permutation(k, sig2)
        if bootstrap_mode == "block":
            num_blocks = -(-n2 // block_size)
            padded = jnp.pad(sig2, (0, num_blocks * block_size - n2))
            blocks = padded.reshape(num_blocks, block_size)
            perm = jax.random.permutation(k, num_blocks)
            return blocks[perm].reshape(-1)[:n2]
        if bootstrap_mode == "circular":
            shift = jax.random.randint(k, (), 0, n2)
            return jnp.roll(sig2, shift)
        raise ValueError("Unknown bootstrap_mode. Use 'permutation', "
                         "'block', 'circular' or 'noise'.")

    def chunk_peaks(ks):
        shuf = jax.vmap(resample)(ks)                        # (chunk, n2)
        return _null_peaks(s1, shuf, n)

    num_chunks = -(-num_bootstrap // chunk)
    keys = jax.random.split(key, num_chunks * chunk).reshape(num_chunks, chunk, -1)
    peaks = jax.lax.map(chunk_peaks, keys).reshape(-1)[:num_bootstrap]
    return jnp.percentile(peaks, 100.0 * (1.0 - alpha))


def _null_peaks(s1: jnp.ndarray, rows: jnp.ndarray, n: int) -> jnp.ndarray:
    """Peak of the PHAT correlation between the fixed spectrum ``s1``
    (rfft_n(sig1, n)) and each row of ``rows`` (chunk, len): the bootstrap
    null statistic max(irfft(W / (|W| + eps))), W = s1 * conj(rfft(row))."""
    r = s1[None, :] * jnp.conj(rfft_n(rows, n))
    r = r / (jnp.abs(r) + gccphat.PHAT_EPS)
    return jnp.max(irfft_n(r, n), axis=-1)


def _noise_null_peaks(sig1, sig2, key, num_bootstrap, n):
    """Peak maxima of PHAT correlations between sig1 and fresh length-n2
    noise rows (see bootstrap_mode='noise').  sig2 enters only through its
    LENGTH (the null's degrees of freedom — the Dirichlet bin covariance
    of an n2-of-n padded window); PHAT cancels its spectrum anyway."""
    n2_len = sig2.shape[-1]
    s1 = rfft_n(sig1, n)

    def chunk_peaks(ks):
        rows = jax.vmap(lambda k: jax.random.uniform(
            k, (n2_len,), sig1.dtype, -0.5, 0.5))(ks)
        return _null_peaks(s1, rows, n)

    chunk = 64
    num_chunks = -(-num_bootstrap // chunk)
    keys = jax.random.split(key, num_chunks * chunk).reshape(
        num_chunks, chunk, -1)
    return jax.lax.map(chunk_peaks, keys).reshape(-1)[:num_bootstrap]


def significance_test(corr: jnp.ndarray, sig1: jnp.ndarray, sig2: jnp.ndarray,
                      key: jax.Array, alpha: float = 0.05,
                      snr_threshold: float = 2.0,
                      num_bootstrap: int = 1000,
                      nfft: Optional[int] = None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Combined bootstrap + SNR significance (utils.py:252-259): returns
    (snr, significant)."""
    snr = correlation_snr(corr)
    peak = jnp.max(corr, -1)
    threshold = bootstrap_significance(
        sig1, sig2, key, num_bootstrap=num_bootstrap, alpha=alpha, nfft=nfft)
    significant = (peak > threshold) & (snr > snr_threshold)
    return snr, significant


def cross_correlation_metrics(corr: jnp.ndarray, sig1: jnp.ndarray,
                              sig2: jnp.ndarray, key: jax.Array,
                              alpha: float = 0.05,
                              num_bootstrap: int = 1000,
                              nfft: Optional[int] = None) -> dict:
    """Metric dict matching compute_cross_correlation_metrics
    (utils.py:261-271)."""
    ppr = peak_to_peak_ratio(corr)
    snr, significant = significance_test(
        corr, sig1, sig2, key, alpha=alpha, num_bootstrap=num_bootstrap, nfft=nfft)
    return {"peak_to_peak_ratio": ppr, "snr": snr, "significant": significant}


def compute_weights(snr: jnp.ndarray) -> jnp.ndarray:
    """Per-pair solver weights: each pair's SNR metric normalized by the
    mean weight (compute_weights, reference utils.py:484-497; missing
    metrics default to 1.0 upstream)."""
    mean = jnp.mean(snr)
    return jnp.where(mean != 0, snr / jnp.where(mean == 0, 1, mean), snr)
