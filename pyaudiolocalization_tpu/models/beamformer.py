"""Narrowband steered-power (Bartlett) localization.

No reference counterpart — this closes a measured estimator gap: GCC-PHAT
on narrowband sources (e.g. the reference's default 1 kHz sine,
main.py:26-64) has an inherently periodic correlation, so TDOA peaks are
ambiguous modulo the carrier period (measured ~17 cm localization error for
an off-center sine via the physical TDOA path).  A steered beamformer uses
the array's PHASE response directly: for candidate position x and frequency
bin k,

    P(x) = sum_k w_k | (1/M) sum_m S_m(k) * exp(+i w_k d_m(x) / c) |^2

which is unambiguous as long as the array is dense enough to avoid spatial
aliasing (inter-mic spacing vs wavelength), regardless of the source's
bandwidth.

Measured envelope (unit-cube arrays, free field): a 4-mic tetrahedron is
ambiguous for pure tones (6 phase constraints, strong grating lobes —
0.5-1 m errors); an 8-mic cube localizes 500-1000 Hz tones to 3-6 mm
(where the GCC-PHAT/TDOA chain measures ~17 cm), and re-aliases at 2 kHz
where the wavelength (17 cm) is far below the 1 m spacing.  Real
multi-harmonic sources fare better than these single-bin worst cases.

Shape: the map is pure dense linear algebra — distances (G, M)
once, per-bin steering phases as cos/sin planes, and the per-bin steered
sum as a (G, M) x (M,) matvec — no gathers, no data-dependent control flow.
Bin selection (top-energy bins of the mean spectrum) is a static-size
top_k.  Two-stage grid search like models/srp.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .srp import two_stage_search


class BeamResult(NamedTuple):
    position: jnp.ndarray   # (..., 3)
    power: jnp.ndarray      # (...,) steered power at the estimate
    coarse: jnp.ndarray     # (..., 3) stage-1 cell center (diagnostics)


def select_bins(spectra: jnp.ndarray, fs: float, nfft: int, num_bins: int,
                band: Optional[Tuple[float, float]] = None,
                weight_exponent: float = 0.3):
    """Pick the ``num_bins`` strongest rfft bins of the mean magnitude
    spectrum (optionally restricted to ``band`` Hz).  Returns
    (bin_indices (B,), weights (B,)): weights are the mean powers raised to
    ``weight_exponent`` and normalized.  TEMPERED weighting matters for
    tonal sources: with raw powers the fundamental swamps its (compression/
    nonlinearity) harmonics, and a grating lobe that happens to align the
    fundamental's phase wins; tempered weights let the harmonics — which
    misalign at the rival lobe — veto it (measured: fixes the occasional
    half-meter grating pick on 800 Hz sine sweeps at identical broadband
    accuracy)."""
    power = jnp.mean(jnp.abs(spectra) ** 2, axis=0)            # (bins,)
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    if band is not None:
        mask = jnp.asarray((freqs >= band[0]) & (freqs <= band[1]),
                           power.dtype)
        power = power * mask
    vals, idx = jax.lax.top_k(power, num_bins)
    tempered = jnp.maximum(vals, 0.0) ** weight_exponent
    tempered = jnp.where(vals > 0, tempered, 0.0)
    w = tempered / jnp.maximum(jnp.sum(tempered), 1e-30)
    return idx, w


def steered_power_map(spectra: jnp.ndarray,
                      bin_idx: jnp.ndarray,
                      bin_w: jnp.ndarray,
                      points: jnp.ndarray,
                      mic_positions: jnp.ndarray,
                      fs: float,
                      nfft: int,
                      c) -> jnp.ndarray:
    """Bartlett steered power for each candidate point.

    spectra: (M, bins) complex rfft of the mic signals; bin_idx/bin_w: (B,)
    selected bins + weights; points: (G, 3).  Returns (G,)."""
    m = spectra.shape[0]
    d = jnp.linalg.norm(points[:, None, :] - mic_positions[None, :, :],
                        axis=-1)                                # (G, M)
    omega = 2.0 * jnp.pi * bin_idx.astype(d.dtype) * (fs / nfft)  # (B,)
    s_sel = spectra[:, bin_idx]                                 # (M, B)
    sr, si = jnp.real(s_sel), jnp.imag(s_sel)
    # Steering aligns each mic's observed phase back to the source:
    # multiply S_m(k) by exp(+i w d_m / c) and coherently average over mics.
    theta = (d[:, :, None] / c) * omega[None, None, :]          # (G, M, B)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    yr = jnp.einsum("gmb,mb->gb", ct, sr) - jnp.einsum("gmb,mb->gb", st, si)
    yi = jnp.einsum("gmb,mb->gb", ct, si) + jnp.einsum("gmb,mb->gb", st, sr)
    # Normalize out per-bin magnitude so loud bins don't dominate beyond
    # their selection weight (phase-coherence metric, PHAT-like per bin).
    mag2 = jnp.sum(sr * sr + si * si, axis=0) + 1e-30           # (B,)
    return jnp.sum(bin_w[None, :] * (yr * yr + yi * yi) / mag2[None, :],
                   axis=-1) / m


def beamform_locate(signals: jnp.ndarray,
                    mic_positions: jnp.ndarray,
                    fs: float,
                    c,
                    lower: jnp.ndarray,
                    upper: jnp.ndarray,
                    num_bins: int = 12,
                    band: Optional[Tuple[float, float]] = None,
                    coarse_n: int = 24,
                    fine_n: int = 12,
                    nfft: Optional[int] = None) -> BeamResult:
    """Two-stage steered-power grid search over the box [lower, upper].

    signals: (M, N) time-domain mic signals.  Unlike the GCC/SRP chain this
    needs no whitening and no lag decoding, and it localizes NARROWBAND
    sources (single tones) that defeat correlation-based TDOA outright.
    Fully jittable; vmap over a leading scene axis for batches."""
    n = signals.shape[-1]
    nf = int(nfft) if nfft is not None else n
    spectra = jnp.fft.rfft(signals, n=nf)
    bin_idx, bin_w = select_bins(spectra, fs, nf, num_bins, band)

    def map_fn(p):
        return steered_power_map(spectra, bin_idx, bin_w, p, mic_positions,
                                 fs, nf, c)

    pos, power, center, _ = two_stage_search(map_fn, map_fn, lower, upper,
                                             coarse_n, fine_n, signals.dtype)
    return BeamResult(jnp.clip(pos, lower, upper), power, center)


def extract_source(signals: jnp.ndarray,
                   mic_positions: jnp.ndarray,
                   position,
                   fs: float,
                   c,
                   mic_weights: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Beamformed AUDIO extraction: delay-and-sum the array toward
    ``position`` and return the enhanced time-domain signal (the listening
    half of localize -> listen; no reference counterpart).

    Each microphone is advanced by its extra propagation delay relative to the
    CLOSEST mic (fractional, via an rfft phase ramp at a static pow2 length),
    then averaged.  The target's wavefronts add coherently while incoherent
    noise adds in power, so SNR improves by ~M (the classic array gain) and
    interferers away from ``position`` are attenuated by the array's spatial
    response.  For directional interferers that the fixed response does not
    suppress enough, ``extract_source_mvdr`` adapts per-bin nulls from the data
    (STFT/WOLA path; measured +16 dB SIR over this function on a 1:1 narrowband
    interferer, +5.7 dB on white noise).

    signals: (..., M, N); position: (3,) (e.g. ``localize_sound_source``'s
    estimate or a ``Track`` point).  mic_weights: optional (M,) non-negative
    taper (defaults to uniform 1/M; pass e.g. SNR-derived weights to
    downweight bad capsules).  Output: (..., N) aligned to the closest
    mic's arrival time.  Fully jittable.
    """
    signals = jnp.asarray(signals)
    mics = jnp.asarray(mic_positions, signals.dtype)
    p = jnp.asarray(position, signals.dtype)
    n = signals.shape[-1]
    m = mics.shape[0]
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    d = jnp.linalg.norm(p[None, :] - mics, axis=-1)          # (M,)
    tau = (d - jnp.min(d)) / c                               # advance >= 0
    if mic_weights is None:
        w = jnp.full((m,), 1.0 / m, signals.dtype)
    else:
        w = jnp.asarray(mic_weights, signals.dtype)
        w = w / jnp.maximum(jnp.sum(w), jnp.finfo(signals.dtype).tiny)
    from ..ops.fftutils import irfft_n, rfft_n
    spec = rfft_n(signals, nfft)                             # (..., M, F)
    freqs = jnp.arange(nfft // 2 + 1, dtype=signals.dtype) * (fs / nfft)
    pha = 2.0 * jnp.pi * freqs[None, :] * tau[:, None]       # (M, F) advance
    ramp = jax.lax.complex(jnp.cos(pha), jnp.sin(pha)).astype(spec.dtype)
    summed = jnp.sum(spec * (w[:, None] * ramp), axis=-2)    # (..., F)
    return irfft_n(summed, nfft)[..., :n].astype(signals.dtype)


# ---------------------------------------------------------------------------
# Adaptive (MVDR) extraction: STFT analysis -> per-bin MVDR -> WOLA synthesis
# ---------------------------------------------------------------------------

def _sqrt_hann(frame: int, dtype) -> jnp.ndarray:
    """sqrt of the PERIODIC Hann window.  Periodic (denominator ``frame``,
    not frame-1) so that the squared window overlap-adds to the exact
    constant L/2 at hop = frame/L for any integer L >= 2 — the WOLA
    perfect-reconstruction condition.  np.hanning is the symmetric variant
    and does NOT satisfy it."""
    idx = np.arange(frame)
    h = 0.5 - 0.5 * np.cos(2.0 * np.pi * idx / frame)
    return jnp.asarray(np.sqrt(h), dtype)


def _wola_layout(n: int, frame: int, hop: int) -> Tuple[int, int, int]:
    """Static WOLA frame layout covering ``n`` samples with full analysis
    weight everywhere.  Returns (num_frames, pad_left, pad_right): the
    signal is zero-padded so every real sample sits under all frame/hop
    overlapping windows (edge samples of an unpadded signal would be
    attenuated by the incomplete window sum)."""
    if frame % hop != 0 or frame // hop < 2:
        raise ValueError(
            f"WOLA needs hop dividing frame with frame/hop >= 2 "
            f"(got frame={frame}, hop={hop}).")
    pad_left = frame - hop
    # last padded position needing full coverage:
    p_end = pad_left + n - 1
    num = p_end // hop + 1                     # frames start at 0..(num-1)*hop
    padded = (num - 1) * hop + frame
    pad_right = padded - pad_left - n
    assert pad_right >= 0
    return num, pad_left, pad_right


def stft_analysis(signals: jnp.ndarray, frame: int,
                  hop: int) -> jnp.ndarray:
    """sqrt-Hann STFT of (..., N) real signals -> (..., T, frame//2+1)
    complex spectra, padded per ``_wola_layout`` so WOLA synthesis with the
    same window reconstructs the interior exactly.  Framing is a static
    strided index (one batched rfft, no dynamic slices)."""
    n = signals.shape[-1]
    num, pad_left, pad_right = _wola_layout(n, frame, hop)
    pad = [(0, 0)] * (signals.ndim - 1) + [(pad_left, pad_right)]
    padded = jnp.pad(signals, pad)
    idx = (np.arange(num)[:, None] * hop
           + np.arange(frame)[None, :])                     # (T, L) static
    frames = padded[..., idx]                               # (..., T, frame)
    win = _sqrt_hann(frame, signals.dtype)
    return jnp.fft.rfft(frames * win, axis=-1)


def wola_synthesis(spectra: jnp.ndarray, frame: int, hop: int,
                   n: int) -> jnp.ndarray:
    """Inverse of ``stft_analysis``: (..., T, frame//2+1) complex frame
    spectra -> (..., n) real signal via sqrt-Hann weighted overlap-add.

    The overlap-add is L = frame/hop shifted static block sums (a reshape
    to (T, L, hop) plus L pad+add layers), NOT a scatter — XLA fuses
    it."""
    num, pad_left, _ = _wola_layout(n, frame, hop)
    lfac = frame // hop
    frames = jnp.fft.irfft(spectra, n=frame, axis=-1)
    win = _sqrt_hann(frame, frames.dtype)
    # squared sqrt-Hann OLA constant is L/2 -> scale by 2/L
    frames = frames * (win * (2.0 / lfac))
    lead = frames.shape[:-2]
    fb = frames.reshape(lead + (num, lfac, hop))
    total = num + lfac - 1
    out = jnp.zeros(lead + (total, hop), frames.dtype)
    for j in range(lfac):
        col = fb[..., :, j, :]                              # (..., T, hop)
        pad = [(0, 0)] * len(lead) + [(j, lfac - 1 - j), (0, 0)]
        out = out + jnp.pad(col, pad)
    sig = out.reshape(lead + (total * hop,))
    return sig[..., pad_left:pad_left + n]


def stack_taps(spectra: jnp.ndarray, taps: int,
               valid: bool) -> jnp.ndarray:
    """Stack ``taps`` delayed STFT frames per snapshot: (M, T, F) ->
    (taps*M, T', F) with rows [x_t; x_{t-1}; ...; x_{t-taps+1}].

    ``valid=True`` keeps only snapshots with a full history
    (T' = T - taps + 1 — covariance estimation must not see fabricated
    zeros); ``valid=False`` zero-pads the pre-capture history so every
    frame has a stacked snapshot (T' = T — the synthesis path needs an
    output per frame)."""
    m, t, f = spectra.shape
    if taps == 1:
        return spectra
    if valid:
        blocks = [spectra[:, taps - 1 - l:t - l, :] for l in range(taps)]
    else:
        # The zero pad is built on device from real planes.
        zr = jnp.zeros((m, taps - 1, f), jnp.real(spectra).dtype)
        pad = jax.lax.complex(zr, zr)
        ext = jnp.concatenate([pad, spectra], axis=1)
        blocks = [ext[:, taps - 1 - l:taps - 1 - l + t, :]
                  for l in range(taps)]
    return jnp.concatenate(blocks, axis=0)


def mvdr_weights(spectra: jnp.ndarray, tau: jnp.ndarray, fs: float,
                 frame: int, loading: float,
                 taps: int = 1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-bin MVDR weights toward relative delays ``tau`` (seconds).

    spectra: (taps*M, T, F) complex STFT snapshots (``stack_taps`` output
    for taps > 1 — tap 0 rows first); returns (wr, wi): (taps*M, F)
    real/imag planes of w_k = R_k^-1 a_k / (a_k^H R_k^-1 a_k) with
    diagonally-loaded per-bin snapshot covariances R_k.  All linear
    algebra stays in the real 2Mx2M embedding (models/music.embed_planes)
    — the embedded inverse and quadratic form equal the complex ones
    exactly, so no complex linalg is needed.

    For ``taps > 1`` (convolutive MVDR) the single distortionless
    constraint is NOT enough: with overlapped STFT frames the delayed
    frames are strongly target-correlated, and a tap-0-only constraint
    lets the minimizer cancel the target THROUGH its own history
    (measured: target gain 0.94 -> 0.20 at taps=2, hop=frame/4).  The
    multi-tap weights are therefore LCMV with ``taps`` constraints —
    unit response to the target direction on tap 0, ZERO response to the
    target direction on every delayed tap:

        w = R^-1 C (C^H R^-1 C)^-1 e_0,   C = I_taps (x) a_k

    which removes the target subspace from the minimizer's reach while
    leaving (taps-1)*M + (M-1) degrees of freedom for delay-spread
    interferer nulls.  For taps=1 this reduces exactly to MVDR."""
    from .capon import loaded_inverse
    from .music import embed_planes
    xr, xi = jnp.real(spectra), jnp.imag(spectra)           # (L*M, T, F)
    t = spectra.shape[1]
    # C_k = (1/T) X X^H = A + iB per bin
    a_mat = (jnp.einsum("mtf,ntf->fmn", xr, xr)
             + jnp.einsum("mtf,ntf->fmn", xi, xi)) / t
    b_mat = (jnp.einsum("mtf,ntf->fmn", xi, xr)
             - jnp.einsum("mtf,ntf->fmn", xr, xi)) / t
    r_inv = loaded_inverse(embed_planes(a_mat, b_mat), loading)
    lm = spectra.shape[0]
    m = lm // taps
    f_bins = frame // 2 + 1
    omega = (2.0 * jnp.pi * fs / frame) * jnp.arange(
        f_bins, dtype=xr.dtype)                             # (F,)
    theta = tau[:, None].astype(xr.dtype) * omega[None, :]  # (M, F)
    if taps == 1:
        # a = exp(-i omega tau) embeds as [cos; -sin].
        a_emb = jnp.concatenate([jnp.cos(theta), -jnp.sin(theta)], axis=0)
        n_emb = jnp.einsum("fmn,nf->mf", r_inv, a_emb)      # (2M, F)
        denom = jnp.einsum("mf,mf->f", a_emb, n_emb)        # real > 0
        denom = jnp.maximum(denom, jnp.asarray(1e-30, xr.dtype))
        w_emb = n_emb / denom[None, :]
        return w_emb[:lm], w_emb[lm:]
    # LCMV in the real embedding (a ring homomorphism, so the embedded
    # Gram inverse equals the embedded complex inverse).  The complex
    # constraint matrix C = I_taps (x) a_k embeds per bin as the
    # (2LM, 2L) block matrix [[Cr, -Ci], [Ci, Cr]] with Cr/Ci the
    # tap-block-diagonal cos/sin planes.
    eye_t = jnp.eye(taps, dtype=xr.dtype)
    # (F, LM, L): row l*M + m of column k holds a_m delta_{lk}
    c_r = jnp.einsum("lk,mf->flmk", eye_t,
                     jnp.cos(theta)).reshape(f_bins, lm, taps)
    c_i = jnp.einsum("lk,mf->flmk", eye_t,
                     -jnp.sin(theta)).reshape(f_bins, lm, taps)
    c_emb = jnp.concatenate(
        [jnp.concatenate([c_r, -c_i], axis=-1),
         jnp.concatenate([c_i, c_r], axis=-1)], axis=-2)    # (F, 2LM, 2L)
    n_c = jnp.einsum("fmn,fnl->fml", r_inv, c_emb)          # (F, 2LM, 2L)
    gram = jnp.einsum("fml,fmk->flk", c_emb, n_c)           # (F, 2L, 2L)
    # Response e_0: unit tap-0 target gain, zero delayed-tap target gain.
    f_vec = jnp.zeros((2 * taps,), xr.dtype).at[0].set(1.0)
    tr_g = jnp.trace(gram, axis1=-2, axis2=-1) / (2 * taps)
    ridge = 1e-7 * jnp.maximum(tr_g, jnp.asarray(1e-30, xr.dtype))
    gram = gram + ridge[:, None, None] * jnp.eye(2 * taps, dtype=xr.dtype)
    sol = jnp.linalg.solve(gram, jnp.broadcast_to(
        f_vec, gram.shape[:1] + (2 * taps,))[..., None])[..., 0]
    w_emb = jnp.einsum("fml,fl->mf", n_c, sol)              # (2LM, F)
    return w_emb[:lm], w_emb[lm:]


def align_to_position(signals: jnp.ndarray, mic_positions: jnp.ndarray,
                      position, fs: float, c) -> jnp.ndarray:
    """Advance each mic by its extra propagation delay toward ``position``
    (fractional, whole-signal rfft phase ramp at a static pow2 length) so
    the target's wavefront is time-aligned across mics, referenced to the
    CLOSEST mic's arrival.  ``extract_source`` is exactly the weighted
    mean of these aligned channels; ``extract_source_mvdr`` adapts per-bin
    weights over them instead.  signals: (..., M, N) -> same shape."""
    signals = jnp.asarray(signals)
    mics = jnp.asarray(mic_positions, signals.dtype)
    p = jnp.asarray(position, signals.dtype)
    n = signals.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    d = jnp.linalg.norm(p[None, :] - mics, axis=-1)          # (M,)
    tau = (d - jnp.min(d)) / c
    from ..ops.fftutils import irfft_n, rfft_n
    spec = rfft_n(signals, nfft)
    freqs = jnp.arange(nfft // 2 + 1, dtype=signals.dtype) * (fs / nfft)
    pha = 2.0 * jnp.pi * freqs[None, :] * tau[:, None]       # (M, F) advance
    ramp = jax.lax.complex(jnp.cos(pha), jnp.sin(pha)).astype(spec.dtype)
    return irfft_n(spec * ramp, nfft)[..., :n].astype(signals.dtype)


@functools.partial(jax.jit, static_argnames=("fs", "frame", "hop",
                                             "loading", "taps"))
def _extract_mvdr_jit(signals, mics, position, c, *, fs, frame, hop,
                      loading, taps):
    n = signals.shape[-1]
    m = signals.shape[-2]
    aligned = align_to_position(signals, mics, position, fs, c)
    spectra = stft_analysis(aligned, frame, hop)            # (M, T, F)
    # Target is pre-aligned, so the steering vector is exactly ones.
    tau0 = jnp.zeros((m,), jnp.real(spectra).dtype)
    # Covariance from full-history snapshots only; outputs for every
    # frame (zero-padded pre-capture history).
    wr, wi = mvdr_weights(stack_taps(spectra, taps, valid=True), tau0,
                          fs, frame, loading, taps=taps)
    stacked = stack_taps(spectra, taps, valid=False)
    xr, xi = jnp.real(stacked), jnp.imag(stacked)
    # y = w^H x per frame/bin
    y_r = (jnp.einsum("mf,mtf->tf", wr, xr)
           + jnp.einsum("mf,mtf->tf", wi, xi))
    y_i = (jnp.einsum("mf,mtf->tf", wr, xi)
           - jnp.einsum("mf,mtf->tf", wi, xr))
    y = jax.lax.complex(y_r, y_i)
    return wola_synthesis(y, frame, hop, n).astype(signals.dtype)


def extract_source_mvdr(signals: jnp.ndarray,
                        mic_positions: jnp.ndarray,
                        position,
                        fs: float,
                        c,
                        frame: int = 256,
                        hop: Optional[int] = None,
                        loading: float = 0.3,
                        taps: int = 1) -> jnp.ndarray:
    """ADAPTIVE beamformed audio extraction: time-aligned per-bin MVDR
    toward ``position`` through an STFT/WOLA synthesis path (the adaptive
    counterpart of ``extract_source``; no reference counterpart — the
    reference stops at localization, main.py:126-347).

    Pipeline: fractional-delay alignment toward the target
    (``align_to_position`` — after it the target's steering vector is
    exactly ones, which is what protects it from self-cancellation) ->
    sqrt-Hann STFT (``stft_analysis``) -> per-bin snapshot covariance +
    diagonally-loaded MVDR weights w = R^-1 1 / (1^H R^-1 1)
    (``mvdr_weights``, real-embedded linear algebra, no complex linalg)
    -> weighted frame combine -> sqrt-Hann weighted overlap-add
    (``wola_synthesis``, exact interior reconstruction).

    Versus delay-and-sum, the minimum-output-power objective places
    adaptive NULLS on directional interferers.  Measured envelope
    (8-mic unit cube, 1:1 mixes over 6 random scenes, EVALUATION.md): a
    NARROWBAND (sine) interferer is nulled to +16 dB better SIR than
    delay-and-sum (27.8 vs 11.9 dB); a WHITE-NOISE interferer to +5.7 dB
    (14.2 vs 8.5) — a broadband point source with delay spread of tens of
    samples is not rank-1 per STFT bin (cross-mic coherence is bounded by
    the analysis-window autocorrelation at the interferer's relative
    delay), so its residual cannot be fully nulled by any per-bin
    weights.  Deeper broadband suppression needs multi-tap (convolutive)
    weights — out of scope.

    ``loading`` (diagonal-loading fraction of the mean covariance
    eigenvalue) defaults to 0.3 — two orders STIFFER than localization's
    1e-3, and the measured optimum for BOTH SIR and target gain.  The
    target is present in the covariance (MPDR), so self-cancellation
    scales with its per-bin SNR over the loading floor times the squared
    steering mismatch (~0.5% alignment residual + ~5% per-mic compress
    gain spread here): at loading 1e-2 the worst scene keeps only 0.52 of
    the target (and the SIR numerator with it — 17.5 dB sine), while 0.3
    keeps 0.91+ at 27.8 dB sine SIR; by 3.0 the nulls wash toward
    delay-and-sum.  Default frame=256/hop=64: the 75% overlap quadruples
    snapshots (T ~ 4N/frame), which matters more than bin resolution at
    clip lengths of a fraction of a second.

    ``taps > 1`` switches to CONVOLUTIVE (multi-tap) LCMV-MVDR: each
    per-bin snapshot stacks the current and ``taps-1`` previous STFT
    frames (``stack_taps``), with ``taps`` constraints protecting the
    target (see ``mvdr_weights`` — a tap-0-only constraint measured
    target gain 0.94 -> 0.20 from self-cancellation through the
    overlapped frames).  MEASURED envelope (6-scene cube protocol,
    EVALUATION.md): the free-field broadband half-win does NOT come from
    delay spread — it is covariance adaptation time (taps=1 white-noise
    SIR 14.8 dB at 0.25 s -> 18.3 dB at 1.0 s; taps never beat taps=1
    there at either length).  Where taps DO help is a REVERBERANT
    interferer (direct + image copies = a genuinely convolutive
    transfer): 11.3 dB (taps=1) -> 12.5 dB (taps=3, loading 0.1) at
    1.0 s, target gain 0.83; loading 0.3 keeps gain 0.93 at +0.6 dB.
    Cost: the per-bin inverses grow to (2*taps*M)^2 and the snapshot
    count drops by taps-1; keep taps*M well under T (~4N/frame
    snapshots).

    signals: (M, N); position: (3,).  ``frame`` should stay a power of
    two.  Fully jitted; vmap over a leading scene axis for batches.
    """
    signals = jnp.asarray(signals)
    mics = jnp.asarray(mic_positions, signals.dtype)
    p = jnp.asarray(position, signals.dtype)
    h = frame // 4 if hop is None else int(hop)
    if taps < 1:
        raise ValueError("taps must be >= 1")
    return _extract_mvdr_jit(signals, mics, p, c, fs=float(fs),
                             frame=int(frame), hop=h,
                             loading=float(loading), taps=int(taps))
