"""Moving-source tracking: segment-wise localization over time.

No reference counterpart (the reference localizes one static scene).  A long
multi-mic capture is split into overlapping segments; each segment runs the
GCC-PHAT -> SRP-PHAT pipeline independently (vmapped — every segment of
every pair correlates in one XLA graph), producing a time-stamped position
track.  Optional exponential smoothing stabilizes the track under a
`lax.scan`.  ``method='capon'``/``'music'`` swap the per-segment estimator
for the narrowband snapshot-covariance scans (models/capon.py /
models/music.py) — moving TONAL sources, whose correlations carry no usable
peaks for the SRP chain.

``smoother='kalman'`` replaces the causal EMA with a constant-velocity
Kalman filter + Rauch-Tung-Striebel backward smoother: per-segment SRP
power weights the measurement covariance (low-confidence segments pull the
track less), the measurement noise is auto-calibrated from the robust
second difference of the raw track (zero for any constant-velocity truth,
so linear motion does not inflate it), and the backward pass makes the
estimate two-sided — the EMA's half-segment lag on a moving source
disappears.  Everything runs as two ``lax.scan`` passes over (S, 3, 2)
state; the three axes decouple (block-diagonal F/Q/H/R), so the per-axis
filters are 2-state and the 2x2 algebra is closed-form.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import gccphat
from ..ops.fftutils import next_pow2
from . import capon as capon_ops
from . import music as music_ops
from . import srp as srp_ops


class Track(NamedTuple):
    times: jnp.ndarray       # (S,) segment-center times, seconds
    positions: jnp.ndarray   # (S, 3) raw per-segment estimates
    smoothed: jnp.ndarray    # (S, 3) smoothed track (EMA or Kalman/RTS)
    powers: jnp.ndarray      # (S,) SRP power per segment (confidence)
    velocities: Optional[jnp.ndarray] = None  # (S, 3) m/s, motion mode only


class MultiTrack(NamedTuple):
    """``track_multiple`` output: K identity-maintained tracks.

    The detection axis of the per-segment multi-source fixes is in
    EXTRACTION (power) order, which flips arbitrarily between segments;
    here axis 1 is the TRACK axis — detection k of segment s belongs to
    the same physical source for every s (data association)."""
    times: jnp.ndarray       # (S,)
    positions: jnp.ndarray   # (S, K, 3) associated raw detections
    smoothed: jnp.ndarray    # (S, K, 3) per-track Kalman/RTS smoothing
    powers: jnp.ndarray      # (S, K) fine-stage SRP power per detection
    velocities: jnp.ndarray  # (S, K, 3) smoothed track velocities (m/s)
    associated: jnp.ndarray  # (S, K) bool: detection passed the gate


def kalman_rts_smooth(positions: jnp.ndarray,
                      dt,
                      powers: Optional[jnp.ndarray] = None,
                      accel_std: float = 0.5,
                      meas_std: Optional[float] = None) -> Tuple[jnp.ndarray,
                                                                 jnp.ndarray]:
    """Constant-velocity Kalman + RTS smoothing of a position track.

    positions: (S, D) raw per-segment estimates sampled every ``dt``
    seconds.  ``powers`` (S,) optionally weights each measurement: the
    per-segment covariance is scaled by median(powers)/power (clipped to
    [0.1, 10]), so low-confidence segments pull the track less.
    ``accel_std`` (m/s^2) is the white-acceleration process noise;
    ``meas_std`` (m) defaults to a robust estimate from the track's second
    difference — exactly zero for constant-velocity truth, so source motion
    does not inflate it (d2 of white measurement noise ~ N(0, 6*sigma^2)).

    Returns ``(smoothed_positions, velocities)``, both (S, D).  Jittable;
    the three spatial axes decouple, so the scan state is (D, 2)/(D, 2, 2)
    with closed-form 2x2 inverses.
    """
    z = jnp.asarray(positions)
    s, d = z.shape
    dtype = z.dtype
    if s < 2:
        return z, jnp.zeros_like(z)
    dt = jnp.asarray(dt, dtype)

    if meas_std is None:
        if s >= 4:
            d2 = z[2:] - 2.0 * z[1:-1] + z[:-2]          # (S-2, D)
            mad = jnp.median(jnp.abs(d2))
            sigma = 1.4826 * mad / jnp.sqrt(6.0)
        else:
            sigma = jnp.asarray(0.02, dtype)
        # Floor: a perfectly static noiseless track would otherwise make R
        # singular against P's process noise.
        meas_var = jnp.maximum(sigma, 1e-4) ** 2
    else:
        meas_var = jnp.asarray(float(meas_std), dtype) ** 2

    if powers is None:
        w = jnp.ones((s,), dtype)
    else:
        p = jnp.asarray(powers, dtype)
        ref = jnp.maximum(jnp.median(p), jnp.asarray(1e-30, dtype))
        w = jnp.clip(p / ref, 0.1, 10.0)
    r_t = meas_var / w                                   # (S,)

    q = jnp.asarray(accel_std, dtype)
    f_mat = jnp.array([[1.0, 1.0], [0.0, 1.0]], dtype).at[0, 1].set(dt)
    q_mat = (q * q) * jnp.array(
        [[0.25, 0.5], [0.5, 1.0]], dtype) * jnp.stack(
        [jnp.stack([dt ** 4, dt ** 3]), jnp.stack([dt ** 3, dt ** 2])])

    def inv2(a):
        det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        adj = jnp.stack(
            [jnp.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
             jnp.stack([-a[..., 1, 0], a[..., 0, 0]], -1)], -2)
        return adj / det[..., None, None]

    m0 = jnp.stack([z[0], jnp.zeros((d,), dtype)], axis=-1)     # (D, 2)
    big = 100.0 * meas_var
    p0 = jnp.broadcast_to(
        jnp.diag(jnp.stack([big, big / (dt * dt)])), (d, 2, 2))

    def fwd(carry, inp):
        m, p = carry                                     # (D,2), (D,2,2)
        zt, rt = inp
        m_pred = m @ f_mat.T
        p_pred = jnp.einsum("ij,djk,lk->dil", f_mat, p, f_mat) + q_mat
        # H = [1, 0]: scalar innovation per axis.
        innov = zt - m_pred[:, 0]                        # (D,)
        s_cov = p_pred[:, 0, 0] + rt                     # (D,)
        k = p_pred[:, :, 0] / s_cov[:, None]             # (D, 2)
        m_new = m_pred + k * innov[:, None]
        p_new = p_pred - k[:, :, None] * p_pred[:, None, 0, :]
        return (m_new, p_new), (m_new, p_new, m_pred, p_pred)

    (_, _), (ms, ps, mp, pp) = jax.lax.scan(
        fwd, (m0, p0), (z, r_t))

    def bwd(carry, inp):
        x_next = carry                                   # (D, 2) smoothed t+1
        m_t, p_t, m_pred_next, p_pred_next = inp
        c = jnp.einsum("dij,kj,dkl->dil", p_t, f_mat, inv2(p_pred_next))
        x_t = m_t + jnp.einsum("dij,dj->di", c, x_next - m_pred_next)
        return x_t, x_t

    # RTS runs t = S-2 .. 0 against the prediction made FOR t+1.
    _, xs_rev = jax.lax.scan(
        bwd, ms[-1],
        (ms[:-1][::-1], ps[:-1][::-1], mp[1:][::-1], pp[1:][::-1]))
    x_smooth = jnp.concatenate([xs_rev[::-1], ms[-1:]], axis=0)
    return x_smooth[..., 0], x_smooth[..., 1]


@functools.partial(jax.jit, static_argnames=("pi", "pj", "fs", "band",
                                             "weighting", "nsub", "wn",
                                             "nfft_f"))
def _subframe_windows(segs: jnp.ndarray, pi, pj, fs: float, band,
                      weighting: str, nsub: int, wn: int,
                      nfft_f: int) -> jnp.ndarray:
    """Per-subframe GCC lag windows, (S, nsub, P, 2*wn+1).

    Each segment splits into ``nsub`` subframes; every subframe runs the
    all-pairs GCC at ``nfft_f`` and the +-``wn``-lag window around lag 0 is
    cut out in linear lag order (index wn = lag 0).  Shared by the
    single-source rate FIT path (:func:`_motion_compensated_corr`) and the
    multi-track rate-STEERED refinement (:func:`_refine_tracks_compensated`).
    Jitted at definition: run eagerly, every complex stack/broadcast would
    be its own dispatch.
    """
    pi = np.asarray(pi, np.int32)
    pj = np.asarray(pj, np.int32)
    s_dim, m, seg_len = segs.shape
    lf = seg_len // nsub
    sub = segs[:, :, :nsub * lf].reshape(s_dim, m, nsub, lf)
    sub = jnp.swapaxes(sub, 1, 2)                          # (S, K, M, Lf)
    corr = gccphat.gcc_phat_all_pairs(sub, pi, pj, nfft=nfft_f, band=band,
                                      fs=fs, weighting=weighting)
    return jnp.concatenate([corr[..., -wn:], corr[..., :wn + 1]], -1)


@functools.partial(jax.jit, static_argnames=("npad",))
def _rfft_pad(win: jnp.ndarray, npad: int) -> jnp.ndarray:
    return jnp.fft.rfft(win, n=npad, axis=-1)


@functools.partial(jax.jit, static_argnames=("pi", "pj", "fs", "band",
                                             "weighting", "nsub", "w_half",
                                             "s_max", "nfft_f"))
def _motion_compensated_corr(segs: jnp.ndarray, pi, pj, fs: float, band,
                             weighting: str, nsub: int, w_half: int,
                             s_max: int, nfft_f: int):
    """Per-segment delay-rate estimation + correlation alignment.

    A source moving during a segment drifts the pair delay by
    tau_dot * L samples (tau_dot = (u_i - u_j)·v / c, dimensionless),
    smearing the segment-long GCC peak and biasing the 'static' tracker.
    Here each segment splits into ``nsub`` subframes; per (segment, pair):

      1. subframe GCC windows (±(w_half + s_max) lags around 0),
      2. per-subframe peak lag (parabolic-refined) + peak-squared weight,
      3. weighted linear fit lag(f) ≈ tau_c + tau_dot · dt_f
         (dt_f = subframe-centre offset from the segment centre, samples),
      4. each subframe window Fourier-shifted by -tau_dot·dt_f and summed —
         a delay-rate-aligned correlation whose peak sits at the SEGMENT
         CENTRE delay tau_c, with the full segment's SNR.

    All shifts ride a batched rfft of the (2(w_half+s_max)+1)-lag windows —
    no data-dependent gathers.  Returns
    ``(circ, tau_dot, weight)``: (S, P, nfft_f) compensated correlations
    rebuilt in circular lag order for srp_phat_locate, the per-pair delay
    rates, and the per-pair fit confidence for the velocity solve.
    """
    wn = w_half + s_max
    win = _subframe_windows(segs, pi, pj, fs, band, weighting, nsub, wn,
                            nfft_f)
    lf = segs.shape[-1] // nsub
    wlen = 2 * wn + 1                                      # (S, K, P, wlen)

    # Per-subframe peak + parabolic refinement (tiny take_along_axis — off
    # the sweep hot path).
    pk = jnp.argmax(win, -1)
    pk_c = jnp.clip(pk, 1, wlen - 2)
    v0 = jnp.take_along_axis(win, pk_c[..., None], -1)[..., 0]
    vm = jnp.take_along_axis(win, (pk_c - 1)[..., None], -1)[..., 0]
    vp = jnp.take_along_axis(win, (pk_c + 1)[..., None], -1)[..., 0]
    denom = vm - 2.0 * v0 + vp
    delta = jnp.where(jnp.abs(denom) > 1e-12,
                      0.5 * (vm - vp) / jnp.where(denom == 0, 1.0, denom),
                      0.0)
    lag_f = pk_c.astype(win.dtype) + jnp.clip(delta, -1.0, 1.0) - wn
    wt = jnp.maximum(v0, 0.0) ** 2 + 1e-12                 # (S, K, P)

    # Weighted linear fit over subframes, per (segment, pair).
    dt_f = jnp.asarray((np.arange(nsub) + 0.5) * lf - (nsub * lf) / 2.0,
                       win.dtype)[None, :, None]           # (1, K, 1)
    sw = jnp.sum(wt, 1)
    swx = jnp.sum(wt * dt_f, 1)
    swxx = jnp.sum(wt * dt_f * dt_f, 1)
    swy = jnp.sum(wt * lag_f, 1)
    swxy = jnp.sum(wt * dt_f * lag_f, 1)
    det = sw * swxx - swx * swx
    tau_dot = jnp.where(jnp.abs(det) > 1e-20,
                        (sw * swxy - swx * swy)
                        / jnp.where(det == 0, 1.0, det), 0.0)  # (S, P)

    # Fourier-align every subframe window by -tau_dot*dt_f and sum.  The
    # s_max margin absorbs the circular wrap (|shift| <= s_max by
    # construction of the tau_dot search range — clip enforces it).
    tau_dot = jnp.clip(tau_dot, -s_max / jnp.maximum(dt_f[0, -1, 0], 1.0),
                       s_max / jnp.maximum(dt_f[0, -1, 0], 1.0))
    shift = tau_dot[:, None, :] * dt_f[..., 0][..., None]  # (S, K, P)
    npad = int(2 ** np.ceil(np.log2(wlen)))
    spec = jnp.fft.rfft(win, n=npad, axis=-1)
    k_bins = jnp.arange(spec.shape[-1], dtype=win.dtype)
    phase = 2.0 * jnp.pi * k_bins * (shift[..., None] / npad)
    shifted = jnp.fft.irfft(spec * jax.lax.complex(jnp.cos(phase),
                                                   jnp.sin(phase)),
                            n=npad, axis=-1)[..., :wlen]
    comp_wide = jnp.sum(shifted, 1)                        # (S, P, wlen)
    comp = comp_wide[..., s_max:s_max + 2 * w_half + 1]

    # Rebuild circular lag order (win_c[j] = corr[(j - w) mod nfft]).
    zeros = jnp.zeros(comp.shape[:-1] + (nfft_f - 2 * w_half - 1,),
                      comp.dtype)
    circ = jnp.concatenate([comp[..., w_half:], zeros, comp[..., :w_half]],
                           -1)
    return circ, tau_dot, sw


def _velocity_lsq(pos: jnp.ndarray, mics: jnp.ndarray, pi, pj, c,
                  tau_dot: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Source velocity from per-pair delay rates at the estimated position.

    The peak lag (samples) of pair (i, j) is (d_i - d_j) * fs / c, so its
    dimensionless rate is (u_i - u_j)·v / c with u the source→mic unit
    bearings; weighted 3x3 least squares recovers v.  A trace-relative
    ridge keeps the normal matrix invertible when the geometry
    under-constrains an axis (e.g. coplanar mics → vertical rate
    unobservable → that component shrinks to 0 instead of blowing up);
    relative scaling matters: the matrix entries go as 1/c^2 ~ 1e-5, so
    an absolute ridge would bias the well-observed axes."""
    d = pos[None, :] - mics
    u = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    a = (jnp.take(u, pi, 0) - jnp.take(u, pj, 0)) / c      # (P, 3)
    aw = a * w[:, None]
    n_mat = aw.T @ a
    lam = 1e-6 * (jnp.trace(n_mat) / 3.0) + 1e-30
    n_mat = n_mat + lam * jnp.eye(3, dtype=pos.dtype)
    rhs = aw.T @ tau_dot
    return jnp.linalg.solve(n_mat, rhs)


def localize_trajectory(signals: jnp.ndarray,
                        mic_positions: jnp.ndarray,
                        fs: float,
                        c,
                        lower: jnp.ndarray,
                        upper: jnp.ndarray,
                        segment: int = 4096,
                        hop: Optional[int] = None,
                        band: Optional[Tuple[float, float]] = None,
                        smoothing: float = 0.6,
                        coarse_n: int = 20,
                        fine_n: int = 10,
                        method: str = "srp",
                        smoother: str = "ema",
                        accel_std: float = 0.5,
                        weighting: str = "phat",
                        motion: str = "static",
                        motion_subframes: int = 8,
                        max_speed: float = 5.0) -> Track:
    """Track a (slowly) moving source through a long capture.

    signals: (M, T); segments of ``segment`` samples every ``hop`` (default
    segment//2).  Each segment localizes independently over the box
    [lower, upper] — via SRP-PHAT (``method='srp'``, broadband default) or
    the narrowband Capon/MUSIC scans (``method='capon'``/``'music'``, for
    tonal sources); ``smoothing`` is the EMA coefficient applied along
    time (0 disables).  ``smoother='kalman'`` replaces the EMA with the
    power-weighted constant-velocity Kalman/RTS smoother
    (:func:`kalman_rts_smooth`; ``accel_std`` is its process noise and
    ``smoothing`` is ignored).  ``weighting`` selects the GCC frequency
    weighting for the 'srp' method (ops/gccphat.GCC_WEIGHTINGS minus
    'ml' — per-segment single snapshots have degenerate coherence; for
    ML-weighted online tracking use StreamingLocalizer).  Fully jittable.

    ``motion='compensated'`` (method='srp' only) drops the static-source-
    per-segment assumption: a mover drifts each pair delay by up to
    2·speed/c·segment samples WITHIN a segment, smearing the segment-long
    correlation peak and biasing the estimate toward where the source
    spent its loudest subframes.  The compensated path estimates each
    pair's delay RATE from ``motion_subframes`` subframe GCCs, aligns the
    subframe correlations to the segment centre, and SRPs the aligned sum
    (see ``_motion_compensated_corr``) — positions become segment-centre
    snapshots, and ``Track.velocities`` carries the per-segment velocity
    solved from the delay rates (``_velocity_lsq``).  ``max_speed`` (m/s)
    bounds the rate search (sets the alignment window margin).
    """
    if method not in ("srp", "capon", "music"):
        raise ValueError("method must be 'srp', 'capon', or 'music'")
    if weighting not in ("phat", "scot", "roth", "cc"):
        raise ValueError("weighting must be 'phat', 'scot', 'roth', or "
                         "'cc' for segment tracking")
    if weighting != "phat" and method != "srp":
        raise ValueError("weighting applies to method='srp' only")
    if smoother not in ("ema", "kalman"):
        raise ValueError("smoother must be 'ema' or 'kalman'")
    if motion not in ("static", "compensated"):
        raise ValueError("motion must be 'static' or 'compensated'")
    if motion == "compensated" and method != "srp":
        raise ValueError("motion='compensated' requires method='srp'")
    m, t = signals.shape
    hop = segment // 2 if hop is None else hop
    if t < segment:
        raise ValueError("signal shorter than one segment")
    num_seg = 1 + (t - segment) // hop
    starts = np.arange(num_seg) * hop
    pi, pj = np.triu_indices(m, 1)
    pi = pi.astype(np.int32)
    pj = pj.astype(np.int32)
    nfft = next_pow2(segment)

    idx = starts[:, None] + np.arange(segment)[None, :]
    segs = jnp.take(signals, jnp.asarray(idx), axis=-1)     # (M, S, L)
    segs = jnp.swapaxes(segs, 0, 1)                         # (S, M, L)

    velocities = None
    if method == "srp" and motion == "compensated":
        lf = segment // motion_subframes
        if lf < 64:
            raise ValueError("segment // motion_subframes must be >= 64")
        nfft_f = next_pow2(2 * lf)
        # Window sizing is host-side: compensated mode needs CONCRETE mic
        # positions (static mode stays fully jittable).
        mics_np = np.asarray(mic_positions, float)
        diam = float(np.max(np.linalg.norm(
            mics_np[:, None, :] - mics_np[None, :, :], axis=-1)))
        w_half = int(np.ceil(diam * float(fs) / float(c))) + 12
        s_max = int(np.ceil(2.0 * max_speed / float(c) * segment / 2.0)) + 2
        if 2 * (w_half + s_max) + 1 > nfft_f:
            raise ValueError(
                "motion='compensated' alignment window (mic diameter "
                f"{w_half} + drift margin {s_max} lags) exceeds the "
                f"subframe transform {nfft_f}: use a longer segment, "
                "fewer motion_subframes, or a smaller max_speed")
        circ, tau_dot, wts = _motion_compensated_corr(
            segs, tuple(pi.tolist()), tuple(pj.tolist()), float(fs), band,
            weighting, motion_subframes, w_half, s_max, nfft_f)

        def locate_one(corr_s):
            out = srp_ops.srp_phat_locate(corr_s, mic_positions, pi, pj,
                                          fs, c, lower, upper,
                                          coarse_n=coarse_n, fine_n=fine_n)
            return out.position, out.power

        positions, powers = jax.vmap(locate_one)(circ)
        mics_dev = jnp.asarray(mic_positions, positions.dtype)
        velocities = jax.vmap(
            lambda p, td, w: _velocity_lsq(p, mics_dev, pi, pj, c, td, w)
        )(positions, tau_dot, wts)
        one = None
    elif method == "srp":
        def one(seg):
            corr = gccphat.gcc_phat_all_pairs(seg, pi, pj, nfft=nfft,
                                              band=band, fs=fs,
                                              weighting=weighting)
            out = srp_ops.srp_phat_locate(corr, mic_positions, pi, pj, fs, c,
                                          lower, upper, coarse_n=coarse_n,
                                          fine_n=fine_n)
            return out.position, out.power
    else:
        # Narrowband per-segment scan: frame ~= segment//4 keeps >= 7 STFT
        # snapshots per segment for the covariance average, rounded DOWN to
        # a power of two (the srp branch likewise uses next_pow2(segment)).
        frame = 1 << max(int(np.log2(max(segment // 4, 64))), 6)
        locate = (capon_ops.capon_locate if method == "capon"
                  else music_ops.music_locate)

        def one(seg):
            out = locate(seg, mic_positions, fs, c, lower, upper,
                         frame=frame, band=band,
                         coarse_n=coarse_n, fine_n=fine_n)
            return out.position, out.power

    if one is not None:
        positions, powers = jax.vmap(one)(segs)

    def ema(prev, cur):
        nxt = smoothing * prev + (1.0 - smoothing) * cur
        return nxt, nxt

    if smoother == "kalman":
        smoothed, _ = kalman_rts_smooth(positions, hop / fs, powers=powers,
                                        accel_std=accel_std)
    elif smoothing > 0:
        _, smoothed = jax.lax.scan(ema, positions[0], positions)
    else:
        smoothed = positions

    times = jnp.asarray((starts + segment / 2.0) / fs, positions.dtype)
    return Track(times, positions, smoothed, powers, velocities)


#: Half-width (samples) of the lag-claiming null around an extracted
#: source's per-pair lag (see _detect_rate_envelope): wide enough to
#: cover the whitened correlation peak (~2 lags) plus the rate-envelope
#: plateau (+-1 candidate spacing) and the fine-stage position error.
_CLAIM_LAGS = 6.0


@functools.partial(jax.jit, static_argnames=(
    "pi", "pj", "fs", "num_sources", "npad", "wlen", "w_half", "s_max",
    "nfft_f", "coarse_n", "fine_n", "min_separation"))
def _detect_rate_envelope(spec, mics_dev, pi, pj, fs, c, lower, upper,
                          num_sources, dt_f, npad, wlen, w_half, s_max,
                          nfft_f, coarse_n, fine_n, min_separation):
    """Motion-robust multi-source detection: a delay-rate matched-filter
    bank (track_multiple ``motion='compensated'`` pass 1).

    Why the plain per-segment GCC drowns here (measured, error-budget
    drive 2026-08-20): a single mover's smeared peak still wins (0.06 m),
    two STATIC sources split the PHAT bins and both peaks win (0.02 m),
    but two MOVERS flatten BOTH peaks — each source only owns ~half the
    bins (peak height ~0.5) AND intra-segment drift spreads that over
    ~2·speed/c·segment lags, dropping the true peaks below the SRP map's
    combinatorial ghosts (~0.9 m mean detection error at every segment
    length).

    The bank restores the static regime: per pair, the subframe
    correlation windows are Fourier-aligned under each of 2·s_max+1
    candidate rates (spacing = 1 sample of end-to-end drift, so the best
    candidate leaves < 0.5 sample of residual smear) and summed; the
    per-lag MAX over candidates is a motion-agnostic envelope in which
    ANY bounded-rate mover stands at full height at its segment-centre
    lag.  The envelope re-embeds in circular lag order and the standard
    K-peak suppression SRP detects on it.  Rates are searched per PAIR
    (1-D), not per source velocity (3-D): the max over rates needs no
    cross-pair consistency for DETECTION — the consistent-velocity
    sharpening happens in pass 2 (:func:`_refine_tracks_compensated`).

    Extraction uses LAG-DOMAIN CLAIMING, not the spatial-ball suppression
    of ``srp_phat_locate_multi``: with few pairs, the mixed hyperbola
    intersections (pair p voting source 1's lag, pair q voting source
    2's) form combinatorial ghosts that a position-ball around peak 1
    cannot remove — measured on the two-mover scene, such a ghost OUTBIDS
    the weaker true source once the movers separate.  Nulling ±claim_w
    lags around the extracted peak's per-pair lag destroys every ghost
    built from them (the broadband analogue of the streaming narrowband
    bin-claiming, models/online.py).

    spec: (S, nsub, P, NB) rfft of the subframe windows.  Returns
    detections (S, K, 3) and powers (S, K) in extraction order.
    Jitted at definition (``pi``/``pj`` are static tuples): eagerly, each
    complex alignment op would be its own dispatch.
    """
    pi = np.asarray(pi, np.int32)
    pj = np.asarray(pj, np.int32)
    dtype = dt_f.dtype
    dtf_max = jnp.maximum(dt_f[-1], 1.0)
    n_r = 2 * s_max + 1
    r_cand = (jnp.arange(n_r, dtype=dtype) - s_max) / dtf_max
    k_bins = jnp.arange(npad // 2 + 1, dtype=dtype)
    zeros = jnp.zeros((spec.shape[2], nfft_f - 2 * w_half - 1), dtype)
    ell = jnp.arange(wlen, dtype=dtype) - (w_half + s_max)  # window lags

    def one(spec_t):
        shift = r_cand[:, None] * dt_f[None, :]              # (R, nsub)
        phase = (2.0 * jnp.pi / npad) * k_bins * shift[..., None, None]
        aligned = jnp.fft.irfft(
            spec_t[None] * jax.lax.complex(jnp.cos(phase), jnp.sin(phase)),
            n=npad, axis=-1)[..., :wlen]                # (R, nsub, P, wlen)
        env0 = jnp.max(jnp.sum(aligned, 1), 0)          # (P, wlen)

        def pick(env, _):
            comp = env[..., s_max:s_max + 2 * w_half + 1]
            circ = jnp.concatenate([comp[..., w_half:], zeros,
                                    comp[..., :w_half]], -1)
            out = srp_ops.srp_phat_locate(
                circ, mics_dev, pi, pj, fs, c, lower, upper,
                coarse_n=coarse_n, fine_n=fine_n)
            dist = jnp.linalg.norm(out.position[None, :] - mics_dev,
                                   axis=-1)
            lag_p = (jnp.take(dist, pi) - jnp.take(dist, pj)) * fs / c
            keep = (jnp.abs(ell[None, :] - lag_p[:, None])
                    > _CLAIM_LAGS).astype(dtype)
            return env * keep, (out.position, out.power)

        _, (pos, pw) = jax.lax.scan(pick, env0, None, length=num_sources)
        return pos, pw

    del min_separation  # claiming replaces the spatial suppression ball
    return jax.vmap(one)(spec)


@functools.partial(jax.jit, static_argnames=(
    "pi", "pj", "fs", "npad", "wlen", "w_half", "s_max", "box",
    "box_coarse_n", "fine_n", "pool_w"))
def _refine_tracks_compensated(spec, smoothed, vels, mics_dev, pi, pj, fs,
                               c, lower, upper, dt_f, npad, wlen, w_half,
                               s_max, box, box_coarse_n, fine_n, pool_w):
    """Rate-steered per-(segment, track) re-detection (track_multiple
    ``motion='compensated'`` pass 2).

    For each track at each segment: the RTS-smoothed position/velocity
    predict every pair's delay RATE ((u_i - u_j)·v / c, dimensionless);
    the segment's subframe correlation windows are Fourier-aligned by that
    predicted rate and summed (full-segment SNR, no motion smear), and a
    two-stage SRP over a +-``box``-meter box around the smoothed position
    re-detects the track.  Unlike the single-source path this never FITS
    the rate from subframe peaks — with K sources a subframe window holds
    K peaks and the global argmax chases the louder one; the smoothed
    track velocity (averaged over many segments by the RTS pass) is
    accurate enough that prediction beats measurement (see
    ``track_multiple``).  spec: (S, nsub, P, NB) rfft of the subframe
    windows.  Returns refined (S, K, 3) positions and (S, K) powers.
    Jitted at definition (``pi``/``pj`` static tuples) — see
    :func:`_detect_rate_envelope`.
    """
    pi = np.asarray(pi, np.int32)
    pj = np.asarray(pj, np.int32)
    dtf_max = jnp.maximum(dt_f[-1], 1.0)
    k_bins = jnp.arange(npad // 2 + 1, dtype=smoothed.dtype)
    box_v = jnp.asarray(box, smoothed.dtype)
    ell_w = jnp.arange(2 * w_half + 1, dtype=smoothed.dtype) - w_half
    num_sources = smoothed.shape[1]

    def one(spec_t, p_k, v_k, lag_others):
        d = p_k[None, :] - mics_dev
        u = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True),
                            1e-9)
        tau_dot = (jnp.take(u, pi, 0) - jnp.take(u, pj, 0)) @ v_k / c
        tau_dot = jnp.clip(tau_dot, -s_max / dtf_max, s_max / dtf_max)
        shift = tau_dot[None, :] * dt_f[:, None]            # (nsub, P)
        phase = (2.0 * jnp.pi / npad) * k_bins * shift[..., None]
        shifted = jnp.fft.irfft(
            spec_t * jax.lax.complex(jnp.cos(phase), jnp.sin(phase)),
            n=npad, axis=-1)[..., :wlen]
        comp = jnp.sum(shifted, 0)[..., s_max:s_max + 2 * w_half + 1]
        # Null the OTHER tracks' predicted lags (lag claiming, see
        # _detect_rate_envelope) so a louder neighbor — sharp or smeared —
        # cannot capture this track's box search near a crossing.
        keep = jnp.all(jnp.abs(ell_w[None, None, :]
                               - lag_others[:, :, None]) > _CLAIM_LAGS,
                       axis=0)
        comp = comp * keep.astype(comp.dtype)

        center = jnp.clip(p_k, lower, upper)
        lo = jnp.maximum(lower, center - box_v)
        hi = jnp.minimum(upper, center + box_v)
        # Pool the coarse stage to the box cell's lag footprint — the
        # whitened peak is 1-2 samples wide and a 12^3 box grid's cells
        # span several samples of lag, so the unpooled coarse argmax
        # MISSES the peak (measured: ~0.5 m refinement errors at every
        # segment; srp_phat_locate's stage 1 pools for the same reason).
        pooled = srp_ops.max_pool_corr(comp, pool_w)

        def coarse_fn(pts):
            return srp_ops.srp_map(pooled, pts, mics_dev, pi, pj, fs, c,
                                   max_lag=w_half, pre_windowed=True)

        def fine_fn(pts):
            return srp_ops.srp_map(comp, pts, mics_dev, pi, pj, fs, c,
                                   max_lag=w_half, pre_windowed=True)

        pos, power, _, _ = srp_ops.two_stage_search(
            coarse_fn, fine_fn, lo, hi, box_coarse_n, fine_n,
            smoothed.dtype)
        return jnp.clip(pos, lower, upper), power

    def per_seg(spec_t, p_seg, v_seg):
        dists = jnp.linalg.norm(p_seg[:, None, :] - mics_dev[None, :, :],
                                axis=-1)                    # (K, M)
        lag_all = (jnp.take(dists, pi, 1)
                   - jnp.take(dists, pj, 1)) * fs / c       # (K, P)
        far = jnp.full_like(lag_all, 1e9)

        def for_track(k, p_k, v_k):
            own = jnp.arange(num_sources) == k
            lag_others = jnp.where(own[:, None], far, lag_all)
            return one(spec_t, p_k, v_k, lag_others)

        return jax.vmap(for_track, in_axes=(0, 0, 0))(
            jnp.arange(num_sources), p_seg, v_seg)

    return jax.vmap(per_seg)(spec, smoothed, vels)          # over segments


def associate_detections(dets: jnp.ndarray,
                         powers: jnp.ndarray,
                         dt_s: float,
                         gate: float) -> Tuple[jnp.ndarray, jnp.ndarray,
                                               jnp.ndarray]:
    """Associate per-segment detection sets (S, K, 3) to K tracks.

    A ``lax.scan`` over segments: each track predicts forward with its
    alpha-beta velocity estimate, and the best of the K! track→detection
    assignments (minimum summed GATED squared distance — exact Hungarian
    for small static K) updates the tracks.  Momentum is what maintains
    identity through a crossing: plain nearest-neighbor association swaps
    the tracks there (pinned by tests/test_track_multiple.py).  A
    detection farther than ``gate`` meters from every prediction leaves
    its track coasting for that segment.

    Returns ``(positions (S, K, 3), powers (S, K), ok (S, K))`` with axis
    1 reordered so each index follows one physical source; ``ok`` marks
    detections that passed the gate (coasting segments keep the raw
    detection value but a False flag)."""
    num_sources = dets.shape[1]
    dtype = dets.dtype

    def assoc(carry, inp):
        pos, vel = carry                            # (K, 3), (K, 3)
        det, pw = inp                               # (K, 3), (K,)
        return association_step(pos, vel, det, pw, dt_s, gate)

    init = (dets[0], jnp.zeros((num_sources, 3), dtype))
    (_, _), out = jax.lax.scan(assoc, init, (dets, powers))
    return out


def association_step(pos, vel, det, pw, dt_s, gate,
                     alpha: float = 0.7, beta: float = 0.4):
    """One momentum-gated K! assignment + alpha-beta update step.

    The scan body of ``associate_detections``, exposed so causal per-hop
    callers (models/online.OnlineTracker) share the exact math.  Inputs:
    track state (pos, vel) each (K, 3), this step's detections (K, 3) and
    powers (K,); returns ``((pos_new, vel_new), (z, zp, ok))`` with z the
    detections reordered to track identity.  Alpha-beta gains are
    moderately trusting — downstream smoothing does the real filtering;
    these only need predictions good enough to disambiguate the K!
    assignment at crossings."""
    num_sources = det.shape[0]
    dtype = det.dtype
    perms_j = jnp.asarray(np.array(
        list(itertools.permutations(range(num_sources))), np.int32))
    gate2 = jnp.asarray(gate * gate, dtype)
    pred = pos + vel * dt_s
    d2 = jnp.sum((pred[:, None, :] - det[None, :, :]) ** 2,
                 -1)                                # (tracks, dets)
    # Gated assignment cost: a detection beyond the gate costs a
    # constant (so permutations are compared on their gated members
    # only) and leaves the track coasting.
    d2g = jnp.minimum(d2, gate2)
    costs = jnp.sum(
        d2g[jnp.arange(num_sources)[None, :], perms_j], -1)  # (K!,)
    best = perms_j[jnp.argmin(costs)]               # det index per track
    z = det[best]
    zp = pw[best]
    innov = z - pred
    ok = jnp.sum(innov * innov, -1) < gate2         # (K,)
    pos_new = jnp.where(ok[:, None], pred + jnp.asarray(alpha, dtype)
                        * innov, pred)
    vel_new = jnp.where(ok[:, None], vel + (jnp.asarray(beta, dtype)
                                            / dt_s) * innov, vel)
    return (pos_new, vel_new), (z, zp, ok)


def track_multiple(signals: jnp.ndarray,
                   mic_positions: jnp.ndarray,
                   fs: float,
                   c,
                   lower: jnp.ndarray,
                   upper: jnp.ndarray,
                   num_sources: int,
                   segment: int = 4096,
                   hop: Optional[int] = None,
                   band: Optional[Tuple[float, float]] = None,
                   coarse_n: int = 24,
                   fine_n: int = 12,
                   min_separation: Optional[float] = None,
                   weighting: str = "phat",
                   accel_std: float = 0.5,
                   gate: Optional[float] = None,
                   max_speed: float = 5.0,
                   motion: str = "static",
                   motion_subframes: int = 8,
                   motion_iterations: int = 2,
                   suppression: str = "spatial") -> MultiTrack:
    """Track ``num_sources`` simultaneous movers with identity maintenance.

    Beyond parity (the reference is single-source static, main.py:126);
    closes the gap models/online.py documents ("associating tracks across
    hops is the caller's business"): per segment the K-peak suppression
    SRP fixes (srp_phat_locate_multi) arrive in EXTRACTION order — which
    source is "first" flips between segments — so two crossing movers
    cannot be followed without data association.

    Pipeline (all jittable, K! static):
      1. segment + GCC + K-source suppression SRP, vmapped over segments;
      2. a ``lax.scan`` over segments associates detections to tracks:
         each track predicts forward with its current velocity estimate
         (an alpha-beta filter — crossing movers are disambiguated by
         MOMENTUM, nearest-neighbor alone swaps them at the crossing),
         and the best of the K! track->detection assignments (minimum
         summed gated squared distance, exact Hungarian for small K)
         updates the tracks.  Detections farther than ``gate`` (meters)
         from every prediction leave their track coasting.
      3. each associated detection sequence is smoothed by the
         power-weighted constant-velocity Kalman/RTS smoother.

    ``gate`` defaults to ``max_speed * dt + 0.3`` meters (dt = hop/fs).
    Sources must be mutually low-correlated (independent talkers) for the
    suppression SRP to separate them — same caveat as
    ``srp_phat_locate_multi``.  ``suppression`` selects the static-mode
    extraction ('spatial' ball or per-pair lag 'claim' — prefer 'claim'
    on sparse arrays, see ``srp_phat_locate_multi``); the compensated
    mode below always claims.

    ``motion='compensated'`` handles sources that move WITHIN a segment.
    A mover drifts each pair delay by up to 2·speed/c·segment samples,
    smearing its whitened peak over that many lags; with K sources each
    peak also only owns ~1/K of the PHAT bins, and the flattened true
    peaks drop below the SRP map's combinatorial ghosts (measured on a
    two-walker WOLA scene: ~0.2-0.5 m static detections where the same
    sources STATIC localize to ~2 cm).  The single-source subframe-peak
    fit (``localize_trajectory``) cannot be reused — a subframe window
    holds K peaks and the global argmax chases the loudest.  Two passes:

      1. DETECTION by a delay-rate matched-filter bank + lag claiming
         (:func:`_detect_rate_envelope`): per pair, subframe correlations
         aligned under every candidate rate, summed, maxed over rates —
         full-height peaks for any bounded-rate mover — then K sequential
         SRP extractions, each nulling ±`_CLAIM_LAGS` around its per-pair
         lags so mixed-pair ghosts cannot outbid a weaker true source
         (``min_separation`` is ignored: claiming replaces the spatial
         suppression ball).  Association + Kalman/RTS as in static mode.
      2. REFINEMENT (:func:`_refine_tracks_compensated`), repeated
         ``motion_iterations`` times: each (segment, track) re-detects by
         aligning the subframe correlations with the rates PREDICTED from
         the track's own RTS-smoothed position/velocity (accurate to
         ~0.1 m/s — prediction beats per-segment measurement here),
         claiming away the other tracks' lags, and box-SRP-searching
         ±``gate`` m around the smoothed position; then re-smooths.

    Measured on the crossing-walkers WOLA render
    (tests/test_track_multiple.py): raw per-segment detections ~2-3 cm
    and identity maintained, vs 0.2-0.5 m static.
    ``positions``/``powers`` are the final refined detections.
    """
    if num_sources < 1:
        raise ValueError("num_sources must be >= 1")
    if num_sources > 5:
        raise ValueError("track_multiple enumerates K! assignments; "
                         "num_sources > 5 is unsupported")
    if weighting not in ("phat", "scot", "roth", "cc"):
        raise ValueError("weighting must be 'phat', 'scot', 'roth', or "
                         "'cc' for segment tracking")
    if motion not in ("static", "compensated"):
        raise ValueError("motion must be 'static' or 'compensated'")
    m, t = signals.shape
    hop = segment // 2 if hop is None else hop
    if t < segment:
        raise ValueError("signal shorter than one segment")
    num_seg = 1 + (t - segment) // hop
    starts = np.arange(num_seg) * hop
    pi, pj = np.triu_indices(m, 1)
    pi = pi.astype(np.int32)
    pj = pj.astype(np.int32)
    nfft = next_pow2(segment)
    dt_s = hop / float(fs)
    gate = (max_speed * dt_s + 0.3) if gate is None else float(gate)

    idx = starts[:, None] + np.arange(segment)[None, :]
    segs = jnp.take(signals, jnp.asarray(idx), axis=-1)     # (M, S, L)
    segs = jnp.swapaxes(segs, 0, 1)                         # (S, M, L)

    if motion == "compensated":
        lf = segment // motion_subframes
        if lf < 64:
            raise ValueError("segment // motion_subframes must be >= 64")
        nfft_f = next_pow2(2 * lf)
        # Window sizing is host-side: compensated mode needs CONCRETE mic
        # positions (same constraint as localize_trajectory's).
        mics_np = np.asarray(mic_positions, float)
        diam = float(np.max(np.linalg.norm(
            mics_np[:, None, :] - mics_np[None, :, :], axis=-1)))
        w_half = int(np.ceil(diam * float(fs) / float(c))) + 12
        s_max = int(np.ceil(2.0 * max_speed / float(c) * segment / 2.0)) + 2
        wn = w_half + s_max
        wlen = 2 * wn + 1
        if wlen > nfft_f:
            raise ValueError(
                "motion='compensated' alignment window (mic diameter "
                f"{w_half} + drift margin {s_max} lags) exceeds the "
                f"subframe transform {nfft_f}: use a longer segment, "
                "fewer motion_subframes, or a smaller max_speed")
        pi_t = tuple(pi.tolist())
        pj_t = tuple(pj.tolist())
        win = _subframe_windows(segs, pi_t, pj_t, float(fs), band,
                                weighting, motion_subframes, wn, nfft_f)
        dtype = win.dtype
        npad = int(2 ** np.ceil(np.log2(wlen)))
        spec = _rfft_pad(win, npad)
        mics_dev = jnp.asarray(mic_positions, dtype)
        dt_f = jnp.asarray((np.arange(motion_subframes) + 0.5) * lf
                           - (motion_subframes * lf) / 2.0, dtype)
        dets, powers = _detect_rate_envelope(
            spec, mics_dev, pi_t, pj_t, float(fs), c, lower, upper,
            num_sources, dt_f, npad, wlen, w_half, s_max, nfft_f,
            coarse_n, fine_n, min_separation)
    else:
        def one(seg):
            corr = gccphat.gcc_phat_all_pairs(seg, pi, pj, nfft=nfft,
                                              band=band, fs=fs,
                                              weighting=weighting)
            out = srp_ops.srp_phat_locate_multi(
                corr, mic_positions, pi, pj, fs, c, lower, upper,
                num_sources=num_sources, coarse_n=coarse_n, fine_n=fine_n,
                min_separation=min_separation, suppression=suppression)
            return out.positions, out.powers

        dets, powers = jax.vmap(one)(segs)          # (S, K, 3), (S, K)

    assoc_pos, assoc_pow, assoc_ok = associate_detections(
        dets, powers, dt_s, gate)
    dtype = dets.dtype

    def smooth(p, w):
        return jax.vmap(
            lambda ps, ws: kalman_rts_smooth(ps, dt_s, powers=ws,
                                             accel_std=accel_std),
            in_axes=(1, 1), out_axes=1)(p, w)

    smoothed, vels = smooth(assoc_pos, assoc_pow)

    if motion == "compensated":
        lo_d = jnp.asarray(lower, dtype)
        hi_d = jnp.asarray(upper, dtype)
        box_coarse_n = 12
        pool_w = max(1, int(np.ceil(0.866 * (2.0 * gate / box_coarse_n)
                                    * float(fs) / float(c))))
        for _ in range(max(int(motion_iterations), 0)):
            assoc_pos, assoc_pow = _refine_tracks_compensated(
                spec, smoothed, vels, mics_dev, pi_t, pj_t, float(fs), c,
                lo_d, hi_d, dt_f, npad, wlen, w_half, s_max, float(gate),
                box_coarse_n=box_coarse_n, fine_n=fine_n, pool_w=pool_w)
            smoothed, vels = smooth(assoc_pos, assoc_pow)

    times = jnp.asarray((starts + segment / 2.0) / fs, dtype)
    return MultiTrack(times, assoc_pos, smoothed, assoc_pow, vels,
                      assoc_ok)
