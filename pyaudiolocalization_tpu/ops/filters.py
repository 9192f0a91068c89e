"""IIR/FIR noise-reduction filters on the device.

Counterpart of ``noise_reduction`` (reference: signal_processing.py:109-138),
which uses scipy's butter+filtfilt, firwin+filtfilt, and wiener.  Design
happens on the host in float64 (coefficients are static data baked into the
jitted graph); the filtering itself runs on device:

  * IIR ``lfilter`` is a linear state-space recurrence
    ``z[t] = M z[t-1] + k x[t]``; we evaluate it either with a sequential
    ``lax.scan`` or (default) a parallel prefix ``lax.associative_scan`` —
    O(T log T) 10x10 matrix products that run in parallel instead of an
    un-parallelizable time loop.
  * ``filtfilt`` reproduces scipy's default odd-extension padding and
    steady-state initial conditions (Gustafsson is not used by the
    reference), so results match the SciPy oracle to fp tolerance.
  * FIR filtering is a convolution (plus the exact ``zi`` head correction),
    not a 100-dim state scan.

No code is taken from scipy; the designs are the textbook bilinear-transform
Butterworth and windowed-sinc constructions, validated against scipy in
tests/test_filters.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np



# ---------------------------------------------------------------------------
# Host-side designs (static, float64, numpy only)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _butter_bandpass_zpk(order: int, low: float, high: float):
    """Digital Butterworth bandpass as z-domain zeros/poles/gain."""
    if not 0.0 < low < high < 1.0:
        # scipy.butter's contract: normalized critical frequencies in (0, 1).
        raise ValueError(
            "Digital filter critical frequencies must be 0 < low < high < 1 "
            f"(got low={low}, high={high}; frequencies are in units of the "
            "Nyquist rate)")
    n = order
    # Analog lowpass prototype: unit-cutoff Butterworth poles, no zeros, k=1.
    k_idx = np.arange(1, n + 1)
    poles = np.exp(1j * np.pi * (2 * k_idx + n - 1) / (2 * n))
    gain = 1.0
    # Pre-warp the band edges (bilinear with fs=2).
    fs = 2.0
    w1 = 2 * fs * np.tan(np.pi * low / fs)
    w2 = 2 * fs * np.tan(np.pi * high / fs)
    bw = w2 - w1
    wo = np.sqrt(w1 * w2)
    # Lowpass -> bandpass on the pole set: each pole p maps to the pair
    # p*bw/2 +/- sqrt((p*bw/2)^2 - wo^2); n zeros appear at s=0.
    scaled = poles * bw / 2.0
    root = np.sqrt(scaled ** 2 - wo ** 2)
    bp_poles = np.concatenate([scaled + root, scaled - root])
    bp_zeros = np.zeros(n, complex)
    bp_gain = gain * bw ** n
    # Bilinear transform to the z-domain.
    fs2 = 2.0 * fs
    z_d = (fs2 + bp_zeros) / (fs2 - bp_zeros)
    p_d = (fs2 + bp_poles) / (fs2 - bp_poles)
    k_d = bp_gain * np.real(np.prod(fs2 - bp_zeros) / np.prod(fs2 - bp_poles))
    # Degree deficit -> zeros at z=-1.
    z_d = np.concatenate([z_d, -np.ones(len(p_d) - len(z_d))])
    return z_d, p_d, float(k_d)


@functools.lru_cache(maxsize=64)
def butter_bandpass(order: int, low: float, high: float) -> Tuple[tuple, tuple]:
    """Digital Butterworth bandpass (b, a), cutoffs normalized to Nyquist
    (scipy.butter(order, [low, high], btype='band') semantics).

    NOTE: the single direct-form realization of an order-2n narrowband filter
    is numerically fragile (poles cluster near the unit circle); prefer
    ``butter_bandpass_sos`` for actual filtering.
    """
    z_d, p_d, k_d = _butter_bandpass_zpk(order, low, high)
    b = np.real(k_d * np.poly(z_d))
    a = np.real(np.poly(p_d))
    return tuple(b.tolist()), tuple(a.tolist())


@functools.lru_cache(maxsize=64)
def butter_bandpass_sos(order: int, low: float, high: float) -> tuple:
    """Butterworth bandpass as second-order sections.

    Same transfer function as ``butter_bandpass`` but factored into
    ``order`` biquads — each a conjugate pole pair with one zero at z=+1 and
    one at z=-1 — with the gain spread evenly across sections.  This is the
    numerically sound realization: each 2x2 state recurrence is
    well-conditioned, so both the sequential scan and the parallel-prefix
    evaluation stay finite in float32 where the order-2n direct form
    overflows (poles at |p| ~ 0.99 make products of its 2n x 2n companion
    matrices blow up transiently).  Returns ((b0,b1,b2,a0,a1,a2), ...).
    """
    z_d, p_d, k_d = _butter_bandpass_zpk(order, low, high)
    # Upper-half-plane representative of each conjugate pole pair.  A digital
    # Butterworth bandpass of analog order n has n such pairs (real poles
    # only occur for degenerate band edges; pair them together then).
    tol = 1e-12
    upper = sorted([p for p in p_d if p.imag > tol], key=lambda p: abs(p))
    reals = sorted([p.real for p in p_d if abs(p.imag) <= tol])
    pole_pairs = [(p, np.conj(p)) for p in upper]
    pole_pairs += [(reals[i], reals[i + 1]) for i in range(0, len(reals) - 1, 2)]
    if 2 * len(pole_pairs) != len(p_d):
        raise ValueError("unpaired pole while forming sections")
    # Zeros are n at z=+1 and n at z=-1: one of each per section keeps every
    # biquad a bandpass.  Sections ordered with poles closest to the unit
    # circle last (standard cascade ordering for minimal peak round-off).
    pole_pairs.sort(key=lambda pq: abs(abs(pq[0]) - 1.0), reverse=True)
    k_sec = float(np.sign(k_d)) * abs(k_d) ** (1.0 / len(pole_pairs))
    sos = []
    for p, q in pole_pairs:
        b = k_sec * np.poly([1.0, -1.0])          # (z-1)(z+1) = z^2 - 1
        a = np.real(np.poly([p, q]))
        sos.append((float(b[0]), float(b[1]), float(b[2]),
                    float(a[0]), float(a[1]), float(a[2])))
    return tuple(sos)


@functools.lru_cache(maxsize=64)
def firwin_bandpass(numtaps: int, low: float, high: float) -> tuple:
    """Hamming-windowed-sinc bandpass FIR taps
    (scipy.firwin(numtaps, [low, high], pass_zero=False) semantics)."""
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = high * np.sinc(high * m) - low * np.sinc(low * m)
    win = np.hamming(numtaps)
    h = h * win
    # Unit gain at the band center.
    scale_freq = 0.5 * (low + high)
    c = np.cos(np.pi * m * scale_freq)
    h = h / np.sum(h * c)
    return tuple(h.tolist())


def _pad_ba(b, a):
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    n = max(len(b), len(a))
    b = np.concatenate([b, np.zeros(n - len(b))])
    a = np.concatenate([a, np.zeros(n - len(a))])
    b, a = b / a[0], a / a[0]
    return b, a


@functools.lru_cache(maxsize=64)
def lfilter_zi(b: tuple, a: tuple) -> tuple:
    """Steady-state initial conditions for a unit-step input (scipy
    lfilter_zi semantics): solve (I - A) zi = B with A the DF2T state
    transition and B = b[1:] - a[1:] b[0]."""
    bb, aa = _pad_ba(b, a)
    n = len(aa)
    if n == 1:
        return ()
    # DF2T transition: z[t] = M z[t-1] + k x[t] with
    # M[i, j] = delta_{j, i+1} - a[i+1] delta_{j, 0}.
    M = np.zeros((n - 1, n - 1))
    M[:-1, 1:] += np.eye(n - 2)
    M[:, 0] -= aa[1:]
    B = bb[1:] - aa[1:] * bb[0]
    zi = np.linalg.solve(np.eye(n - 1) - M, B)
    return tuple(zi.tolist())


def _df2t_matrices(b: tuple, a: tuple):
    bb, aa = _pad_ba(b, a)
    n = len(aa)
    M = np.zeros((n - 1, n - 1))
    M[:-1, 1:] += np.eye(n - 2)
    M[:, 0] -= aa[1:]
    kvec = bb[1:] - aa[1:] * bb[0]
    # Plain float: a numpy f64 scalar would promote f32 signals to f64.
    return float(bb[0]), M, kvec


# ---------------------------------------------------------------------------
# Device-side filtering
# ---------------------------------------------------------------------------

def lfilter(b, a, x: jnp.ndarray, zi: jnp.ndarray | None = None,
            method: str = "prefix") -> jnp.ndarray:
    """Direct-form-II-transposed linear filter along the last axis.

    ``b``/``a`` are static coefficient sequences; ``zi`` (optional) has shape
    ``x.shape[:-1] + (max(len(a), len(b)) - 1,)``.  ``method``:
      * 'prefix' — parallel prefix over (M, k*x_t) pairs;
      * 'scan'   — sequential lax.scan (reference semantics, low memory).
    """
    b = tuple(np.atleast_1d(b).tolist())
    a = tuple(np.atleast_1d(a).tolist())
    return _lfilter_jit(b, a, x, zi, method)


# Jitted at definition (eager per-op dispatch of the prefix path costs
# hundreds of one-off XLA op compiles per new shape on CPU hosts; one
# persistent-cacheable whole-graph compile under jit).  Coefficients are
# normalized to hashable tuples by the public wrappers above/below.
@functools.partial(jax.jit, static_argnames=("b", "a", "method"))
def _lfilter_jit(b: tuple, a: tuple, x: jnp.ndarray,
                 zi: jnp.ndarray | None, method: str) -> jnp.ndarray:
    if len(a) == 1:
        return _fir_lfilter(b, a[0], x, zi)
    b0, M, kvec = _df2t_matrices(b, a)
    dt = x.dtype
    Mj = jnp.asarray(M, dt)
    kj = jnp.asarray(kvec, dt)
    state_dim = M.shape[0]
    batch_shape = x.shape[:-1]
    T = x.shape[-1]
    if zi is None:
        zi = jnp.zeros(batch_shape + (state_dim,), dt)

    if method == "scan":
        def step(z, xt):
            # y_t reads z BEFORE the update (z holds z[t-1]).
            y = b0 * xt + z[..., 0]
            z = z @ Mj.T + kvec_outer(xt)
            return z, y

        def kvec_outer(xt):
            return xt[..., None] * kj

        xt_seq = jnp.moveaxis(x, -1, 0)
        _, ys = jax.lax.scan(step, zi, xt_seq)
        return jnp.moveaxis(ys, 0, -1)

    # Parallel prefix: z[t] = M z[t-1] + k x[t] composes associatively as
    # (A2, c2) o (A1, c1) = (A2 A1, A2 c1 + c2).
    A = jnp.broadcast_to(Mj, (T, state_dim, state_dim))
    c = x[..., :, None] * kj  # (..., T, state_dim)
    c = jnp.moveaxis(c, -2, 0)  # (T, ..., state_dim)

    def combine(e1, e2):
        A1, c1 = e1
        A2, c2 = e2
        return A2 @ A1, jnp.einsum("t...ij,t...j->t...i", A2, c1) + c2

    A_acc, c_acc = jax.lax.associative_scan(combine, (A, c), axis=0)
    # z[t] = A_acc[t] @ zi + c_acc[t]; y[t] = b0 x[t] + z[t-1][0].
    z = jnp.einsum("tij,...j->t...i", A_acc, zi) + c_acc
    z_prev0 = jnp.concatenate([zi[None, ..., 0], z[:-1, ..., 0]], axis=0)
    y = b0 * x + jnp.moveaxis(z_prev0, 0, -1)
    return y


def _fir_lfilter(b: tuple, a0: float, x: jnp.ndarray,
                 zi: jnp.ndarray | None) -> jnp.ndarray:
    """lfilter with a=[a0]: causal convolution, plus the exact DF2T head
    correction (y[t] += zi[t] for t < len(b)-1)."""
    dt = x.dtype
    taps = jnp.asarray(np.asarray(b, np.float64) / a0, dt)
    k = taps.shape[0]
    T = x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(k - 1, 0)])
    # Correlate with reversed taps == causal convolution with taps.
    y = _conv_valid(xp, taps[::-1])
    if zi is not None and k > 1:
        head = jnp.zeros_like(y).at[..., : k - 1].set(
            zi[..., : min(k - 1, zi.shape[-1])][..., : k - 1])
        y = y + head
    return y[..., :T]


def _conv_valid(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """'valid' correlation of x with kernel along the last axis, batched.

    Large kernels go through the FFT (overlap-free, one padded transform):
    O(n log n) instead of the direct convolution's O(n * k) for the
    thousands-of-taps impulse responses filtfilt_sos_conv builds."""
    n = x.shape[-1]
    k = kernel.shape[0]
    if k >= 256:
        nfft = 1 << (n - 1).bit_length()
        # The kernel spectrum is a compile-time constant.
        spec = jnp.fft.rfft(x, n=nfft) * jnp.fft.rfft(kernel[::-1], n=nfft)
        full = jnp.fft.irfft(spec, n=nfft).astype(x.dtype)
        # Linear-conv positions k-1..n-1 are alias-free because nfft >= n.
        return full[..., k - 1:n]
    batch_shape = x.shape[:-1]
    xin = x.reshape((-1, 1, x.shape[-1]))
    ker = kernel.reshape((1, 1, kernel.shape[0]))
    out = jax.lax.conv_general_dilated(
        xin, ker, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "IOH", "NCH"))
    return out.reshape(batch_shape + (out.shape[-1],))


def _odd_ext(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Odd extension at both ends (scipy.signal.odd_ext semantics)."""
    left = 2 * x[..., :1] - x[..., n:0:-1]
    right = 2 * x[..., -1:] - x[..., -2:-(n + 2):-1]
    return jnp.concatenate([left, x, right], axis=-1)


def filtfilt(b, a, x: jnp.ndarray, method: str = "prefix") -> jnp.ndarray:
    """Zero-phase filtering with scipy's defaults: odd extension of length
    3*max(len(a), len(b)), steady-state zi scaled by the first sample,
    forward pass, reversed pass, strip extension."""
    b = tuple(np.atleast_1d(b).tolist())
    a = tuple(np.atleast_1d(a).tolist())
    padlen = 3 * max(len(a), len(b))
    if x.shape[-1] <= padlen:
        raise ValueError(
            f"The length of the input vector must be greater than padlen ({padlen}).")
    zi = jnp.asarray(lfilter_zi(b, a), x.dtype)
    ext = _odd_ext(x, padlen)
    y = lfilter(b, a, ext, zi * ext[..., :1], method=method)
    y = y[..., ::-1]
    y = lfilter(b, a, y, zi * y[..., :1], method=method)
    y = y[..., ::-1]
    return y[..., padlen:-padlen]


@functools.lru_cache(maxsize=64)
def sos_impulse_response(sos: tuple, tol: float = 1e-9) -> tuple:
    """Impulse response of a biquad cascade, truncated where the tail is
    below ``tol`` relative to the peak (host-side float64 simulation).

    The truncation length follows the slowest pole: L ~ log(tol)/log|p|max.
    For the reference's order-5 bandpass (|p|max ~ 0.989) that is ~1.8k
    samples — short enough that IIR filtering becomes a small convolution.
    """
    max_pole = 0.0
    for sec in sos:
        roots = np.roots(np.asarray(sec[3:], np.float64))
        max_pole = max(max_pole, float(np.max(np.abs(roots))))
    max_pole = min(max(max_pole, 1e-6), 0.999999)
    L = int(np.ceil(np.log(tol) / np.log(max_pole))) + len(sos) * 2 + 1
    L = min(L, 65536)
    h = np.zeros(L, np.float64)
    h[0] = 1.0
    for sec in sos:
        b = np.asarray(sec[:3], np.float64)
        a = np.asarray(sec[3:], np.float64)
        out = np.zeros(L, np.float64)
        z1 = z2 = 0.0
        for t in range(L):  # DF2T biquad, 3 coeffs — cheap even in Python
            xt = h[t]
            yt = b[0] * xt + z1
            z1 = b[1] * xt - a[1] * yt + z2
            z2 = b[2] * xt - a[2] * yt
            out[t] = yt
        h = out
    return tuple(h.tolist())


def filtfilt_sos_conv(sos: tuple, x: jnp.ndarray,
                      tol: float = 1e-9) -> jnp.ndarray:
    """Zero-phase IIR filtering as TWO convolutions — the default
    filtfilt path.  Matches scipy's filtfilt protocol up to the impulse-tail
    truncation O(tol):

      * forward pass: scipy's steady-state ``zi * ext[0]`` initial condition
        is identical to the input having been the constant ``ext[0]`` for all
        t < 0, realized by prepending L-1 samples of it and convolving with
        the truncated impulse response h;
      * backward pass: scipy assumes the FORWARD OUTPUT stays constant past
        its end (``zi * y_fwd[-1]``), realized by appending L-1 samples of
        y_fwd's last value and correlating with h (= time-reversed filtering).

    Each convolution is one dense multiply-accumulate program (or one FFT
    product, see _conv_valid) instead of log-depth prefix scans over
    (T, 2, 2) matrices.
    """
    h_np = np.asarray(sos_impulse_response(sos, tol), np.float64)
    L = h_np.shape[0]
    h = jnp.asarray(h_np, x.dtype)
    padlen = 3 * (2 * len(sos) + 1)
    if x.shape[-1] <= padlen:
        raise ValueError(
            f"The length of the input vector must be greater than padlen ({padlen}).")
    ext = _odd_ext(x, padlen)
    shape_pad = ext.shape[:-1] + (L - 1,)
    # Forward: causal conv with h over [const-x0 prehistory | ext].
    pre = jnp.broadcast_to(ext[..., :1], shape_pad)
    y_fwd = _conv_valid(jnp.concatenate([pre, ext], -1), h[::-1])
    # Backward: anti-causal conv (plain correlation with h) over
    # [y_fwd | const-last posthistory].
    post = jnp.broadcast_to(y_fwd[..., -1:], shape_pad)
    y = _conv_valid(jnp.concatenate([y_fwd, post], -1), h)
    return y[..., padlen:-padlen]


def sosfilt(sos: tuple, x: jnp.ndarray, x0=None,
            method: str = "prefix") -> jnp.ndarray:
    """Cascade of biquads along the last axis.  When ``x0`` is given, each
    section starts from its steady state for a step of amplitude ``x0``
    scaled by the DC gain of the sections before it (scipy ``sosfilt_zi``
    semantics) — the cascade equivalent of lfilter's ``zi * x[0]``."""
    y = x
    gain_cum = 1.0
    for sec in sos:
        b, a = sec[:3], sec[3:]
        zi = None
        if x0 is not None:
            zi = jnp.asarray(lfilter_zi(b, a), x.dtype) * (gain_cum * x0)
            gain_cum *= sum(b) / sum(a)
        y = lfilter(b, a, y, zi, method=method)
    return y


def filtfilt_sos(sos: tuple, x: jnp.ndarray,
                 method: str = "conv") -> jnp.ndarray:
    """Zero-phase filtering through a biquad cascade with the same edge
    protocol as ``filtfilt``: odd extension of 3*(2*nsections+1) samples
    (== scipy's 3*max(len(a), len(b)) for the composed filter) and
    steady-state initial conditions scaled by the first sample of each pass.
    Stable in float32 where the direct-form ``filtfilt`` is not.

    method 'conv' (default) evaluates the whole thing as a
    single truncated-impulse-response convolution; 'prefix'/'scan' run the
    exact recurrences per section."""
    if method == "conv":
        return filtfilt_sos_conv(sos, x)
    padlen = 3 * (2 * len(sos) + 1)
    if x.shape[-1] <= padlen:
        raise ValueError(
            f"The length of the input vector must be greater than padlen ({padlen}).")
    ext = _odd_ext(x, padlen)
    y = sosfilt(sos, ext, ext[..., :1], method=method)
    y = y[..., ::-1]
    y = sosfilt(sos, y, y[..., :1], method=method)
    y = y[..., ::-1]
    return y[..., padlen:-padlen]


def wiener(x: jnp.ndarray, mysize: int = 3) -> jnp.ndarray:
    """Local-statistics Wiener filter (scipy.signal.wiener 1-D semantics,
    noise power estimated as the mean local variance)."""
    ones = jnp.ones(mysize, x.dtype)
    pad = mysize // 2
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, mysize - 1 - pad)])
    l_mean = _conv_valid(xp, ones) / mysize
    xp2 = jnp.pad(x * x, [(0, 0)] * (x.ndim - 1) + [(pad, mysize - 1 - pad)])
    l_var = _conv_valid(xp2, ones) / mysize - l_mean * l_mean
    noise = jnp.mean(l_var, axis=-1, keepdims=True)
    res = l_mean + (x - l_mean) * (1.0 - noise / jnp.where(l_var == 0, 1.0, l_var))
    return jnp.where(l_var < noise, l_mean, res)


# ---------------------------------------------------------------------------
# Dispatcher (reference signal_processing.py:109-138)
# ---------------------------------------------------------------------------

def noise_reduction(signal: jnp.ndarray, fs: float, method: str = "butterworth",
                    lowcut: float = 300.0, highcut: float = 3400.0,
                    filter_order: int = 101,
                    lfilter_method: str = "conv") -> jnp.ndarray:
    """Bandpass/Wiener noise reduction with the reference's defaults."""
    nyquist = 0.5 * fs
    if method == "butterworth":
        sos = butter_bandpass_sos(5, lowcut / nyquist, highcut / nyquist)
        return filtfilt_sos(sos, signal, method=lfilter_method)
    if method == "fir":
        taps = firwin_bandpass(filter_order, lowcut / nyquist, highcut / nyquist)
        return filtfilt(taps, (1.0,), signal, method=lfilter_method)
    if method == "wiener":
        return wiener(signal)
    raise ValueError(
        "Unknown filter method. Available methods: 'butterworth', 'fir', 'wiener'")
