"""SRP-PHAT: steered-response-power localization over a candidate grid.

No reference counterpart (the reference only solves TDOA least squares) —
this is the standard robust alternative: for every candidate position x,
sum each pair's whitened correlation at that position's expected lag

    SRP(x) = sum_p corr_p[ round(fs * (|x - mic_j| - |x - mic_i|) / c) ]

and take the argmax.  No initialization, no convergence failures, and
naturally robust to multipath/outlier pairs (a bad pair adds noise to the
map instead of biasing a solver).  Shape: the whole grid
evaluates as one gather + reduction; scenes/pairs batch with vmap; a second
fine stage re-grids around the coarse peak, then an optional quadratic
refinement interpolates sub-cell.

Operates on circular-order correlations exactly as ``gcc_phat_all_pairs``
returns them (lag 0 at index 0, negative lags wrapped), so no roll/copy is
needed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class SrpResult(NamedTuple):
    position: jnp.ndarray   # (..., 3)
    power: jnp.ndarray      # (...,) SRP value at the estimate
    coarse: jnp.ndarray     # (..., 3) stage-1 cell center (diagnostics)


class MultiSrpResult(NamedTuple):
    positions: jnp.ndarray  # (..., K, 3) in coarse extraction order
    powers: jnp.ndarray     # (..., K) fine-stage SRP values


def _axis_grid(lo, hi, n: int, dtype):
    steps = (jnp.arange(n, dtype=dtype) + 0.5) / n
    return lo + steps * (hi - lo)


def _grid_points(lo: jnp.ndarray, hi: jnp.ndarray, n: int, dtype):
    """(n^3, 3) cell-center lattice over the box [lo, hi]^3."""
    ax = [_axis_grid(lo[d], hi[d], n, dtype) for d in range(3)]
    gx, gy, gz = jnp.meshgrid(*ax, indexing="ij")
    return jnp.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)


# ---------------------------------------------------------------------------
# Shared grid-search machinery (SRP, Bartlett beamformer, MUSIC)
# ---------------------------------------------------------------------------

def quadratic_peak_offset(fine_val: jnp.ndarray, k, fine_n: int,
                          spacing: jnp.ndarray) -> jnp.ndarray:
    """Sub-cell 3-axis parabolic peak interpolation on a fine-lattice map.

    The fine grid quantizes every grid solver's answer to its spacing
    (~1-2 cm at the default 24/12 stages); fitting a parabola through the
    argmax and its two axis neighbors recovers the continuous peak to a
    fraction of a cell.  Boundary argmaxes and non-concave fits keep a
    zero offset; offsets are clamped to half a cell (a sharper-than-
    quadratic peak, e.g. MUSIC's 1/x^2, just yields a small conservative
    shift).  fine_val: (fine_n^3,); spacing: (3,) per-axis lattice step.
    Returns the (3,) position correction."""
    strides = jnp.asarray([fine_n * fine_n, fine_n, 1])
    idx3 = (k // strides) % fine_n
    f0 = fine_val[k]
    km = jnp.clip(k - strides, 0, fine_val.shape[0] - 1)
    kp = jnp.clip(k + strides, 0, fine_val.shape[0] - 1)
    f_m = fine_val[km]
    f_p = fine_val[kp]
    interior = (idx3 > 0) & (idx3 < fine_n - 1)
    denom = f_m - 2.0 * f0 + f_p
    off = jnp.where(interior & (denom < 0.0),
                    0.5 * (f_m - f_p) / jnp.where(denom < 0.0, denom, -1.0),
                    0.0)
    return jnp.clip(off, -0.5, 0.5) * spacing


def two_stage_search(coarse_fn, fine_fn, lower, upper, coarse_n: int,
                     fine_n: int, dtype):
    """Coarse argmax over the box, then a fine re-grid of +-1.5 coarse
    cells around the peak, then sub-cell parabolic peak interpolation.

    ``coarse_fn``/``fine_fn`` map a (G, 3) point lattice to (G,) values
    (they may differ — SRP evaluates the coarse stage on a max-pooled
    correlation).  Returns (pos, power, center, cell); ``pos`` is NOT
    clipped to the box (the fine grid extends half a cell beyond it) —
    clip at the call site if required."""
    pts = _grid_points(lower, upper, coarse_n, dtype)
    vals = coarse_fn(pts)
    center = pts[jnp.argmax(vals)]
    cell = (upper - lower) / coarse_n
    fine_pts = _grid_points(center - 1.5 * cell, center + 1.5 * cell,
                            fine_n, dtype)
    fine_val = fine_fn(fine_pts)
    k = jnp.argmax(fine_val)
    spacing = 3.0 * cell / fine_n
    pos = fine_pts[k] + quadratic_peak_offset(fine_val, k, fine_n, spacing)
    return pos, fine_val[k], center, cell


def suppressed_multi_search(coarse_fn, fine_fn, lower, upper, coarse_n: int,
                            fine_n: int, num_sources: int, min_separation,
                            dtype):
    """Iterative argmax + spatial suppression over the coarse map, then the
    fine stage around each extracted peak.

    Suppression radius defaults to THREE coarse cells: the fine stage
    re-grids +-1.5 cells around each peak, so smaller radii would let
    distinct peaks' fine boxes overlap (pass ``min_separation`` to
    override, accepting that risk for known-close sources).  Returns
    (positions (K, 3) clipped to the box, powers (K,)) in descending
    coarse-power extraction order; ``powers`` are fine-stage values and
    may not be monotone."""
    pts = _grid_points(lower, upper, coarse_n, dtype)
    vals = coarse_fn(pts)
    cell = (upper - lower) / coarse_n
    radius = (3.0 * jnp.max(cell) if min_separation is None
              else jnp.asarray(min_separation, dtype))

    def pick(carry, _):
        v = carry
        idx = jnp.argmax(v)
        center = pts[idx]
        close = jnp.linalg.norm(pts - center[None, :], axis=-1) <= radius
        return jnp.where(close, -jnp.inf, v), center

    _, centers = jax.lax.scan(pick, vals, None, length=num_sources)

    def refine_one(center):
        fine_pts = _grid_points(center - 1.5 * cell, center + 1.5 * cell,
                                fine_n, dtype)
        fine_val = fine_fn(fine_pts)
        k = jnp.argmax(fine_val)
        pos = fine_pts[k] + quadratic_peak_offset(fine_val, k, fine_n,
                                                  3.0 * cell / fine_n)
        return pos, fine_val[k]

    positions, powers = jax.vmap(refine_one)(centers)
    return jnp.clip(positions, lower[None, :], upper[None, :]), powers


def srp_map(corr: jnp.ndarray, points: jnp.ndarray, mic_positions: jnp.ndarray,
            pairs_i: np.ndarray, pairs_j: np.ndarray, fs: float, c,
            max_lag: Optional[int] = None,
            pre_windowed: bool = False) -> jnp.ndarray:
    """SRP value for each candidate point.

    corr: (P, nfft) circular-order whitened correlations; points: (G, 3).
    Returns (G,).  Fractional expected lags are linearly interpolated
    between neighboring correlation samples.

    With ``max_lag`` (a STATIC bound on |expected lag| in samples — any
    physically possible |tau|*fs is at most the pair mic distance over c),
    the interpolation runs GATHER-FREE: the correlation is sliced to the
    centered +-max_lag window and each value is a hat-kernel weighted
    reduction over the window, which XLA fuses — no runtime-index gather
    even when mic positions are traced (e.g. the sweep's jittered arrays;
    with compile-time-constant grids XLA folds the gather anyway).  Without
    ``max_lag`` the exact-equivalent circular gather path runs.
    """
    nfft = corr.shape[-1]
    if max_lag is not None and max_lag < 1:
        # corr[..., -0:] would be the WHOLE array (Python slice semantics),
        # silently corrupting the window math.
        raise ValueError("max_lag must be >= 1 (or None for the gather path)")
    d = jnp.linalg.norm(points[:, None, :] - mic_positions[None, :, :],
                        axis=-1)                                   # (G, M)
    # Peak sits at lag -(arrival_j - arrival_i) (see models/tdoa.py).
    tau = -(jnp.take(d, pairs_j, 1) - jnp.take(d, pairs_i, 1)) / c  # (G, P)
    lag = tau * fs
    if max_lag is not None and (pre_windowed or 2 * max_lag + 1 <= nfft):
        if pre_windowed:
            # corr is ALREADY the centered (P, 2*max_lag+1) window (see
            # _pooled_window) — callers pre-slice so pooling and repeated
            # map calls never touch the full transform length.
            if corr.shape[-1] != 2 * max_lag + 1:
                raise ValueError("pre_windowed corr must have length "
                                 "2*max_lag+1")
            win = corr
        else:
            win = jnp.concatenate([corr[..., -max_lag:],
                                   corr[..., :max_lag + 1]], -1)  # (P, 2L+1)
        idx = lag + max_lag                                   # window coords
        ells = jnp.arange(2 * max_lag + 1, dtype=corr.dtype)
        w = jnp.maximum(0.0, 1.0 - jnp.abs(idx[:, :, None] - ells))
        return jnp.sum(w * win[None, :, :], axis=(-2, -1))    # (G,)
    lag0 = jnp.floor(lag)
    frac = lag - lag0
    i0 = jnp.mod(lag0.astype(jnp.int32), nfft)
    i1 = jnp.mod(i0 + 1, nfft)
    p_idx = jnp.arange(pairs_i.shape[0])[None, :]
    v0 = corr[p_idx, i0]
    v1 = corr[p_idx, i1]
    return jnp.sum(v0 * (1.0 - frac) + v1 * frac, axis=-1)        # (G,)


def max_pool_corr(corr: jnp.ndarray, w: int) -> jnp.ndarray:
    """Circular sliding maximum of width 2w+1 along the last axis.

    A whitened broadband correlation peak is only ~1-2 samples wide — about
    c/fs ~ 2 cm of spatial extent — so coarse grid cells straddle it and
    score near zero.  Pooling to the cell's lag footprint makes every cell
    containing a peak see it (standard SRP 'volumetric' trick)."""
    pooled = corr
    for s in range(1, max(0, w) + 1):
        pooled = jnp.maximum(pooled, jnp.maximum(
            jnp.roll(corr, s, axis=-1), jnp.roll(corr, -s, axis=-1)))
    return pooled


def _center_window(corr: jnp.ndarray, half: int) -> jnp.ndarray:
    """Centered +-half lag slice of a circular correlation (lag 0 mid)."""
    return jnp.concatenate([corr[..., -half:], corr[..., :half + 1]], -1)


def _pooled_window(corr: jnp.ndarray, ml: int, w: int) -> jnp.ndarray:
    """Centered +-ml slice of ``max_pool_corr(corr, w)`` computed WITHOUT
    pooling the full transform: slice +-(ml+w) first, pool the slice (its
    circular rolls only contaminate within w of the slice ends), trim w per
    side — exact, ~nfft/(2*ml) times less traffic on the hot path."""
    if w <= 0:
        return _center_window(corr, ml)
    sl = _center_window(corr, ml + w)
    return max_pool_corr(sl, w)[..., w:-w]


def _resolve_max_lag(max_lag_samples, mic_positions, fs, c) -> Optional[int]:
    """Static |lag| bound (samples) for srp_map's gather-free path.

    For ANY candidate point, |tau(x; i, j)| <= |mic_i - mic_j| / c (triangle
    inequality), so the mic-array diameter bounds every expected lag.  With
    concrete mic positions the bound is computed here; traced positions
    (e.g. the sweep's jittered arrays under jit) need the caller to pass
    ``max_lag_samples`` — None falls back to the circular-gather path."""
    if max_lag_samples is not None:
        return int(max_lag_samples) + 2
    try:
        mics = np.asarray(mic_positions)
        diam = float(np.max(np.linalg.norm(
            mics[:, None, :] - mics[None, :, :], axis=-1)))
        return int(np.ceil(diam * fs / float(c))) + 2
    except Exception:
        return None


def _resolve_pool(pool_samples, lower, upper, coarse_n, fs, c) -> int:
    if pool_samples is not None:
        return int(pool_samples)
    try:
        cell = float(jnp.max(upper - lower)) / coarse_n
        return max(1, int(np.ceil(0.866 * cell * fs / float(c))))
    except Exception:
        # Bounds/c are tracers inside an outer jit: callers that jit should
        # pass pool_samples explicitly; 2 covers ~5 cm cells at 16 kHz.
        return 2


def srp_phat_locate(corr: jnp.ndarray,
                    mic_positions: jnp.ndarray,
                    pairs_i: np.ndarray,
                    pairs_j: np.ndarray,
                    fs: float,
                    c,
                    lower: jnp.ndarray,
                    upper: jnp.ndarray,
                    coarse_n: int = 24,
                    fine_n: int = 12,
                    refine: bool = True,
                    pool_samples: Optional[int] = None,
                    max_lag_samples: Optional[int] = None) -> SrpResult:
    """Two-stage SRP-PHAT grid search over the box [lower, upper].

    Stage 1: coarse_n^3 lattice over the box, evaluated on a max-pooled
    correlation (see ``max_pool_corr`` — the cells must not straddle the
    1-2-sample-wide peaks); stage 2: fine_n^3 lattice over the
    +-1-coarse-cell neighborhood of the peak on the RAW correlation;
    optional per-axis quadratic interpolation of the fine peak.  Everything
    is one jitted graph (jitted here at definition — eager callers such as
    the tracking/online serving paths would otherwise pay per-op dispatch);
    vmap over a leading scene axis for batches.
    """
    return _srp_locate_jit(
        corr, mic_positions, c, lower, upper,
        pi=tuple(np.asarray(pairs_i, np.int32).tolist()),
        pj=tuple(np.asarray(pairs_j, np.int32).tolist()),
        fs=float(fs), coarse_n=coarse_n, fine_n=fine_n, refine=refine,
        w=_resolve_pool(pool_samples, lower, upper, coarse_n, fs, c),
        ml=_resolve_max_lag(max_lag_samples, mic_positions, fs, c))


@functools.partial(jax.jit, static_argnames=(
    "pi", "pj", "fs", "coarse_n", "fine_n", "refine", "w", "ml"))
def _srp_locate_jit(corr, mic_positions, c, lower, upper, *, pi, pj, fs,
                    coarse_n, fine_n, refine, w, ml) -> SrpResult:
    dtype = corr.dtype
    pi = np.asarray(pi, np.int32)
    pj = np.asarray(pj, np.int32)
    windowed = ml is not None and 2 * (ml + w) + 1 <= corr.shape[-1]

    if windowed:
        coarse_src, pw = _pooled_window(corr, ml, w), True
        corr = _center_window(corr, ml)  # later stages read the raw window
    else:
        coarse_src, pw = max_pool_corr(corr, w), False

    def coarse_fn(p):
        return srp_map(coarse_src, p, mic_positions, pi, pj, fs, c,
                       max_lag=ml, pre_windowed=pw)

    def fine_fn(p):
        return srp_map(corr, p, mic_positions, pi, pj, fs, c,
                       max_lag=ml, pre_windowed=pw)

    pos, power, center, cell = two_stage_search(
        coarse_fn, fine_fn, lower, upper, coarse_n, fine_n, dtype)

    if refine:
        # Per-axis quadratic fit through (pos - h, pos, pos + h).
        h = 3.0 * cell / fine_n

        def axis_refine(carry, d):
            p, _ = carry
            e = jnp.zeros(3, dtype).at[d].set(1.0)
            step = h[d]
            vm = fine_fn((p - step * e)[None])[0]
            v0 = fine_fn(p[None])[0]
            vp = fine_fn((p + step * e)[None])[0]
            denom = vm - 2.0 * v0 + vp
            delta = jnp.where(jnp.abs(denom) > 1e-12,
                              0.5 * (vm - vp) / jnp.where(denom == 0, 1.0,
                                                          denom), 0.0)
            delta = jnp.clip(delta, -1.0, 1.0) * step
            return (p + delta * e, v0), None

        (pos, _), _ = jax.lax.scan(axis_refine, (pos, power), jnp.arange(3))
        pos = jnp.clip(pos, lower, upper)
        power = fine_fn(pos[None])[0]

    return SrpResult(pos, power, center)


def srp_phat_locate_multi(corr: jnp.ndarray,
                          mic_positions: jnp.ndarray,
                          pairs_i: np.ndarray,
                          pairs_j: np.ndarray,
                          fs: float,
                          c,
                          lower: jnp.ndarray,
                          upper: jnp.ndarray,
                          num_sources: int,
                          coarse_n: int = 24,
                          fine_n: int = 12,
                          min_separation: Optional[float] = None,
                          pool_samples: Optional[int] = None,
                          max_lag_samples: Optional[int] = None,
                          suppression: str = "spatial",
                          claim_lags: float = 4.0) -> MultiSrpResult:
    """Localize up to ``num_sources`` simultaneous sources: iteratively take
    the SRP-map argmax and spatially suppress a ``min_separation``-radius
    ball around it (default: THREE coarse cells — the fine stage re-grids
    +-1.5 cells, so smaller radii would let distinct peaks' fine boxes
    overlap), then refine each coarse peak with the single-source fine
    stage.  The static peak count keeps the whole thing one XLA graph;
    entries follow coarse extraction order (descending POOLED coarse
    power); the returned ``powers`` are fine-stage values and may not be
    monotone.

    ``suppression='claim'`` replaces the spatial ball with LAG CLAIMING:
    after each extraction, ±``claim_lags`` samples around the extracted
    position's per-pair lag are nulled on every pair before the next full
    two-stage search.  With few pairs, the mixed hyperbola intersections
    (pair p voting source 1's lag, pair q source 2's) form combinatorial
    ghosts that no position-ball around peak 1 can remove — on a 4-mic
    tetra with two 20 dB talkers the spatial mode misses one source in
    ~17% of scenes (the ghost outbids it) while claiming recovers both in
    96-100% at 3-9x lower mean error, and it never measured worse (8-mic
    cube identical, reverberant 6% -> 19% both-found — A/B 2026-08-20,
    tests/test_srp.py pins a ghost-prone scene).  Cost: K full searches
    instead of one coarse + K refines — prefer it whenever pair count is
    small or accuracy beats throughput.

    No reference counterpart (the reference is strictly single-source);
    sources must be mutually low-correlated (e.g. independent talkers) for
    their SRP peaks to separate.
    """
    if suppression not in ("spatial", "claim"):
        raise ValueError("suppression must be 'spatial' or 'claim'")
    pi_t = tuple(np.asarray(pairs_i, np.int32).tolist())
    pj_t = tuple(np.asarray(pairs_j, np.int32).tolist())
    ml = _resolve_max_lag(max_lag_samples, mic_positions, fs, c)
    w = _resolve_pool(pool_samples, lower, upper, coarse_n, fs, c)
    if suppression == "claim":
        return _srp_locate_multi_claim_jit(
            corr, mic_positions, c, lower, upper, pi=pi_t, pj=pj_t,
            fs=float(fs), num_sources=num_sources, coarse_n=coarse_n,
            fine_n=fine_n, w=w, ml=ml, claim_lags=float(claim_lags))
    return _srp_locate_multi_jit(
        corr, mic_positions, c, lower, upper, pi=pi_t, pj=pj_t,
        fs=float(fs), num_sources=num_sources, coarse_n=coarse_n,
        fine_n=fine_n, min_separation=min_separation, w=w, ml=ml)


@functools.partial(jax.jit, static_argnames=(
    "pi", "pj", "fs", "num_sources", "coarse_n", "fine_n", "min_separation",
    "w", "ml"))
def _srp_locate_multi_jit(corr, mic_positions, c, lower, upper, *, pi, pj,
                          fs, num_sources, coarse_n, fine_n, min_separation,
                          w, ml) -> MultiSrpResult:
    dtype = corr.dtype
    pi = np.asarray(pi, np.int32)
    pj = np.asarray(pj, np.int32)
    windowed = ml is not None and 2 * (ml + w) + 1 <= corr.shape[-1]
    if windowed:
        coarse_src, pw = _pooled_window(corr, ml, w), True
        corr = _center_window(corr, ml)
    else:
        coarse_src, pw = max_pool_corr(corr, w), False

    def coarse_fn(p):
        return srp_map(coarse_src, p, mic_positions, pi, pj, fs, c,
                       max_lag=ml, pre_windowed=pw)

    def fine_fn(p):
        return srp_map(corr, p, mic_positions, pi, pj, fs, c,
                       max_lag=ml, pre_windowed=pw)

    positions, fine_powers = suppressed_multi_search(
        coarse_fn, fine_fn, lower, upper, coarse_n, fine_n, num_sources,
        min_separation, dtype)
    return MultiSrpResult(positions, fine_powers)


@functools.partial(jax.jit, static_argnames=(
    "pi", "pj", "fs", "num_sources", "coarse_n", "fine_n", "w", "ml",
    "claim_lags"))
def _srp_locate_multi_claim_jit(corr, mic_positions, c, lower, upper, *,
                                pi, pj, fs, num_sources, coarse_n, fine_n,
                                w, ml, claim_lags) -> MultiSrpResult:
    """Sequential single-source searches with per-pair lag claiming between
    extractions (see ``srp_phat_locate_multi`` ``suppression='claim'``)."""
    dtype = corr.dtype
    nfft = corr.shape[-1]
    lag_np = np.arange(nfft)
    lag_np = np.where(lag_np <= nfft // 2, lag_np, lag_np - nfft)
    lag_axis = jnp.asarray(lag_np, dtype)
    pi_np = np.asarray(pi, np.int32)
    pj_np = np.asarray(pj, np.int32)
    mics = jnp.asarray(mic_positions, dtype)

    def pick(cur, _):
        res = _srp_locate_jit(cur, mic_positions, c, lower, upper, pi=pi,
                              pj=pj, fs=fs, coarse_n=coarse_n,
                              fine_n=fine_n, refine=True, w=w, ml=ml)
        d = jnp.linalg.norm(res.position[None, :] - mics, axis=-1)
        lag_p = (jnp.take(d, pi_np) - jnp.take(d, pj_np)) * fs / c
        diff = jnp.mod(lag_axis[None, :] - lag_p[:, None] + nfft / 2.0,
                       float(nfft)) - nfft / 2.0       # circular distance
        cur = cur * (jnp.abs(diff) > claim_lags).astype(dtype)
        return cur, (res.position, res.power)

    _, (positions, powers) = jax.lax.scan(pick, corr, None,
                                          length=num_sources)
    return MultiSrpResult(positions, powers)
