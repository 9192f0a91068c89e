"""Monte-Carlo scene sweeps: thousands of simulate->localize pipelines as
one XLA graph, sharded over a device mesh.

This subsystem has no counterpart in the reference — it is the rebuild's
data-parallel axis (SURVEY.md §2.4 item 6, §5.8): the reference is a serial
single-scene script (main.py:335-347), so scaling it means batching *scenes*
(randomized source positions, mic-geometry jitter, materials, SNR) with
``vmap`` and sharding the scene axis over ``jax.sharding.Mesh`` devices with
``jax.shard_map``.  The only collectives are metric reductions (``psum`` for
RMSE/hit-rate) — there is no parameter state to synchronize in this
workload, so the only traffic is scalar all-reduces over the scene axis.

Key entry points:
  * ``SweepSpec`` — static (hashable) scene-distribution description.
  * ``run_scene`` — ONE fully-jitted simulate+estimate+solve pipeline
    (the "forward step" of the flagship model).
  * ``localize_batch`` — estimation-only batch over given signals (the
    GCC-PHAT -> TDOA -> solver back half), used by bench.py.
  * ``monte_carlo_sweep`` — the sharded sweep: scenes split over the mesh,
    per-scene results gathered, summary statistics psum-reduced.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import acoustics
from ..models import beamformer as beam_ops
from ..models import capon as capon_ops
from ..models import music as music_ops
from ..models import solver as solver_ops
from ..models import srp as srp_ops
from ..models import tdoa as tdoa_ops
from ..models import uncertainty as uncertainty_ops
from ..models.simulator import scene_paths, render_scene
from ..ops import gccphat
from ..ops import filters as filter_ops
from ..ops import signal as sig_ops
from ..ops.fftutils import fft_length

SCENE_AXIS = "scenes"


def make_mesh(num_devices: Optional[int] = None,
              axis_name: str = SCENE_AXIS) -> Mesh:
    """1-D device mesh over the scene (data-parallel) axis."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (axis_name,))


def _pairs(num_mics: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """All i<j mic pairs in the reference's loop order (main.py:202-203)."""
    pi, pj = [], []
    for i in range(num_mics):
        for j in range(i + 1, num_mics):
            pi.append(i)
            pj.append(j)
    return tuple(pi), tuple(pj)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Static description of a randomized-scene distribution.

    Everything here determines shapes or is baked into the jitted graph, so
    the dataclass is hashable and usable as a jit-static argument.  Arrays
    (mic layout, planes) are stored as nested tuples for hashability.
    """

    fs: float = 44100.0
    duration: float = 1.0
    signal_type: str = "sine"
    freq: float = 1000.0
    mic_positions: tuple = (
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    # Planes as ((a, b, c, d), ...) + per-plane material ids; empty = free field.
    plane_coeffs: tuple = ()
    plane_material_ids: tuple = ()
    # Material tables (absorption, freq coefficient) indexed by material id.
    # Defaults are per-meter-sane values (SURVEY.md Q2 rebuild policy), not
    # the reference's underflowing Hz-scaled ones.
    material_absorption: tuple = (0.01, 0.05, 0.1)
    material_freq: tuple = (1e-5, 5e-5, 3e-5)
    max_reflections: int = 0
    absorption_threshold: float = 0.01
    # Scene randomization: source uniform in [box_lo, box_hi]^3, Gaussian mic
    # jitter, measurement noise at an SNR (dB) drawn uniformly per scene.
    source_box_lo: tuple = (0.0, 0.0, 0.0)
    source_box_hi: tuple = (1.0, 1.0, 1.0)
    mic_jitter: float = 0.0
    snr_db: Tuple[float, float] = (20.0, 40.0)
    # Estimation knobs.  solver: 'lm' (clustered multi-start
    # Levenberg-Marquardt on the measured TDOAs, the reference's approach),
    # 'lm-robust' (same chain with leave-k-out least-median-of-squares
    # consensus + Huber refit — rescues scenes where reflections corrupt
    # individual pair TDOAs: 84% -> 97% hit on the 10 dB reverberant eval
    # regime; see models/solver.multi_start_lm_robust),
    # 'srp' (initialization-free SRP-PHAT grid search over the source box),
    # 'srp+lm' (SRP fix polished by LM, gated to the SRP cell), 'de'
    # (on-device differential evolution over the TDOA objective —
    # BASELINE config 4; population = de_popsize * 3), 'beam'
    # (narrowband steered-power beamforming, models/beamformer.py — the
    # estimator that localizes pure tones, which defeat every
    # correlation-based TDOA chain; needs adequate spatial sampling), or
    # 'music' (subspace localization, models/music.py — same narrowband
    # regime as 'beam' with super-resolution of closely spaced sources;
    # also valid for multi-source sweeps), or 'capon' (MVDR adaptive scan,
    # models/capon.py — nulls loud interferers; multi-source capable, no
    # source-count dependence in the map itself).
    solver: str = "lm"
    de_popsize: int = 15
    de_maxiter: int = 200
    # Multi-source mode (no reference counterpart — the reference is strictly
    # single-source, main.py:126-333): simulate num_sources simultaneous
    # incoherent sources per scene and localize all of them with iterative-
    # suppression SRP-PHAT (models/srp.srp_phat_locate_multi).  Requires
    # solver='srp' and an incoherent signal type ('noise'/'speech', or
    # per-source frequencies via source_freqs).  SceneResult fields gain a
    # leading source axis: estimate/source (K, 3), error/cost (K,), matched
    # to ground truth by best assignment over the K! permutations.
    num_sources: int = 1
    # Minimum pairwise source spacing enforced at scene sampling (0 = none);
    # also shrinks the SRP suppression radius so close pairs stay separable.
    source_min_separation: float = 0.0
    # Optional per-source frequency override for deterministic signal types
    # (two same-frequency sines are fully coherent and cannot be separated).
    source_freqs: Optional[tuple] = None
    # Multi-source extraction mode: 'spatial' suppression ball, or 'claim'
    # (per-pair lag claiming between extractions — prefer on sparse arrays,
    # see models/srp.srp_phat_locate_multi).
    suppression: str = "spatial"
    filter_method: str = "butterworth"
    lowcut: float = 300.0
    highcut: float = 3400.0
    # 'circular' = next_pow2(n) circular correlation: half the FFT size of
    # 'pow2' (= next_pow2(2n-1)); aliasing only raises the far-lag noise
    # floor, which the physical lag window never looks at. ~1.4x faster.
    nfft_mode: str = "circular"
    # Peak-threshold statistic for the TDOA stage: 'gaussian' estimates the
    # reference's median-|corr| threshold from mean |corr| in one reduction
    # pass (see models/tdoa.py — exact 'median'/'adaptive' also accepted).
    threshold_method: str = "gaussian"
    # GCC frequency weighting for the correlation-based solvers
    # (ops/gccphat.GCC_WEIGHTINGS minus 'ml' — single-snapshot scenes have
    # degenerate coherence).
    gcc_weighting: str = "phat"
    temperature: float = 20.0
    humidity: float = 50.0
    # Extra seconds of propagation headroom baked into the render length; must
    # cover the longest accepted path delay or that path aliases circularly.
    delay_budget_s: Optional[float] = None

    # ----- derived static shapes -----
    @property
    def num_mics(self) -> int:
        return len(self.mic_positions)

    @property
    def num_samples(self) -> int:
        return int(self.fs * self.duration)

    @property
    def pairs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        return _pairs(self.num_mics)

    @property
    def nfft(self) -> int:
        return fft_length(self.num_samples, self.num_samples, self.nfft_mode)

    @property
    def speed_of_sound(self) -> float:
        # Host-side numpy version of acoustics.speed_of_sound (it stages jnp
        # constants to tracers when evaluated under an active jit trace).
        t = 20.0 if not (-50 <= self.temperature <= 50) else self.temperature
        h = 50.0 if not (0 <= self.humidity <= 100) else self.humidity
        return 331.0 + 0.6 * t + 0.0124 * h

    @property
    def max_tdoa(self) -> float:
        """Physical bound on any pairwise TDOA: array diameter over c, with
        jitter headroom.  Used as the peak-search lag window, which both
        rejects spurious far-lag peaks and lets the TDOA stage run its
        static-window fast path (models/tdoa.py)."""
        mics = np.asarray(self.mic_positions, float)
        diam = float(np.max(np.linalg.norm(
            mics[:, None, :] - mics[None, :, :], axis=-1)))
        diam += 6.0 * self.mic_jitter
        return 1.25 * diam / self.speed_of_sound

    @property
    def delay_budget(self) -> float:
        """Conservative static bound on the longest path delay (s)."""
        if self.delay_budget_s is not None:
            return self.delay_budget_s
        mics = np.asarray(self.mic_positions, float)
        lo = np.minimum(np.asarray(self.source_box_lo, float), mics.min(0))
        hi = np.maximum(np.asarray(self.source_box_hi, float), mics.max(0))
        diam = float(np.linalg.norm(hi - lo)) + 6.0 * self.mic_jitter
        # Scene extremes: the lo/hi bounding-box corners (cover mics and the
        # whole source box) — plane distance is measured from the SCENE, not
        # the origin, so origin-offset scenes with near-origin planes still
        # get a big-enough render budget (no circular aliasing).
        corners = np.array([[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
                            [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
                            [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
                            [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]]])
        reach = 0.0
        for coeffs in self.plane_coeffs:
            n = np.asarray(coeffs[:3], float)
            nn = max(float(np.linalg.norm(n)), 1e-9)
            dist = float(np.max(np.abs(corners @ n + float(coeffs[3])))) / nn
            reach = max(reach, 2.0 * dist + 2.0 * diam)
        # Each reflection order can at most add one "reach" leg.
        return (diam + self.max_reflections * reach) / 300.0 + 1.0 / self.fs

    @property
    def total_samples(self) -> int:
        return self.num_samples + int(np.ceil(self.delay_budget * self.fs))


class SceneResult(NamedTuple):
    """Per-scene result.  With ``SweepSpec.num_sources > 1`` every field but
    ``tdoas``/``covariance`` gains a source axis K before its trailing dims
    (estimates assignment-matched to ground truth; cost = -SRP power).

    ``covariance`` is the residual-estimated Gauss-Markov position
    covariance at the fix (models/uncertainty.position_covariance) for the
    single-source TDOA solvers ('lm'/'lm-robust'/'de'/'srp'/'srp+lm');
    all-NaN for the narrowband solvers (no per-pair TDOAs) and for
    multi-source sweeps.  Same caveat as the public API's heuristic flag:
    a pure-grid 'srp' cell (or a rejected 'srp+lm' polish) is not a
    stationary point of the TDOA least-squares cost, so its covariance is
    an approximation.  No null-space analysis here — a degenerate array
    spec yields inf/NaN entries (use position_uncertainty host-side for
    the unobservable-axes report)."""
    estimate: jnp.ndarray   # (..., 3) / (..., K, 3)
    source: jnp.ndarray     # (..., 3) / (..., K, 3) ground truth
    error: jnp.ndarray      # (...,) / (..., K) Euclidean error in meters
    cost: jnp.ndarray       # (...,) / (..., K) final solver cost
    tdoas: jnp.ndarray      # (..., P)
    covariance: jnp.ndarray  # (..., 3, 3) position covariance (m^2)


class SweepSummary(NamedTuple):
    rmse: jnp.ndarray        # scalar
    mean_error: jnp.ndarray  # scalar
    hit_rate: jnp.ndarray    # fraction of scenes with error < hit_threshold
    results: SceneResult     # per-scene


# ---------------------------------------------------------------------------
# Estimation back half (signals -> position), batched
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _permutations(k: int) -> np.ndarray:
    """All K! assignment permutations (static; K is capped at 6)."""
    return np.array(list(itertools.permutations(range(k))), np.int32)


def _check_spec(spec: SweepSpec) -> None:
    if spec.num_sources < 1:
        raise ValueError("num_sources must be >= 1")
    if spec.gcc_weighting not in ("phat", "scot", "roth", "cc"):
        raise ValueError(
            f"unknown gcc_weighting {spec.gcc_weighting!r}; sweeps support "
            "'phat', 'scot', 'roth', 'cc' ('ml' needs Welch-averaged "
            "spectra — single-snapshot scene coherence is degenerate)")
    if spec.suppression not in ("spatial", "claim"):
        raise ValueError("suppression must be 'spatial' or 'claim'")
    if spec.num_sources > 1:
        if spec.solver not in ("srp", "music", "capon"):
            raise ValueError(
                "multi-source sweeps (num_sources > 1) require solver='srp', "
                "'music', or 'capon': per-pair TDOA solvers assume a single "
                "dominant source")
        if spec.num_sources > 6:
            raise ValueError(
                "num_sources > 6 not supported (K! assignment matching)")
        if (spec.source_freqs is not None
                and len(spec.source_freqs) != spec.num_sources):
            raise ValueError("source_freqs must have num_sources entries")
        if spec.signal_type == "sine" and spec.source_freqs is None:
            raise ValueError(
                "multi-source 'sine' scenes need distinct source_freqs: "
                "same-frequency sines are fully coherent and cannot be "
                "separated (SRP-PHAT or MUSIC)")


def _srp_box(spec: SweepSpec):
    """Static SRP search box: the source prior expanded 20% (matches the
    single-source 'srp' solver branch)."""
    blo = np.asarray(spec.source_box_lo, float)
    bhi = np.asarray(spec.source_box_hi, float)
    margin = 0.2 * (bhi - blo) + 1e-3
    return blo - margin, bhi + margin


def _estimate_multi(spec: SweepSpec, signals: jnp.ndarray, mics: jnp.ndarray,
                    c) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Multi-source estimation: filter -> all-pairs GCC-PHAT -> iterative-
    suppression SRP over the (expanded) source box.  Returns
    (positions (K, 3), powers (K,), diagnostic argmax TDOAs (P,))."""
    pi = np.asarray(spec.pairs[0], np.int32)
    pj = np.asarray(spec.pairs[1], np.int32)
    filtered, band = _prefilter(spec, signals)
    if spec.solver in ("music", "capon"):
        # Snapshot-covariance multi-source extraction: no correlation stage
        # at all (TDOA diagnostics are zeros, like the single-source
        # 'beam'/'music'/'capon' branches — narrowband sources have no
        # usable correlation peaks).
        blo, bhi = _srp_box(spec)
        sep = (0.8 * spec.source_min_separation
               if spec.source_min_separation > 0 else None)
        locate = (music_ops.music_locate_multi if spec.solver == "music"
                  else capon_ops.capon_locate_multi)
        out = locate(
            filtered, mics, spec.fs, c,
            jnp.asarray(blo, signals.dtype), jnp.asarray(bhi, signals.dtype),
            num_sources=spec.num_sources, band=band, min_separation=sep)
        td = jnp.zeros(pi.shape[0], signals.dtype)
        return out.positions, -out.powers, td
    corr = gccphat.gcc_phat_all_pairs(filtered, pi, pj, nfft=spec.nfft,
                                      band=band, fs=spec.fs,
                                      weighting=spec.gcc_weighting)
    # Diagnostic per-pair argmax TDOA (dominated by the strongest source):
    # physical decode of the circular peak index, td = -lag/fs as in
    # models/tdoa.time_delays_from_corr.
    n = corr.shape[-1]
    am = jnp.argmax(corr, -1)
    lag = jnp.where(am >= n // 2, am - n, am).astype(signals.dtype)
    td = -lag / spec.fs

    blo, bhi = _srp_box(spec)
    coarse_n = 24
    pool = srp_ops._resolve_pool(None, blo, bhi, coarse_n, spec.fs,
                                 spec.speed_of_sound)
    sep = (0.8 * spec.source_min_separation
           if spec.source_min_separation > 0 else None)
    out = srp_ops.srp_phat_locate_multi(
        corr, mics, pi, pj, spec.fs, c,
        jnp.asarray(blo, signals.dtype), jnp.asarray(bhi, signals.dtype),
        num_sources=spec.num_sources, coarse_n=coarse_n,
        min_separation=sep, pool_samples=pool,
        max_lag_samples=int(np.ceil(spec.max_tdoa * spec.fs)),
        suppression=spec.suppression)
    # Negated SRP power, matching the single-source 'srp' branch's cost
    # convention (lower = better) across both localize_batch shapes.
    return out.positions, -out.powers, td


def _prefilter(spec: SweepSpec, signals: jnp.ndarray):
    """(filtered_signals, whitening_band) for the GCC front-end.

    Band-limit the whitening for bandpass front-ends: plain PHAT over a
    bandpassed pair plants a spurious lag-0 peak (reference defect Q5).
    When band-limited whitening is active, the time-domain bandpass itself
    is redundant and SKIPPED: applying the same LTI filter to both channels
    multiplies the cross-spectrum by |H(f)|^2, which cancels exactly in the
    PHAT normalization R/|R| at every bin where H is nonzero, and the band
    mask zeroes the rest.  Correlations agree to ~1% (filtfilt's odd-
    extension edge transients are not exactly circular |H|^2) with identical
    peak structure, minus the entire filtfilt cost (~30% of the estimation
    path at 44.1 kHz).  Wiener is nonlinear, so it really runs."""
    if spec.filter_method in ("butterworth", "fir"):
        return signals, (spec.lowcut, spec.highcut)
    return filter_ops.noise_reduction(signals, spec.fs,
                                      method=spec.filter_method,
                                      lowcut=spec.lowcut,
                                      highcut=spec.highcut), None


def _estimate(spec: SweepSpec, signals: jnp.ndarray, mics: jnp.ndarray,
              c, key: jax.Array) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Filter -> all-pairs GCC-PHAT -> physical-lag TDOA -> clustered init ->
    bounded multi-start LM.  One scene; vmap for batches."""
    if spec.num_sources > 1:
        return _estimate_multi(spec, signals, mics, c)
    pi = np.asarray(spec.pairs[0], np.int32)
    pj = np.asarray(spec.pairs[1], np.int32)
    if spec.solver == "beam":
        # Steered-power beamforming consumes spectra — no correlation,
        # no TDOAs (returned as zeros: the narrowband sources this solver
        # exists for have no well-defined correlation peaks).  LTI
        # front-ends (butterworth/fir) become the band mask below;
        # nonlinear ones (wiener) really run via _prefilter — steered
        # power, unlike PHAT, does not cancel |H|^2, but a bandpass is
        # monotone per-bin scaling inside the band, which the band mask
        # already expresses.
        blo, bhi = _srp_box(spec)
        beam_sigs, band = _prefilter(spec, signals)
        out = beam_ops.beamform_locate(
            beam_sigs, mics, spec.fs, c,
            jnp.asarray(blo, signals.dtype), jnp.asarray(bhi, signals.dtype),
            band=band, nfft=spec.nfft)
        td = jnp.zeros(pi.shape[0], signals.dtype)
        return out.position, -out.power, td
    if spec.solver in ("music", "capon"):
        # Snapshot-covariance estimators: same narrowband regime and
        # front-end treatment as 'beam' (band mask instead of redundant LTI
        # filter; wiener really runs).  'music' projects onto the noise
        # subspace (super-resolution where the Bartlett beamwidth merges
        # sources); 'capon' scans the MVDR spectrum (nulls loud
        # interferers, no source-count dependence).
        blo, bhi = _srp_box(spec)
        m_sigs, band = _prefilter(spec, signals)
        locate = (music_ops.music_locate if spec.solver == "music"
                  else capon_ops.capon_locate)
        out = locate(
            m_sigs, mics, spec.fs, c,
            jnp.asarray(blo, signals.dtype), jnp.asarray(bhi, signals.dtype),
            band=band)
        td = jnp.zeros(pi.shape[0], signals.dtype)
        return out.position, -out.power, td
    filtered, band = _prefilter(spec, signals)

    corr = gccphat.gcc_phat_all_pairs(filtered, pi, pj, nfft=spec.nfft,
                                      band=band, fs=spec.fs,
                                      weighting=spec.gcc_weighting)
    res = tdoa_ops.time_delays_from_corr(
        corr, spec.num_samples, spec.num_samples, spec.fs, num_peaks=1,
        threshold_method=spec.threshold_method,
        max_expected_delay=spec.max_tdoa, lag_mode="physical")
    # physical peak lag -> td = arrival_j - arrival_i (models/tdoa.py).
    td = -res.delays[..., 0]
    weights = jnp.ones(pi.shape[0], signals.dtype)

    if spec.solver in ("srp", "srp+lm"):
        # Search box: the scene's source prior, expanded 20% (static).
        blo, bhi = _srp_box(spec)
        coarse_n = 24
        pool = srp_ops._resolve_pool(None, blo, bhi,
                                     coarse_n, spec.fs, spec.speed_of_sound)
        srp = srp_ops.srp_phat_locate(
            corr, mics, pi, pj, spec.fs, c,
            jnp.asarray(blo, signals.dtype),
            jnp.asarray(bhi, signals.dtype), coarse_n=coarse_n,
            pool_samples=pool,
            max_lag_samples=int(np.ceil(spec.max_tdoa * spec.fs)))
        if spec.solver == "srp":
            return srp.position, -srp.power, td
        # 'srp+lm': polish the SRP fix with LM on the measured TDOAs, but
        # only accept the polish if it stays within one coarse cell — in
        # reverberant scenes the TDOAs themselves can be wrong (reflection
        # peaks), and an unconstrained LM walks far from the SRP optimum.
        lower, upper = solver_ops.dynamic_bounds(mics, td, c)
        lm = solver_ops.lm_solve(srp.position, mics, pi, pj, td, c, weights,
                                 lower, upper)
        cell = float(np.linalg.norm((bhi - blo) / coarse_n))  # box pre-expanded
        near = jnp.linalg.norm(lm.x - srp.position) <= cell
        return (jnp.where(near, lm.x, srp.position),
                jnp.where(near, lm.cost, -srp.power), td)

    x, cost = _solve_from_td(spec, mics, pi, pj, td, c, weights, key)
    return x, cost, td


def _solve_from_td(spec: SweepSpec, mics, pi, pj, td, c, weights,
                   key: jax.Array) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solver back half for the 'lm'/'de' solvers: clustered init + bounded
    multi-start LM, or on-device DE seeded with the heuristic guesses."""
    if spec.solver == "de":
        k_guess, k_de = jax.random.split(key)
        lower, upper = solver_ops.dynamic_bounds(mics, td, c)
        guesses, _ = solver_ops.heuristic_initial_guesses(
            mics, pi, pj, td, c, k_guess)

        def objective(x):
            r = solver_ops.tdoa_residuals(x, mics, pi, pj, td, c, weights)
            return jnp.sum(r * r)

        de = solver_ops.differential_evolution(
            objective, lower, upper, k_de, popsize=spec.de_popsize,
            maxiter=spec.de_maxiter, init=guesses,
            # scipy's polish=True semantics (main.py:281-292): L-BFGS-B
            polish_fn=lambda x: (lambda r: (r.x, r.fun))(
                solver_ops.lbfgsb_minimize(objective, x, lower, upper)))
        return de.x, de.energy

    guesses, _ = solver_ops.heuristic_initial_guesses(
        mics, pi, pj, td, c, key)
    lower, upper = solver_ops.dynamic_bounds(mics, td, c)
    guesses = jnp.clip(guesses, lower[None, :], upper[None, :])
    if spec.solver == "lm-robust":
        best = solver_ops.multi_start_lm_robust(
            guesses, mics, pi, pj, td, c, weights, lower, upper)
    else:
        best = solver_ops.multi_start_lm(
            guesses, mics, pi, pj, td, c, weights, lower, upper)
    return best.x, best.cost


@functools.partial(jax.jit, static_argnames=("spec",))
def localize_batch(spec: SweepSpec, signals: jnp.ndarray, mics: jnp.ndarray,
                   key: jax.Array) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Estimation-only batch: signals (B, M, N), shared mic geometry.
    Returns (estimates (B, 3), costs (B,), tdoas (B, P)); with
    ``spec.num_sources > 1`` estimates are (B, K, 3) and costs (B, K)
    NEGATED fine-stage SRP powers (lower = better, matching every other
    solver's cost convention), in coarse extraction order (no ground truth
    to match against here)."""
    _check_spec(spec)
    c = jnp.asarray(spec.speed_of_sound, signals.dtype)
    keys = jax.random.split(key, signals.shape[0])
    return jax.vmap(lambda s, k: _estimate(spec, s, mics, c, k))(signals, keys)


# ---------------------------------------------------------------------------
# Full scene pipeline (randomize -> simulate -> estimate)
# ---------------------------------------------------------------------------

def _draw_sources(spec: SweepSpec, key: jax.Array, dtype) -> jnp.ndarray:
    """(K, 3) source positions uniform in the box; K > 1 with a separation
    constraint places sources greedily, each from 16 static candidates (first
    one far enough from everything already placed; candidate 0 if none is —
    a documented soft constraint, not rejection sampling)."""
    k = spec.num_sources
    lo = jnp.asarray(spec.source_box_lo, dtype)
    hi = jnp.asarray(spec.source_box_hi, dtype)
    if k == 1:
        # Keep the exact single-source draw (bit-identical checkpoint resume).
        return jax.random.uniform(key, (3,), dtype, lo, hi)[None, :]
    cands = jax.random.uniform(key, (k, 16, 3), dtype, lo, hi)
    sep = spec.source_min_separation
    if sep <= 0:
        return cands[:, 0]

    def place(carry, ck):
        placed, idx = carry
        prev = jnp.arange(k) < idx                                  # (K,)
        d = jnp.linalg.norm(ck[:, None, :] - placed[None, :, :],
                            axis=-1)                                 # (16, K)
        ok = jnp.all(jnp.where(prev[None, :], d >= sep, True), -1)  # (16,)
        pick = jnp.argmax(ok)  # first valid candidate; 0 when none valid
        return (placed.at[idx].set(ck[pick]), idx + 1), None

    (placed, _), _ = jax.lax.scan(
        place, (jnp.zeros((k, 3), dtype), jnp.int32(0)), cands)
    return placed


def _random_scene(spec: SweepSpec, key: jax.Array, dtype):
    k_src, k_mic, k_snr = jax.random.split(key, 3)
    sources = _draw_sources(spec, k_src, dtype)                 # (K, 3)
    mics = jnp.asarray(spec.mic_positions, dtype)
    if spec.mic_jitter > 0:
        mics = mics + spec.mic_jitter * jax.random.normal(k_mic, mics.shape, dtype)
    snr_db = jax.random.uniform(k_snr, (), dtype, spec.snr_db[0], spec.snr_db[1])
    return sources, mics, snr_db


def _source_paths(spec: SweepSpec, source, mics, c, freq, dtype):
    """Delay/gain matrix for one source's direct + image paths."""
    absorption = jnp.asarray(spec.material_absorption, dtype)
    freq_tab = jnp.asarray(spec.material_freq, dtype)
    if len(spec.plane_coeffs) and spec.max_reflections > 0:
        coeffs = jnp.asarray(spec.plane_coeffs, dtype)
        mat_ids = jnp.asarray(spec.plane_material_ids, jnp.int32)
        images = acoustics.image_sources(
            source, coeffs, mat_ids, mics, freq, absorption, freq_tab,
            spec.max_reflections, spec.absorption_threshold)
    else:
        images = acoustics.ImageSources(
            jnp.zeros((0, 3), dtype), jnp.zeros((0,), jnp.int32),
            jnp.zeros((0,), bool), jnp.zeros((0,), jnp.int32))
    return scene_paths(source, mics, c, freq, images, absorption, freq_tab)


def _render_source(spec: SweepSpec, source, mics, c, freq, key: jax.Array,
                   dtype, finalize: bool, snr_db=None,
                   noise_key=None) -> jnp.ndarray:
    """One source's static-shape multipath render (raw when finalize=False;
    measurement noise fused in when snr_db/noise_key are given)."""
    base = sig_ops.generate_signal(spec.signal_type, spec.fs, spec.duration,
                                   freq, key=key, dtype=dtype)
    paths = _source_paths(spec, source, mics, c, freq, dtype)
    return render_scene(base, paths.delays, paths.gains, spec.fs,
                        spec.total_samples, spec.num_samples, pad_mode="pow2",
                        finalize=finalize, snr_db=snr_db,
                        noise_key=noise_key)


def _source_freq(spec: SweepSpec, k: int) -> float:
    return spec.source_freqs[k] if spec.source_freqs is not None else spec.freq


def _simulate(spec: SweepSpec, sources, mics, c, snr_db, key: jax.Array,
              dtype) -> jnp.ndarray:
    """Static-shape multipath render + measurement noise at the drawn SNR.
    ``sources`` is (K, 3); K > 1 sums the raw per-source renders (each with
    an independent signal key) before the per-mic normalize+compress."""
    # Additive white measurement noise at the per-scene SNR is part of both
    # branches (new capability — the reference simulates noiselessly
    # outside calibration); the single-source branch adds it inside
    # render_scene (snr_db/noise_key).
    if spec.num_sources == 1:
        k_sig, k_noise = jax.random.split(key)
        return _render_source(spec, sources[0], mics, c, _source_freq(spec, 0),
                              k_sig, dtype, finalize=True, snr_db=snr_db,
                              noise_key=k_noise)
    keys = jax.random.split(key, spec.num_sources + 1)
    k_noise = keys[-1]
    raw = _render_source(spec, sources[0], mics, c, _source_freq(spec, 0),
                         keys[0], dtype, finalize=False)
    for k in range(1, spec.num_sources):
        raw = raw + _render_source(spec, sources[k], mics, c,
                                   _source_freq(spec, k), keys[k], dtype,
                                   finalize=False)
    sigs = sig_ops.dynamic_range_compression(sig_ops.normalize_signal(raw))
    rms = jnp.sqrt(jnp.mean(sigs * sigs, -1, keepdims=True))
    sigma = rms * 10.0 ** (-snr_db / 20.0)
    noise = jax.random.normal(k_noise, sigs.shape, dtype)
    return sigs + sigma * noise


def run_scene(spec: SweepSpec, key: jax.Array, dtype=jnp.float32) -> SceneResult:
    """ONE randomized simulate->localize pipeline; fully jittable, vmappable
    over keys.  This is the flagship forward step.

    With ``spec.num_sources > 1`` the result fields carry a leading source
    axis (estimate/source (K, 3), error/cost (K,)); estimates are reordered
    to the ground-truth sources by the best (min mean-error) assignment over
    all K! permutations, and ``cost`` holds the negated fine-stage SRP power
    of each matched estimate."""
    _check_spec(spec)
    k_scene, k_sim, k_est = jax.random.split(key, 3)
    c = jnp.asarray(spec.speed_of_sound, dtype)
    with jax.named_scope("scene_sample"):
        sources, mics, snr_db = _random_scene(spec, k_scene, dtype)
    with jax.named_scope("simulate"):
        signals = _simulate(spec, sources, mics, c, snr_db, k_sim, dtype)
    with jax.named_scope("estimate"):
        estimate, cost, td = _estimate(spec, signals, mics, c, k_est)
    if spec.num_sources == 1:
        source = sources[0]
        error = jnp.linalg.norm(estimate - source)
        if spec.solver in ("lm", "lm-robust", "de", "srp", "srp+lm"):
            cov = uncertainty_ops.position_covariance(
                estimate, mics, np.asarray(spec.pairs[0], np.int32),
                np.asarray(spec.pairs[1], np.int32), td, c)
        else:
            cov = jnp.full((3, 3), jnp.nan, dtype)
        return SceneResult(estimate, source, error, cost, td, cov)
    perms = jnp.asarray(_permutations(spec.num_sources))           # (K!, K)
    d = jnp.linalg.norm(estimate[perms] - sources[None, :, :],
                        axis=-1)                                    # (K!, K)
    best = jnp.argmin(jnp.mean(d, -1))
    order = perms[best]
    return SceneResult(estimate[order], sources, d[best], cost[order], td,
                       jnp.full((3, 3), jnp.nan, dtype))


def _summary(results: SceneResult, hit_threshold: float,
             axis_name: Optional[str] = None) -> SweepSummary:
    err = results.error
    sq = jnp.mean(err * err)
    mean = jnp.mean(err)
    hits = jnp.mean((err < hit_threshold).astype(err.dtype))
    if axis_name is not None:
        sq = jax.lax.pmean(sq, axis_name)
        mean = jax.lax.pmean(mean, axis_name)
        hits = jax.lax.pmean(hits, axis_name)
    return SweepSummary(jnp.sqrt(sq), mean, hits, results)


@functools.partial(jax.jit,
                   static_argnames=("spec", "num_scenes", "hit_threshold",
                                    "dtype"))
def _sweep_single(spec: SweepSpec, key: jax.Array, num_scenes: int,
                  hit_threshold: float, dtype) -> SweepSummary:
    keys = jax.random.split(key, num_scenes)
    results = jax.vmap(lambda k: run_scene(spec, k, dtype))(keys)
    return _summary(results, hit_threshold)


def monte_carlo_sweep(spec: SweepSpec,
                      key: jax.Array,
                      num_scenes: int,
                      mesh: Optional[Mesh] = None,
                      hit_threshold: float = 0.1,
                      dtype=jnp.float32) -> SweepSummary:
    """Run ``num_scenes`` randomized scenes; with a mesh, the scene axis is
    sharded across its devices via ``jax.shard_map`` and summary statistics
    are psum-reduced over the mesh.  Per-scene results come back sharded
    over the mesh (one gather at host access time, not inside the step)."""
    if mesh is None:
        return _sweep_single(spec, key, num_scenes, hit_threshold, dtype)

    (axis_name,) = mesh.axis_names
    n_dev = mesh.devices.size
    if num_scenes % n_dev != 0:
        raise ValueError(
            f"num_scenes={num_scenes} must be divisible by the mesh size {n_dev}")
    keys = jax.random.split(key, num_scenes)

    def shard_fn(local_keys):
        results = jax.vmap(lambda k: run_scene(spec, k, dtype))(local_keys)
        return _summary(results, hit_threshold, axis_name=axis_name)

    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=P(axis_name),
        out_specs=SweepSummary(P(), P(), P(), SceneResult(
            P(axis_name), P(axis_name), P(axis_name), P(axis_name),
            P(axis_name), P(axis_name))),
        # Scan carries inside the solver start replicated and become
        # device-varying; skip the static varying-axis check.
        check_vma=False)
    sharding = NamedSharding(mesh, P(axis_name))
    if any(d.process_index != jax.process_index()
           for d in mesh.devices.flat):
        # Multi-host mesh (parallel/multihost.py): every process holds the
        # same replicated host-side key array; materialize only the
        # addressable shards here — XLA's collectives handle the rest.
        keys_np = np.asarray(keys)
        keys = jax.make_array_from_callback(
            keys.shape, sharding, lambda idx: keys_np[idx])
    else:
        keys = jax.device_put(keys, sharding)
    return jax.jit(sharded)(keys)
