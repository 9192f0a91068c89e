"""Public API: the reference-compatible entry points.

``localize_sound_source(config, ...)`` and
``simulate_signals_with_multipath(...)`` preserve the reference's call
shapes and result dict (reference: main.py:66-333); ``run_calibration`` is
re-exported from models/calibration.  Host code here only orchestrates:
everything numeric runs inside one jitted estimation core per static
configuration — the reference's per-pair Python loops (main.py:202-228) and
per-guess solver restarts (main.py:261-274) are vmapped device axes.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .models import acoustics
from .models import beamformer as beam_ops
from .models import capon as capon_ops
from .models import music as music_ops
from .models import solver as solver_ops
from .models import srp as srp_ops
from .models import tdoa as tdoa_ops
from .models import uncertainty as uncertainty_ops
from .models.calibration import run_calibration  # re-export  # noqa: F401
from .models.simulator import simulate_signals, simulate_signals_fast
from .models.sync import synchronize_signals
from .ops import gccphat
from .ops import filters as filter_ops
from .ops.fftutils import fft_length
from .utils.audio_io import read_audio_files
from .utils.config import SceneConfig, LocalizationConfig
from .utils.devcache import dev_const
from .utils.materials import MaterialTable, default_table, material_properties
from .utils import plotting

logger = logging.getLogger(__name__)


# Warm single-scene latency: after the one-fetch readback work, the
# remaining eager device ops on the localize hot path are PRNGKey+split and
# the tiny constant uploads (mic positions, speed of sound, calibration
# vector) — each its own dispatch and host-to-device copy.  Both caches
# below return values IDENTICAL to what the uncached code built (jax arrays
# are immutable and split(PRNGKey(seed)) is deterministic), so seed-pinned
# results are bit-unchanged; they only skip re-uploading/re-deriving on
# repeat calls, the serving pattern the warm-latency metric measures.
_SEED_KEYS_CACHE: Dict[Any, Any] = {}


def _seed_keys(seed: int):
    """split(PRNGKey(seed), 3), memoized per (seed, backend)."""
    k = (int(seed), jax.default_backend())
    if k not in _SEED_KEYS_CACHE:
        if len(_SEED_KEYS_CACHE) >= 256:
            _SEED_KEYS_CACHE.clear()
        _SEED_KEYS_CACHE[k] = jax.random.split(
            jax.random.PRNGKey(int(seed)), 3)
    return _SEED_KEYS_CACHE[k]


_dev_const = dev_const  # shared content-keyed upload cache (utils/devcache)


def simulate_signals_with_multipath(source_pos,
                                    mic_positions,
                                    fs,
                                    c,
                                    duration: float = 1.0,
                                    signal_type: str = "sine",
                                    freq: float = 1000.0,
                                    reflective_planes=None,
                                    material_properties: Optional[Mapping] = None,
                                    max_reflections: int = 2,
                                    absorption_threshold: float = 0.01,
                                    trim_to_duration: bool = True,
                                    key: Optional[jax.Array] = None,
                                    dtype=None,
                                    absorption_mode: str = "carrier"
                                    ) -> List[np.ndarray]:
    """Reference-signature wrapper (main.py:66-79): returns a list of per-mic
    numpy arrays like the reference.

    ``absorption_mode='per-bin'`` (extension) evaluates the attenuation
    law's exp(-freq_coeff * f * d) term at every rfft bin instead of the
    single carrier ``freq`` — see models/simulator.simulate_signals."""
    table = MaterialTable.from_dict(material_properties) \
        if material_properties is not None else default_table()
    planes = reflective_planes or []
    coeffs = np.array([p["plane"] for p in planes], float).reshape(len(planes), 4) \
        if planes else np.zeros((0, 4))
    mat_ids = np.array([table.id_of(p.get("material", "air"), strict=True)
                        for p in planes], np.int32)
    if key is None:
        key = jax.random.PRNGKey(0)
    sigs = simulate_signals(
        source_pos, mic_positions, fs, c, duration, signal_type, freq,
        coeffs, mat_ids,
        jnp.asarray(table.absorption), jnp.asarray(table.freq),
        max_reflections, absorption_threshold, trim_to_duration, key=key,
        dtype=dtype, absorption_mode=absorption_mode)
    return [np.asarray(s) for s in sigs]


# ---------------------------------------------------------------------------
# Jitted estimation core
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("fs", "pairs_i", "pairs_j", "nfft", "filter_method",
                     "lag_mode", "max_expected_delay", "analyze",
                     "num_bootstrap", "bootstrap_mode",
                     "clustering_method", "eps",
                     "min_samples", "use_calibration", "phat_band",
                     "threshold_method", "solver", "pool", "max_lag",
                     "need_corr", "weighting"))
def _estimation_core(signals: jnp.ndarray,
                     mic_positions: jnp.ndarray,
                     c: jnp.ndarray,
                     calib_delays: jnp.ndarray,
                     key: jax.Array,
                     box_lo: Optional[jnp.ndarray] = None,
                     box_hi: Optional[jnp.ndarray] = None,
                     *,
                     fs: float,
                     pairs_i: Tuple[int, ...],
                     pairs_j: Tuple[int, ...],
                     nfft: int,
                     filter_method: str,
                     lag_mode: str,
                     max_expected_delay: Optional[float],
                     analyze: bool,
                     num_bootstrap: int,
                     bootstrap_mode: str,
                     clustering_method: str,
                     eps: float,
                     min_samples: int,
                     use_calibration: bool,
                     phat_band: Optional[Tuple[float, float]] = None,
                     threshold_method: str = "median",
                     solver: str = "lm",
                     pool: int = 2,
                     max_lag: Optional[int] = None,
                     need_corr: bool = True,
                     weighting: str = "phat"
                     ) -> Dict[str, jnp.ndarray]:
    """Filter -> all-pairs GCC-PHAT -> TDOA ladder -> (metrics) -> position
    solver, one XLA graph.  ``solver`` selects the back half: 'lm' is the
    reference chain (clustered init -> bounds -> weighted multi-start LM,
    main.py:261-274); 'srp'/'srp+lm' grid-search the steered-response PHAT
    power over [box_lo, box_hi]; 'beam'/'music'/'capon' are the narrowband
    spectral estimators (no usable correlation peaks — the GCC/TDOA front
    half only runs for them when the caller needs the metrics/plots,
    ``need_corr``)."""
    pi = np.asarray(pairs_i, np.int32)
    pj = np.asarray(pairs_j, np.int32)
    n = signals.shape[-1]
    num_mics = mic_positions.shape[0]

    with jax.named_scope("filter"):
        filtered = filter_ops.noise_reduction(signals, fs, method=filter_method)

    k_metrics, k_cluster = jax.random.split(key)
    if need_corr:
        with jax.named_scope("gccphat"):
            corr = gccphat.gcc_phat_all_pairs(filtered, pi, pj, nfft=nfft,
                                              band=phat_band, fs=fs,
                                              weighting=weighting)  # (P, nfft)
        with jax.named_scope("tdoa"):
            res = tdoa_ops.time_delays_from_corr(
                corr, n, n, fs, num_peaks=1, threshold_method=threshold_method,
                max_expected_delay=max_expected_delay, lag_mode=lag_mode)
        measured = res.delays[..., 0]                                 # (P,)
        # Physical convention: td = arrival_j - arrival_i = -(peak lag)/fs,
        # which is what the residual system (d_j - d_i) = c*td expects.
        td = -measured if lag_mode == "physical" else measured
        if use_calibration:
            td = td - (jnp.take(calib_delays, pj) - jnp.take(calib_delays, pi))

        peak_corr = jnp.max(corr, -1)                                 # (P,)
        corr_matrix = jnp.zeros((num_mics, num_mics), corr.dtype)
        corr_matrix = corr_matrix.at[pi, pj].set(peak_corr).at[pj, pi].set(
            peak_corr)
    else:
        # Narrowband solver with no metric/plot consumers: the correlation
        # front half is pure waste (tones have no usable GCC peaks) — td is
        # a zero diagnostic like the sweep's narrowband branches.
        corr = None
        measured = td = jnp.zeros(pi.shape[0], signals.dtype)
        corr_matrix = jnp.zeros((num_mics, num_mics), signals.dtype)

    if analyze:
        snr = tdoa_ops.correlation_snr(corr)                      # (P,)
        ppr = tdoa_ops.peak_to_peak_ratio(corr)
        # The null threshold must be calibrated at the SAME transform length
        # as the real correlation: the max-over-bins statistic of a whitened
        # null scales with the bin count, so resampling at a different nfft
        # biases 'significant' (in parity mode this is the exact
        # non-power-of-two length, matching the reference's own calibration).
        thresholds = jax.vmap(
            lambda s1, s2, k: tdoa_ops.bootstrap_significance(
                s1, s2, k, num_bootstrap=num_bootstrap, nfft=nfft,
                bootstrap_mode=bootstrap_mode)
        )(jnp.take(filtered, pi, 0), jnp.take(filtered, pj, 0),
          jax.random.split(k_metrics, pi.shape[0]))
        significant = (peak_corr > thresholds) & (snr > 2.0)
        weights = tdoa_ops.compute_weights(snr)
    else:
        snr = ppr = significant = None
        weights = jnp.ones(pi.shape[0], signals.dtype)

    nb_cov = None
    with jax.named_scope("solver"):
        if solver in ("lm", "lm-robust"):
            guesses, _ = solver_ops.heuristic_initial_guesses(
                mic_positions, pi, pj, td, c, k_cluster,
                clustering_method=clustering_method, eps=eps,
                min_samples=min_samples)
            lower, upper = solver_ops.dynamic_bounds(mic_positions, td, c)
            guesses = jnp.clip(guesses, lower[None, :], upper[None, :])
            solve = (solver_ops.multi_start_lm_robust
                     if solver == "lm-robust" else solver_ops.multi_start_lm)
            best = solve(
                guesses, mic_positions, pi, pj, td, c, weights, lower, upper)
            best_x, best_cost = best.x, best.cost
        elif solver in ("srp", "srp+lm"):
            srp = srp_ops.srp_phat_locate(
                corr, mic_positions, pi, pj, fs, c, box_lo, box_hi,
                pool_samples=pool, max_lag_samples=max_lag)
            best_x, best_cost = srp.position, -srp.power
            if solver == "srp+lm":
                # LM polish on the measured TDOAs, accepted only within one
                # coarse cell of the SRP optimum (mirrors parallel/sweep.py:
                # reflection-corrupted TDOAs can walk LM far off).
                b_lower, b_upper = solver_ops.dynamic_bounds(
                    mic_positions, td, c)
                lm = solver_ops.lm_solve(srp.position, mic_positions, pi, pj,
                                         td, c, weights, b_lower, b_upper)
                cell = jnp.linalg.norm((box_hi - box_lo) / _SRP_COARSE_N)
                near = jnp.linalg.norm(lm.x - srp.position) <= cell
                best_x = jnp.where(near, lm.x, srp.position)
                best_cost = jnp.where(near, lm.cost, -srp.power)
            lower, upper = box_lo, box_hi
            guesses = best_x[None, :]
        else:  # narrowband: beam / music / capon
            if solver == "beam":
                def nb_locate(sig, lo, hi):
                    return beam_ops.beamform_locate(
                        sig, mic_positions, fs, c, lo, hi,
                        band=phat_band, nfft=nfft)
            elif solver == "music":
                def nb_locate(sig, lo, hi):
                    return music_ops.music_locate(
                        sig, mic_positions, fs, c, lo, hi, band=phat_band)
            else:
                def nb_locate(sig, lo, hi):
                    return capon_ops.capon_locate(
                        sig, mic_positions, fs, c, lo, hi, band=phat_band)
            nb = nb_locate(filtered, box_lo, box_hi)
            best_x, best_cost = nb.position, -nb.power
            # Group-jackknife error bars (VERDICT r4 #6): the same
            # estimator re-localizes each quarter of the capture on a
            # small box around the fix; the group scatter / 4 estimates
            # Cov (models/uncertainty.group_jackknife_covariance).
            nb_cov = uncertainty_ops.group_jackknife_covariance(
                filtered, lambda s, lo, hi: nb_locate(s, lo, hi).position,
                best_x, 0.12 * (box_hi - box_lo), groups=_NB_GROUPS)
            # Fine-grid resolution floor: the two-stage search quantizes
            # to a fine cell of (hi-lo)/96 per axis (coarse_n=24,
            # fine_n=12) and the quadratic peak refinement leaves a
            # deterministic ~cell/4 interpolation bias that no resampling
            # can see (measured 2.9 mm vs the 3.6 mm floor on a 1.4 m
            # box, capon @ 1.1 kHz) — without it the reported sigma
            # understates the bias-limited high-SNR regime ~10x.
            floor = (box_hi - box_lo) * (1.0 / 384.0)
            nb_cov = nb_cov + jnp.diag(floor * floor)
            lower, upper = box_lo, box_hi
            guesses = best_x[None, :]

    out = {
        "estimated_position": best_x,
        "cost": best_cost,
        "tdoas": td,
        "measured_delays": measured,
        "correlation_matrix": corr_matrix,
        "corr": corr,
        "weights": weights,
        "lower": lower,
        "upper": upper,
        "initial_guesses": guesses,
    }
    if analyze:
        out.update({"snr": snr, "peak_to_peak_ratio": ppr,
                    "significant": significant})
    # Everything the host reads unconditionally, as ONE flat vector: each
    # device-to-host fetch synchronizes, so estimated/cost/tdoas/
    # corr-matrix (+ analyze metrics) come back in a single transfer.
    parts = [best_x, jnp.reshape(best_cost, (1,)), td, corr_matrix.ravel()]
    if analyze:
        parts += [snr, ppr, significant.astype(signals.dtype)]
    if nb_cov is not None:
        parts += [nb_cov.ravel()]   # trailing 9 floats, narrowband only
    out["host_pack"] = jnp.concatenate(
        [p.astype(signals.dtype) for p in parts])
    return out


# Time-chunk count for the narrowband group-jackknife error bars (each
# chunk re-localizes on a small box around the fix; see
# models/uncertainty.group_jackknife_covariance for the bias/variance
# trade).
_NB_GROUPS = 4


def _resolve_threshold(loc: LocalizationConfig) -> str:
    """None -> the mode's default statistic: the reference's 'median' in
    parity mode, the sweep's one-pass 'gaussian' estimate in physical mode
    (see LocalizationConfig.threshold_method)."""
    if loc.threshold_method is not None:
        return loc.threshold_method
    return "median" if loc.lag_mode == "reference" else "gaussian"


_SOLVERS = ("lm", "lm-robust", "srp", "srp+lm", "beam", "music", "capon")

_SRP_COARSE_N = 24  # stage-1 grid cells per axis (matches models/srp)


def _srp_grid_knobs(scene, loc, mic_positions, fs, c):
    """Host-side static knobs shared by the grid solvers: search box,
    max-pool width (0.866 = covering radius of a coarse cell in units of
    its edge, in samples of travel time), and the mic-diameter lag bound.
    One definition — the nfft alias-margin check and the estimation-core
    setup must stay in lockstep."""
    blo, bhi = _resolve_search_box(scene, loc)
    cell = float(np.max(np.asarray(bhi) - np.asarray(blo))) / _SRP_COARSE_N
    pool = max(1, int(np.ceil(0.866 * cell * fs / c)))
    mics_np = np.asarray(mic_positions, float)
    diam = float(np.max(np.linalg.norm(
        mics_np[:, None, :] - mics_np[None, :, :], axis=-1)))
    max_lag = int(np.ceil(diam * fs / c))
    return blo, bhi, pool, max_lag


def _resolve_search_box(scene: SceneConfig, loc: LocalizationConfig):
    """Host-side grid-search box for the srp/beam/music/capon solvers:
    the configured ``search_box`` verbatim, else the mic array's bounding
    box expanded by max(array diameter, 0.5 m) per side (covers sources in
    and around the array — distant sources need an explicit box; TDOA
    geometry barely constrains range out there anyway)."""
    if loc.search_box is not None:
        lo = np.asarray(loc.search_box[0], float)
        hi = np.asarray(loc.search_box[1], float)
        if lo.shape != (3,) or hi.shape != (3,) or np.any(hi <= lo):
            raise ValueError("search_box must be ((x0,y0,z0),(x1,y1,z1)) "
                             "with hi > lo per axis")
        return lo, hi
    mics = np.asarray(scene.mic_positions, float)
    lo, hi = mics.min(0), mics.max(0)
    margin = max(float(np.linalg.norm(hi - lo)), 0.5)
    return lo - margin, hi + margin


def _resolve_phat_band(loc: LocalizationConfig):
    """Band-limited PHAT whitening (SURVEY.md Q5 fix) in physical mode:
    'auto' follows the bandpass front-end's passband; None = reference
    behavior (whiten every bin)."""
    band = loc.phat_band
    if band == "auto":
        if loc.lag_mode == "physical" and loc.filter_method in ("butterworth",
                                                                "fir"):
            return (300.0, 3400.0)  # noise_reduction's default passband
        return None
    return tuple(band) if band is not None else None


def localize_sound_source(config,
                          calibration_data=None,
                          audio_files=None,
                          use_simulation: bool = True,
                          show_plots: bool = True,
                          key: Optional[jax.Array] = None,
                          dtype=None,
                          signals: Optional[Sequence] = None) -> Dict[str, Any]:
    """Full localization pipeline with the reference's public contract
    (main.py:126-333): same config keys, same result dict keys.

    Extensions: ``config['localization']['lag_mode']`` ('physical' default,
    'reference' for defect-exact parity), ``sync_mode`` ('reference'
    default, 'none' to skip the TDOA-cancelling pre-sync — SURVEY.md Q4),
    ``num_bootstrap``, an explicit PRNG ``key``, and ``signals`` to inject
    pre-recorded per-mic waveforms directly (bypasses simulation/file I/O).

    ``config['localization']['solver']`` (physical mode only) selects the
    position estimator: 'lm' (default, the reference's clustered multi-
    start LM), 'srp' / 'srp+lm' (SRP-PHAT grid search — robust where
    reverberation corrupts per-pair TDOAs), or 'beam' / 'music' / 'capon'
    (narrowband steered-power / subspace / MVDR — pure tones defeat the
    GCC chain).  Grid solvers search ``search_box`` (default: the mic
    bounding box expanded by max(array diameter, 0.5 m) per side).  The
    result dict keys are unchanged.

    ``config['localization']['gcc_weighting']`` (physical mode only)
    selects the GCC frequency weighting: 'phat' (default, the reference's
    estimator), 'scot' (per-channel gain/coloration invariant — mismatched
    mic responses), 'roth' (Wiener weighting), or 'cc' (unweighted — best
    at very low SNR).  See ops/gccphat.GCC_WEIGHTINGS.
    """
    scene = config if isinstance(config, SceneConfig) else SceneConfig.from_dict(config)
    loc = scene.localization
    if loc.solver not in _SOLVERS:
        raise ValueError(f"Unknown solver {loc.solver!r}; expected one of "
                         f"{_SOLVERS}")
    if loc.solver != "lm" and loc.lag_mode == "reference":
        raise ValueError(
            "solver overrides are physical-mode extensions; reference-parity "
            "mode (lag_mode='reference') keeps the reference's LM -> DE "
            "chain (main.py:261-298)")
    if loc.gcc_weighting not in ("phat", "scot", "roth", "cc"):
        raise ValueError(
            f"Unknown gcc_weighting {loc.gcc_weighting!r}; the batch API "
            "supports 'phat', 'scot', 'roth', 'cc' ('ml' needs Welch-"
            "averaged spectra — use ops.gccphat.gcc_phat_streaming)")
    if loc.gcc_weighting != "phat" and loc.lag_mode == "reference":
        raise ValueError(
            "gcc_weighting is a physical-mode extension; reference-parity "
            "mode keeps PHAT (utils.py:116)")
    fs = scene.fs
    mic_positions = scene.mic_positions
    num_mics = scene.num_mics
    if key is None:
        k_sim, k_core, k_de = _seed_keys(scene.seed)
    else:
        k_sim, k_core, k_de = jax.random.split(key, 3)

    # Calibration-delay vector extraction (main.py:147-157).
    calib_delays = None
    if calibration_data is not None:
        if len(calibration_data) != num_mics:
            logger.warning(
                "Number of calibration entries does not match the number of "
                "microphones. Ignoring calibration for this run.")
        else:
            try:
                calib_delays = np.array(
                    [d.get("delay", 0.0) for d in calibration_data], float)
                logger.info("Applying calibration correction.")
            except Exception as e:  # matches main.py:155-157
                logger.warning("Error processing calibration data: %s. "
                               "Ignoring calibration.", e)
                calib_delays = None
    # Physical-mode calibration sanity gate (SURVEY.md rebuild policy): a
    # noise-dominated calibration (Q2's underflowed attenuation makes the
    # recordings signal-free) yields random delays that blow the estimate up
    # to tens of meters (main.py:335-347's measured 63.1 m).  When every
    # entry carries the correlation-peak 'snr' that run_calibration /
    # analyze_calibration report, require a real matched-filter peak before
    # trusting the delays.  Parity mode applies calibration verbatim (Q3),
    # and entries WITHOUT 'snr' (external hardware calibrations) are
    # trusted as given.
    if (calib_delays is not None and loc.lag_mode == "physical"
            and all("snr" in d for d in calibration_data)):
        from .models.calibration import CALIBRATION_SNR_GATE
        worst = min(float(d["snr"]) for d in calibration_data)
        if worst < CALIBRATION_SNR_GATE:
            logger.warning(
                "Calibration correlation-peak SNR %.1f below the quality "
                "gate %.1f (noise-dominated recording); ignoring "
                "calibration in physical mode.", worst, CALIBRATION_SNR_GATE)
            calib_delays = None

    c = acoustics.speed_of_sound_host(scene.celsius, scene.humidity)
    logger.info("Computed speed of sound: %.2f m/s", c)

    if signals is not None:
        if len(signals) != num_mics:
            raise ValueError(
                "The number of injected signals must match the number of "
                "microphones.")
        signal_list = [jnp.asarray(s, dtype) if dtype else jnp.asarray(s)
                       for s in signals]
        logger.info("Using injected signals.")
    elif use_simulation:
        if scene.source_position is None:
            raise ValueError(
                "source_position must be provided when use_simulation=True.")
        if loc.lag_mode == "physical":
            # Physical mode renders at a static pow2 length from a host-side
            # delay budget: no per-call device sync for the data-dependent
            # max path delay (waveform difference vs the exact 2N transform
            # is ~1e-3 periodic-sinc tails).  Parity mode keeps the
            # reference's concrete padding rule below.
            sigs = simulate_signals_fast(
                scene.source_position, mic_positions, fs, c, scene.duration,
                scene.signal_type, scene.freq, scene.plane_coeffs,
                scene.plane_material_ids, scene.materials.absorption,
                scene.materials.freq, loc.max_reflections,
                loc.absorption_threshold, key=k_sim, dtype=dtype,
                absorption_mode=scene.absorption_mode)
        else:
            if scene.absorption_mode != "carrier":
                raise ValueError(
                    "absorption_mode is a physical-mode simulation "
                    "extension; reference-parity mode keeps the carrier-"
                    "frequency attenuation law (utils.py:50-65)")
            sigs = simulate_signals(
                scene.source_position, mic_positions, fs, c, scene.duration,
                scene.signal_type, scene.freq, scene.plane_coeffs,
                scene.plane_material_ids,
                jnp.asarray(scene.materials.absorption),
                jnp.asarray(scene.materials.freq),
                loc.max_reflections, loc.absorption_threshold,
                trim_to_duration=True, key=k_sim, dtype=dtype)
        # Keep the stacked (M, n) array: unstacking into a per-mic list and
        # restacking costs num_mics+1 eager device ops on the warm
        # single-scene path.  Only sync_mode='reference'
        # needs the list form.
        signal_list = None
        logger.info("Simulated signals generated.")
    else:
        if audio_files is None:
            raise ValueError(
                "Audio files must be provided when use_simulation=False.")
        if len(audio_files) != num_mics:
            raise ValueError(
                "The number of audio files must match the number of microphones.")
        signal_list = read_audio_files(audio_files, fs, dtype=dtype)
        logger.info("Real audio data loaded.")

    if signal_list is None and loc.sync_mode == "reference":
        signal_list = [sigs[i] for i in range(num_mics)]
    if loc.sync_mode == "reference":
        signal_list = synchronize_signals(signal_list, fs)
        logger.info("Signals synchronized.")
    if signal_list is None:
        signals = sigs  # simulated: already stacked, equal lengths
    else:
        # sync_mode='none' still needs equal lengths: trailing zero-pad like
        # the reference's pad-align (utils.py:448-456) without the shifting.
        max_len = max(int(s.shape[-1]) for s in signal_list)
        signal_list = [jnp.pad(s, (0, max_len - s.shape[-1]))
                       if s.shape[-1] < max_len else s for s in signal_list]
        signals = jnp.stack(signal_list)

    pairs = scene.mic_pairs
    pairs_i = tuple(p[0] for p in pairs)
    pairs_j = tuple(p[1] for p in pairs)
    n = signals.shape[-1]
    # Parity mode keeps the exact reference length (n1+n2-1).  Physical
    # mode uses the circular next_pow2(n) transform like the sweep path —
    # at half the FFT length — but ONLY when the peak-search window is
    # provably alias-free: circular bins beyond nfft-n carry
    # folded far-lag energy, so the consulted window (max_expected_delay
    # plus the TDOA fast path's dilation margin) must fit inside the
    # alias-free margin; otherwise (including max_expected_delay=None,
    # whose argmax consults every lag) fall back to the alias-free
    # next_pow2(2n-1).
    if loc.lag_mode == "reference":
        nfft = fft_length(n, n, "exact")
    else:
        nfft = fft_length(n, n, "circular")
        if loc.max_expected_delay is None:
            nfft = fft_length(n, n, "pow2")
        else:
            dilation = 8 * max(int(fs * 0.001), 1)
            needed = int(np.ceil(loc.max_expected_delay * fs)) + dilation + 1
            if loc.solver in ("srp", "srp+lm"):
                # SRP consults lags up to the mic-diameter bound plus the
                # max-pool width — that window must be alias-free too.
                _, _, srp_pool, srp_lag = _srp_grid_knobs(
                    scene, loc, mic_positions, fs, c)
                needed = max(needed, srp_lag + srp_pool + 3)
            if nfft - n < needed:
                nfft = fft_length(n, n, "pow2")

    calib_arr = _dev_const(calib_delays if calib_delays is not None
                           else np.zeros(num_mics), signals.dtype)
    box_lo = box_hi = None
    pool, max_lag = 2, None
    need_corr = True
    if loc.solver not in ("lm", "lm-robust"):
        # Static SRP knobs resolved on the host (inside jit the bounds
        # are tracers — see models/srp._resolve_pool's fallback).
        blo, bhi, pool, max_lag = _srp_grid_knobs(
            scene, loc, mic_positions, fs, c)
        box_lo = _dev_const(blo, signals.dtype)
        box_hi = _dev_const(bhi, signals.dtype)
        if loc.solver in ("beam", "music", "capon"):
            need_corr = (loc.analyze_correlation
                         or loc.visualize_correlation)
    core = _estimation_core(
        signals, _dev_const(mic_positions, signals.dtype),
        _dev_const(c, signals.dtype), calib_arr,
        k_core, box_lo, box_hi,
        fs=fs, pairs_i=pairs_i, pairs_j=pairs_j, nfft=nfft,
        filter_method=loc.filter_method, lag_mode=loc.lag_mode,
        max_expected_delay=loc.max_expected_delay,
        analyze=loc.analyze_correlation, num_bootstrap=loc.num_bootstrap,
        bootstrap_mode=loc.bootstrap_mode,
        clustering_method=loc.clustering_method, eps=loc.clustering_eps,
        min_samples=loc.clustering_min_samples,
        use_calibration=calib_delays is not None,
        phat_band=_resolve_phat_band(loc),
        threshold_method=_resolve_threshold(loc),
        solver=loc.solver, pool=pool, max_lag=max_lag,
        need_corr=need_corr, weighting=loc.gcc_weighting)

    # Single host round trip for every unconditionally-read output.
    num_pairs = len(pairs)
    pk = np.asarray(core["host_pack"], np.float64)
    estimated = pk[:3]
    cost = float(pk[3])
    td_np = pk[4:4 + num_pairs]
    corr_matrix = pk[4 + num_pairs:4 + num_pairs + num_mics * num_mics
                     ].reshape(num_mics, num_mics)
    off = 4 + num_pairs + num_mics * num_mics
    for (i, j), td in zip(pairs, td_np):
        logger.info("Time difference for mic pair %d-%d: %.6f s", i + 1, j + 1, td)
        logger.info("Distance difference for mic pair %d-%d: %.3f m",
                    i + 1, j + 1, c * td)

    # DE fallback mirrors main.py:276-298: only when LM produced no usable
    # solution (grid solvers return finite steered powers by construction,
    # and their zero-TDOA diagnostics would make the DE objective
    # meaningless anyway).
    if not np.isfinite(cost) and loc.solver in ("lm", "lm-robust"):
        logger.warning("Least-squares failed, trying differential evolution.")
        pi = np.asarray(pairs_i, np.int32)
        pj = np.asarray(pairs_j, np.int32)
        weights = core["weights"]

        def objective(x):
            r = solver_ops.tdoa_residuals(
                x, jnp.asarray(mic_positions, signals.dtype), pi, pj,
                jnp.asarray(td_np, signals.dtype), c, weights)
            return jnp.sum(r * r)

        lower, upper = core["lower"], core["upper"]

        def polish(x):
            # scipy differential_evolution(polish=True) refines with
            # L-BFGS-B (main.py:281-292); same algorithm here.
            res = solver_ops.lbfgsb_minimize(objective, x, lower, upper)
            return res.x, res.fun

        # Parity mode matches the reference's scipy defaults (main.py:281-292:
        # tol=0.01); physical mode keeps the tighter 1e-6 convergence.
        de = solver_ops.differential_evolution(
            objective, lower, upper, k_de, polish_fn=polish,
            tol=0.01 if loc.lag_mode == "reference" else 1e-6)
        fallback_used = True
        if np.isfinite(float(de.energy)):
            estimated = np.asarray(de.x)
            logger.info("Estimated source (differential evolution): %s", estimated)
        else:
            logger.error("Differential evolution failed. Falling back to the "
                         "first initial guess.")
            estimated = np.asarray(core["initial_guesses"])[0]
    else:
        fallback_used = False
        logger.info("Estimated source: (%.3f, %.3f, %.3f) m", *estimated)

    # Rebuild extension: position uncertainty (models/uncertainty.py — the
    # reference's least_squares solve, main.py:261-274, discards all
    # curvature).  TDOA solvers: Gauss-Markov from the fix geometry,
    # host-side NumPy on already-fetched values (no extra device
    # round trips).  Narrowband solvers: group-jackknife over time chunks,
    # computed in-graph (their corr/tdoa outputs are zero-filled
    # diagnostics, not the measurements the fix came from).
    uncertainty = None
    if loc.solver in ("beam", "music", "capon"):
        # Narrowband solvers: group-jackknife covariance computed in-graph
        # (trailing 9 floats of the host pack, models/uncertainty.
        # group_jackknife_covariance) — no TDOA residuals exist for the
        # Gauss-Markov path, and peak curvature measures beamwidth, not
        # error.
        nb_off = off + (3 * num_pairs if loc.analyze_correlation else 0)
        uncertainty = uncertainty_ops.summary_from_covariance(
            pk[nb_off:nb_off + 9].reshape(3, 3), dof=_NB_GROUPS - 1)
        uncertainty["heuristic"] = False
        logger.info("Position 1-sigma (x,y,z): (%.4f, %.4f, %.4f) m "
                    "(group jackknife)", *uncertainty["std"])
    if loc.solver in ("lm", "lm-robust", "srp", "srp+lm"):
        w_np = (uncertainty_ops.weights_from_snr(pk[off:off + num_pairs])
                if loc.analyze_correlation else None)
        uncertainty = uncertainty_ops.position_uncertainty(
            estimated, mic_positions, pairs_i, pairs_j, td_np, c,
            weights=w_np)
        if uncertainty is not None:
            # The Gauss-Markov expansion assumes ``estimated`` is a
            # stationary point of the weighted TDOA least-squares cost.
            # Flag the fixes that are not: pure-grid SRP cells, an
            # srp+lm whose LM polish was rejected (cost stayed at the
            # negative -srp.power sentinel), and the DE/first-guess
            # fallbacks — there the reported sigma is an approximation.
            uncertainty["heuristic"] = bool(
                loc.solver == "srp"
                or (loc.solver == "srp+lm" and cost < 0.0)
                or fallback_used)
            logger.info("Position 1-sigma (x,y,z): (%.4f, %.4f, %.4f) m",
                        *uncertainty["std"])

    correlation_metrics = None
    if loc.analyze_correlation:
        snr_np = pk[off:off + num_pairs]
        ppr_np = pk[off + num_pairs:off + 2 * num_pairs]
        sig_np = pk[off + 2 * num_pairs:off + 3 * num_pairs]
        correlation_metrics = {
            (i, j): {
                "peak_to_peak_ratio": float(ppr_np[k]),
                "snr": float(snr_np[k]),
                "significant": bool(sig_np[k] > 0.5),
            }
            for k, (i, j) in enumerate(pairs)
        }
        for pair, metrics in correlation_metrics.items():
            logger.info("Cross-correlation metrics for mic pair %d-%d: %s",
                        pair[0] + 1, pair[1] + 1, metrics)

    # The reference plots the 3-D scatter on every simulated run
    # (main.py:300-315, blocking plt.show()), so parity mode always emits
    # localization_result.png — even headless.  Physical mode skips the
    # silent savefig unless visualization is configured on: it costs ~0.2 s
    # of host time per call, dominating the warm single-scene latency.
    if use_simulation and (show_plots or loc.visualize_correlation
                           or loc.lag_mode == "reference"):
        plotting.plot_localization_3d(mic_positions, scene.source_position,
                                      estimated, show_plot=show_plots)
    if loc.visualize_correlation:
        plotting.plot_correlation_heatmap(
            corr_matrix, mic_positions, show_plot=show_plots,
            save_path="heatmap.png")
        plotting.plot_correlation_3d(
            [np.asarray(c_) for c_ in core["corr"]], list(pairs), fs,
            show_plot=show_plots, save_path="correlation_3d.png")

    return {
        "estimated_position": estimated,
        "actual_position": scene.source_position if use_simulation else None,
        "mic_positions": mic_positions,
        "correlation_metrics": correlation_metrics,
        "correlation_matrix": corr_matrix if loc.visualize_correlation else None,
        "calibration_data": calibration_data,
        # Rebuild extensions (not in the reference dict):
        "tdoas": td_np,
        "cost": cost,
        "uncertainty": uncertainty,
    }
