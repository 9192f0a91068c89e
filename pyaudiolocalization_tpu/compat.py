"""Drop-in compatibility layer: every reference function under its original
name and call signature.

A PyAudioLocalization user imports from ``main``, ``utils``,
``signal_processing``, ``calibration``, ``materials`` and ``plotting``; this
module collapses all of those surfaces into one:

    from pyaudiolocalization_tpu import compat as utils
    delays, corr, lags = utils.get_time_delays_phat(s1, s2, fs)

Inputs/outputs are NumPy (converted at the boundary); the math runs on the
jitted device ops.  Functions default to reference-exact semantics including
the documented defects (SURVEY.md Q1-Q5) — e.g. ``get_time_delays_phat``
uses the reference's scipy-'full' lag mapping.  The reference never seeds
its global NumPy RNG; stochastic functions here take their randomness from a
module key that ``seed()`` resets (deterministic by default).

Reference citations are per function; signatures mirror the reference's
exactly (extra keyword-only arguments are rebuild extensions).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .api import localize_sound_source, simulate_signals_with_multipath  # noqa: F401
from .models import acoustics as _ac
from .models import calibration as _cal
from .models import cluster as _cluster
from .models import solver as _solver
from .models import sync as _sync
from .models import tdoa as _tdoa
from .ops import delay as _delay
from .ops import filters as _filters
from .ops import gccphat as _gcc
from .ops import resample as _resample
from .ops import signal as _sig
from .utils.audio_io import read_audio_files as _read_audio_files
from .utils.materials import MaterialTable, material_properties  # noqa: F401
from .utils.plotting import (  # noqa: F401
    plot_correlation_heatmap, plot_correlation_3d, plot_calibration_results)
from .models.calibration import run_calibration  # noqa: F401

logger = logging.getLogger(__name__)

_key = jax.random.PRNGKey(0)


def seed(n: int) -> None:
    """Reset the module PRNG (the reference relies on NumPy's unseeded
    global RNG; here randomness is explicit and deterministic)."""
    global _key
    _key = jax.random.PRNGKey(n)


def _next_key() -> jax.Array:
    global _key
    _key, sub = jax.random.split(_key)
    return sub


# ---------------------------------------------------------------------------
# utils.py counterparts
# ---------------------------------------------------------------------------

def speed_of_sound(temperature: float, humidity: float,
                   pressure: float = 101.325) -> float:
    """utils.py:15-27."""
    return float(_ac.speed_of_sound(temperature, humidity, pressure))


def reflect_point_across_plane(point, plane) -> np.ndarray:
    """utils.py:29-42 (raises on a degenerate plane, like the reference)."""
    plane = np.asarray(plane, float)
    if np.allclose(plane[:3], 0.0):
        raise ValueError("Invalid plane: normal vector cannot be zero.")
    return np.asarray(_ac.reflect_point_across_plane(
        jnp.asarray(np.asarray(point, float)), jnp.asarray(plane)))


def distance(point1, point2) -> float:
    """utils.py:44-48."""
    return float(_ac.distance(jnp.asarray(np.asarray(point1, float)),
                              jnp.asarray(np.asarray(point2, float))))


def calculate_attenuation(distance_val: float, material: str,
                          frequency: float,
                          material_properties: Dict[str, Any]) -> float:
    """utils.py:50-65 (unknown material warns and falls back to 'air')."""
    table = MaterialTable.from_dict(material_properties)
    if material not in table.ids:
        logger.warning("Material '%s' not defined; falling back to 'air'.",
                       material)
    mid = table.id_of(material, strict=False)
    return float(_ac.calculate_attenuation(
        jnp.asarray(float(distance_val)), mid, float(frequency),
        jnp.asarray(table.absorption), jnp.asarray(table.freq)))


def generate_image_sources_iterative(source, planes, max_order: int,
                                     frequency: float,
                                     material_properties: Dict[str, Any],
                                     mic_positions,
                                     absorption_threshold: float = 0.01,
                                     round_decimals: int = 6
                                     ) -> List[Dict[str, Any]]:
    """utils.py:67-106: returns [{'source': xyz, 'material': name}, ...] in
    the reference's BFS order (rejected nodes omitted)."""
    table = MaterialTable.from_dict(material_properties)
    coeffs = np.array([p["plane"] for p in planes], float).reshape(
        len(planes), 4) if planes else np.zeros((0, 4))
    mat_ids = np.array([table.id_of(p.get("material", "air"), strict=True)
                        for p in planes], np.int32)
    img = _ac.image_sources(
        jnp.asarray(np.asarray(source, float)), jnp.asarray(coeffs),
        jnp.asarray(mat_ids), jnp.asarray(np.asarray(mic_positions, float)),
        float(frequency), jnp.asarray(table.absorption),
        jnp.asarray(table.freq), int(max_order),
        float(absorption_threshold), round_decimals)
    positions = np.asarray(img.positions)
    accepted = np.asarray(img.accepted)
    ids = np.asarray(img.material_ids)
    return [{"source": positions[i], "material": table.names[ids[i]]}
            for i in range(positions.shape[0]) if accepted[i]]


def phat_correlation(sig1, sig2) -> np.ndarray:
    """utils.py:108-119: circular-order whitened correlation at n1+n2-1."""
    return np.asarray(_gcc.phat_correlation(jnp.asarray(np.asarray(sig1)),
                                            jnp.asarray(np.asarray(sig2))))


def get_time_delays_phat(sig1, sig2, fs: float, num_peaks: int = 1,
                         threshold_method: str = "median",
                         threshold_multiplier: float = 1.0,
                         max_expected_delay: Optional[float] = None,
                         *, lag_mode: str = "reference"
                         ) -> Tuple[List[float], np.ndarray, np.ndarray]:
    """utils.py:121-181: (delays, corr, time_lags).  lag_mode='reference'
    reproduces defect Q1 exactly; pass 'physical' for correct lags."""
    res = _tdoa.get_time_delays_phat(
        jnp.asarray(np.asarray(sig1)), jnp.asarray(np.asarray(sig2)), fs,
        num_peaks=num_peaks, threshold_method=threshold_method,
        threshold_multiplier=threshold_multiplier,
        max_expected_delay=max_expected_delay, lag_mode=lag_mode)
    delays = [float(d) for d, v in
              zip(np.asarray(res.delays), np.asarray(res.valid)) if v]
    return delays, np.asarray(res.corr), np.asarray(res.time_lags)


def bootstrap_significance(sig1, sig2, fs: float, num_bootstrap: int = 1000,
                           alpha: float = 0.05,
                           bootstrap_mode: str = "permutation",
                           block_size: int = 50) -> float:
    """utils.py:183-216 (randomness from the module key; see seed())."""
    return float(_tdoa.bootstrap_significance(
        jnp.asarray(np.asarray(sig1)), jnp.asarray(np.asarray(sig2)),
        _next_key(), num_bootstrap=num_bootstrap, alpha=alpha,
        bootstrap_mode=bootstrap_mode, block_size=block_size))


def perform_significance_test_bootstrap(sig1, sig2, fs: float,
                                        alpha: float = 0.05
                                        ) -> Tuple[float, bool]:
    """utils.py:218-226: (peak, significant-vs-bootstrap-threshold)."""
    corr = _gcc.phat_correlation(jnp.asarray(np.asarray(sig1)),
                                 jnp.asarray(np.asarray(sig2)))
    peak = float(jnp.max(corr))
    thr = bootstrap_significance(sig1, sig2, fs, alpha=alpha)
    return peak, bool(peak > thr)


def compute_peak_to_peak_ratio(corr) -> float:
    """utils.py:228-236."""
    return float(_tdoa.peak_to_peak_ratio(jnp.asarray(np.asarray(corr))))


def compute_snr(corr) -> float:
    """utils.py:238-250."""
    return float(_tdoa.correlation_snr(jnp.asarray(np.asarray(corr))))


def perform_significance_test(corr, sig1, sig2, fs: float,
                              alpha: float = 0.05,
                              snr_threshold: float = 2.0
                              ) -> Tuple[float, bool]:
    """utils.py:252-259: (snr, significant)."""
    snr, significant = _tdoa.significance_test(
        jnp.asarray(np.asarray(corr)), jnp.asarray(np.asarray(sig1)),
        jnp.asarray(np.asarray(sig2)), _next_key(), alpha=alpha,
        snr_threshold=snr_threshold)
    return float(snr), bool(significant)


def compute_cross_correlation_metrics(corr, sig1, sig2, fs: float,
                                      alpha: float = 0.05) -> Dict[str, Any]:
    """utils.py:261-271."""
    out = _tdoa.cross_correlation_metrics(
        jnp.asarray(np.asarray(corr)), jnp.asarray(np.asarray(sig1)),
        jnp.asarray(np.asarray(sig2)), _next_key(), alpha=alpha)
    return {"peak_to_peak_ratio": float(out["peak_to_peak_ratio"]),
            "snr": float(out["snr"]),
            "significant": bool(out["significant"])}


def determine_optimal_number_of_clusters(data, max_clusters: int = 5,
                                         method: str = "kmeans",
                                         eps: float = 0.001,
                                         min_samples: int = 2) -> int:
    """utils.py:273-302."""
    pts = np.asarray(data, float).reshape(-1, np.asarray(data).shape[-1]) \
        if len(data) else np.zeros((0, 3))
    if pts.shape[0] < 2:
        return 1
    valid = jnp.ones(pts.shape[0], bool)
    return int(_solver.optimal_cluster_count(
        jnp.asarray(pts), valid, _next_key(), max_clusters=max_clusters,
        method=method, eps=eps, min_samples=min_samples))


def heuristic_initialization_adaptive(mic_positions, mic_pairs, tdoas,
                                      c: float,
                                      clustering_method: str = "kmeans",
                                      eps: float = 0.001,
                                      min_samples: int = 2
                                      ) -> List[List[float]]:
    """utils.py:304-362: clustered initial guesses + the mic centroid."""
    pi = np.asarray([p[0] for p in mic_pairs], np.int32)
    pj = np.asarray([p[1] for p in mic_pairs], np.int32)
    guesses, valid = _solver.heuristic_initial_guesses(
        jnp.asarray(np.asarray(mic_positions, float)), pi, pj,
        jnp.asarray(np.asarray(tdoas, float)), float(c), _next_key(),
        clustering_method=clustering_method, eps=eps,
        min_samples=min_samples)
    g = np.asarray(guesses)
    v = np.asarray(valid)
    return [g[i].tolist() for i in range(g.shape[0]) if v[i]]


def dynamic_bounds_extended(mic_positions, tdoas, c: float,
                            buffer: float = 5.0) -> List[Tuple[float, float]]:
    """utils.py:364-382: per-axis (lower, upper) list."""
    lower, upper = _solver.dynamic_bounds(
        jnp.asarray(np.asarray(mic_positions, float)),
        jnp.asarray(np.asarray(tdoas, float)), float(c), buffer=buffer)
    return list(zip(np.asarray(lower).tolist(), np.asarray(upper).tolist()))


def equations(vars, mic_positions, mic_pairs, tdoas, c: float,
              weights=None) -> List[float]:
    """utils.py:384-405: weighted TDOA residual system."""
    if weights is not None and len(weights) != len(mic_pairs):
        raise ValueError(
            "Length of weights must match the number of microphone pairs.")
    pi = np.asarray([p[0] for p in mic_pairs], np.int32)
    pj = np.asarray([p[1] for p in mic_pairs], np.int32)
    w = jnp.asarray(np.asarray(weights, float)) if weights is not None \
        else jnp.ones(len(mic_pairs))
    r = _solver.tdoa_residuals(
        jnp.asarray(np.asarray(vars, float)),
        jnp.asarray(np.asarray(mic_positions, float)), pi, pj,
        jnp.asarray(np.asarray(tdoas, float)), float(c), w)
    return np.asarray(r).tolist()


def synchronize_signals_improved(signals, fs: float,
                                 use_interpolation: bool = True
                                 ) -> List[np.ndarray]:
    """utils.py:407-457."""
    return [np.asarray(s) for s in
            _sync.synchronize_signals(signals, fs, use_interpolation)]


def read_audio_files(audio_files: List[str],
                     expected_fs: float) -> List[np.ndarray]:
    """utils.py:459-482."""
    return [np.asarray(s) for s in _read_audio_files(audio_files, expected_fs)]


def compute_weights(correlation_metrics, mic_pairs) -> np.ndarray:
    """utils.py:484-497: per-pair SNR weight (1.0 if missing), normalized by
    the mean."""
    weights = []
    for pair in mic_pairs:
        metrics = correlation_metrics.get(pair, None) \
            if correlation_metrics else None
        weights.append(metrics.get("snr", 1.0) if metrics is not None else 1.0)
    return np.asarray(_tdoa.compute_weights(jnp.asarray(weights, jnp.float64
                                                        if jax.config.jax_enable_x64
                                                        else jnp.float32)))


# ---------------------------------------------------------------------------
# signal_processing.py counterparts
# ---------------------------------------------------------------------------

def generate_pink_noise(fs: float, duration: float) -> np.ndarray:
    """signal_processing.py:11-23."""
    return np.asarray(_sig.pink_noise(_next_key(), fs, int(fs * duration)))


def generate_signal(signal_type: str, fs: float, duration: float,
                    freq: float) -> np.ndarray:
    """signal_processing.py:25-36."""
    return np.asarray(_sig.generate_signal(signal_type, fs, duration, freq,
                                           key=_next_key()))


def generate_realistic_speech(fs: float, duration: float) -> np.ndarray:
    """signal_processing.py:38-64."""
    return np.asarray(_sig.realistic_speech(_next_key(), fs,
                                            int(fs * duration), duration))


def fractional_delay(signal, delay: float, fs: float) -> np.ndarray:
    """signal_processing.py:66-80."""
    return np.asarray(_delay.fractional_delay(
        jnp.asarray(np.asarray(signal)), delay, fs))


def normalize_signal(signal) -> np.ndarray:
    """signal_processing.py:82-86."""
    return np.asarray(_sig.normalize_signal(jnp.asarray(np.asarray(signal))))


def dynamic_range_compression(signal, threshold: float = 0.8,
                              epsilon: float = 1e-8) -> np.ndarray:
    """signal_processing.py:88-94."""
    return np.asarray(_sig.dynamic_range_compression(
        jnp.asarray(np.asarray(signal)), threshold, epsilon))


def dynamic_range_compression_soft_clip(signal,
                                        threshold: float = 0.8) -> np.ndarray:
    """signal_processing.py:96-103 (dead code in the reference)."""
    return np.asarray(_sig.dynamic_range_compression_soft_clip(
        jnp.asarray(np.asarray(signal)), threshold))


def resample_audio(data, original_fs: float, target_fs: float) -> np.ndarray:
    """signal_processing.py:105-107 (resampy kaiser_best construction)."""
    return np.asarray(_resample.resample(jnp.asarray(np.asarray(data)),
                                         original_fs, target_fs))


def noise_reduction(signal, fs: float, method: str = "butterworth",
                    lowcut: float = 300, highcut: float = 3400,
                    filter_order: int = 101) -> np.ndarray:
    """signal_processing.py:109-138."""
    return np.asarray(_filters.noise_reduction(
        jnp.asarray(np.asarray(signal)), fs, method=method, lowcut=lowcut,
        highcut=highcut, filter_order=filter_order))


# ---------------------------------------------------------------------------
# calibration.py counterparts (also re-exported above)
# ---------------------------------------------------------------------------

def generate_calibration_signal(fs, duration: float = 1.0,
                                signal_type: str = "chirp",
                                freq_start: float = 500,
                                freq_end: float = 5000) -> np.ndarray:
    """calibration.py:10-21."""
    return np.asarray(_cal.generate_calibration_signal(
        fs, duration, signal_type, freq_start, freq_end))


def analyze_calibration(recorded_signals, calib_signal,
                        fs) -> List[Dict[str, float]]:
    """calibration.py:42-51: [{'delay': s, 'amplitude': a}, ...]."""
    rec = jnp.stack([jnp.asarray(np.asarray(r)) for r in recorded_signals])
    out = _cal.analyze_calibration(rec, jnp.asarray(np.asarray(calib_signal)),
                                   fs)
    return [{"delay": float(d), "amplitude": float(a)}
            for d, a in zip(np.asarray(out.delays), np.asarray(out.amplitudes))]


def simulate_calibration_recording(calib_signal, mic_positions,
                                   source_position, fs, c,
                                   attenuation_factor: float = 1.0,
                                   noise_level: float = 0.01,
                                   freq=None, material_properties=None
                                   ) -> List[np.ndarray]:
    """calibration.py:23-40 (freq defaults to 1000 Hz like the reference)."""
    if material_properties is not None:
        table = MaterialTable.from_dict(material_properties)
        absorption = jnp.asarray(table.absorption)
        ftab = jnp.asarray(table.freq)
    else:
        absorption = ftab = None
    rec = _cal.simulate_calibration_recording(
        jnp.asarray(np.asarray(calib_signal)),
        jnp.asarray(np.asarray(mic_positions, float)),
        jnp.asarray(np.asarray(source_position, float)), fs, c, _next_key(),
        attenuation_factor=attenuation_factor, noise_level=noise_level,
        freq=1000.0 if freq is None else float(freq),
        absorption_table=absorption, freq_table=ftab)
    return [np.asarray(rec[i]) for i in range(rec.shape[0])]
