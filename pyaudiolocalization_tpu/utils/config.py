"""Typed configuration for the localization stack.

The reference configures everything through one nested Python dict literal
(reference: main.py:26-64) whose keys are read ad hoc with ``.get`` defaults
(main.py:136-145, calibration.py:85-98).  We preserve that dict as the public
API (``localize_sound_source(config_dict)`` still works) but normalize it into
frozen dataclasses so that:

  * static fields (shapes: mic count, sample counts, reflection order, filter
    choice, clustering method) are hashable jit-static arguments;
  * array-valued fields (positions, plane coefficients, material ids) are
    packed into dense ndarrays ready to ship to device;
  * every scene carries an explicit PRNG seed (the reference uses the global
    NumPy RNG with no seeding anywhere — SURVEY.md §4.5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .materials import MaterialTable, default_table


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Mirrors the reference's config['calibration'] (main.py:46-52)."""

    signal_type: str = "chirp"
    freq_start: float = 500.0
    freq_end: float = 5000.0
    attenuation_factor: float = 1.0
    noise_level: float = 0.01

    @staticmethod
    def from_dict(d: Mapping[str, Any] | None) -> "CalibrationConfig":
        d = d or {}
        return CalibrationConfig(
            signal_type=d.get("signal_type", "chirp"),
            freq_start=float(d.get("freq_start", 500)),
            freq_end=float(d.get("freq_end", 5000)),
            attenuation_factor=float(d.get("attenuation_factor", 1.0)),
            noise_level=float(d.get("noise_level", 0.01)),
        )


@dataclasses.dataclass(frozen=True)
class LocalizationConfig:
    """Mirrors config['localization'] (main.py:53-63), defaults matching
    localize_sound_source's .get defaults (main.py:137-145)."""

    max_reflections: int = 2
    filter_method: str = "butterworth"
    absorption_threshold: float = 0.01
    analyze_correlation: bool = False
    visualize_correlation: bool = False
    clustering_method: str = "kmeans"
    clustering_eps: float = 0.001
    clustering_min_samples: int = 2
    max_expected_delay: Optional[float] = None
    # --- Rebuild extensions (SURVEY.md appendix, rebuild policy) ---
    # 'physical' interprets GCC-PHAT lags circularly (correct physics);
    # 'reference' reproduces the scipy-'full' index mapping defect Q1 exactly.
    lag_mode: str = "physical"
    # The reference pre-aligns signals before TDOA estimation, cancelling the
    # very delays being measured (Q4).  'none' skips it (default for physics),
    # 'reference' reproduces it.
    sync_mode: str = "reference"
    # Bootstrap resamples for the significance test (reference hardcodes 1000,
    # utils.py:186).
    num_bootstrap: int = 1000
    # Null-threshold resampling scheme (reference: per-draw sample
    # permutation, utils.py:183-216).  'permutation' is parity-exact;
    # 'noise' is the physical-mode surrogate (fresh length-n noise rows —
    # distribution-equal under PHAT, tests/test_bootstrap_noise.py, with
    # no per-draw permutation sort).
    bootstrap_mode: str = "permutation"
    # PHAT whitening band (Hz): 'auto' band-limits to the noise-reduction
    # passband in physical lag mode (fixes the reference's bandpass+PHAT
    # lag-0 artifact, SURVEY.md Q5), None disables, or an explicit (lo, hi).
    phat_band: Any = "auto"
    # TDOA-ladder threshold statistic: None resolves to 'median' in
    # reference-parity mode (the reference's utils.py:148 statistic) and to
    # 'gaussian' in physical mode (one-pass scaled mean-|x| median estimate,
    # same default as the sweep path).  Explicit 'median'/'gaussian'/'adaptive'
    # override either mode.
    threshold_method: Optional[str] = None
    # Position solver (physical mode only; parity mode always runs the
    # reference's clustered-LM -> DE chain, main.py:261-298).  'lm' is the
    # reference-shaped default; 'lm-robust' adds leave-k-out least-median
    # consensus + Huber refit to the same chain (rescues scenes where
    # reflections corrupt individual pair TDOAs: 84% -> 97% hit on the
    # 10 dB reverberant eval regime); 'srp' / 'srp+lm' run the SRP-PHAT
    # grid search (still the most robust choice in reverberation);
    # 'beam' / 'music' / 'capon' are the narrowband steered-power /
    # subspace / MVDR estimators (pure tones defeat the GCC chain
    # outright).  See EVALUATION.md's hard-regime table.
    solver: str = "lm"
    # GCC frequency weighting (physical mode only; parity mode is PHAT —
    # the only weighting the reference implements, utils.py:116).  'scot'
    # is invariant to per-channel gain/coloration (mismatched mic
    # responses); 'roth' is the Wiener/least-squares weighting; 'cc' is
    # plain cross-correlation (best at very low SNR where PHAT's unit-
    # magnitude normalization amplifies noise-only bins); 'ml' (Hannan-
    # Thomson) is streaming-only — see ops/gccphat.GCC_WEIGHTINGS.
    gcc_weighting: str = "phat"
    # Grid-search box for the srp/beam/music/capon solvers as
    # ((x0,y0,z0), (x1,y1,z1)).  None derives a default from the mic
    # array: its bounding box expanded by max(array diameter, 0.5 m) per
    # side — sources well outside the array need an explicit box.
    search_box: Optional[Tuple[Tuple[float, float, float],
                               Tuple[float, float, float]]] = None

    @staticmethod
    def from_dict(d: Mapping[str, Any] | None) -> "LocalizationConfig":
        d = d or {}
        med = d.get("max_expected_delay", None)
        box = d.get("search_box", None)
        if box is not None:
            box = (tuple(float(v) for v in box[0]),
                   tuple(float(v) for v in box[1]))
        return LocalizationConfig(
            max_reflections=int(d.get("max_reflections", 2)),
            filter_method=d.get("filter_method", "butterworth"),
            absorption_threshold=float(d.get("absorption_threshold", 0.01)),
            analyze_correlation=bool(d.get("analyze_correlation", False)),
            visualize_correlation=bool(d.get("visualize_correlation", False)),
            clustering_method=d.get("clustering_method", "kmeans"),
            clustering_eps=float(d.get("clustering_eps", 0.001)),
            clustering_min_samples=int(d.get("clustering_min_samples", 2)),
            max_expected_delay=None if med is None else float(med),
            lag_mode=d.get("lag_mode", "physical"),
            sync_mode=d.get("sync_mode", "reference"),
            num_bootstrap=int(d.get("num_bootstrap", 1000)),
            bootstrap_mode=d.get("bootstrap_mode", "permutation"),
            phat_band=d.get("phat_band", "auto"),
            threshold_method=d.get("threshold_method", None),
            solver=d.get("solver", "lm"),
            gcc_weighting=d.get("gcc_weighting", "phat"),
            search_box=box,
        )


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Top-level scene description (reference main.py:26-64).

    Array-valued members are numpy arrays; everything that determines shapes
    is a plain Python scalar so the whole object can key a jit cache.
    """

    fs: float = 44100.0
    duration: float = 1.0
    celsius: float = 20.0
    humidity: float = 50.0
    mic_positions: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]))
    source_position: Optional[np.ndarray] = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5]))
    signal_type: str = "sine"
    freq: float = 1000.0
    # Planes as (P, 4) coefficients + per-plane material ids into `materials`.
    plane_coeffs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4)))
    plane_material_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))
    materials: MaterialTable = dataclasses.field(default_factory=default_table)
    # 'carrier' (default) evaluates the attenuation law at the single
    # carrier `freq` (the reference's semantics, utils.py:50-65); 'per-bin'
    # evaluates its exp(-freq_coeff * f * d) term at every rfft bin —
    # physical-mode simulation extension (models/simulator).
    absorption_mode: str = "carrier"
    calibration: CalibrationConfig = dataclasses.field(
        default_factory=CalibrationConfig)
    localization: LocalizationConfig = dataclasses.field(
        default_factory=LocalizationConfig)
    seed: int = 0

    # ----- derived static shapes -----
    @property
    def num_mics(self) -> int:
        return int(self.mic_positions.shape[0])

    @property
    def num_samples(self) -> int:
        # Matches int(fs * duration) used throughout the reference
        # (signal_processing.py:26, main.py:120).
        return int(self.fs * self.duration)

    @property
    def num_planes(self) -> int:
        return int(self.plane_coeffs.shape[0])

    @property
    def mic_pairs(self) -> Tuple[Tuple[int, int], ...]:
        """All i<j pairs in the reference's loop order (main.py:202-203)."""
        m = self.num_mics
        return tuple((i, j) for i in range(m) for j in range(i + 1, m))

    @staticmethod
    def from_dict(config: Mapping[str, Any],
                  materials: MaterialTable | None = None,
                  seed: int = 0) -> "SceneConfig":
        """Build from a reference-style config dict (main.py:26-64 keys)."""
        table = materials if materials is not None else default_table()
        planes = config.get("reflective_planes", []) or []
        coeffs = np.array([p["plane"] for p in planes], np.float64).reshape(
            len(planes), 4) if planes else np.zeros((0, 4))
        # Unknown plane materials are an error during image-source generation
        # in the reference (utils.py:93-94) — resolve strictly here.
        mat_ids = np.array(
            [table.id_of(p.get("material", "air"), strict=True) for p in planes],
            np.int32)
        src = config.get("source_position", None)
        return SceneConfig(
            fs=float(config.get("fs", 44100)),
            duration=float(config.get("duration", 1.0)),
            celsius=float(config.get("celsius", 20)),
            humidity=float(config.get("humidity", 50)),
            mic_positions=np.asarray(config["mic_positions"], np.float64),
            source_position=None if src is None else np.asarray(src, np.float64),
            signal_type=config.get("signal_type", "sine"),
            freq=float(config.get("freq", 1000)),
            plane_coeffs=coeffs,
            plane_material_ids=mat_ids,
            materials=table,
            absorption_mode=config.get("absorption_mode", "carrier"),
            calibration=CalibrationConfig.from_dict(config.get("calibration")),
            localization=LocalizationConfig.from_dict(config.get("localization")),
            seed=int(config.get("seed", seed)),
        )


# The reference's default demo scenario (main.py:26-64) as a plain dict, kept
# importable for parity tests and examples.
DEFAULT_CONFIG: Dict[str, Any] = {
    "fs": 44100,
    "duration": 1.0,
    "celsius": 20,
    "humidity": 50,
    "mic_positions": [
        [0.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
    ],
    "source_position": [0.5, 0.5, 0.5],
    "signal_type": "sine",
    "freq": 1000,
    "reflective_planes": [
        {"plane": [1, 0, 0, -5], "material": "wood"},
        {"plane": [0, 1, 0, -5], "material": "metal"},
        {"plane": [0, 0, 1, -5], "material": "wood"},
    ],
    "calibration": {
        "signal_type": "chirp",
        "freq_start": 500,
        "freq_end": 5000,
        "attenuation_factor": 1.0,
        "noise_level": 0.01,
    },
    "localization": {
        "max_reflections": 3,
        "filter_method": "butterworth",
        "absorption_threshold": 0.01,
        "analyze_correlation": True,
        "visualize_correlation": True,
        "clustering_method": "kmeans",
        "clustering_eps": 0.001,
        "clustering_min_samples": 2,
        "max_expected_delay": 0.05,
    },
}
