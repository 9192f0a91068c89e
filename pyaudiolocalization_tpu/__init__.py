"""pyaudiolocalization_tpu — sound-source localization in JAX.

A from-scratch JAX/XLA rebuild of PyAudioLocalization's capabilities
(see SURVEY.md for the reference analysis and README.md for the design).
The reference's public API is preserved at this top level.
"""

from .api import (  # noqa: F401
    localize_sound_source,
    simulate_signals_with_multipath,
    run_calibration,
)
from .utils.config import SceneConfig, LocalizationConfig, CalibrationConfig, DEFAULT_CONFIG  # noqa: F401
from .utils.materials import material_properties, MaterialTable, default_table  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "localize_sound_source",
    "simulate_signals_with_multipath",
    "run_calibration",
    "SceneConfig",
    "LocalizationConfig",
    "CalibrationConfig",
    "DEFAULT_CONFIG",
    "material_properties",
    "MaterialTable",
    "default_table",
]
