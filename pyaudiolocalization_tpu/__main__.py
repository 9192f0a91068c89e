"""``python -m pyaudiolocalization_tpu`` — the reference's demo driver.

Counterpart of the reference's ``__main__`` block (main.py:335-347): run the
chirp calibration, log per-mic delay/amplitude and their averages, then run
the full localization pipeline on the default simulated scene with the
calibration corrections applied.

Extra flags (rebuild additions):
  --no-calibration   skip calibration (the reference's defective calibration
                     corrupts localization — SURVEY.md Q2/Q3; default keeps
                     reference behavior)
  --physical         use the physically-correct lag/sync modes instead of
                     reference-defect parity
  --no-plots         save figures instead of showing them
  --seed N           PRNG seed (the reference is unseeded)
  --solver NAME      physical-mode estimator (lm / lm-robust / srp /
                     srp+lm / beam / music / capon); implies --physical
"""

from __future__ import annotations

import argparse
import copy
import logging
from typing import Any, Dict

import numpy as np

from . import localize_sound_source, run_calibration
from .utils.config import DEFAULT_CONFIG

logger = logging.getLogger("pyaudiolocalization_tpu")


def demo(argv=None) -> Dict[str, Any]:
    """Parse the demo flags, run calibration + localization, and return
    localize_sound_source's result dict."""
    parser = argparse.ArgumentParser(
        prog="pyaudiolocalization_tpu",
        description="Sound-source localization demo")
    parser.add_argument("--no-calibration", action="store_true")
    parser.add_argument("--physical", action="store_true")
    parser.add_argument("--no-plots", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--solver", default=None,
        choices=("lm", "lm-robust", "srp", "srp+lm", "beam", "music",
                 "capon"),
        help="physical-mode estimator (implies --physical)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s")

    config = copy.deepcopy(DEFAULT_CONFIG)
    config["seed"] = args.seed
    if args.physical or args.solver:
        config["localization"]["lag_mode"] = "physical"
        config["localization"]["sync_mode"] = "none"
    if args.solver:
        config["localization"]["solver"] = args.solver

    calibration_data = None
    if not args.no_calibration:
        # main.py:338-344: run calibration, log per-mic results + averages.
        calibration_data, _sig, _rec = run_calibration(config)
        for i, res in enumerate(calibration_data):
            logger.info("Microphone %d: delay = %.6f s, amplitude = %.2f",
                        i + 1, res["delay"], res["amplitude"])
        avg_delay = float(np.mean([r["delay"] for r in calibration_data]))
        avg_amp = float(np.mean([r["amplitude"] for r in calibration_data]))
        logger.info("Average delay: %.6f s", avg_delay)
        logger.info("Average amplitude: %.2f", avg_amp)

    result = localize_sound_source(
        config, calibration_data=calibration_data, use_simulation=True,
        show_plots=not args.no_plots)
    est = result["estimated_position"]
    act = result["actual_position"]
    logger.info("Estimated position: %s", np.round(est, 4).tolist())
    if act is not None:
        err = float(np.linalg.norm(np.asarray(est) - np.asarray(act)))
        logger.info("Actual position: %s, error: %.4f m",
                    np.asarray(act).tolist(), err)
    return result


def main(argv=None) -> int:
    demo(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
