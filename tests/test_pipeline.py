"""End-to-end pipeline tests (reference main.py:126-347 behavior).

Small scenes (8 kHz, 0.25 s) keep compile + run times reasonable on CPU;
BASELINE config-1 physics (tetrahedral sine, free field) is covered both in
compat ('reference') mode — where the equidistant default source must land
on the circumcenter — and in physical mode, where off-center sources must
actually localize (the reference cannot do this, SURVEY.md Q1/Q4/Q5).
"""

import copy

import jax
import numpy as np
import pytest

import pyaudiolocalization_tpu as pal
from pyaudiolocalization_tpu.models.calibration import (
    analyze_calibration, generate_calibration_signal, full_cross_correlation)
from pyaudiolocalization_tpu.models.sync import synchronize_signals

import jax.numpy as jnp
import scipy.signal


def small_config(**loc_overrides):
    cfg = copy.deepcopy(pal.DEFAULT_CONFIG)
    cfg["fs"] = 8000
    cfg["duration"] = 0.25
    loc = cfg["localization"]
    loc["analyze_correlation"] = False
    loc["visualize_correlation"] = False
    loc.update(loc_overrides)
    return cfg


def test_default_scene_reference_mode():
    """Compat mode on the default scene: at 8 kHz the defective reference
    ladder yields garbage TDOAs for everyone (tests/test_reference_parity.py
    proves ours are bit-identical to the reference's) — here we only check
    the pipeline contract: finite cost, estimate within bounds, result keys."""
    cfg = small_config(lag_mode="reference", sync_mode="reference")
    res = pal.localize_sound_source(cfg, use_simulation=True, show_plots=False)
    assert np.isfinite(res["cost"])
    assert res["estimated_position"].shape == (3,)
    assert res["actual_position"] is not None
    assert res["correlation_metrics"] is None
    assert res["correlation_matrix"] is None


@pytest.mark.parametrize("source", [[0.2, 0.7, 0.4], [0.8, 0.3, 0.6]])
def test_offcenter_source_physical_mode(source):
    """Physical mode must localize off-center sources — the reference
    collapses these to the circumcenter (SURVEY.md Q1/Q4/Q5)."""
    cfg = small_config(lag_mode="physical", sync_mode="none",
                       filter_method="wiener", max_expected_delay=0.05)
    cfg["source_position"] = source
    cfg["signal_type"] = "noise"
    res = pal.localize_sound_source(cfg, use_simulation=True, show_plots=False,
                                    key=jax.random.PRNGKey(7))
    err = np.linalg.norm(res["estimated_position"] - np.array(source))
    assert err < 0.1, f"err={err} for {source}"


def test_analyze_correlation_metrics():
    cfg = small_config(analyze_correlation=True, num_bootstrap=50)
    res = pal.localize_sound_source(cfg, use_simulation=True, show_plots=False)
    metrics = res["correlation_metrics"]
    assert set(metrics.keys()) == {(i, j) for i in range(4) for j in range(i + 1, 4)}
    for m in metrics.values():
        assert set(m.keys()) == {"peak_to_peak_ratio", "snr", "significant"}


def test_input_validation():
    cfg = small_config()
    cfg["source_position"] = None
    with pytest.raises(ValueError):
        pal.localize_sound_source(cfg, use_simulation=True, show_plots=False)
    cfg2 = small_config()
    with pytest.raises(ValueError):
        pal.localize_sound_source(cfg2, use_simulation=False, show_plots=False)
    with pytest.raises(ValueError):
        pal.localize_sound_source(cfg2, use_simulation=False,
                                  audio_files=["a.wav"], show_plots=False)


def test_calibration_correction_applied():
    """Calibration delays shift the TDOAs by calib[j]-calib[i]
    (main.py:209-214)."""
    cfg = small_config(lag_mode="physical", sync_mode="none")
    base = pal.localize_sound_source(cfg, use_simulation=True, show_plots=False)
    calib = [{"delay": 0.001 * i, "amplitude": 1.0} for i in range(4)]
    res = pal.localize_sound_source(cfg, calibration_data=calib,
                                    use_simulation=True, show_plots=False)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    for k, (i, j) in enumerate(pairs):
        expected = base["tdoas"][k] - (0.001 * j - 0.001 * i)
        np.testing.assert_allclose(res["tdoas"][k], expected, atol=1e-9)


def test_calibration_length_mismatch_ignored():
    cfg = small_config()
    calib = [{"delay": 0.0, "amplitude": 1.0}] * 3  # 3 != 4 mics
    res = pal.localize_sound_source(cfg, calibration_data=calib,
                                    use_simulation=True, show_plots=False)
    assert res["estimated_position"].shape == (3,)


def test_simulate_signals_with_multipath_reference_signature():
    sigs = pal.simulate_signals_with_multipath(
        [0.5, 0.5, 0.5],
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
        8000.0, 343.0, duration=0.25, signal_type="sine", freq=1000,
        reflective_planes=pal.DEFAULT_CONFIG["reflective_planes"],
        material_properties=pal.material_properties,
        max_reflections=3, absorption_threshold=0.01)
    assert len(sigs) == 4
    for s in sigs:
        assert s.shape == (2000,)
        assert np.max(np.abs(s)) <= 1.0 + 1e-9


def test_run_calibration_shape_and_q2():
    """run_calibration returns per-mic dicts; with default (underflowing)
    materials the recordings are noise (SURVEY.md Q2) so estimated delays
    are artifacts — large vs the true ~1-5 ms."""
    cfg = copy.deepcopy(pal.DEFAULT_CONFIG)
    cfg["fs"] = 8000
    cfg["duration"] = 0.25
    results, calib_signal, recordings = pal.run_calibration(cfg)
    assert len(results) == 4
    assert calib_signal.shape == (2000,)
    assert np.asarray(recordings).shape == (4, 2000)
    for r in results:
        # 'snr' is a rebuild extension: the correlation-peak quality
        # statistic that physical mode gates calibration application on.
        assert set(r.keys()) == {"delay", "amplitude", "snr"}


def test_analyze_calibration_recovers_known_delay():
    """With sane attenuation the correlation analysis must recover an
    integer-sample delay exactly (calibration.py:42-51 semantics)."""
    fs = 8000.0
    calib = generate_calibration_signal(fs, 0.25)
    delayed = jnp.roll(calib, 20)
    res = analyze_calibration(delayed[None, :], calib, fs)
    np.testing.assert_allclose(np.asarray(res.delays), [20 / fs], atol=1e-9)


def test_full_cross_correlation_matches_scipy(rng):
    a = rng.normal(size=300)
    b = rng.normal(size=200)
    ref = scipy.signal.correlate(a, b, mode="full")
    got = np.asarray(full_cross_correlation(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, atol=1e-9)


def test_synchronize_signals_matches_reference_behavior(rng):
    """The reference's sync pads the *late* signal even later (verified
    against /root/reference/utils.py:407-457 this session: a +30-sample
    delayed copy comes out at relative lag -60, i.e. the delay is doubled,
    not cancelled — an extension of SURVEY.md Q4).  We reproduce that
    behavior exactly in sync_mode='reference'."""
    fs = 8000.0
    base = rng.normal(size=2000)
    shifted = np.concatenate([np.zeros(30), base])[:2000]
    out = synchronize_signals([base, shifted], fs)
    assert out[0].shape == out[1].shape == (2030,)
    corr = np.asarray(full_cross_correlation(out[0], out[1]))
    lag = np.argmax(np.abs(corr)) - (out[1].shape[-1] - 1)
    assert lag == -60


def test_physical_nfft_alias_guard():
    """Physical mode picks circular next_pow2(n) only when the peak-search
    window fits the alias-free margin; short captures and unwindowed
    (argmax-everywhere) configs must fall back to next_pow2(2n-1)."""
    import copy
    from pyaudiolocalization_tpu import localize_sound_source, DEFAULT_CONFIG

    def run(duration, max_expected_delay):
        cfg = copy.deepcopy(DEFAULT_CONFIG)
        cfg["duration"] = duration
        cfg["signal_type"] = "noise"
        cfg["source_position"] = [0.3, 0.6, 0.4]
        cfg["localization"]["lag_mode"] = "physical"
        cfg["localization"]["sync_mode"] = "none"
        cfg["localization"]["max_expected_delay"] = max_expected_delay
        cfg["localization"]["analyze_correlation"] = False
        cfg["localization"]["visualize_correlation"] = False
        return localize_sound_source(cfg, use_simulation=True,
                                     show_plots=False)

    # Long capture with a modest window -> accurate either way (smoke).
    r = run(0.5, 0.01)
    err = np.linalg.norm(np.asarray(r["estimated_position"])
                         - np.array([0.3, 0.6, 0.4]))
    assert err < 0.02
    # Short capture where the 0.05 s window exceeds the circular alias-free
    # margin: the guard must keep the estimate accurate (before the guard,
    # folded far-lag peaks could land inside the search window).
    r = run(0.15, 0.05)
    err = np.linalg.norm(np.asarray(r["estimated_position"])
                         - np.array([0.3, 0.6, 0.4]))
    assert err < 0.02


# ---------------------------------------------------------------------------
# Public solver selection (config['localization']['solver'], VERDICT r2 item 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["srp", "srp+lm"])
def test_solver_srp_through_public_api(solver):
    """SRP-PHAT behind the reference-shaped entry point: off-center noise
    source localizes through the grid search (result dict keys unchanged)."""
    cfg = small_config(lag_mode="physical", sync_mode="none",
                       max_expected_delay=0.05, solver=solver)
    cfg["signal_type"] = "noise"
    cfg["source_position"] = [0.3, 0.6, 0.4]
    res = pal.localize_sound_source(cfg, use_simulation=True,
                                    show_plots=False,
                                    key=jax.random.PRNGKey(5))
    err = np.linalg.norm(res["estimated_position"] - np.array([0.3, 0.6, 0.4]))
    assert err < 0.1, f"{solver}: err={err}"
    assert np.isfinite(res["cost"])
    assert set(res.keys()) == {
        "estimated_position", "actual_position", "mic_positions",
        "correlation_metrics", "correlation_matrix", "calibration_data",
        "tdoas", "cost", "uncertainty"}
    # Pure-grid SRP fixes are not stationary points of the TDOA LS cost;
    # the attached sigma must carry the heuristic flag (srp+lm clears it
    # when the LM polish is accepted).
    assert res["uncertainty"]["heuristic"] == (solver == "srp")


_CUBE_MICS = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
              [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]]


@pytest.mark.parametrize("solver", ["beam", "music", "capon"])
def test_solver_narrowband_tone_through_public_api(solver):
    """Pure tones defeat the GCC/TDOA chain outright (EVALUATION.md hard
    regimes); the narrowband solvers must localize them through the same
    public entry point.  8-mic cube: the narrowband envelope's unambiguous
    array — a 4-mic tetrahedron gives only 3 independent phase constraints
    per bin, spatially ambiguous at 1.1 kHz (measured err 0.56 m for ALL
    narrowband solvers regardless of box size)."""
    cfg = small_config(lag_mode="physical", sync_mode="none", solver=solver,
                       search_box=((-0.2, -0.2, -0.2), (1.2, 1.2, 1.2)))
    cfg["mic_positions"] = _CUBE_MICS
    cfg["signal_type"] = "sine"
    cfg["freq"] = 1100.0
    cfg["source_position"] = [0.35, 0.55, 0.45]
    res = pal.localize_sound_source(cfg, use_simulation=True,
                                    show_plots=False,
                                    key=jax.random.PRNGKey(9))
    err = np.linalg.norm(res["estimated_position"]
                         - np.array([0.35, 0.55, 0.45]))
    assert err < 0.05, f"{solver}: err={err}"


def test_solver_narrowband_with_analyze_metrics():
    """Narrowband solver + analyze_correlation: the GCC front half still
    runs for the metrics dict even though the solver ignores it."""
    cfg = small_config(lag_mode="physical", sync_mode="none", solver="capon",
                       analyze_correlation=True, num_bootstrap=25)
    cfg["signal_type"] = "sine"
    cfg["freq"] = 1100.0
    res = pal.localize_sound_source(cfg, use_simulation=True,
                                    show_plots=False)
    assert len(res["correlation_metrics"]) == 6
    assert res["estimated_position"].shape == (3,)


def test_solver_explicit_search_box():
    cfg = small_config(lag_mode="physical", sync_mode="none", solver="srp",
                       max_expected_delay=0.05,
                       search_box=((-0.5, -0.5, -0.5), (1.5, 1.5, 1.5)))
    cfg["signal_type"] = "noise"
    cfg["source_position"] = [0.6, 0.4, 0.5]
    res = pal.localize_sound_source(cfg, use_simulation=True,
                                    show_plots=False,
                                    key=jax.random.PRNGKey(2))
    err = np.linalg.norm(res["estimated_position"] - np.array([0.6, 0.4, 0.5]))
    assert err < 0.1


def test_solver_validation_errors():
    with pytest.raises(ValueError, match="Unknown solver"):
        pal.localize_sound_source(small_config(solver="nope"),
                                  use_simulation=True, show_plots=False)
    with pytest.raises(ValueError, match="physical-mode"):
        pal.localize_sound_source(
            small_config(solver="srp", lag_mode="reference"),
            use_simulation=True, show_plots=False)
    with pytest.raises(ValueError, match="search_box"):
        pal.localize_sound_source(
            small_config(solver="srp", lag_mode="physical",
                         max_expected_delay=0.05,
                         search_box=((0, 0, 0), (0, 1, 1))),
            use_simulation=True, show_plots=False)


# ---------------------------------------------------------------------------
# Physical-mode calibration sanity gate (SURVEY.md rebuild policy; Q2/Q3)
# ---------------------------------------------------------------------------

def test_q2_noise_calibration_gated_in_physical_mode():
    """A Q2 noise-dominated calibration (underflowed attenuation -> signal-
    free recordings, random delays) must be IGNORED in physical mode (the
    estimate stays accurate) and applied verbatim in parity mode (Q3: the
    TDOAs shift by the garbage delay differences, the reference's measured
    63 m blowup behavior)."""
    cfg = small_config(lag_mode="physical", sync_mode="none",
                       filter_method="wiener", max_expected_delay=0.05)
    cfg["signal_type"] = "noise"
    cfg["source_position"] = [0.3, 0.6, 0.4]
    calib, _, _ = pal.run_calibration(cfg, key=jax.random.PRNGKey(1))
    assert all("snr" in d for d in calib)
    assert max(d["snr"] for d in calib) < 20.0, \
        "default config must reproduce Q2's noise-dominated calibration"
    assert any(abs(d["delay"]) > 1e-3 for d in calib)

    base = pal.localize_sound_source(cfg, use_simulation=True,
                                     show_plots=False,
                                     key=jax.random.PRNGKey(7))
    gated = pal.localize_sound_source(cfg, calibration_data=calib,
                                      use_simulation=True, show_plots=False,
                                      key=jax.random.PRNGKey(7))
    np.testing.assert_allclose(gated["estimated_position"],
                               base["estimated_position"], atol=1e-9)
    err = np.linalg.norm(gated["estimated_position"]
                         - np.array([0.3, 0.6, 0.4]))
    assert err < 0.1

    # Parity mode: defect-exact — the garbage delays ARE applied.
    cfg_ref = small_config(lag_mode="reference")
    ref_base = pal.localize_sound_source(cfg_ref, use_simulation=True,
                                         show_plots=False,
                                         key=jax.random.PRNGKey(7))
    ref_cal = pal.localize_sound_source(cfg_ref, calibration_data=calib,
                                        use_simulation=True, show_plots=False,
                                        key=jax.random.PRNGKey(7))
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    for k, (i, j) in enumerate(pairs):
        expected = ref_base["tdoas"][k] - (calib[j]["delay"]
                                           - calib[i]["delay"])
        np.testing.assert_allclose(ref_cal["tdoas"][k], expected, atol=1e-9)


def test_good_calibration_applied_in_physical_mode():
    """Entries whose snr passes the gate (or that carry no snr at all) are
    applied in physical mode."""
    cfg = small_config(lag_mode="physical", sync_mode="none")
    base = pal.localize_sound_source(cfg, use_simulation=True,
                                     show_plots=False)
    calib = [{"delay": 0.001 * i, "amplitude": 1.0, "snr": 150.0}
             for i in range(4)]
    res = pal.localize_sound_source(cfg, calibration_data=calib,
                                    use_simulation=True, show_plots=False)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    for k, (i, j) in enumerate(pairs):
        expected = base["tdoas"][k] - (0.001 * j - 0.001 * i)
        np.testing.assert_allclose(res["tdoas"][k], expected, atol=1e-9)
