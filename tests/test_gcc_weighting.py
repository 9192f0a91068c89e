"""GCC weighting family (Knapp & Carter 1976) — physical-mode extensions
beyond the reference's PHAT-only estimator (utils.py:108-119).

Covers the ops-level weightings (phat/scot/roth/cc batch, + ml streaming),
their defining algebraic properties, and the public-API plumbing
(``config['localization']['gcc_weighting']``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pyaudiolocalization_tpu as pal
from pyaudiolocalization_tpu.ops import gccphat

BATCH_WEIGHTINGS = ("phat", "scot", "roth", "cc")


def _delayed_pair(rng, n=2048, delay=17):
    """White-noise pair where s1 lags s2 by `delay` samples, so the
    cross-correlation ifft(S1 conj S2) peaks at circular lag +delay."""
    s = rng.normal(size=n + delay)
    s1 = s[:n]
    s2 = s[delay:]
    return jnp.asarray(s1), jnp.asarray(s2)


@pytest.mark.parametrize("weighting", BATCH_WEIGHTINGS)
def test_weightings_recover_known_delay(rng, weighting):
    """Every weighting's correlation peaks at the true circular lag."""
    delay = 23
    s1, s2 = _delayed_pair(rng, delay=delay)
    corr = np.asarray(gccphat.phat_correlation(s1, s2, weighting=weighting))
    assert int(np.argmax(corr)) == delay, weighting


@pytest.mark.parametrize("weighting", BATCH_WEIGHTINGS)
def test_all_pairs_weighting_matches_two_signal_form(rng, weighting):
    sigs = jnp.asarray(rng.normal(size=(4, 1024)))
    pi = np.array([0, 0, 1, 2], np.int32)
    pj = np.array([1, 2, 3, 3], np.int32)
    nfft = 2048
    got = np.asarray(gccphat.gcc_phat_all_pairs(
        sigs, pi, pj, nfft=nfft, weighting=weighting))
    for k, (i, j) in enumerate(zip(pi, pj)):
        ref = np.asarray(gccphat.phat_correlation(
            sigs[i], sigs[j], nfft=nfft, weighting=weighting))
        np.testing.assert_allclose(got[k], ref, atol=1e-8, err_msg=weighting)


def test_scot_invariant_to_zero_phase_coloration(rng):
    """SCOT divides by sqrt(auto_i * auto_j): a zero-phase per-channel
    magnitude coloration cancels exactly (the weighting's defining
    property — mismatched mic frequency responses don't move the peak),
    while plain 'cc' visibly changes."""
    s1, s2 = _delayed_pair(rng, n=1024, delay=9)
    n = 2048
    # Smooth positive zero-phase coloration of channel 2 (real even filter).
    freqs = np.fft.rfftfreq(n)
    h = (0.2 + np.cos(np.pi * freqs) ** 2).astype(np.float64)   # > 0
    s2_col = jnp.asarray(np.fft.irfft(np.fft.rfft(np.asarray(s2), n) * h, n)[
        : s2.shape[-1]])
    base = np.asarray(gccphat.phat_correlation(s1, s2, nfft=n,
                                               weighting="scot"))
    col = np.asarray(gccphat.phat_correlation(s1, s2_col, nfft=n,
                                              weighting="scot"))
    # Coloration truncated back to the time domain is not bit-exact, but
    # the SCOT correlations must stay strongly aligned and share the peak.
    assert int(np.argmax(col)) == int(np.argmax(base))
    cos = float(np.dot(base, col) / (np.linalg.norm(base)
                                     * np.linalg.norm(col)))
    assert cos > 0.95, cos
    cc_base = np.asarray(gccphat.phat_correlation(s1, s2, nfft=n,
                                                  weighting="cc"))
    cc_col = np.asarray(gccphat.phat_correlation(s1, s2_col, nfft=n,
                                                 weighting="cc"))
    cc_cos = float(np.dot(cc_base, cc_col) / (np.linalg.norm(cc_base)
                                              * np.linalg.norm(cc_col)))
    assert cc_cos < cos  # coloration distorts CC more than SCOT


def test_roth_matches_closed_form(rng):
    """Roth = cross / (auto_1 + eps), straight from the definition."""
    s1, s2 = _delayed_pair(rng, n=700, delay=5)
    n = 1400
    S1 = np.fft.rfft(np.asarray(s1), n)
    S2 = np.fft.rfft(np.asarray(s2), n)
    expected = np.fft.irfft(
        S1 * np.conj(S2) / (np.abs(S1) ** 2 + gccphat.PHAT_EPS), n)
    got = np.asarray(gccphat.phat_correlation(s1, s2, nfft=n,
                                              weighting="roth"))
    np.testing.assert_allclose(got, expected, atol=1e-8)


def test_ml_streaming_recovers_delay_under_decoherence(rng):
    """Hannan-Thomson weighting on the Welch path: a delayed coherent
    source plus strong INDEPENDENT per-channel noise in the upper band.
    'ml' must still peak at the true lag — it down-weights the decohered
    bins by the inverse phase variance."""
    fs = 8000.0
    t = 65536
    delay = 12
    src = rng.normal(size=t + delay)
    # Low-band coherent source (keep below fs/4), strong high-band noise.
    from scipy.signal import butter, lfilter
    b, a = butter(4, 0.2)
    src = lfilter(b, a, src)
    bh, ah = butter(4, 0.4, btype="high")
    n1 = lfilter(bh, ah, rng.normal(size=t)) * 3.0
    n2 = lfilter(bh, ah, rng.normal(size=t)) * 3.0
    sigs = jnp.asarray(np.stack([src[:t] + n1, src[delay:] + n2]))
    corr, lags = gccphat.gcc_phat_streaming(
        sigs, np.array([0], np.int32), np.array([1], np.int32),
        frame=4096, max_lag=64, weighting="ml")
    got = int(lags[int(np.argmax(np.asarray(corr)[0]))])
    assert got == delay, got


@pytest.mark.parametrize("weighting", ["scot", "roth", "cc"])
def test_streaming_weightings_recover_delay(rng, weighting):
    delay = 7
    src = rng.normal(size=32768 + delay)
    sigs = jnp.asarray(np.stack([src[:32768], src[delay:]]))
    corr, lags = gccphat.gcc_phat_streaming(
        sigs, np.array([0], np.int32), np.array([1], np.int32),
        frame=2048, max_lag=32, weighting=weighting)
    assert int(lags[int(np.argmax(np.asarray(corr)[0]))]) == delay


def test_unknown_weighting_raises(rng):
    s1, s2 = _delayed_pair(rng, n=256, delay=3)
    with pytest.raises(ValueError, match="weighting"):
        gccphat.phat_correlation(s1, s2, weighting="eckart")


def _small_config(**loc_overrides):
    cfg = copy.deepcopy(pal.DEFAULT_CONFIG)
    cfg["fs"] = 8000
    cfg["duration"] = 0.25
    cfg["localization"].update(loc_overrides)
    return cfg


@pytest.mark.parametrize("weighting", ["scot", "roth", "cc"])
def test_api_gcc_weighting_localizes(weighting):
    """Physical-mode localization stays accurate under every batch
    weighting on the clean free-field scene (all weightings are unbiased
    there; accuracy differences only appear in hard regimes)."""
    cfg = _small_config(lag_mode="physical", sync_mode="none",
                        filter_method="wiener", max_expected_delay=0.05,
                        gcc_weighting=weighting)
    cfg["source_position"] = [0.3, 0.6, 0.4]
    cfg["signal_type"] = "noise"
    res = pal.localize_sound_source(cfg, use_simulation=True,
                                    show_plots=False,
                                    key=jax.random.PRNGKey(3))
    err = np.linalg.norm(res["estimated_position"]
                         - np.array(cfg["source_position"]))
    assert err < 0.1, (weighting, err)


def test_sweep_gcc_weighting():
    """SweepSpec.gcc_weighting routes the Monte-Carlo estimator through the
    weighted XLA path; 'ml'/unknown are rejected at spec check."""
    from pyaudiolocalization_tpu.parallel.sweep import SweepSpec, run_scene

    spec = SweepSpec(fs=16000.0, duration=0.05, signal_type="noise",
                     source_box_lo=(0.2,) * 3, source_box_hi=(0.8,) * 3,
                     gcc_weighting="scot")
    res = run_scene(spec, jax.random.PRNGKey(5))
    assert float(res.error) < 0.1, float(res.error)
    with pytest.raises(ValueError, match="gcc_weighting"):
        run_scene(SweepSpec(fs=16000.0, duration=0.05,
                            gcc_weighting="ml"), jax.random.PRNGKey(0))


@pytest.mark.parametrize("weighting", ["scot", "ml", "cc"])
def test_streaming_localizer_weighting_converges(weighting):
    """StreamingLocalizer(method='srp', weighting=...) tracks a static
    source — the EMA cross/auto spectra are the Welch averages the ratio
    weightings (incl. Hannan-Thomson 'ml') expect."""
    from pyaudiolocalization_tpu.models.online import StreamingLocalizer
    from pyaudiolocalization_tpu.models.simulator import simulate_signals
    from pyaudiolocalization_tpu.models.acoustics import speed_of_sound

    fs = 16000.0
    mics = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    c = float(speed_of_sound(20.0, 50.0))
    src = np.array([0.3, 0.6, 0.4])
    sigs = np.asarray(simulate_signals(src, mics, fs, c, duration=0.5,
                                       signal_type="noise",
                                       key=jax.random.PRNGKey(0)))
    loc = StreamingLocalizer(mics, fs, c, [0.0] * 3, [1.0] * 3,
                             frame=2048, hop=512, weighting=weighting)
    positions, powers = loc.run(sigs)
    tail = positions[len(positions) // 2:]
    assert np.linalg.norm(tail - src[None, :], axis=-1).max() < 0.05
    assert np.all(np.isfinite(powers))


def test_tracking_weighting_follows_moving_source():
    """localize_trajectory(weighting=...) tracks the same moving source
    as the PHAT default; narrowband methods reject weighting overrides."""
    from pyaudiolocalization_tpu.models.tracking import localize_trajectory
    from pyaudiolocalization_tpu.models.simulator import simulate_signals
    from pyaudiolocalization_tpu.models.acoustics import speed_of_sound

    fs = 16000.0
    mics = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    c = float(speed_of_sound(20.0, 50.0))
    a = np.asarray(simulate_signals([0.3, 0.4, 0.5], mics, fs, c,
                                    duration=0.3, signal_type="noise",
                                    key=jax.random.PRNGKey(1)))
    b = np.asarray(simulate_signals([0.7, 0.6, 0.5], mics, fs, c,
                                    duration=0.3, signal_type="noise",
                                    key=jax.random.PRNGKey(2)))
    sigs = jnp.asarray(np.concatenate([a, b], axis=1))
    track = localize_trajectory(sigs, jnp.asarray(mics, jnp.float32), fs, c,
                                jnp.zeros(3), jnp.ones(3),
                                segment=2048, weighting="scot")
    pos = np.asarray(track.positions)
    assert np.linalg.norm(pos[0] - [0.3, 0.4, 0.5]) < 0.1
    assert np.linalg.norm(pos[-1] - [0.7, 0.6, 0.5]) < 0.1
    with pytest.raises(ValueError, match="weighting"):
        localize_trajectory(sigs, jnp.asarray(mics, jnp.float32), fs, c,
                            jnp.zeros(3), jnp.ones(3), segment=2048,
                            weighting="ml")
    with pytest.raises(ValueError, match="srp"):
        localize_trajectory(sigs, jnp.asarray(mics, jnp.float32), fs, c,
                            jnp.zeros(3), jnp.ones(3), segment=2048,
                            method="capon", weighting="scot")


def test_streaming_localizer_weighting_validation():
    from pyaudiolocalization_tpu.models.online import StreamingLocalizer
    mics = np.zeros((4, 3)) + np.eye(4, 3)
    with pytest.raises(ValueError, match="unknown weighting"):
        StreamingLocalizer(mics, 16000.0, 343.0, [0] * 3, [1] * 3,
                           weighting="bogus")
    with pytest.raises(ValueError, match="broadband 'srp'"):
        StreamingLocalizer(mics, 16000.0, 343.0, [0] * 3, [1] * 3,
                           method="capon", weighting="scot")


def test_api_weighting_validation():
    cfg = _small_config(lag_mode="reference", gcc_weighting="scot")
    with pytest.raises(ValueError, match="physical-mode extension"):
        pal.localize_sound_source(cfg, use_simulation=True, show_plots=False)
    cfg2 = _small_config(lag_mode="physical", gcc_weighting="ml")
    with pytest.raises(ValueError, match="gcc_weighting"):
        pal.localize_sound_source(cfg2, use_simulation=True, show_plots=False)
