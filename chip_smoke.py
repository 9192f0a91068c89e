"""Bring-up check on the GPU: drive the localizer's main paths once at full
size through the public entry points, and check every result.

    python chip_smoke.py            # phases 1-6 on one card
    python chip_smoke.py --four     # sharded sweep on four cards vs one

Phases (one process, one card):
  1. device      — JAX's default backend is the GPU; card name, power limit
  2. demo        — ``python -m pyaudiolocalization_tpu --no-plots --seed 0``:
                   chirp calibration + localization of DEFAULT_CONFIG
                   (4 mics, 44.1 kHz x 1 s, 1000-draw bootstrap x 6 pairs)
  3. scene       — physical-mode DEFAULT_CONFIG, noise source, LM and SRP
  4. sweeps      — monte_carlo_sweep at bench.py's batch shapes
  5. streaming   — StreamingLocalizer over 2 s of an 8-mic 16 kHz capture
  6. reference   — GCC-PHAT against a NumPy float64 oracle, and
                   localize_batch on the GPU against the same call on the CPU
``--four`` runs only the sharded sweep over a 4-device mesh against the
same sweep on one device.

Each phase runs twice (cold = with compilation, then warm) and prints one
line with both wall times and what it checked.  Any failed check raises, so
the script exits non-zero; the last line is a JSON summary of the device.
Without a GPU it stops before the first phase.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

# Sizes (the reference deployment and bench.py's batch shapes).
FS = 44100.0
N = 44100                     # 1 s
NFFT = 131072                 # next_pow2(2N - 1), the linear-GCC length
GCC_BATCH = 8
LOCALIZE_BATCH = 16
FULL_SWEEP_SCENES = 512
REVERB_SCENES = 512
MULTI_SCENES = 128
STREAM_SECONDS = 2.0

CUBE8 = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
         (1.0, 1.0, 0.0), (1.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 1.0))


class CheckFailed(RuntimeError):
    pass


def _check(ok, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def _precision() -> str:
    p = jax.config.jax_default_matmul_precision
    return "default (float32 dots may run as TF32)" if p is None else str(p)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _phase(name: str, fn) -> None:
    """Run ``fn`` cold (with compilation), then warm; print one line."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    checked = fn()
    warm = time.perf_counter() - t0
    print(f"phase {name}: cold {cold:.3f} s, warm {warm:.3f} s; {checked}",
          flush=True)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_demo(seed: int) -> str:
    from pyaudiolocalization_tpu.__main__ import demo
    res = demo(["--no-plots", "--seed", str(seed)])
    est = np.asarray(res["estimated_position"], float)
    _check(est.shape == (3,) and np.all(np.isfinite(est)),
           f"demo estimate not finite: {est}")
    _check(all(np.isfinite(m["snr"]) or m["snr"] == np.inf
               for m in res["correlation_metrics"].values()),
           "demo correlation metrics not finite")
    err = float(np.linalg.norm(est - np.asarray(res["actual_position"])))
    return (f"4 mics x 44.1 kHz x 1 s, calibration + 1000-draw bootstrap x 6 "
            f"pairs; estimate finite {np.round(est, 4).tolist()} "
            f"(error {err:.4f} m, not bounded: the reference's calibration "
            f"defects apply)")


def _physical_config(solver: str):
    from pyaudiolocalization_tpu import DEFAULT_CONFIG
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["signal_type"] = "noise"
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               solver=solver)
    return cfg


def phase_scene() -> str:
    from pyaudiolocalization_tpu import localize_sound_source
    errs = {}
    for solver, bound in (("lm", 0.02), ("srp", 0.1)):
        cfg = _physical_config(solver)
        res = localize_sound_source(cfg, use_simulation=True,
                                    show_plots=False)
        est = np.asarray(res["estimated_position"], float)
        err = float(np.linalg.norm(est - np.asarray(cfg["source_position"])))
        _check(np.isfinite(err) and err < bound,
               f"physical {solver} error {err:.4f} m >= {bound} m")
        errs[solver] = (err, bound)
    return ("physical DEFAULT_CONFIG, noise source, 4 mics x 44.1 kHz x 1 s: "
            + ", ".join(f"{s} error {e:.4f} m < {b} m"
                        for s, (e, b) in errs.items()))


def sweep_specs():
    """(name, spec, scenes, rmse bound, hit-rate bound): bench.py's specs."""
    from pyaudiolocalization_tpu.parallel import SweepSpec
    full = SweepSpec(fs=FS, duration=1.0, signal_type="noise",
                     source_box_lo=(0.1, 0.1, 0.1),
                     source_box_hi=(0.9, 0.9, 0.9), snr_db=(20.0, 40.0))
    reverb = SweepSpec(fs=16000.0, duration=0.25, signal_type="noise",
                       source_box_lo=(0.2, 0.2, 0.2),
                       source_box_hi=(0.8, 0.8, 0.8), snr_db=(10.0, 25.0),
                       solver="srp",
                       plane_coeffs=((1.0, 0, 0, 0.5), (1.0, 0, 0, -5.5),
                                     (0, 1.0, 0, 0.5), (0, 1.0, 0, -6.5),
                                     (0, 0, 1.0, 0.5), (0, 0, 1.0, -3.0)),
                       plane_material_ids=(1, 1, 2, 2, 1, 1),
                       max_reflections=2)
    multi = SweepSpec(fs=16000.0, duration=0.25, signal_type="noise",
                      mic_positions=CUBE8, solver="srp", num_sources=2,
                      source_min_separation=0.4,
                      source_box_lo=(0.1, 0.1, 0.1),
                      source_box_hi=(0.9, 0.9, 0.9), snr_db=(20.0, 40.0))
    # Bounds from the CPU tests of the same estimators
    # (tests/test_parallel.py): free-field LM rmse < 0.05 m with every scene
    # a hit, here <= 1% misses over 512 scenes; the reverberant SRP room
    # rmse < 0.5 m; two sources on the cube rmse < 0.1 m, hit rate > 0.9.
    return (("full", full, FULL_SWEEP_SCENES, 0.05, 0.99),
            ("reverb", reverb, REVERB_SCENES, 0.5, 0.9),
            ("multi", multi, MULTI_SCENES, 0.1, 0.9))


def phase_sweeps(seed: int) -> str:
    from pyaudiolocalization_tpu.parallel import monte_carlo_sweep
    parts = []
    for name, spec, scenes, rmse_max, hit_min in sweep_specs():
        s = monte_carlo_sweep(spec, jax.random.PRNGKey(seed), scenes)
        rmse, hit = float(s.rmse), float(s.hit_rate)
        _check(np.all(np.isfinite(np.asarray(s.results.estimate))),
               f"{name} sweep: non-finite estimates")
        _check(rmse < rmse_max and hit >= hit_min,
               f"{name} sweep: rmse {rmse:.4f} m (bound {rmse_max}), "
               f"hit rate {hit:.3f} (bound {hit_min})")
        parts.append(f"{name} {scenes} scenes rmse {rmse:.4f} m < "
                     f"{rmse_max}, hit {hit:.3f} >= {hit_min}")
    return "; ".join(parts)


def phase_streaming(seed: int) -> str:
    from pyaudiolocalization_tpu.models.acoustics import speed_of_sound_host
    from pyaudiolocalization_tpu.models.online import StreamingLocalizer
    from pyaudiolocalization_tpu.models.simulator import simulate_signals
    fs = 16000.0
    c = speed_of_sound_host(20.0, 50.0)
    mics = np.asarray(CUBE8)
    src = np.array([0.3, 0.6, 0.4])
    sigs = np.asarray(simulate_signals(
        src, mics, fs, c, duration=STREAM_SECONDS, signal_type="noise",
        key=jax.random.PRNGKey(seed)))
    frame, hop = 2048, 512
    loc = StreamingLocalizer(mics, fs, c, [0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                             frame=frame, hop=hop)
    positions, powers = loc.run(sigs)
    hops = sigs.shape[-1] // hop - frame // hop + 1
    _check(positions.shape[0] == hops and np.all(np.isfinite(positions))
           and np.all(np.isfinite(powers)),
           f"streaming: {positions.shape[0]} of {hops} hops, finite "
           f"{np.all(np.isfinite(positions))}")
    tail = positions[len(positions) // 2:]
    err = float(np.linalg.norm(tail - src[None, :], axis=-1).max())
    # Bound of tests/test_online.py::test_stream_converges_to_static_source.
    _check(err < 0.05, f"streaming tail error {err:.4f} m >= 0.05 m")
    return (f"8 mics x 16 kHz x {STREAM_SECONDS} s, {positions.shape[0]} "
            f"hops all finite; second-half max error {err:.4f} m < 0.05 m")


def _delayed_noise(rng, num: int, mics: np.ndarray, fs: float, c: float,
                   n: int, sources: np.ndarray) -> np.ndarray:
    """(num, M, n) float32 captures of white noise from ``sources`` with
    exact fractional delays (float64 phase ramps) plus 1% sensor noise."""
    base = rng.standard_normal((num, 2 * n))
    spec = np.fft.rfft(base, axis=-1)
    freqs = np.fft.rfftfreq(2 * n, 1.0 / fs)
    dist = np.linalg.norm(sources[:, None, :] - mics[None, :, :], axis=-1)
    ramp = np.exp(-2j * np.pi * freqs[None, None, :]
                  * (dist / c)[..., None])
    sig = np.fft.irfft(spec[:, None, :] * ramp, 2 * n, axis=-1)[..., :n]
    sig += 0.01 * rng.standard_normal(sig.shape)
    return sig.astype(np.float32)


def phase_reference(seed: int) -> str:
    from pyaudiolocalization_tpu.ops import gccphat
    from pyaudiolocalization_tpu.parallel import SweepSpec, localize_batch
    rng = np.random.default_rng(seed)
    mics4 = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                      [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    c = 343.0
    pi = np.array([0, 0, 0, 1, 1, 2], np.int32)
    pj = np.array([1, 2, 3, 2, 3, 3], np.int32)

    # (a) GCC-PHAT at the linear length against a float64 NumPy oracle.
    src = rng.uniform(0.1, 0.9, (GCC_BATCH, 3))
    x = _delayed_noise(rng, GCC_BATCH, mics4, FS, c, N, src)
    got = np.asarray(jax.jit(lambda s: gccphat.gcc_phat_all_pairs(
        s, pi, pj, nfft=NFFT))(jnp.asarray(x)))
    spec = np.fft.rfft(x.astype(np.float64), NFFT, axis=-1)
    cross = spec[:, pi] * np.conj(spec[:, pj])
    want = np.fft.irfft(cross / (np.abs(cross) + gccphat.PHAT_EPS), NFFT,
                        axis=-1)
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    lag_diff = int(np.max(np.abs(np.argmax(got, -1) - np.argmax(want, -1))))
    _check(got.shape == want.shape and rel < 1e-4 and lag_diff <= 1,
           f"gcc vs float64 oracle: rel {rel:.2e} (bound 1e-4), peak lag "
           f"diff {lag_diff} samples (bound 1)")

    # (b) localize_batch on the GPU against the same call on the CPU.
    spec_b = SweepSpec(fs=FS, duration=N / FS, signal_type="noise",
                       mic_positions=tuple(map(tuple, mics4)))
    src_b = rng.uniform(0.1, 0.9, (LOCALIZE_BATCH, 3))
    xb = _delayed_noise(rng, LOCALIZE_BATCH, mics4, FS,
                        spec_b.speed_of_sound, N, src_b)
    key = np.asarray(jax.random.PRNGKey(seed))

    def run(device):
        # CPU executables are machine code for this host's CPU: keep them
        # out of the persistent cache, which may be shared across hosts.
        min_time = jax.config.jax_persistent_cache_min_compile_time_secs
        if device.platform == "cpu":
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              float("inf"))
        try:
            with jax.default_device(device):
                est, _, td = localize_batch(
                    spec_b, jax.device_put(xb, device),
                    jax.device_put(mics4.astype(np.float32), device),
                    jax.device_put(key, device))
                return np.asarray(est), np.asarray(td)
        finally:
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              min_time)

    est_g, td_g = run(jax.devices()[0])
    est_c, td_c = run(jax.devices("cpu")[0])
    pos_diff = float(np.max(np.linalg.norm(est_g - est_c, axis=-1)))
    td_diff = float(np.max(np.abs(td_g - td_c)) * FS)
    err = float(np.max(np.linalg.norm(est_g - src_b, axis=-1)))
    _check(pos_diff <= 1e-3 and td_diff <= 1.0,
           f"localize_batch GPU vs CPU: positions differ by {pos_diff:.2e} m "
           f"(bound 1e-3), TDOAs by {td_diff:.3f} samples (bound 1)")
    _check(err < 0.05, f"localize_batch max error {err:.4f} m >= 0.05 m")
    return (f"gcc (8,4,44100) nfft {NFFT} float32 vs float64 oracle: max "
            f"rel diff {rel:.2e} < 1e-4, peak lags differ by {lag_diff} "
            f"<= 1 sample; localize_batch {LOCALIZE_BATCH} scenes GPU vs CPU "
            f"float32: positions differ by {pos_diff:.2e} m <= 1e-3 m, TDOAs "
            f"by {td_diff:.3f} <= 1 sample, max error vs truth {err:.4f} m; "
            f"matmul precision {_precision()}")


def phase_four(seed: int) -> str:
    """Sharded sweep over four cards against the same sweep on one card.

    The per-pair TDOA lags (integer peak decisions) must be identical scene
    by scene: a scrambled scene-to-device key mapping or a broken
    collective changes them.  (Their float values, lag / fs, may differ
    in the last bit between the two compiled programs.)  Estimates and
    errors are compared at 1e-5 m: XLA compiles the per-card batch of 128
    differently from the one-card batch of 512, and the float32 LM fix
    moves by a few micrometres under such last-bit changes (one card,
    batch 512 vs 4 x 128: up to 2.0e-6 m; TF32 vs HIGHEST matmuls: up to
    3.8e-6 m; TDOAs identical in both)."""
    from pyaudiolocalization_tpu.parallel import make_mesh, monte_carlo_sweep
    _check(len(jax.devices()) >= 4,
           f"--four needs 4 devices, found {len(jax.devices())}")
    name, spec, scenes, rmse_max, hit_min = sweep_specs()[0]
    key = jax.random.PRNGKey(seed)
    sharded = monte_carlo_sweep(spec, key, scenes, mesh=make_mesh(4))
    single = monte_carlo_sweep(spec, key, scenes, mesh=None)
    td_s = np.asarray(sharded.results.tdoas) * spec.fs      # in samples
    td_1 = np.asarray(single.results.tdoas) * spec.fs
    lag_s, lag_1 = np.rint(td_s), np.rint(td_1)
    _check(np.array_equal(lag_s, lag_1),
           f"sharded vs unsharded TDOA lags differ in "
           f"{int(np.any(lag_s != lag_1, -1).sum())} scenes")
    td_diff = float(np.max(np.abs(td_s - td_1)))
    diffs = {}
    for field in ("estimate", "error"):
        a = np.asarray(getattr(sharded.results, field))
        b = np.asarray(getattr(single.results, field))
        diffs[field] = float(np.max(np.abs(a - b)))
        _check(diffs[field] <= 1e-5,
               f"sharded vs unsharded {field}: max diff "
               f"{diffs[field]:.3e} m > 1e-5 m")
    rmse_s, rmse_1 = float(sharded.rmse), float(single.rmse)
    _check(rmse_s < rmse_max and abs(rmse_s - rmse_1) <= 1e-6,
           f"sharded rmse {rmse_s:.6f} m vs unsharded {rmse_1:.6f} m")
    return (f"{name} sweep {scenes} scenes over make_mesh(4) "
            f"({scenes // 4} per card) vs mesh=None on one card: TDOA lags "
            f"identical in every scene (values within {td_diff:.1e} "
            f"samples); estimates differ by at most "
            f"{diffs['estimate']:.3e} m and errors by {diffs['error']:.3e} m "
            f"(bound 1e-5 m); rmse {rmse_s:.6f} m vs {rmse_1:.6f} m; matmul "
            f"precision {_precision()}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card sharded sweep check")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend {backend!r}); "
              "this check runs only on the card.", file=sys.stderr)
        return 2

    from pyaudiolocalization_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    dev = jax.devices()[0]
    card = card_line()
    print(f"phase device: backend gpu, {len(jax.devices())} x "
          f"{dev.device_kind}; matmul precision {_precision()}", flush=True)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as scratch:
        os.chdir(scratch)          # the demo saves its figures to the cwd
        try:
            if args.four:
                _phase("four", lambda: phase_four(args.seed))
            else:
                _phase("demo", lambda: phase_demo(args.seed))
                _phase("scene", phase_scene)
                _phase("sweeps", lambda: phase_sweeps(args.seed))
                _phase("streaming", lambda: phase_streaming(args.seed))
                _phase("reference", lambda: phase_reference(args.seed))
        finally:
            os.chdir(cwd)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
