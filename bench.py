"""Benchmark: batched GCC-PHAT + end-to-end localization on the GPU.

Prints ONE JSON line. Headline metric = GCC-PHAT mic-pairs/sec at
44.1 kHz x 1 s (BASELINE.md: reference serial CPU = 23.3 pairs/s, measured
on phat_correlation, utils.py:108-119). Extras carry the end-to-end
scenes/sec (reference 1.23 scenes/s, main.py:126-333), the card's name and
power limit, and two device ceilings measured in the same run (copy
bandwidth, HIGHEST-precision float32 matmul rate).

Timing protocol: enqueue ``iters`` steps back-to-back and wait for the last
one with ``jax.block_until_ready`` (the device queue is in order).  Exits
non-zero without a GPU: no number here comes from another backend.

    python bench.py
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import card_line
from pyaudiolocalization_tpu.ops import gccphat
from pyaudiolocalization_tpu.parallel import (SweepSpec, localize_batch,
                                              monte_carlo_sweep)

BASELINE_PAIRS_PER_SEC = 23.3   # BASELINE.md row 1
BASELINE_SCENES_PER_SEC = 1.23  # BASELINE.md row 3

FS = 44100.0
N = 44100           # 1 s
NUM_MICS = 4
PAIRS_I = np.array([0, 0, 0, 1, 1, 2], np.int32)
PAIRS_J = np.array([1, 2, 3, 2, 3, 3], np.int32)
NFFT = 131072       # next power of two above n1+n2-1 = 88199


def _time(fn, *args, iters=8, warmup=2, blocks=1):
    """Mean step time: enqueue ``iters`` steps, wait for the last.
    ``blocks`` > 1 repeats the whole block and also returns the relative
    spread across blocks."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    dts = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(iters)]
        jax.block_until_ready(outs[-1])
        dts.append((time.perf_counter() - t0) / iters)
    if blocks == 1:
        return dts[0]
    mean = sum(dts) / blocks
    rel_spread = (max(dts) - min(dts)) / mean
    return mean, rel_spread


def bench_gcc_phat(batch: int = 256):
    """Batched all-pairs GCC-PHAT: (B, M, N) -> (B, P, NFFT) -> scalar."""
    key = jax.random.PRNGKey(0)
    signals = jax.random.normal(key, (batch, NUM_MICS, N), jnp.float32)

    @jax.jit
    def step(sigs):
        corr = gccphat.gcc_phat_all_pairs(sigs, PAIRS_I, PAIRS_J, nfft=NFFT)
        # Tiny reduction so the step's output transfer is one float.
        return jnp.max(corr)

    dt = _time(step, signals)
    pairs = batch * PAIRS_I.shape[0]
    return pairs / dt


def bench_localize(batch: int = 256):
    """End-to-end estimation (filter -> GCC-PHAT -> TDOA -> clustered init ->
    multi-start LM) on 4-mic scenes at 44.1 kHz x 1 s."""
    spec = SweepSpec(fs=FS, duration=1.0, signal_type="noise",
                     source_box_lo=(0.1, 0.1, 0.1),
                     source_box_hi=(0.9, 0.9, 0.9))
    mics = jnp.asarray(spec.mic_positions, jnp.float32)
    key = jax.random.PRNGKey(1)
    # Synthetic broadband inputs: bench measures the estimation path.
    signals = jax.random.normal(key, (batch, NUM_MICS, spec.num_samples),
                                jnp.float32)

    @jax.jit
    def step(sigs, k):
        est, cost, td = localize_batch(spec, sigs, mics, k)
        return est

    dt = _time(step, signals, jax.random.PRNGKey(2), iters=6, warmup=1)
    return batch / dt


def bench_full_sweep(batch: int = 512):
    """FULL pipeline throughput: randomized scene -> multipath simulate ->
    filter -> GCC-PHAT -> TDOA -> solve, all on device (44.1 kHz x 1 s,
    4 mics).  The reference needs 0.485 s (simulate) + 0.814 s (localize)
    per scene serially."""
    spec = SweepSpec(fs=FS, duration=1.0, signal_type="noise",
                     source_box_lo=(0.1, 0.1, 0.1),
                     source_box_hi=(0.9, 0.9, 0.9), snr_db=(20.0, 40.0))

    def step(i):
        return monte_carlo_sweep(spec, jax.random.PRNGKey(i), batch)

    dt, spread = _sweep_time(step, batch)
    return batch / dt, float(np.asarray(step(0).rmse)), spread


def bench_reverberant_sweep(batch: int = 512):
    """Reverberant-room pipeline: 6 reflective planes at order 2 = 37
    render paths per mic (the EVALUATION.md hard-regime room), SRP-PHAT
    solver, 16 kHz x 0.25 s.  Exercises the multipath render at high path
    count."""
    spec = SweepSpec(fs=16000.0, duration=0.25, signal_type="noise",
                     source_box_lo=(0.2, 0.2, 0.2),
                     source_box_hi=(0.8, 0.8, 0.8), snr_db=(10.0, 25.0),
                     solver="srp",
                     plane_coeffs=((1.0, 0, 0, 0.5), (1.0, 0, 0, -5.5),
                                   (0, 1.0, 0, 0.5), (0, 1.0, 0, -6.5),
                                   (0, 0, 1.0, 0.5), (0, 0, 1.0, -3.0)),
                     plane_material_ids=(1, 1, 2, 2, 1, 1),
                     max_reflections=2)

    def step(i):
        return monte_carlo_sweep(spec, jax.random.PRNGKey(i), batch)

    dt, spread = _sweep_time(step, batch)
    return batch / dt, float(np.asarray(step(0).rmse)), spread


def _sweep_time(step, batch, iters=3, blocks=3):
    """Blocked sweep timing with a relative spread across blocks."""
    jax.block_until_ready(step(0))
    dts = []
    for b in range(blocks):
        t0 = time.perf_counter()
        outs = [step(1 + b * iters + i) for i in range(iters)]
        jax.block_until_ready(outs[-1])
        dts.append((time.perf_counter() - t0) / iters)
    mean = sum(dts) / blocks
    return mean, (max(dts) - min(dts)) / mean


def bench_bootstrap(num_bootstrap: int = 1000,
                    bootstrap_mode: str = "permutation", iters: int = 4):
    """The reference's dominant cost: the bootstrap significance test over
    all 6 pairs at 1000 PHAT resamples each (≈258 s of the 274 s default
    run — reference utils.py:183-216, BASELINE.md rows 4-5).  Here the
    resamples are chunked batched FFTs inside one jitted call.  Measured in
    BOTH modes: 'permutation' (parity-exact; per-draw sort) and 'noise'
    (the physical-mode surrogate — fresh noise rows, no sort;
    distribution-equal, tests/test_bootstrap_noise.py)."""
    from pyaudiolocalization_tpu.models import tdoa as tdoa_ops

    key = jax.random.PRNGKey(5)
    signals = jax.random.normal(key, (NUM_MICS, N), jnp.float32)

    @jax.jit
    def step(sigs, k):
        thr = jax.vmap(
            lambda s1, s2, kk: tdoa_ops.bootstrap_significance(
                s1, s2, kk, num_bootstrap=num_bootstrap, nfft=NFFT,
                bootstrap_mode=bootstrap_mode)
        )(jnp.take(sigs, PAIRS_I, 0), jnp.take(sigs, PAIRS_J, 0),
          jax.random.split(k, PAIRS_I.shape[0]))
        return jnp.max(thr)

    dt = _time(step, signals, jax.random.PRNGKey(6), iters=iters, warmup=1)
    return PAIRS_I.shape[0] * num_bootstrap / dt


def bench_analyze_run():
    """End-to-end wall time of the reference's full default ``__main__``
    (chirp calibration + analyze_correlation localization with 1000
    bootstraps + saved figures — main.py:335-347; reference: 274.4 s,
    BASELINE.md row 4).  Warm timing: one compile pass, then a timed run
    with a different seed (seed feeds PRNG key VALUES, so no recompile)."""
    import logging
    logging.disable(logging.INFO)  # demo logs are not part of the metric
    from pyaudiolocalization_tpu.__main__ import main as demo_main
    try:
        demo_main(["--no-plots", "--seed", "0"])   # compile/cache warmup
        t0 = time.perf_counter()
        demo_main(["--no-plots", "--seed", "1"])
        return time.perf_counter() - t0
    finally:
        logging.disable(logging.NOTSET)


def bench_single_scene_latency():
    """Warm single-scene latency of physical-mode localize_sound_source
    (analyze/visualize off) INCLUDING host orchestration — the
    reference-shaped API's interactive cost (reference: 0.814 s,
    BASELINE.md row 3)."""
    import copy
    from pyaudiolocalization_tpu import localize_sound_source, DEFAULT_CONFIG

    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["signal_type"] = "noise"
    loc = cfg["localization"]
    loc.update(lag_mode="physical", sync_mode="none",
               analyze_correlation=False, visualize_correlation=False,
               max_expected_delay=0.05)

    def run(seed):
        return localize_sound_source(cfg, use_simulation=True,
                                     show_plots=False,
                                     key=jax.random.PRNGKey(seed))

    run(0)  # compile
    times = []
    for s in range(1, 6):
        t0 = time.perf_counter()
        run(s)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def bench_multi_source(batch: int = 128):
    """Two simultaneous incoherent sources per scene, localized with
    suppression SRP-PHAT over an 8-mic cube (new capability — the
    reference is strictly single-source)."""
    mics8 = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
             (0.0, 0.0, 1.0), (1.0, 1.0, 0.0), (1.0, 0.0, 1.0),
             (0.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    spec = SweepSpec(fs=16000.0, duration=0.25, signal_type="noise",
                     mic_positions=mics8, solver="srp", num_sources=2,
                     source_min_separation=0.4,
                     source_box_lo=(0.1, 0.1, 0.1),
                     source_box_hi=(0.9, 0.9, 0.9), snr_db=(20.0, 40.0))

    def step(i):
        return monte_carlo_sweep(spec, jax.random.PRNGKey(i), batch)

    dt, spread = _sweep_time(step, batch)
    return batch / dt, float(np.asarray(step(0).rmse)), spread


def bench_device_ceilings():
    """Two device ceilings measured in the same run, for reading the other
    numbers against: copy bandwidth (an in-jit lax.scan of ``rep``
    elementwise steps over a 256 MB carry — each step reads and writes the
    carry in device memory, so bytes = rep * 2 * size) and the float32
    matmul rate at HIGHEST precision (a dependent chain of (4096, 4096)
    products)."""
    size = 64 * 2 ** 20                      # elements; 256 MB float32
    rep = 8
    x = jax.random.normal(jax.random.PRNGKey(9), (size,), jnp.float32)

    @jax.jit
    def copy_step(x):
        def body(c, _):
            return c * 1.0000001, None
        y, _ = jax.lax.scan(body, x, None, length=rep)
        return y[:8].sum()

    dt = _time(copy_step, x, iters=4, warmup=2)
    copy_gbps = rep * 2.0 * size * 4 / dt / 1e9

    w = jax.random.normal(jax.random.PRNGKey(12), (4096, 4096), jnp.float32)
    a = jax.random.normal(jax.random.PRNGKey(13), (4096, 4096), jnp.float32)
    chain = 8

    @jax.jit
    def matmul_step(a, w):
        def body(c, _):
            return jnp.dot(c, w, precision=jax.lax.Precision.HIGHEST), None
        y, _ = jax.lax.scan(body, a, None, length=chain)
        return y[0, :8].sum()

    dt = _time(matmul_step, a, w, iters=4, warmup=2)
    return copy_gbps, chain * 2.0 * 4096.0 ** 3 / dt / 1e12


BASELINE_ANALYZE_RUN_S = 274.4        # BASELINE.md row 4
BASELINE_BOOTSTRAP_PAIRS_PER_SEC = 6000.0 / 258.0  # row 5: 6 pairs x 1000
BASELINE_SINGLE_SCENE_S = 0.814       # row 3 (per-scene latency)


def main():
    if jax.default_backend() != "gpu":
        print(f"bench: JAX found no GPU (default backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    from pyaudiolocalization_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    pairs_per_sec = bench_gcc_phat()
    scenes_per_sec = bench_localize()
    sweep_per_sec, sweep_rmse, sweep_spread = bench_full_sweep()
    reverb_per_sec, reverb_rmse, reverb_spread = bench_reverberant_sweep()
    multi_per_sec, multi_rmse, multi_spread = bench_multi_source()
    boot_noise_pps = bench_bootstrap(bootstrap_mode="noise", iters=8)
    boot_perm_pps = bench_bootstrap(bootstrap_mode="permutation")
    copy_gbps, matmul_tflops = bench_device_ceilings()
    latency_s = bench_single_scene_latency()
    analyze_s = bench_analyze_run()

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "gccphat_pairs_per_sec_44k1x1s",
        "value": round(pairs_per_sec, 1),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_line(),
        "extra": {
            "localize_scenes_per_sec": round(scenes_per_sec, 2),
            "localize_vs_baseline": round(
                scenes_per_sec / BASELINE_SCENES_PER_SEC, 1),
            "full_sweep_scenes_per_sec": round(sweep_per_sec, 2),
            "full_sweep_rmse_m": round(sweep_rmse, 4),
            "full_sweep_rel_spread": round(sweep_spread, 3),
            "reverb_scenes_per_sec": round(reverb_per_sec, 2),
            "reverb_rmse_m": round(reverb_rmse, 4),
            "reverb_rel_spread": round(reverb_spread, 3),
            "multi_source_scenes_per_sec": round(multi_per_sec, 2),
            "multi_source_rmse_m": round(multi_rmse, 4),
            "multi_source_rel_spread": round(multi_spread, 3),
            "bootstrap_pair_resamples_per_sec": round(boot_noise_pps, 1),
            "bootstrap_vs_baseline": round(
                boot_noise_pps / BASELINE_BOOTSTRAP_PAIRS_PER_SEC, 1),
            "bootstrap_permutation_resamples_per_sec": round(
                boot_perm_pps, 1),
            "bootstrap_permutation_vs_baseline": round(
                boot_perm_pps / BASELINE_BOOTSTRAP_PAIRS_PER_SEC, 1),
            "device_copy_gbps": round(copy_gbps, 2),
            "matmul_f32_highest_tflops": round(matmul_tflops, 2),
            "analyze_run_s": round(analyze_s, 3),
            "analyze_run_vs_baseline": round(
                BASELINE_ANALYZE_RUN_S / analyze_s, 1),
            "single_scene_latency_s": round(latency_s, 4),
            "single_scene_vs_baseline": round(
                BASELINE_SINGLE_SCENE_S / latency_s, 2),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
