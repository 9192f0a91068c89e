"""Multipath scene simulator: one frequency-domain render per mic.

Counterpart of ``simulate_signals_with_multipath`` (reference:
main.py:66-124), which loops fractional_delay per (mic, path) — one 2N FFT
pair per path.  Here all paths render as phase ramps against a single base
spectrum and sum in the frequency domain (ops/delay.delay_and_sum), then
per-mic normalize + compress, matching the reference's output bit-for-fp.

Two entry points:
  * ``render_scene`` — fully jitted, static total_samples, masked paths;
    vmappable over scene batches for the Monte-Carlo sweep.
  * ``simulate_signals`` — host wrapper with the reference's data-dependent
    padding rule total = int((duration + max_delay)*fs) for concrete scenes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import signal as sig_ops
from ..ops.delay import delay_and_sum
from ..utils.devcache import dev_const
from . import acoustics

AIR_ID = 0  # MaterialTable guarantees the fallback material at row 0.


class ScenePaths(NamedTuple):
    delays: jnp.ndarray   # (M, 1 + I) seconds; column 0 = direct path
    gains: jnp.ndarray    # (M, 1 + I) attenuation * acceptance mask


# float64's smallest normal is ~2.2e-308; a channel whose strongest path is
# below that is all-zero for the float64 reference too (normalize passes
# silent signals through, signal_processing.py:82-86).
_F64_LOG_TINY = -708.0


def scene_paths(source: jnp.ndarray,
                mic_positions: jnp.ndarray,
                c,
                frequency,
                images: acoustics.ImageSources,
                absorption_table: jnp.ndarray,
                freq_table: jnp.ndarray) -> ScenePaths:
    """Delay/gain matrix for the direct path + every (masked) image source
    (reference main.py:104-118 semantics: direct uses 'air', each image its
    plane's material).

    Gains are computed in LOG space and rescaled per mic so the strongest
    path has gain 1: the reference's default materials give attenuations of
    ~exp(-90) (SURVEY.md Q2) that flush to zero in float32 and silence whole
    channels; its float64 NumPy survives only because per-mic normalization
    (main.py:121) rescales ~1e-40 waveforms afterwards.  Per-mic rescaling
    before the render is mathematically identical after that normalization,
    and exact in float32.  Channels whose strongest path underflows even
    float64 stay zero, matching the reference's observable output.
    """
    d_direct = jnp.linalg.norm(source[None, :] - mic_positions, axis=-1)  # (M,)
    la_direct = acoustics.log_attenuation(
        d_direct, AIR_ID, frequency, absorption_table, freq_table)
    if images.positions.shape[0] == 0:
        la_all = la_direct[:, None]
        delays = d_direct[:, None] / c
    else:
        d_img = jnp.linalg.norm(
            images.positions[None, :, :] - mic_positions[:, None, :], axis=-1)
        la_img = acoustics.log_attenuation(
            d_img, images.material_ids[None, :], frequency,
            absorption_table, freq_table)
        la_img = jnp.where(images.accepted[None, :], la_img, -jnp.inf)
        la_all = jnp.concatenate([la_direct[:, None], la_img], 1)  # (M, 1+I)
        delays = jnp.concatenate([d_direct[:, None], d_img], 1) / c
    ref = jnp.max(la_all, axis=1, keepdims=True)                   # (M, 1)
    alive = ref > _F64_LOG_TINY
    gains = jnp.where(jnp.isfinite(la_all),
                      jnp.exp(la_all - jnp.where(alive, ref, 0.0)), 0.0)
    return ScenePaths(delays, jnp.where(alive, gains, 0.0))


def scene_path_slopes(source: jnp.ndarray,
                      mic_positions: jnp.ndarray,
                      images: acoustics.ImageSources,
                      freq_table: jnp.ndarray) -> jnp.ndarray:
    """Per-path log-gain frequency slopes (M, 1 + I) for per-bin absorption
    rendering (acoustics.attenuation_freq_slope): direct path uses 'air',
    each image its plane's material — the same material assignment as
    scene_paths.  Rejected paths keep their finite slope; their gain is
    already 0."""
    d_direct = jnp.linalg.norm(source[None, :] - mic_positions, axis=-1)
    s_direct = acoustics.attenuation_freq_slope(d_direct, AIR_ID, freq_table)
    if images.positions.shape[0] == 0:
        return s_direct[:, None]
    d_img = jnp.linalg.norm(
        images.positions[None, :, :] - mic_positions[:, None, :], axis=-1)
    s_img = acoustics.attenuation_freq_slope(
        d_img, images.material_ids[None, :], freq_table)
    return jnp.concatenate([s_direct[:, None], s_img], 1)


@functools.partial(jax.jit, static_argnames=("total_samples", "out_samples",
                                              "pad_mode", "finalize"))
def render_scene(base_signal: jnp.ndarray,
                 paths_delays: jnp.ndarray,
                 paths_gains: jnp.ndarray,
                 fs: float,
                 total_samples: int,
                 out_samples: int,
                 pad_mode: str = "exact",
                 finalize: bool = True,
                 snr_db=None,
                 noise_key=None,
                 freq_slopes=None,
                 freq_ref=0.0) -> jnp.ndarray:
    """Render (M, out_samples) mic signals: pad base to total_samples
    (main.py:102-103), delay-and-sum all paths, trim (main.py:119-120),
    normalize + compress per mic (main.py:121-122).

    ``finalize=False`` skips the per-mic normalize+compress and returns the
    raw linear mixture — used by the multi-source sweep, which sums the raw
    renders of several simultaneous sources before normalizing once (the
    reference is strictly single-source, main.py:66-124).

    ``snr_db`` (scalar, with ``noise_key``) additionally adds white
    measurement noise at that per-mic SNR after finalization
    (``jax.random.normal`` from ``noise_key``).

    ``freq_slopes`` (M, P) with ``freq_ref`` enables frequency-dependent
    per-path absorption (ops/delay.delay_and_sum)."""
    if snr_db is not None and noise_key is None:
        raise ValueError("snr_db requires noise_key")
    padded = jnp.zeros(total_samples, base_signal.dtype).at[
        : base_signal.shape[0]].set(base_signal)
    # render_scene's 'pow2' contract is circular-safe by construction:
    # total_samples already includes the max path-delay budget, so the
    # cheaper next_pow2(total_samples) transform cannot wrap active paths.
    sigs = delay_and_sum(
        padded, paths_delays, paths_gains, fs,
        pad_mode="pow2-circular" if pad_mode == "pow2" else pad_mode,
        freq_slopes=freq_slopes, freq_ref=freq_ref)
    sigs = sigs[:, :out_samples]
    if finalize:
        sigs = sig_ops.dynamic_range_compression(
            sig_ops.normalize_signal(sigs))
    if snr_db is not None:
        rms = jnp.sqrt(jnp.mean(sigs * sigs, -1, keepdims=True))
        sigma = rms * 10.0 ** (-jnp.asarray(snr_db, sigs.dtype) / 20.0)
        sigs = sigs + sigma * jax.random.normal(noise_key, sigs.shape,
                                                sigs.dtype)
    return sigs


def _check_per_bin_coefficients(freq_table, plane_material_ids,
                                fs: float) -> None:
    """Warn when per-bin rendering meets reference-Q2-scale frequency
    coefficients.  The reference table's per-Hz values (air 0.1, wood 0.8 —
    materials.py:3-17, SURVEY.md Q2) give exp(-0.1*f*d) ~ exp(-400) across
    an audio band: survivable in carrier mode (a per-path SCALAR that
    per-mic normalization rescales) but, evaluated per bin, they annihilate
    everything above near-DC.  The render stays well-defined (absorbed bins
    underflow to exactly 0) — but the result is almost certainly not what
    the user wants, so say so.  Physically-scaled coefficients are ~1e-6
    (air) to ~1e-3 (very absorbent walls) per Hz*m.  Only materials the
    scene actually uses count: the direct path's row 0 ('air') plus the
    planes' — users who register sane materials (README) must not be warned
    about unused defaults."""
    table = np.asarray(freq_table)
    if not table.size:
        return
    used = np.unique(np.concatenate(
        [[0], np.asarray(plane_material_ids, np.int64).ravel()]))
    worst = float(np.max(table[used])) * (fs / 2.0)
    if worst > 50.0:
        import warnings
        warnings.warn(
            "absorption_mode='per-bin' with frequency coefficients that "
            f"absorb the band ~exp(-{worst:.0f}) at Nyquist per metre: the "
            "default material table keeps the reference's per-Hz values "
            "(air 0.1, wood 0.8), which only make sense as carrier-mode "
            "scalars.  Per-bin rendering expects physically-scaled "
            "coefficients (~1e-6..1e-3 per Hz*m); most of the band will "
            "render as exact zeros otherwise.", stacklevel=3)


@functools.partial(jax.jit,
                   static_argnames=("max_reflections", "absorption_threshold",
                                    "per_bin"))
def _scene_geometry(source, mics, plane_coeffs, plane_material_ids,
                    absorption_table, freq_table, freq, c, *,
                    max_reflections: int, absorption_threshold: float,
                    per_bin: bool = False):
    """Image sources + path delays/gains + the reference's max active path
    delay (main.py:93-101) in ONE device call instead of one dispatch per
    eager op.

    ``per_bin=True`` references the gains at f=0 (geometric spreading +
    scalar absorption only, i.e. log_attenuation evaluated at frequency 0)
    for per-bin rendering: the render then applies the absolute law
    exp(-slope * f) per rfft bin, whose exponent is always <= 0 — no f32
    overflow/NaN hazard, and relative path weights AT the carrier bin equal
    the carrier-mode weights exactly (both differ only by a per-mic common
    scale that the per-mic normalization removes).  Image-source ACCEPTANCE
    stays thresholded at the carrier either way (the reference's culling
    rule, utils.py:90-106)."""
    images = acoustics.image_sources(
        source, plane_coeffs, plane_material_ids, mics, freq,
        absorption_table, freq_table, max_reflections, absorption_threshold)
    gain_freq = jnp.zeros_like(freq) if per_bin else freq
    paths = scene_paths(source, mics, c, gain_freq, images,
                        absorption_table, freq_table)
    slopes = scene_path_slopes(source, mics, images, freq_table)
    m = mics.shape[0]
    if images.positions.shape[0]:
        active = jnp.concatenate(
            [jnp.ones((m, 1), bool),
             jnp.broadcast_to(images.accepted[None, :],
                              (m, images.accepted.shape[0]))], 1)
    else:
        active = jnp.ones((m, 1), bool)
    active = active[:, : paths.delays.shape[1]]
    max_delay = jnp.max(jnp.where(active, paths.delays, 0.0))
    return paths.delays, paths.gains, slopes, max_delay


@functools.partial(jax.jit,
                   static_argnames=("signal_type", "fs", "duration", "dtype"))
def _base_signal(key, freq, *, signal_type: str, fs: float, duration: float,
                 dtype):
    return sig_ops.generate_signal(signal_type, fs, duration, freq, key=key,
                                   dtype=dtype)


def simulate_signals(source_pos,
                     mic_positions,
                     fs: float,
                     c: float,
                     duration: float = 1.0,
                     signal_type: str = "sine",
                     freq: float = 1000.0,
                     plane_coeffs=None,
                     plane_material_ids=None,
                     absorption_table=None,
                     freq_table=None,
                     max_reflections: int = 2,
                     absorption_threshold: float = 0.01,
                     trim_to_duration: bool = True,
                     key: Optional[jax.Array] = None,
                     dtype=None,
                     absorption_mode: str = "carrier") -> jnp.ndarray:
    """Host-level scene simulation with the reference's concrete padding
    rule.  Returns (M, samples).

    ``absorption_mode``: 'carrier' (default) evaluates the attenuation law
    at the single carrier ``freq`` — the reference's semantics
    (utils.py:50-65 via main.py:104-118); 'per-bin' evaluates the same
    exp(-freq_coeff * f * d) term at every rfft bin (the ABSOLUTE law
    exp(-slope * f), gains referenced at f=0 — see _scene_geometry), so
    reflections off high-``freq``-coefficient materials lose treble
    relative to the direct path (image-source ACCEPTANCE stays
    carrier-thresholded, matching the reference's culling rule).
    Physical-mode extension — parity callers keep 'carrier'; expects
    physically-scaled frequency coefficients (warns on reference-Q2-scale
    tables, see _check_per_bin_coefficients)."""
    if absorption_mode not in ("carrier", "per-bin"):
        raise ValueError("absorption_mode must be 'carrier' or 'per-bin'")
    dt = jnp.dtype(dtype) if dtype is not None else jnp.result_type(float)
    source = jnp.asarray(np.asarray(source_pos), dt)
    mics = jnp.asarray(np.asarray(mic_positions), dt)
    if plane_coeffs is None or np.asarray(plane_coeffs).size == 0:
        plane_coeffs = jnp.zeros((0, 4), dt)
        plane_material_ids = jnp.zeros((0,), jnp.int32)
    else:
        plane_coeffs = jnp.asarray(np.asarray(plane_coeffs), dt)
        plane_material_ids = jnp.asarray(np.asarray(plane_material_ids), jnp.int32)
    if absorption_table is None:
        from ..utils.materials import default_table
        table = default_table()
        absorption_table = jnp.asarray(table.absorption, dt)
        freq_table = jnp.asarray(table.freq, dt)

    if key is None:
        key = jax.random.PRNGKey(0)
    per_bin = absorption_mode == "per-bin"
    if per_bin:
        _check_per_bin_coefficients(freq_table, plane_material_ids, fs)
    base = _base_signal(key, jnp.asarray(freq, dt), signal_type=signal_type,
                        fs=fs, duration=duration, dtype=dt)
    path_delays, path_gains, path_slopes, max_delay_dev = _scene_geometry(
        source, mics, plane_coeffs, plane_material_ids,
        absorption_table, freq_table, jnp.asarray(freq, dt),
        jnp.asarray(c, dt), max_reflections=max_reflections,
        absorption_threshold=absorption_threshold, per_bin=per_bin)

    # Reference padding rule (main.py:93-103): max delay over *accepted*
    # image sources and the direct path — data-dependent, so ONE scalar
    # fetch resolves the concrete render length on the host.
    max_delay = float(max_delay_dev)
    total_samples = int((duration + max_delay) * fs)
    out_samples = int(duration * fs) if trim_to_duration else total_samples
    return render_scene(base, path_delays, path_gains, fs,
                        total_samples, out_samples,
                        freq_slopes=path_slopes if per_bin else None,
                        freq_ref=0.0)


def simulate_moving_source(start_pos,
                           velocity,
                           mic_positions,
                           fs: float,
                           c: float,
                           duration: float = 1.0,
                           signal_type: str = "noise",
                           freq: float = 1000.0,
                           frame: int = 1024,
                           key: Optional[jax.Array] = None,
                           snr_db=None,
                           finalize: bool = True,
                           absorption: float = 0.01,
                           freq_slope: float = 1e-6,
                           dtype=None) -> jnp.ndarray:
    """Render (M, duration*fs) mic signals for a source moving at constant
    velocity — the time-varying-delay counterpart of ``simulate_signals``
    (no reference counterpart: the reference renders one static scene,
    main.py:66-124).

    The render is WOLA (weighted overlap-add): the base signal is split
    into Hann-windowed frames of ``frame`` samples hopped by frame/2; each
    frame renders with the STATIC per-mic delay/gain of the source position
    at its centre (the same phase-ramp render as the static path,
    ops/delay.delay_and_sum), and the delayed frames overlap-add.  The
    per-frame delay error is bounded by |d tau/dt| * frame/2 samples —
    at walking speed (1.5 m/s, 16 kHz, frame=1024) about 2 samples of
    intra-frame smear, the same physical smear a real moving source puts
    into any frame-based analysis.  Direct path only: image sources of a
    moving source move along per-plane MIRRORED trajectories, so a
    reverberant mover is a sum of such renders — out of scope here.

    Per-mic gains follow the carrier-frequency log-attenuation law
    (geometric spreading + ``absorption``·d + ``freq_slope``·freq·d air
    loss per meter), referenced to the strongest (mic, frame) so float32
    cannot flush the render.  The defaults are PHYSICAL air (the same
    coefficients the physical-mode test scenes pass to
    ``simulate_signals_fast``) — NOT the reference-parity material table:
    its 'air' row carries the reference's defective freq coefficient 0.1
    (SURVEY.md Q2 — e^{-0.1·f·d}), which under this render's GLOBAL gain
    reference silences every mic ~0.2 m farther than the closest one
    within a fraction of a second of motion (found 2026-08-20: two-mover
    captures degenerated to single-mic-audible scenes and multi-source
    detection 'drowned' at ~0.9 m error; the static parity path survives
    the same table only because the reference normalizes PER MIC).

    Used by tests/test_tracking_motion.py to show segment-static tracking
    bias vs the motion-compensated tracker (models/tracking.py
    ``motion='compensated'``)."""
    dt = jnp.dtype(dtype) if dtype is not None else jnp.result_type(float)
    start = jnp.asarray(np.asarray(start_pos), dt)
    vel = jnp.asarray(np.asarray(velocity), dt)
    mics = jnp.asarray(np.asarray(mic_positions), dt)
    if key is None:
        key = jax.random.PRNGKey(0)
    if frame < 64 or frame % 2:
        raise ValueError("frame must be an even length >= 64")
    hop = frame // 2
    # Conservative host-side delay budget: |p(t) - mic| is convex in t, so
    # its max over the capture sits at an endpoint (padded by one second of
    # travel to cover the lead/tail margin below).
    s0 = np.asarray(start_pos, float)
    v0 = np.asarray(velocity, float)
    mics_np = np.asarray(mic_positions, float)
    d_ends = [np.linalg.norm(s0 + tt * v0 - mics_np, axis=-1)
              for tt in (-1.0, float(duration) + 1.0)]
    budget = int(np.ceil(float(np.max(d_ends)) / float(c) * fs)) + 2

    # Lead/tail margin: the WOLA sum only reaches steady state (window sum
    # exactly 1, every sample covered by two frames) one frame in, and the
    # fade regions have per-mic-misaligned envelopes that degrade inter-mic
    # coherence.  Content at output time t arrives delayed by up to
    # ``budget`` samples, so the margin must absorb the delay too: render
    # [0, duration) + 2*(frame + budget) of extra signal and slice out the
    # steady-state interior.  ``start_pos`` is the source position at the
    # first OUTPUT sample.
    lead = frame + budget
    if lead > int(fs):
        raise ValueError("scene too distant for the moving render: the "
                         "propagation delay budget exceeds 1 s")
    base = _base_signal(key, jnp.asarray(freq, dt), signal_type=signal_type,
                        fs=fs, duration=duration + 2.0 * lead / fs, dtype=dt)
    t_gen = base.shape[0]
    t_out = t_gen - 2 * lead
    num_frames = max(1, -(-t_gen // hop))
    pad_base = jnp.pad(base, (0, num_frames * hop + frame - t_gen))

    # Periodic Hann: with 50% overlap the interior window sum is exactly 1;
    # the start/end fade regions fall in the lead/tail margin and are
    # sliced away.
    n_idx = jnp.arange(frame, dtype=dt)
    win = 0.5 * (1.0 - jnp.cos(2.0 * jnp.pi * n_idx / frame))

    starts = np.arange(num_frames) * hop
    frames = jnp.stack([pad_base[s:s + frame] for s in starts]) * win

    # Per-frame source position at the frame centre (generated time starts
    # ``lead`` samples before the first output sample).
    t_c = jnp.asarray((starts + frame / 2.0 - lead) / fs, dt)     # (K,)
    pos_k = start[None, :] + t_c[:, None] * vel[None, :]          # (K, 3)
    d_k = jnp.linalg.norm(pos_k[:, None, :] - mics[None, :, :],
                          axis=-1)                                # (K, M)
    la = acoustics.log_attenuation(
        d_k, AIR_ID, jnp.asarray(freq, dt),
        jnp.asarray([absorption], dt), jnp.asarray([freq_slope], dt))
    gains = jnp.exp(la - jnp.max(la))                             # (K, M)
    delays = d_k / c

    total = frame + budget

    def render_frame(xk, dk, gk):
        padded = jnp.pad(xk, (0, total - frame))
        return delay_and_sum(padded, dk[:, None], gk[:, None], fs,
                             pad_mode="pow2-circular")
    rendered = jax.vmap(render_frame)(frames, delays, gains)      # (K, M, T)

    m = mics.shape[0]
    t_full = int(starts[-1]) + total
    out = jnp.zeros((m, t_full), dt)
    wsum = jnp.zeros((t_full,), dt)
    for k, s in enumerate(starts):
        out = out + jnp.pad(rendered[k], ((0, 0), (s, t_full - s - total)))
        wsum = wsum + jnp.pad(win, (s, t_full - s - frame))
    # Slice the steady-state interior (see the lead/tail note above); the
    # wsum division is an exact identity there and only guards the slice
    # arithmetic.
    out = (out[:, lead:lead + t_out]
           / jnp.maximum(wsum[lead:lead + t_out], 1e-3))

    if finalize:
        out = sig_ops.dynamic_range_compression(
            sig_ops.normalize_signal(out))
    if snr_db is not None:
        rms = jnp.sqrt(jnp.mean(out * out, -1, keepdims=True))
        sigma = rms * 10.0 ** (-jnp.asarray(snr_db, dt) / 20.0)
        out = out + sigma * jax.random.normal(
            jax.random.fold_in(key, 1), out.shape, dt)
    return out


def static_delay_budget(source_pos, mic_positions, plane_coeffs,
                        max_reflections: int, fs: float) -> float:
    """Conservative HOST-side bound on the longest path delay (s), no
    device sync: scene diameter plus one plane-mirror "reach" per
    reflection order (mirrors parallel/sweep.SweepSpec.delay_budget with a
    point source)."""
    pts = np.vstack([np.asarray(mic_positions, float).reshape(-1, 3),
                     np.asarray(source_pos, float).reshape(1, 3)])
    diam = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    reach = 0.0
    coeffs = np.asarray(plane_coeffs, float).reshape(-1, 4)
    for row in coeffs:
        n = row[:3]
        nn = max(float(np.linalg.norm(n)), 1e-9)
        # Mirror reach must be measured from the SCENE to the plane, not
        # from the origin: a plane through the origin (d=0) far from an
        # offset scene still doubles the scene->plane distance per bounce.
        dist = float(np.max(np.abs(pts @ n + row[3]))) / nn
        reach = max(reach, 2.0 * dist + 2.0 * diam)
    return (diam + max_reflections * reach) / 300.0 + 1.0 / fs


@functools.partial(jax.jit,
                   static_argnames=("signal_type", "fs", "duration", "dtype",
                                    "max_reflections", "absorption_threshold",
                                    "per_bin", "total_samples",
                                    "out_samples"))
def _simulate_fast_core(source, mics, plane_coeffs, plane_material_ids,
                        absorption_table, freq_table, freq, c, key, *,
                        signal_type: str, fs: float, duration: float, dtype,
                        max_reflections: int, absorption_threshold: float,
                        per_bin: bool, total_samples: int, out_samples: int):
    """Base signal + scene geometry + render in ONE jitted graph: the
    single-scene warm latency pays one dispatch per device call, so the
    three stages trace together here (the nested jits inline under this
    trace)."""
    base = sig_ops.generate_signal(signal_type, fs, duration, freq, key=key,
                                   dtype=dtype)
    path_delays, path_gains, path_slopes, _ = _scene_geometry(
        source, mics, plane_coeffs, plane_material_ids,
        absorption_table, freq_table, freq, c,
        max_reflections=max_reflections,
        absorption_threshold=absorption_threshold, per_bin=per_bin)
    return render_scene(base, path_delays, path_gains, fs,
                        total_samples, out_samples, pad_mode="pow2",
                        freq_slopes=path_slopes if per_bin else None,
                        freq_ref=0.0)


def simulate_signals_fast(source_pos,
                          mic_positions,
                          fs: float,
                          c: float,
                          duration: float,
                          signal_type: str,
                          freq: float,
                          plane_coeffs,
                          plane_material_ids,
                          absorption_table,
                          freq_table,
                          max_reflections: int,
                          absorption_threshold: float,
                          key: jax.Array,
                          dtype=None,
                          absorption_mode: str = "carrier") -> jnp.ndarray:
    """Physical-mode scene simulation: same geometry/paths as
    ``simulate_signals`` but rendered at a STATIC power-of-two length from a
    conservative host-side delay budget — no per-call device sync for the
    data-dependent max path delay (waveforms differ from the reference's
    exact-2N transform only in the periodic-sinc interpolation tails, ~1e-3 —
    see ops/delay.delay_and_sum).  Reference-parity callers must keep
    ``simulate_signals``."""
    dt = jnp.dtype(dtype) if dtype is not None else jnp.result_type(float)
    # dev_const: each eager upload is a host-to-device copy plus a
    # dispatch; the warm single-scene path re-ships the same geometry/
    # material constants every call (utils/devcache — content-keyed,
    # value-identical).
    source = dev_const(np.asarray(source_pos), dt)
    mics = dev_const(np.asarray(mic_positions), dt)
    if plane_coeffs is None or np.asarray(plane_coeffs).size == 0:
        plane_np = np.zeros((0, 4))
        plane_coeffs = dev_const(plane_np, dt)
        plane_material_ids = dev_const(np.zeros((0,)), jnp.int32)
    else:
        plane_np = np.asarray(plane_coeffs, float)
        plane_coeffs = dev_const(plane_np, dt)
        plane_material_ids = dev_const(np.asarray(plane_material_ids),
                                       jnp.int32)
    if absorption_mode not in ("carrier", "per-bin"):
        raise ValueError("absorption_mode must be 'carrier' or 'per-bin'")
    per_bin = absorption_mode == "per-bin"
    if per_bin:
        _check_per_bin_coefficients(freq_table, plane_material_ids, fs)
    budget = static_delay_budget(np.asarray(source_pos), mic_positions,
                                 plane_np, max_reflections, fs)
    out_samples = int(duration * fs)
    total_samples = out_samples + int(np.ceil(budget * fs))
    return _simulate_fast_core(
        source, mics, plane_coeffs, plane_material_ids,
        dev_const(absorption_table, dt), dev_const(freq_table, dt),
        dev_const(freq, dt), dev_const(c, dt), key,
        signal_type=signal_type, fs=fs, duration=duration, dtype=dt,
        max_reflections=max_reflections,
        absorption_threshold=absorption_threshold, per_bin=per_bin,
        total_samples=total_samples, out_samples=out_samples)
