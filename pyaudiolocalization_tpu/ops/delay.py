"""Fractional (sub-sample) delays via frequency-domain phase ramps.

Counterpart of ``fractional_delay`` (reference:
signal_processing.py:66-80), which FFTs to 2N, multiplies a linear phase
ramp, inverse transforms and applies ~1% linear fade-in/out ramps.  We use
rfft/irfft (identical result for real inputs — the phase ramp is Hermitian)
and additionally provide a *batched* delay-and-sum: the image-source
simulator needs the sum of many delayed, scaled copies of one base signal
per mic (reference main.py:104-118 does one FFT⁻¹ per path); since the fade
window is delay-independent and everything is linear, we sum all paths in
the frequency domain and inverse-transform once per mic.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .fftutils import next_pow2, rfft_n, irfft_n


def fade_window(num_samples: int, fraction: float = 0.01, dtype=None):
    """Linear fade-in/out ramps over the first/last ``int(fraction*N)``
    samples (signal_processing.py:75-78).  The Hann window computed at
    signal_processing.py:74 is unused in the reference — only the ramps
    apply."""
    dt = jnp.dtype(dtype) if dtype is not None else jnp.result_type(float)
    fade_length = int(fraction * num_samples)
    window = jnp.ones(num_samples, dt)
    if fade_length > 0:
        ramp = jnp.linspace(0.0, 1.0, fade_length, dtype=dt)
        window = window.at[:fade_length].mul(ramp)
        window = window.at[num_samples - fade_length:].mul(ramp[::-1])
    return window


def _phase_ramp(padded_length: int, delays: jnp.ndarray, fs: float):
    """exp(-i*2*pi*f*delay) over rfft bins of ``padded_length``; ``delays``
    may have any batch shape, output gains a trailing frequency axis."""
    freqs = jnp.fft.rfftfreq(padded_length, d=1.0 / fs)
    theta = 2 * jnp.pi * freqs * delays[..., None]
    return jax.lax.complex(jnp.cos(theta), -jnp.sin(theta))


def fractional_delay(signal: jnp.ndarray, delay, fs: float) -> jnp.ndarray:
    """Delay one 1-D signal by ``delay`` seconds; matches the reference op
    including the zero-padding to 2N and the fade ramps."""
    n = signal.shape[-1]
    padded = 2 * n
    spec = rfft_n(signal, padded)
    ramp = _phase_ramp(padded, jnp.asarray(delay, signal.dtype), fs)
    out = irfft_n(spec * ramp, padded)[..., :n]
    return out.astype(signal.dtype) * fade_window(n, dtype=signal.dtype)


def delay_and_sum(base: jnp.ndarray,
                  delays: jnp.ndarray,
                  gains: jnp.ndarray,
                  fs: float,
                  apply_fade: bool = True,
                  pad_mode: str = "exact",
                  freq_slopes: Optional[jnp.ndarray] = None,
                  freq_ref: float = 0.0) -> jnp.ndarray:
    """Batched multipath render: for each output channel m,
    ``out[m] = fade * sum_p gains[m, p] * delay(base, delays[m, p])``.

    Equivalent to the reference's per-path loop (main.py:104-118) because the
    fade window does not depend on the delay, but needs only one forward rfft
    and one irfft per channel.

    base:   (N,) real base signal (already padded to the full render length).
    delays: (M, P) seconds.
    gains:  (M, P) linear amplitude per path (0 to disable a path).
    pad_mode: 'exact' uses the reference's 2N transform length; 'pow2'
    uses next_pow2(2N) — alias-free for any delay < N samples, like
    'exact', but at a power-of-two length; 'pow2-circular' uses
    next_pow2(N), which is ~2x cheaper again but wraps circularly: the
    CALLER must guarantee max(delays)*fs fits within next_pow2(N) - support
    (the sweep's render_scene qualifies because its N already includes the
    max path-delay budget).  Only the periodic-sinc interpolation tails
    differ from the reference's 2N transform (~1e-3 waveform level).
    returns (M, N).

    ``freq_slopes`` (M, P), optional, enables frequency-dependent per-path
    absorption: each path's gain is additionally shaped per rfft bin by
    ``exp(-freq_slopes * (f - freq_ref))`` — the reference's own
    exp(-freq_coeff * f * d) attenuation term evaluated at every bin
    instead of a single carrier.  CALLER CONTRACT: reference ``gains`` at
    (or below) the band's maximum-response frequency — the simulator passes
    f=0-referenced gains with ``freq_ref=0.0`` so the exponent argument is
    always <= 0 (underflow-to-0 is the physically correct "bin fully
    absorbed" limit and is f32-FTZ-safe; no overflow is possible).  For
    other references the exponent is clamped to an exp-safe value so that
    dead paths (gain 0, finite slope — the simulator keeps rejected paths'
    slopes) stay exactly 0 instead of 0 * inf = NaN.
    """
    n = base.shape[-1]
    if pad_mode == "exact":
        padded = 2 * n
    elif pad_mode == "pow2":
        padded = next_pow2(2 * n)
    elif pad_mode == "pow2-circular":
        padded = next_pow2(n)
    else:
        raise ValueError(
            f"pad_mode must be 'exact', 'pow2' or 'pow2-circular', got "
            f"{pad_mode!r}")
    spec = rfft_n(base, padded)                              # (F,)
    ramps = _phase_ramp(padded, delays.astype(base.dtype), fs)  # (M, P, F)
    if freq_slopes is None:
        mixed = jnp.einsum("mp,mpf->mf", gains.astype(ramps.real.dtype),
                           ramps) * spec
    else:
        freqs = jnp.fft.rfftfreq(padded, d=1.0 / fs).astype(base.dtype)
        # Per-bin shaping exp(-slope * (f - freq_ref)).  Bins above the
        # reference underflow to 0 = "fully absorbed" (f32-FTZ-safe); bins
        # BELOW it have a positive argument, so clamp to an exp-safe value:
        # dead paths carry gain 0 with a finite slope, and an unclamped
        # overflow would make them 0 * inf = NaN (the simulator references
        # gains at f=0 so the argument is <= 0 and the clamp never binds).
        arg = (-freq_slopes.astype(base.dtype)[..., None]
               * (freqs - jnp.asarray(freq_ref, base.dtype)))
        max_arg = float(np.log(np.finfo(jnp.dtype(base.dtype)).max)) - 8.0
        shaped = (gains.astype(base.dtype)[..., None]
                  * jnp.exp(jnp.minimum(arg, max_arg)))
        mixed = jnp.einsum("mpf,mpf->mf", shaped.astype(ramps.real.dtype),
                           ramps) * spec
    out = irfft_n(mixed, padded)[..., :n].astype(base.dtype)
    if apply_fade:
        out = out * fade_window(n, dtype=base.dtype)[None, :]
    return out
