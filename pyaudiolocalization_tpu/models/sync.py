"""Signal synchronization before TDOA estimation.

Counterpart of ``synchronize_signals_improved`` (reference: utils.py:407-457):
align every signal to the highest-energy one by full cross-correlation with
cubic-spline sub-sample refinement, gated by a 0.3x-autocorrelation peak
check and a 50 ms plausibility window, then pad-align.

SURVEY.md Q4: this step *cancels the TDOAs* the pipeline then measures; it
is part of the reference's observable behavior, so sync_mode='reference'
reproduces it and sync_mode='none' (the physically sane choice) skips it.

Design: ALL numerics — energies, the (M, 2N-1) correlation batch, peak
picking, spline refinement, the confidence/plausibility gates — run in one
jitted call; exactly one scalar batch crosses back to the host (the per-mic
shifts), which then drives the data-dependent pad-align (a per-signal
host loop would pay a device round trip per signal).
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.interp import refine_peak_cubic
from .calibration import full_cross_correlation


@functools.partial(jax.jit, static_argnames=("fs", "use_interpolation"))
def _sync_shifts(signals: jnp.ndarray, fs: float,
                 use_interpolation: bool) -> jnp.ndarray:
    """Per-signal shifts (samples, float) vs the highest-energy reference.

    signals: (M, N) — equal length (callers zero-pad; trailing zeros extend
    the correlation but leave peak positions and the lag origin unchanged).
    """
    m, n = signals.shape
    energies = jnp.sum(signals * signals, -1)
    ref_idx = jnp.argmax(energies)
    reference = jnp.take(signals, ref_idx, axis=0)

    corr = full_cross_correlation(signals, reference)      # (M, 2N-1)
    abs_corr = jnp.abs(corr)
    peak_idx = jnp.argmax(abs_corr, -1)
    peak_val = jnp.take_along_axis(abs_corr, peak_idx[:, None], -1)[:, 0]
    ref_peak = peak_val[ref_idx]  # autocorrelation peak of the reference

    if use_interpolation:
        def refine(row, idx):
            window = jax.lax.dynamic_slice(row, (idx - 2,), (5,))
            return refine_peak_cubic(window, idx.astype(row.dtype))

        interior = (peak_idx > 1) & (peak_idx < corr.shape[-1] - 2)
        safe_idx = jnp.clip(peak_idx, 2, corr.shape[-1] - 3)
        refined = jax.vmap(refine)(corr, safe_idx)
        confident = peak_val >= 0.3 * ref_peak             # utils.py:428-430
        refined = jnp.where(confident & interior, refined,
                            peak_idx.astype(corr.dtype))
    else:
        refined = peak_idx.astype(corr.dtype)

    shift = refined - (n - 1)
    max_shift = fs * 0.05                                  # utils.py:421
    shift = jnp.where(jnp.abs(shift) > max_shift, 0.0, shift)
    return shift.at[ref_idx].set(0.0)


def synchronize_signals(signals, fs: float, use_interpolation: bool = True):
    """Behavior-port of utils.py:407-457 over a list/stack of equal- or
    unequal-length 1-D signals.  Returns a list of jnp arrays."""
    signals = [jnp.asarray(s) for s in signals]
    max_in = max(s.shape[-1] for s in signals)
    stacked = jnp.stack([jnp.pad(s, (0, max_in - s.shape[-1]))
                         for s in signals])
    shifts = np.asarray(_sync_shifts(stacked, fs, use_interpolation))

    min_shift = float(shifts.min())
    adjusted = []
    for sig, shift in zip(signals, shifts.tolist()):
        pad_left = max(0, int(round(shift - min_shift)))
        adjusted.append(jnp.pad(sig, (pad_left, 0)))
    max_len = max(s.shape[-1] for s in adjusted)
    return [jnp.pad(s, (0, max_len - s.shape[-1])) for s in adjusted]
