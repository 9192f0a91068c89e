"""Capon / MVDR (minimum-variance distortionless response) localization.

No reference counterpart — completes the classic narrowband estimator trio
alongside the Bartlett scan (models/beamformer.py) and MUSIC
(models/music.py):

    P_capon(x) = 1 / (a(x)^H R^-1 a(x))

The adaptive weights R^-1 a minimize output power subject to unit gain at
the steered point, so a LOUD interferer elsewhere is nulled instead of
leaking through sidelobes: where the Bartlett map shows only the dominant
emitter plus its sidelobe skirt, the Capon map keeps a distinct peak at a
10x-weaker same-band target.  Resolution sits between Bartlett and MUSIC;
unlike MUSIC it needs no source-count estimate (no subspace split) — the
better default when ``num_sources`` is unknown.

Shape (same toolbox as the siblings):

  * snapshot covariances and steering stay in the REAL 2Mx2M embedding
    (models/music.py helpers) — inverses embed the complex inverses, and
    the quadratic form a^H R^-1 a equals the embedded form exactly, so no
    complex linear algebra anywhere;
  * diagonal loading R + loading * (tr(R)/2M) * I guarantees
    invertibility at any snapshot count and bounds the white-noise-gain
    loss (standard robust-Capon practice);
  * one batched (B, 2M, 2M) inverse per selected bin, then the grid scan
    is a single einsum; coarse->fine search and multi-source suppression
    reuse models/srp.py's shared machinery.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .beamformer import select_bins
from .music import (embedded_covariances, embedded_steering,
                    refine_bin_freqs, snapshot_frames)
from .srp import suppressed_multi_search, two_stage_search


class CaponResult(NamedTuple):
    position: jnp.ndarray    # (..., 3)
    power: jnp.ndarray       # (...,) Capon spectrum value at the estimate
    coarse: jnp.ndarray      # (..., 3) stage-1 cell center (diagnostics)


class MultiCaponResult(NamedTuple):
    positions: jnp.ndarray   # (..., K, 3) descending coarse power
    powers: jnp.ndarray      # (..., K) fine-stage Capon spectrum values


def loaded_inverse(cov: jnp.ndarray, loading: float) -> jnp.ndarray:
    """Inverse of the diagonally-loaded embedded covariance(s).

    cov: (..., 2M, 2M) real embeddings (music.embed_planes).  Loading is
    relative to the mean eigenvalue (trace/2M), floored at an
    f32-representable tiny so an all-zero covariance (digital silence)
    inverts to a huge-but-finite matrix instead of NaN-poisoning the map.
    Shared by the batch Capon path and the streaming 'capon' method so the
    loading convention cannot drift between them."""
    two_m = cov.shape[-1]
    tr = jnp.trace(cov, axis1=-2, axis2=-1) / two_m         # (...,)
    tr = jnp.maximum(tr, jnp.asarray(1e-30, cov.dtype))
    eye = jnp.eye(two_m, dtype=cov.dtype)
    return jnp.linalg.inv(cov + loading * tr[..., None, None] * eye)


def _loaded_inverses(snaps: jnp.ndarray, bin_idx: jnp.ndarray,
                     loading: float) -> jnp.ndarray:
    """(B, 2M, 2M) inverses of the diagonally-loaded embedded covariances."""
    return loaded_inverse(embedded_covariances(snaps, bin_idx), loading)


def capon_map_bins(cov_inv: jnp.ndarray, omega: jnp.ndarray,
                   points: jnp.ndarray, mic_positions: jnp.ndarray,
                   c) -> jnp.ndarray:
    """Per-bin Capon/MVDR spectra: (G, B), one column per selected bin
    (``capon_map`` is the bin-weighted sum).  The MVDR output scales with
    the source power in the bin, so per-bin peak normalization is what
    lets a 30 dB-weaker emitter's peak compete (see music.music_map_bins
    and models/online.py)."""
    a_emb = embedded_steering(points, mic_positions, omega, c)  # (G, 2M, B)
    q = jnp.einsum("gmb,bmn,gnb->gb", a_emb, cov_inv, a_emb)    # (G, B)
    return 1.0 / jnp.maximum(q, 1e-30)


def capon_map(cov_inv: jnp.ndarray, omega: jnp.ndarray, bin_w: jnp.ndarray,
              points: jnp.ndarray, mic_positions: jnp.ndarray,
              c) -> jnp.ndarray:
    """Capon spectrum for each candidate point.

    cov_inv: (B, 2M, 2M) loaded embedded inverses; omega: (B,) rad/s;
    points: (G, 3).  Returns (G,): sum_b w_b / (a^H R_b^-1 a) — the
    embedded quadratic form equals the complex one exactly."""
    per_bin = capon_map_bins(cov_inv, omega, points, mic_positions, c)
    return jnp.sum(bin_w[None, :] * per_bin, axis=-1)


def capon_locate(signals: jnp.ndarray,
                 mic_positions: jnp.ndarray,
                 fs: float,
                 c,
                 lower: jnp.ndarray,
                 upper: jnp.ndarray,
                 frame: int = 256,
                 hop: Optional[int] = None,
                 num_bins: int = 8,
                 band: Optional[Tuple[float, float]] = None,
                 loading: float = 1e-3,
                 coarse_n: int = 24,
                 fine_n: int = 12) -> CaponResult:
    """Two-stage Capon/MVDR grid search over the box [lower, upper].

    signals: (M, N) time-domain mic signals.  ``loading`` is the diagonal
    loading fraction (relative to the mean covariance eigenvalue)."""
    return _capon_locate_jit(
        signals, mic_positions, c, lower, upper, fs=float(fs), frame=frame,
        hop=hop, num_bins=num_bins, band=band, loading=float(loading),
        coarse_n=coarse_n, fine_n=fine_n)


@functools.partial(jax.jit, static_argnames=(
    "fs", "frame", "hop", "num_bins", "band", "loading", "coarse_n",
    "fine_n"))
def _capon_locate_jit(signals, mic_positions, c, lower, upper, *, fs, frame,
                      hop, num_bins, band, loading, coarse_n,
                      fine_n) -> CaponResult:
    dtype = signals.dtype
    snaps = snapshot_frames(signals, frame, hop)
    bin_idx, bin_w = select_bins(
        jnp.mean(jnp.abs(snaps), axis=1), fs, frame, num_bins, band)
    cov_inv = _loaded_inverses(snaps, bin_idx, loading)
    omega = refine_bin_freqs(snaps, bin_idx, fs, frame,
                             frame // 2 if hop is None else int(hop))

    def map_fn(p):
        return capon_map(cov_inv, omega, bin_w, p, mic_positions, c)

    pos, power, center, _ = two_stage_search(map_fn, map_fn, lower, upper,
                                             coarse_n, fine_n, dtype)
    return CaponResult(jnp.clip(pos, lower, upper), power, center)


def capon_locate_multi(signals: jnp.ndarray,
                       mic_positions: jnp.ndarray,
                       fs: float,
                       c,
                       lower: jnp.ndarray,
                       upper: jnp.ndarray,
                       num_sources: int,
                       frame: int = 256,
                       hop: Optional[int] = None,
                       num_bins: int = 8,
                       band: Optional[Tuple[float, float]] = None,
                       loading: float = 1e-3,
                       coarse_n: int = 24,
                       fine_n: int = 12,
                       min_separation: Optional[float] = None
                       ) -> MultiCaponResult:
    """Extract ``num_sources`` peaks of the Capon map via the shared
    argmax-suppression protocol (models/srp.py).  Unlike MUSIC the map
    itself does not depend on ``num_sources`` — it only sets how many
    peaks are extracted, so overestimating it is harmless.

    ``num_sources="auto"`` counts broadband sources first via the
    Wax-Kailath MDL criterion (models/order.estimate_num_sources)."""
    if num_sources == "auto":
        from .order import estimate_num_sources
        num_sources = max(1, estimate_num_sources(
            signals, fs, num_bins=num_bins, band=band,
            max_sources=signals.shape[0] - 1))
    return _capon_locate_multi_jit(
        signals, mic_positions, c, lower, upper, fs=float(fs),
        num_sources=num_sources, frame=frame, hop=hop, num_bins=num_bins,
        band=band, loading=float(loading), coarse_n=coarse_n, fine_n=fine_n,
        min_separation=min_separation)


@functools.partial(jax.jit, static_argnames=(
    "fs", "num_sources", "frame", "hop", "num_bins", "band", "loading",
    "coarse_n", "fine_n", "min_separation"))
def _capon_locate_multi_jit(signals, mic_positions, c, lower, upper, *, fs,
                            num_sources, frame, hop, num_bins, band, loading,
                            coarse_n, fine_n, min_separation
                            ) -> MultiCaponResult:
    dtype = signals.dtype
    snaps = snapshot_frames(signals, frame, hop)
    bin_idx, bin_w = select_bins(
        jnp.mean(jnp.abs(snaps), axis=1), fs, frame, num_bins, band)
    cov_inv = _loaded_inverses(snaps, bin_idx, loading)
    omega = refine_bin_freqs(snaps, bin_idx, fs, frame,
                             frame // 2 if hop is None else int(hop))

    def map_fn(p):
        return capon_map(cov_inv, omega, bin_w, p, mic_positions, c)

    positions, powers = suppressed_multi_search(
        map_fn, map_fn, lower, upper, coarse_n, fine_n, num_sources,
        min_separation, dtype)
    return MultiCaponResult(positions, powers)
