"""MUSIC (MUltiple SIgnal Classification) narrowband localization.

No reference counterpart — a beyond-parity estimator that complements the
Bartlett beamformer (models/beamformer.py): where the steered-power scan's
resolution is limited by the array's beamwidth (closely spaced sources merge
into one lobe), MUSIC projects steering vectors onto the NOISE subspace of
the spatial covariance and peaks sharply wherever a steering vector is
orthogonal to it — super-resolution for uncorrelated narrowband sources.

Estimator shape (incoherent wideband MUSIC, per selected rfft bin k):

    R_k   = (1/F) sum_f  x_f(k) x_f(k)^H          (M x M snapshot covariance)
    E_n,k = all-but-top-num_sources eigenvectors  (noise subspace)
    P(x)  = sum_k w_k / max(||E_n,k^H a_k(x)||^2, eps)

with near-field phase-only steering a_m(x) = exp(-i w_k d_m(x) / c).

Design decisions:

  * NO complex linear algebra: the Hermitian covariance C = A + iB embeds as
    the real symmetric (2M, 2M) matrix [[A, -B], [B, A]] whose spectrum is
    C's doubled — each complex eigenvector v = vr + i vi appears as the two
    real eigenvectors [vr; vi], [-vi; vr].  The complex projection norm
    ||E_s^H a||^2 equals the real embedded projection of [Re a; Im a], so
    one real `eigh` on a tiny (2M, 2M) matrix replaces complex EVD.
    Signal subspace = top
    2*num_sources embedded eigenvectors.
  * Snapshots come from a strided frame matrix (F frames x `frame` samples,
    one batched rfft); bin selection reuses the beamformer's tempered
    top-energy rule.
  * The grid scan is dense linear algebra over (G, M) distance planes —
    cos/sin steering planes contracted against the (2M, 2K) subspace — no
    gathers; coarse->fine two-stage search like models/srp.py, and a
    multi-source variant with the same spatial-suppression loop as
    srp_phat_locate_multi.

Caveats (standard MUSIC limits, documented for users): sources must be
mutually uncorrelated at the selected bins (fully coherent copies — e.g.
strong specular multipath of the SAME tone — collapse the signal subspace;
use the SRP/GCC chain there), and F must exceed num_sources for the
covariance to attain rank.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .beamformer import select_bins
from .srp import suppressed_multi_search, two_stage_search


class MusicResult(NamedTuple):
    position: jnp.ndarray    # (..., 3)
    power: jnp.ndarray       # (...,) pseudo-spectrum value at the estimate
    coarse: jnp.ndarray      # (..., 3) stage-1 cell center (diagnostics)


class MultiMusicResult(NamedTuple):
    positions: jnp.ndarray   # (..., K, 3) descending coarse power
    powers: jnp.ndarray      # (..., K) fine-stage pseudo-spectrum values


def snapshot_frames(signals: jnp.ndarray, frame: int,
                    hop: Optional[int] = None) -> jnp.ndarray:
    """(M, N) time signals -> (M, F, frame//2+1) complex rfft snapshots.

    Frames start every ``hop`` samples (default frame//2, 50% overlap) — a
    static strided slice, so the whole STFT is one batched rfft."""
    m, n = signals.shape
    h = frame // 2 if hop is None else int(hop)
    if n < frame:
        raise ValueError(
            f"signals ({n} samples) shorter than the analysis frame ({frame}).")
    num = 1 + (n - frame) // h
    starts = np.arange(num) * h
    idx = starts[:, None] + np.arange(frame)[None, :]       # (F, L) static
    frames = signals[:, idx]                                # (M, F, L)
    win = jnp.asarray(np.hanning(frame), signals.dtype)
    return jnp.fft.rfft(frames * win[None, None, :], axis=-1)


def embed_planes(a_mat: jnp.ndarray, b_mat: jnp.ndarray) -> jnp.ndarray:
    """Embed Hermitian C = A + iB as the real symmetric [[A, -B], [B, A]].

    The embedding is a ring homomorphism (products/inverses of embedded
    matrices embed the complex products/inverses), so downstream subspace
    (MUSIC) and quadratic-form (Capon/MVDR) math stays complex-free.
    a_mat/b_mat: (..., M, M) -> (..., 2M, 2M)."""
    top = jnp.concatenate([a_mat, -b_mat], axis=-1)
    bot = jnp.concatenate([b_mat, a_mat], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def embedded_covariances(snaps: jnp.ndarray,
                         bin_idx: jnp.ndarray) -> jnp.ndarray:
    """Real-embedded snapshot covariances for each selected bin.

    snaps: (M, F, bins) complex; returns (B, 2M, 2M) embeddings of
    C = (1/F) X X^H (see ``embed_planes``)."""
    sel = snaps[:, :, bin_idx]                              # (M, F, B)
    xr = jnp.real(sel).transpose(2, 0, 1)                   # (B, M, F)
    xi = jnp.imag(sel).transpose(2, 0, 1)
    f = sel.shape[1]
    # C = (1/F) X X^H = A + iB:  A = (xr xr^T + xi xi^T)/F (symmetric),
    # B = (xi xr^T - xr xi^T)/F (antisymmetric).
    a_mat = (xr @ jnp.swapaxes(xr, -1, -2)
             + xi @ jnp.swapaxes(xi, -1, -2)) / f           # (B, M, M)
    b_mat = (xi @ jnp.swapaxes(xr, -1, -2)
             - xr @ jnp.swapaxes(xi, -1, -2)) / f
    return embed_planes(a_mat, b_mat)                       # (B, 2M, 2M)


def embedded_steering(points: jnp.ndarray, mic_positions: jnp.ndarray,
                      omega: jnp.ndarray, c) -> jnp.ndarray:
    """Real-embedded near-field phase-only steering vectors.

    a_m(x) = exp(-i omega d_m(x) / c) embeds as [Re a; Im a] = [cos; -sin].
    points: (G, 3); omega: (B,) rad/s.  Returns (G, 2M, B)."""
    d = jnp.linalg.norm(points[:, None, :] - mic_positions[None, :, :],
                        axis=-1)                            # (G, M)
    theta = (d[:, :, None] / c) * omega.astype(d.dtype)[None, None, :]
    return jnp.concatenate([jnp.cos(theta), -jnp.sin(theta)], axis=1)


def _noise_subspaces(snaps: jnp.ndarray, bin_idx: jnp.ndarray,
                     num_sources: int) -> jnp.ndarray:
    """Embedded NOISE subspaces for each selected bin.

    snaps: (M, F, bins) complex; returns (B, 2M, 2M-2K) orthonormal columns
    spanning the real embedding of each bin's noise eigenspace (everything
    below the top-K).  The pseudo-spectrum projects onto THIS subspace
    directly — computing it as ||a||^2 - ||E_s^H a||^2 subtracts two nearly
    equal numbers exactly where the MUSIC peak is sharpest, which in
    float32 blurs the fine-stage map into quantization noise
    (measured: p90 35 mm via the signal-subspace complement, 7 mm direct)."""
    m = snaps.shape[0]
    emb = embedded_covariances(snaps, bin_idx)              # (B, 2M, 2M)
    _, vecs = jnp.linalg.eigh(emb)                          # ascending
    return vecs[:, :, :2 * m - 2 * num_sources]             # (B, 2M, 2M-2K)


def refine_bin_freqs(snaps: jnp.ndarray, bin_idx: jnp.ndarray,
                     fs: float, nfft: int, hop: int) -> jnp.ndarray:
    """Per-bin frequency refinement via the phase-vocoder estimator: the
    mean inter-frame phase advance of bin k, summed over mics and frame
    pairs, gives the tone's TRUE frequency to a fraction of a Hz.

    Why it matters: a tone off the DFT grid still yields a rank-1 snapshot
    covariance whose signal eigenvector is the steering vector at the
    tone's true frequency (the Hann leakage factor is common to all mics),
    so steering at the bin CENTER mis-rotates phases by up to half a bin —
    measured 2.2 cm localization error for a 600 Hz tone in 62.5 Hz bins,
    vs ~6 mm refined.  The phase-advance estimator beats magnitude
    parabolic interpolation (windowed-peak interpolation is biased) and
    keeps COARSE frames viable — coarse bins retain the frequency
    DIVERSITY across selected bins that vetoes grating lobes, while
    refinement restores fine-bin steering precision.

    snaps: (M, F, bins) complex rfft snapshots with frame hop ``hop``.
    Returns angular frequencies (B,) rad/s, offsets clamped to +-0.55 bin
    (a top-energy bin's true tone is always within half a bin).

    Validity: the wrapped residual is unambiguous only while
    |delta_true * hop| <= pi, i.e. hop <= nfft/1.1 given the 0.55-bin
    clamp; for larger (gapped-frame) hops the phase advance aliases
    (measured: a 658 Hz tone refines to 699.7 Hz at frame=256, hop=384),
    so refinement is skipped and bin centers are used as-is."""
    rdtype = jnp.real(snaps).dtype
    base = 2.0 * jnp.pi * bin_idx.astype(rdtype) / nfft     # rad/sample
    if snaps.shape[1] < 2 or hop > nfft / 1.1:
        return base * fs
    sel = snaps[:, :, bin_idx]                              # (M, F, B)
    prod = sel[:, 1:, :] * jnp.conj(sel[:, :-1, :])
    s_sum = jnp.sum(prod, axis=(0, 1))                      # (B,)
    adv = jnp.arctan2(jnp.imag(s_sum), jnp.real(s_sum))     # (-pi, pi]
    expected = base * hop
    two_pi = 2.0 * jnp.pi
    delta = (adv - expected + jnp.pi) % two_pi - jnp.pi     # wrapped residual
    half_bin = 0.55 * two_pi / nfft                         # rad/sample
    delta = jnp.clip(delta / hop, -half_bin, half_bin)
    return (base + delta) * fs


def music_map_bins(subspaces: jnp.ndarray, omega: jnp.ndarray,
                   points: jnp.ndarray, mic_positions: jnp.ndarray,
                   c) -> jnp.ndarray:
    """Per-bin MUSIC pseudo-spectra: (G, B), one column per selected bin
    (``music_map`` is the bin-weighted sum).  Exposed separately so callers
    can normalize each bin's contribution by its own peak before summing —
    the absolute pseudo-spectrum scale varies by orders of magnitude with
    per-bin SNR, so without normalization a strong emitter's noise floor
    can outbid a 30 dB-weaker emitter's genuine peak (see
    models/online.py's streaming narrowband step)."""
    m = mic_positions.shape[0]
    a_emb = embedded_steering(points, mic_positions, omega, c)  # (G, 2M, B)
    # ||E_n^H a||^2 per (G, B): contract the embedded noise columns.
    proj = jnp.einsum("bmk,gmb->gbk", subspaces, a_emb)     # (G, B, 2M-2K)
    noise = jnp.maximum(jnp.sum(proj * proj, axis=-1), 1e-7 * m)
    return 1.0 / noise


def music_map(subspaces: jnp.ndarray, omega: jnp.ndarray,
              bin_w: jnp.ndarray, points: jnp.ndarray,
              mic_positions: jnp.ndarray, c) -> jnp.ndarray:
    """MUSIC pseudo-spectrum for each candidate point.

    subspaces: (B, 2M, 2M-2K) embedded NOISE subspaces (_noise_subspaces);
    omega: (B,) angular frequencies (rad/s, see ``refine_bin_freqs``);
    points: (G, 3).  Returns (G,).  Steering is phase-only (unit modulus),
    ||a||^2 = M; the noise projection is computed directly (float32-stable,
    see _noise_subspaces)."""
    per_bin = music_map_bins(subspaces, omega, points, mic_positions, c)
    return jnp.sum(bin_w[None, :] * per_bin, axis=-1)


def _check_num_sources(num_sources: int, num_mics: int) -> None:
    """MUSIC needs a non-empty noise subspace: K < M strictly (with K = M
    every steering vector lies in the signal span and the pseudo-spectrum
    is flat)."""
    if not 1 <= num_sources < num_mics:
        raise ValueError(
            f"num_sources must satisfy 1 <= num_sources < num_mics "
            f"({num_mics}); got {num_sources} — MUSIC requires at least one "
            f"noise-subspace dimension.")


def music_locate(signals: jnp.ndarray,
                 mic_positions: jnp.ndarray,
                 fs: float,
                 c,
                 lower: jnp.ndarray,
                 upper: jnp.ndarray,
                 num_sources: int = 1,
                 frame: int = 256,
                 hop: Optional[int] = None,
                 num_bins: int = 8,
                 band: Optional[Tuple[float, float]] = None,
                 coarse_n: int = 24,
                 fine_n: int = 12) -> MusicResult:
    """Two-stage MUSIC grid search over the box [lower, upper].

    signals: (M, N) time-domain mic signals.  Set ``num_sources`` to the
    number of simultaneous narrowband emitters whose subspace should be
    protected (the returned estimate is the single strongest peak — use
    ``music_locate_multi`` to extract all of them)."""
    _check_num_sources(num_sources, signals.shape[0])
    return _music_locate_jit(
        signals, mic_positions, c, lower, upper,
        fs=float(fs), num_sources=num_sources, frame=frame,
        hop=hop, num_bins=num_bins, band=band, coarse_n=coarse_n,
        fine_n=fine_n)


@functools.partial(jax.jit, static_argnames=(
    "fs", "num_sources", "frame", "hop", "num_bins", "band", "coarse_n",
    "fine_n"))
def _music_locate_jit(signals, mic_positions, c, lower, upper, *, fs,
                      num_sources, frame, hop, num_bins, band, coarse_n,
                      fine_n) -> MusicResult:
    dtype = signals.dtype
    snaps = snapshot_frames(signals, frame, hop)
    bin_idx, bin_w = select_bins(
        jnp.mean(jnp.abs(snaps), axis=1), fs, frame, num_bins, band)
    subs = _noise_subspaces(snaps, bin_idx, num_sources)
    omega = refine_bin_freqs(snaps, bin_idx, fs, frame,
                             frame // 2 if hop is None else int(hop))

    def map_fn(p):
        return music_map(subs, omega, bin_w, p, mic_positions, c)

    pos, power, center, _ = two_stage_search(map_fn, map_fn, lower, upper,
                                             coarse_n, fine_n, dtype)
    return MusicResult(jnp.clip(pos, lower, upper), power, center)


def music_locate_multi(signals: jnp.ndarray,
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
                       coarse_n: int = 24,
                       fine_n: int = 12,
                       min_separation: Optional[float] = None
                       ) -> MultiMusicResult:
    """Extract ``num_sources`` peaks of the MUSIC map: iterative coarse
    argmax + spatial suppression (same protocol as srp_phat_locate_multi:
    default radius 3 coarse cells), then a fine re-grid around each peak.

    ``num_sources="auto"`` counts broadband sources first via the
    Wax-Kailath MDL criterion (models/order.estimate_num_sources; see its
    docstring for the disjoint-tone caveat)."""
    if num_sources == "auto":
        from .order import estimate_num_sources
        num_sources = max(1, estimate_num_sources(
            signals, fs, num_bins=num_bins, band=band,
            max_sources=signals.shape[0] - 1))
    _check_num_sources(num_sources, signals.shape[0])
    return _music_locate_multi_jit(
        signals, mic_positions, c, lower, upper,
        fs=float(fs), num_sources=num_sources, frame=frame, hop=hop,
        num_bins=num_bins, band=band, coarse_n=coarse_n, fine_n=fine_n,
        min_separation=min_separation)


@functools.partial(jax.jit, static_argnames=(
    "fs", "num_sources", "frame", "hop", "num_bins", "band", "coarse_n",
    "fine_n", "min_separation"))
def _music_locate_multi_jit(signals, mic_positions, c, lower, upper, *, fs,
                            num_sources, frame, hop, num_bins, band,
                            coarse_n, fine_n, min_separation
                            ) -> MultiMusicResult:
    dtype = signals.dtype
    snaps = snapshot_frames(signals, frame, hop)
    bin_idx, bin_w = select_bins(
        jnp.mean(jnp.abs(snaps), axis=1), fs, frame, num_bins, band)
    subs = _noise_subspaces(snaps, bin_idx, num_sources)
    omega = refine_bin_freqs(snaps, bin_idx, fs, frame,
                             frame // 2 if hop is None else int(hop))

    def map_fn(p):
        return music_map(subs, omega, bin_w, p, mic_positions, c)

    positions, powers = suppressed_multi_search(
        map_fn, map_fn, lower, upper, coarse_n, fine_n, num_sources,
        min_separation, dtype)
    return MultiMusicResult(positions, powers)
