"""Position-uncertainty quantification for the TDOA fix.

The reference solves the weighted TDOA least-squares system
(main.py:261-274 via ``scipy.optimize.least_squares``) and discards all
curvature information — the result dict carries a point estimate only.
This module is a rebuild extension: it propagates per-pair TDOA noise
through the solve's local geometry (the Gauss-Markov / GDOP analysis) so
``localize_sound_source`` can report a position covariance, per-axis
standard deviations and a confidence ellipsoid next to the estimate.

Model.  The solver minimizes ``sum_p (w_p * r_p)^2`` with
``r_p = (||x - m_j|| - ||x - m_i||) - c * tau_p`` (models/solver.py:35,
reference utils.py:384-405).  Writing the TDOA measurement noise as
``c * tau_p ~ N(0, sigma_p^2)``, the first-order (Gauss-Markov)
covariance of the weighted-least-squares fix is the sandwich

    A   = (J^T W^2 J)^{-1}
    Cov = A  J^T W^2 S W^2 J  A,        S = diag(sigma_p^2)

with ``J`` the (P, 3) Jacobian of the residuals at the solution — row p
is ``u_j - u_i``, the difference of unit vectors from the two mics
toward the fix (the same rows models/solver.py:45 feeds LM).  Two noise
models are supported:

* ``sigma_td`` given: homoscedastic, ``sigma_p = c * sigma_td`` for all
  pairs (e.g. the GCC-PHAT CRLB or the sample-quantization floor
  ``1 / (fs * sqrt(12))``).
* ``sigma_td=None`` (default): estimated from the fit residuals under
  the classical WLS assumption ``sigma_p = sigma / w_p`` (weights are
  inverse noise scales — the reference's SNR-derived weights,
  utils.py:484-497, approximate this), which collapses the sandwich to
  ``sigma_hat^2 * A`` with ``sigma_hat^2 = sum (w_p r_p)^2 / (P - 3)``.
  Needs ``P > 3`` pairs (4 mics give P=6, dof=3).

``position_uncertainty`` is host-side NumPy on (P, 3)-sized arrays: the API
calls it after its single packed device fetch, so it adds no device round trips
to the warm single-scene path.  ``position_covariance`` is the
jittable/vmappable core of the same expansion for the batched sweep path
(parallel/sweep.py SceneResult covariance).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

# chi-square quantiles for 3 degrees of freedom (position ellipsoid).
_CHI2_3 = {0.68: 3.505915, 0.90: 6.251389, 0.95: 7.814728, 0.99: 11.344867}


def weights_from_snr(snr: np.ndarray) -> np.ndarray:
    """Host-side mirror of models/tdoa.compute_weights (reference
    utils.py:484-497): per-pair SNR normalized by the mean weight."""
    snr = np.asarray(snr, np.float64)
    mean = snr.mean() if snr.size else 0.0
    return snr / mean if mean != 0 else snr


def tdoa_jacobian(x: np.ndarray, mic_positions: np.ndarray,
                  pairs_i: Sequence[int],
                  pairs_j: Sequence[int]) -> np.ndarray:
    """(P, 3) Jacobian of the range-difference residuals at ``x``: row p
    is ``u_j - u_i`` (unit vectors mic -> x; models/solver.py:45)."""
    x = np.asarray(x, np.float64)
    mics = np.asarray(mic_positions, np.float64)
    diff = x[None, :] - mics                     # (M, 3)
    dist = np.linalg.norm(diff, axis=1)
    unit = diff / np.maximum(dist, 1e-12)[:, None]
    pi = np.asarray(pairs_i, np.intp)
    pj = np.asarray(pairs_j, np.intp)
    return unit[pj] - unit[pi]


def _inv3(a: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse via the adjugate, fully elementwise (same
    rationale as models/solver._solve3).  A singular input divides by ~0 and
    returns inf/NaN entries — the batched covariance path documents that,
    unlike the host-side ``position_uncertainty``, it performs no null-space
    analysis."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    adj = jnp.stack([
        jnp.stack([c00, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11], -1),
        jnp.stack([c01, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12], -1),
        jnp.stack([c02, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10], -1),
    ], -2)
    return adj / det[..., None, None]


def position_covariance(x_hat: jnp.ndarray,
                        mic_positions: jnp.ndarray,
                        pairs_i: np.ndarray,
                        pairs_j: np.ndarray,
                        tdoas: jnp.ndarray,
                        c,
                        weights: Optional[jnp.ndarray] = None
                        ) -> jnp.ndarray:
    """Jittable residual-estimated Gauss-Markov covariance of a TDOA fix.

    The batched core of ``position_uncertainty``'s default
    (``sigma_td=None``) path: ``sigma_hat^2 (J^T W^2 J)^{-1}`` with
    ``sigma_hat^2 = sum (w_p r_p)^2 / (P - 3)`` — pure (P, 3) linear
    algebra, vmappable over scenes (parallel/sweep.py attaches it to
    every TDOA-solver SceneResult).  Differences vs the host version:

    * no null-space analysis — a degenerate (coplanar/collinear) array
      yields inf/NaN entries from the closed-form 3x3 inverse instead of
      the explicit ``unobservable_axes`` report;
    * ``P <= 3`` (no residual dof) returns an all-NaN matrix instead of
      ``None`` (static shape under jit).

    ``pairs_i``/``pairs_j`` must be static (NumPy) index arrays so the
    gathers constant-fold instead of becoming data-dependent.
    """
    P = int(np.asarray(pairs_i).shape[0])
    dtype = tdoas.dtype
    if P - 3 < 1:
        return jnp.full((3, 3), jnp.nan, dtype)
    pi = np.asarray(pairs_i, np.int32)
    pj = np.asarray(pairs_j, np.int32)
    diff = x_hat[None, :] - mic_positions                  # (M, 3)
    dist = jnp.linalg.norm(diff, axis=-1)
    unit = diff / jnp.maximum(dist, 1e-12)[:, None]
    jac = unit[pj] - unit[pi]                              # (P, 3)
    w = jnp.ones(P, dtype) if weights is None else weights
    w2 = w * w
    normal = jac.T @ (w2[:, None] * jac)                   # J^T W^2 J
    r = (dist[pj] - dist[pi]) - jnp.asarray(c, dtype) * tdoas
    sigma2_hat = jnp.sum((w * r) ** 2) / (P - 3)
    cov = sigma2_hat * _inv3(normal)
    return 0.5 * (cov + jnp.swapaxes(cov, -1, -2))


def position_uncertainty(x_hat: np.ndarray,
                         mic_positions: np.ndarray,
                         pairs_i: Sequence[int],
                         pairs_j: Sequence[int],
                         tdoas: np.ndarray,
                         c: float,
                         weights: Optional[np.ndarray] = None,
                         sigma_td: Optional[float] = None,
                         confidence: float = 0.95,
                         ) -> Optional[Dict[str, np.ndarray]]:
    """Gauss-Markov uncertainty of a TDOA fix (see module docstring).

    Returns ``None`` when no noise scale is obtainable (``sigma_td`` not
    given and ``P <= 3`` leaves zero residual degrees of freedom).
    Otherwise a dict with:

    * ``covariance`` — (3, 3) position covariance (m^2), symmetric PSD.
    * ``std`` — (3,) per-axis standard deviations (m).
    * ``sigma_td`` — the per-pair TDOA noise scale used (s); for the
      residual-estimated path this is ``sigma_hat / c`` (the w_p=1
      equivalent scale).
    * ``ellipsoid_radii`` / ``ellipsoid_axes`` — semi-axis lengths (m)
      and unit axes (columns) of the ``confidence`` ellipsoid
      (chi-square with 3 dof; supported levels 0.68/0.90/0.95/0.99).
    * ``dof`` — residual degrees of freedom ``P - 3`` (0 when
      ``sigma_td`` was supplied and residuals were not consulted).
    * ``unobservable_axes`` — (3, k) orthonormal columns spanning the
      null space of ``J^T W^2 J`` (k=0 for a well-conditioned geometry).

    A geometrically degenerate array (coplanar mics with an in-plane
    source, or a collinear array) makes ``J^T W^2 J`` singular: the TDOA
    data carry NO information along the null direction(s).  Eigenvalues
    below ``1e-8`` of the largest are treated as exactly zero; the
    returned ``std`` is ``inf`` on every axis with a null-space
    component, the matching ``ellipsoid_radii`` are ``inf``, and
    ``covariance`` holds the observable-subspace covariance only (its
    finite entries must not be read as certainty along
    ``unobservable_axes`` — consult ``std``/``unobservable_axes``).
    """
    if confidence not in _CHI2_3:
        raise ValueError(f"confidence must be one of {sorted(_CHI2_3)}")
    x_hat = np.asarray(x_hat, np.float64)
    tdoas = np.asarray(tdoas, np.float64)
    P = tdoas.shape[0]
    w = (np.ones(P) if weights is None
         else np.asarray(weights, np.float64))
    jac = tdoa_jacobian(x_hat, mic_positions, pairs_i, pairs_j)
    w2 = w * w
    normal = jac.T @ (w2[:, None] * jac)          # J^T W^2 J
    # Null-space aware inverse: np.linalg.pinv would ZERO the variance
    # along an unobservable eigendirection (reporting perfect certainty
    # exactly where the data say nothing — e.g. the out-of-plane axis of
    # a coplanar array).  Detect near-zero eigenvalues explicitly and
    # report infinite variance there instead.
    n_evals, n_evecs = np.linalg.eigh(normal)
    observable = n_evals > max(float(n_evals[-1]), 0.0) * 1e-8
    null_basis = n_evecs[:, ~observable]          # (3, k)
    inv_evals = np.where(observable,
                         1.0 / np.where(observable, n_evals, 1.0), 0.0)
    a_inv = (n_evecs * inv_evals) @ n_evecs.T

    if sigma_td is not None:
        # Homoscedastic known noise: full sandwich (exact even when the
        # solve's weights were not inverse-variance).
        s2 = (float(c) * float(sigma_td)) ** 2
        meat = jac.T @ ((w2 * w2)[:, None] * jac)  # J^T W^4 J
        cov = s2 * (a_inv @ meat @ a_inv)
        dof = 0
        sigma_used = float(sigma_td)
    else:
        dof = P - 3
        if dof < 1:
            logger.warning(
                "position_uncertainty: %d pairs leave no residual degrees "
                "of freedom (need > 3 pairs); pass sigma_td explicitly.", P)
            return None
        mics = np.asarray(mic_positions, np.float64)
        di = np.linalg.norm(x_hat[None, :] - mics, axis=1)
        pi = np.asarray(pairs_i, np.intp)
        pj = np.asarray(pairs_j, np.intp)
        r = (di[pj] - di[pi]) - float(c) * tdoas
        sigma2_hat = float(np.sum((w * r) ** 2)) / dof
        cov = sigma2_hat * a_inv
        sigma_used = float(np.sqrt(sigma2_hat)) / float(c)

    cov = 0.5 * (cov + cov.T)
    evals, evecs = np.linalg.eigh(cov)
    evals = np.maximum(evals, 0.0)
    radii = np.sqrt(evals * _CHI2_3[confidence])
    std = np.sqrt(np.maximum(np.diag(cov), 0.0))
    if null_basis.shape[1]:
        # Infinite variance along unobservable directions: every axis
        # with a null-space component, and every covariance eigenvector
        # lying in the null space (cov annihilates it, so eigh returns
        # the null directions as zero-eigenvalue eigenvectors).
        std = np.where((null_basis ** 2).sum(axis=1) > 1e-12, np.inf, std)
        in_null = (null_basis.T @ evecs) ** 2   # (k, 3)
        radii = np.where(in_null.sum(axis=0) > 0.5, np.inf, radii)
    return {
        "covariance": cov,
        "std": std,
        "sigma_td": sigma_used,
        "ellipsoid_radii": radii,
        "ellipsoid_axes": evecs,
        "confidence": confidence,
        "dof": dof,
        "unobservable_axes": null_basis,
    }


def group_jackknife_covariance(signals: jnp.ndarray,
                               locate_fn,
                               x_hat: jnp.ndarray,
                               radius: jnp.ndarray,
                               groups: int = 4) -> jnp.ndarray:
    """Group-jackknife covariance of a grid-search fix (VERDICT r4 #6).

    The narrowband beam/music/capon solvers produce no per-pair TDOA
    residuals, so the Gauss-Markov expansion above has nothing to chew
    on, and the steered-power peak CURVATURE alone measures beamwidth,
    not estimation error (at high SNR the error is far smaller than the
    beam).  Estimator-agnostic resampling instead: the capture splits
    into ``groups`` equal time chunks; each chunk re-runs the SAME
    estimator restricted to the box ``x_hat +- radius``; under the
    standard 1/sqrt(T) error scaling of independent snapshots, the
    scatter of the group fixes about their own mean, divided by
    ``groups``, estimates Cov(x_hat).

    ``locate_fn(chunk_signals, lower, upper) -> (3,) position`` must be
    the estimator configuration that produced ``x_hat`` (traceable — the
    whole thing runs inside the jitted estimation core; groups vmap).
    Caveats: below the estimator's breakdown SNR the group fixes rail
    against the ``radius`` box and the estimate saturates (reported
    sigma stops growing); group chunks carry 1/groups of the snapshots,
    so ``groups`` much larger than 4 trades bias for variance.
    """
    m, n = signals.shape
    chunk = n // groups
    parts = signals[:, :groups * chunk].reshape(m, groups, chunk)
    parts = jnp.swapaxes(parts, 0, 1)               # (G, M, chunk)
    lo = x_hat - radius
    hi = x_hat + radius
    xs = jax.vmap(lambda s: locate_fn(s, lo, hi))(parts)    # (G, 3)
    d = xs - jnp.mean(xs, axis=0)
    cov_groups = jnp.einsum("gi,gj->ij", d, d) / (groups - 1)
    return cov_groups / groups


def summary_from_covariance(cov: np.ndarray,
                            dof: int,
                            confidence: float = 0.95
                            ) -> Dict[str, np.ndarray]:
    """Host-side uncertainty dict from a (3, 3) covariance — the
    narrowband jackknife counterpart of ``position_uncertainty``'s
    return (same keys; ``sigma_td`` is None — no TDOA noise scale
    exists — and ``unobservable_axes`` is empty: resampling scatter has
    no null-space notion)."""
    if confidence not in _CHI2_3:
        raise ValueError(f"confidence must be one of {sorted(_CHI2_3)}")
    cov = np.asarray(cov, np.float64)
    cov = 0.5 * (cov + cov.T)
    evals, evecs = np.linalg.eigh(cov)
    evals = np.maximum(evals, 0.0)
    return {
        "covariance": cov,
        "std": np.sqrt(np.maximum(np.diag(cov), 0.0)),
        "sigma_td": None,
        "ellipsoid_radii": np.sqrt(evals * _CHI2_3[confidence]),
        "ellipsoid_axes": evecs,
        "confidence": confidence,
        "dof": dof,
        "unobservable_axes": np.zeros((3, 0)),
    }
