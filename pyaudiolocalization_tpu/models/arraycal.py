"""Array-geometry self-calibration: refine microphone POSITIONS from test
events at known source positions.

The reference's calibration estimates per-microphone DELAY offsets only
(calibration.py:4-48); deployment surveys of the microphone coordinates
themselves are assumed exact.  This module closes that gap: given K test
emissions (chirps/noise bursts) from known positions, it inverts the same
weighted pair-TDOA residual system the localizer uses (utils.py:384-405
semantics, roles of source and microphones swapped) for the M microphone
positions.

Design: the whole refinement is ONE jitted ``lax.scan`` — each
sweep updates every microphone simultaneously (Jacobi block-coordinate
Gauss-Newton; the per-mic 3x3 normal equations go through the same
closed-form Cramer solve as the localizer's LM) with a shared
Levenberg-style damping that retreats on cost increases.  No Python loops,
no data-dependent shapes; (K, P) residual planes vectorize over events and
pairs.

Identifiability: each event contributes P pair equations of rank <= M-1;
3M unknowns need K >= ceil(3M/(M-1)) well-spread events (K >= 4 for a
4-mic array).  Events coplanar with a microphone leave its out-of-plane
coordinate weakly constrained — spread the test positions in 3-D.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import gccphat
from . import solver as solver_ops
from . import tdoa as tdoa_ops

__all__ = ["refine_mic_positions", "calibrate_array_geometry",
           "self_calibrate_array", "GeometryCalResult", "SelfCalResult"]


class GeometryCalResult(NamedTuple):
    mic_positions: jnp.ndarray   # (M, 3) refined coordinates
    cost: jnp.ndarray            # final 0.5*sum(r^2) over all events/pairs
    initial_cost: jnp.ndarray    # same at the initial geometry
    tdoas: Optional[jnp.ndarray] = None   # (K, P) measured TDOAs (wrapper)


class SelfCalResult(NamedTuple):
    mic_positions: jnp.ndarray      # (M, 3) refined coordinates
    source_positions: jnp.ndarray   # (K, 3) jointly estimated events
    cost: jnp.ndarray               # final data cost 0.5*sum(r^2)
    initial_cost: jnp.ndarray       # data cost at the surveyed geometry
    tdoas: Optional[jnp.ndarray] = None


def _residuals(mics, sources, pairs_i, pairs_j, tdoas, c, weights):
    """r[k, p] = w[k, p] * ((d_kj - d_ki) - c * tdoa[k, p]) and the unit
    vectors u[k, m] = (m_m - s_k) / d_km used by the per-mic Jacobians."""
    diff = mics[None, :, :] - sources[:, None, :]          # (K, M, 3)
    d = jnp.linalg.norm(diff, axis=-1)                     # (K, M)
    u = diff / jnp.maximum(d, 1e-12)[..., None]            # (K, M, 3)
    di = jnp.take(d, pairs_i, axis=1)
    dj = jnp.take(d, pairs_j, axis=1)
    r = weights * ((dj - di) - c * tdoas)                  # (K, P)
    return r, u


def refine_mic_positions(tdoas: jnp.ndarray,
                         source_positions: jnp.ndarray,
                         mic_init: jnp.ndarray,
                         pairs_i, pairs_j,
                         c,
                         weights: Optional[jnp.ndarray] = None,
                         sweeps: int = 60,
                         lam0: float = 1e-2,
                         max_step: float = 0.2,
                         prior_positions: Optional[jnp.ndarray] = None,
                         prior_weight: float = 0.0) -> GeometryCalResult:
    """Refine microphone positions from measured pair TDOAs.

    tdoas: (K, P) seconds, physical convention td = arrival_j - arrival_i
    (what the localizer's residual system consumes: (d_j - d_i) = c*td).
    source_positions: (K, 3) known emitter positions.  mic_init: (M, 3)
    surveyed/nominal coordinates (also the linearization anchor — the
    refinement is local, intended for survey errors up to ~10 cm).
    weights: optional (K, P) residual weights (e.g. correlation SNR).
    max_step caps each per-sweep per-mic move (meters) — a trust region
    against early ill-conditioned sweeps.

    ``prior_positions``/``prior_weight`` add a Tikhonov pull
    prior_weight * ||m - prior|| per mic (three extra residuals) — used by
    ``self_calibrate_array`` to pin the global frame (TDOAs are invariant
    to a joint rigid motion of mics+sources, so unknown-source
    calibration needs an anchor).
    """
    tdoas = jnp.asarray(tdoas)
    sources = jnp.asarray(source_positions, tdoas.dtype)
    mic_init = jnp.asarray(mic_init, tdoas.dtype)
    pi = jnp.asarray(pairs_i, jnp.int32)
    pj = jnp.asarray(pairs_j, jnp.int32)
    k, p = tdoas.shape
    m = mic_init.shape[0]
    w = (jnp.ones((k, p), tdoas.dtype) if weights is None
         else jnp.asarray(weights, tdoas.dtype))
    c = jnp.asarray(c, tdoas.dtype)

    # Per-mic pair-membership masks: mic a appears in pair p as the i slot
    # (sign -1 on u_i) or the j slot (sign +1 on u_j).
    sel_i = (pi[None, :] == jnp.arange(m)[:, None]).astype(tdoas.dtype)
    sel_j = (pj[None, :] == jnp.arange(m)[:, None]).astype(tdoas.dtype)

    prior = (jnp.asarray(prior_positions, tdoas.dtype)
             if prior_positions is not None else mic_init)
    pw = jnp.asarray(prior_weight, tdoas.dtype)

    def cost_fn(mics):
        r, _ = _residuals(mics, sources, pi, pj, tdoas, c, w)
        return 0.5 * (jnp.sum(r * r)
                      + jnp.sum((pw * (mics - prior)) ** 2))

    def sweep(state, _):
        mics, lam, cost = state
        r, u = _residuals(mics, sources, pi, pj, tdoas, c, w)
        ui = jnp.take(u, pi, axis=1)                       # (K, P, 3)
        uj = jnp.take(u, pj, axis=1)
        # J[a, k, p, :] = w * (sel_j[a, p] * uj - sel_i[a, p] * ui)
        jac = (sel_j[:, None, :, None] * uj[None]
               - sel_i[:, None, :, None] * ui[None])       # (M, K, P, 3)
        jac = jac * w[None, :, :, None]
        jtj = jnp.einsum("akpx,akpy->axy", jac, jac)       # (M, 3, 3)
        jtr = jnp.einsum("akpx,kp->ax", jac, r)            # (M, 3)
        # Tikhonov anchor: prior residuals pw*(m - prior) per coordinate.
        jtj = jtj + (pw * pw) * jnp.eye(3, dtype=tdoas.dtype)[None]
        jtr = jtr + (pw * pw) * (mics - prior)
        diag = jnp.diagonal(jtj, axis1=-2, axis2=-1)
        damp = lam * jnp.maximum(diag, 1e-12)
        a_mat = jtj + damp[..., None] * jnp.eye(3, dtype=tdoas.dtype)
        delta = solver_ops._solve3(a_mat, -jtr)            # (M, 3)
        step = jnp.linalg.norm(delta, axis=-1, keepdims=True)
        delta = delta * jnp.minimum(1.0, max_step / jnp.maximum(step, 1e-12))
        mics_new = mics + delta
        cost_new = cost_fn(mics_new)
        accept = cost_new < cost
        mics = jnp.where(accept, mics_new, mics)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-10),
                        jnp.minimum(lam * 4.0, 1e12))
        return (mics, lam, cost), None

    cost0 = cost_fn(mic_init)
    state = (mic_init, jnp.asarray(lam0, tdoas.dtype), cost0)
    (mics, _, cost), _ = jax.lax.scan(sweep, state, None, length=sweeps)
    return GeometryCalResult(mics, cost, cost0)


def self_calibrate_array(tdoas: jnp.ndarray,
                         mic_init: jnp.ndarray,
                         pairs_i, pairs_j,
                         c,
                         weights: Optional[jnp.ndarray] = None,
                         rounds: int = 3,
                         sweeps_per_round: int = 12,
                         anchor_weight: float = 1e-3,
                         key: Optional[jax.Array] = None) -> SelfCalResult:
    """Joint array/source self-calibration: the test-event positions are
    UNKNOWN.  Initializes by alternating (a) localizing every event with
    the standard clustered-init multi-start LM given the current geometry
    and (b) refining the microphone positions given those event estimates
    (each round one jitted dispatch; alternation alone converges only
    linearly — measured 16-35 mm residual shape error after 60 rounds),
    then polishes the JOINT 3(M+K)-dim system with a damped Gauss-Newton
    to data precision (measured: exact TDOAs recover the array SHAPE to
    ~0.002 mm).

    Gauge: pair TDOAs are invariant to a rigid motion applied jointly to
    mics and sources, so the frame is pinned by a weak Tikhonov anchor
    toward the surveyed ``mic_init``.  The anchor must stay WEAK
    (default 1e-3): the data-null rigid modes are decided by ANY positive
    weight, while a strong anchor (1.0) trades genuine data residual for
    survey agreement (measured: biases the recovered shape by ~30 mm at
    a 3 cm survey error).  Consequently the ABSOLUTE positions inherit
    the rigid component of the survey error (~2 cm at a 3 cm jitter);
    the inter-mic geometry — what TDOA localization actually consumes —
    is recovered to data precision.

    Identifiability: each event contributes M-1 independent TDOAs and
    consumes 3 unknowns for its own position, so unknown-source
    calibration needs M >= 5 microphones (a 4-mic array fits every
    event's TDOAs EXACTLY at ANY geometry — verified: the data cost is
    ~1e-26 at both the true and the surveyed 4-mic geometry) and
    K >= (3M-6)/(M-4) well-spread events (M=5 -> 9, M=6 -> 6; use ~2x
    for conditioning).  The refinement is local (survey errors up to
    ~10 cm); it reports the DATA cost so callers can gate on convergence.
    """
    tdoas = jnp.asarray(tdoas)
    mic_init = jnp.asarray(mic_init, tdoas.dtype)
    if mic_init.shape[0] < 5:
        raise ValueError(
            "Unknown-source self-calibration needs >= 5 microphones: with "
            "M mics each event contributes M-1 independent TDOAs and "
            "consumes 3 unknowns for its own position, so a 4-mic array "
            "fits every event exactly at ANY geometry. Survey the event "
            "positions (calibrate_array_geometry with source_positions) "
            "or add microphones.")
    pi = jnp.asarray(pairs_i, jnp.int32)
    pj = jnp.asarray(pairs_j, jnp.int32)
    k, p = tdoas.shape
    w = (jnp.ones((k, p), tdoas.dtype) if weights is None
         else jnp.asarray(weights, tdoas.dtype))
    c = jnp.asarray(c, tdoas.dtype)
    if key is None:
        key = jax.random.PRNGKey(0)
    event_keys = jax.random.split(key, k)

    def localize_one(mics, td_row, w_row, kk):
        guesses, _ = solver_ops.heuristic_initial_guesses(
            mics, pi, pj, td_row, c, kk)
        lower, upper = solver_ops.dynamic_bounds(mics, td_row, c)
        res = solver_ops.multi_start_lm(guesses, mics, pi, pj, td_row, c,
                                        w_row, lower, upper)
        return res.x

    @jax.jit
    def round_step(mics):
        sources = jax.vmap(lambda t, ww, kk: localize_one(mics, t, ww, kk))(
            tdoas, w, event_keys)
        res = refine_mic_positions(
            tdoas, sources, mics, pi, pj, c, weights=w,
            sweeps=sweeps_per_round, prior_positions=mic_init,
            prior_weight=anchor_weight)
        return res.mic_positions, sources

    def data_cost(mics, sources):
        r, _ = _residuals(mics, sources, pi, pj, tdoas, c, w)
        return 0.5 * jnp.sum(r * r)

    mics = mic_init
    sources = None
    for _ in range(rounds):
        mics, sources = round_step(mics)

    # Alternation converges only linearly (it ignores d(sources)/d(mics)),
    # so polish the JOINT 3(M+K)-dim problem with a damped Gauss-Newton
    # (Levenberg-Marquardt): the system is small (tens of unknowns), one
    # jnp.linalg.solve per iteration, quadratic convergence near the
    # solution; the anchor rows keep the gauge pinned.  One jitted
    # while_loop.
    m = mic_init.shape[0]
    aw = jnp.asarray(anchor_weight, tdoas.dtype)

    def resid_vec(x):
        mm = x[:3 * m].reshape(m, 3)
        ss = x[3 * m:].reshape(k, 3)
        r, _ = _residuals(mm, ss, pi, pj, tdoas, c, w)
        return jnp.concatenate([r.ravel(), (aw * (mm - mic_init)).ravel()])

    @jax.jit
    def joint_lm(x0):
        jac_fn = jax.jacfwd(resid_vec)

        def cost_of(x):
            r = resid_vec(x)
            return 0.5 * jnp.dot(r, r)

        def cond(st):
            _, _, _, it, done = st
            return (it < 100) & ~done

        def body(st):
            x, lam, cost, it, done = st
            r = resid_vec(x)
            jmat = jac_fn(x)
            jtj = jmat.T @ jmat
            jtr = jmat.T @ r
            a = jtj + lam * jnp.diag(jnp.maximum(jnp.diag(jtj), 1e-12))
            delta = jnp.linalg.solve(a, -jtr)
            xn = x + delta
            cn = cost_of(xn)
            accept = cn < cost
            conv = accept & ((cost - cn) <= 1e-12 * (cost + 1e-30))
            x = jnp.where(accept, xn, x)
            cost = jnp.where(accept, cn, cost)
            lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12),
                            jnp.minimum(lam * 4.0, 1e12))
            return (x, lam, cost, it + 1, done | conv | (lam >= 1e12))

        st = (x0, jnp.asarray(1e-3, x0.dtype), cost_of(x0), jnp.asarray(0),
              jnp.asarray(False))
        x, _, cost, _, _ = jax.lax.while_loop(cond, body, st)
        return x

    x = joint_lm(jnp.concatenate([mics.ravel(), sources.ravel()]))
    mics = x[:3 * m].reshape(m, 3)
    sources = x[3 * m:].reshape(k, 3)

    cost0 = data_cost(mic_init, jax.vmap(
        lambda t, ww, kk: localize_one(mic_init, t, ww, kk))(
        tdoas, w, event_keys))
    return SelfCalResult(mics, sources, data_cost(mics, sources), cost0)


def calibrate_array_geometry(signals: jnp.ndarray,
                             source_positions: Optional[jnp.ndarray],
                             mic_init: jnp.ndarray,
                             fs: float,
                             c,
                             nfft: Optional[int] = None,
                             band: Optional[tuple] = None,
                             max_expected_delay: Optional[float] = None,
                             weight_by_snr: bool = True,
                             sweeps: int = 60,
                             threshold_method: str = "gaussian"
                             ) -> GeometryCalResult:
    """Signal-level wrapper: measure per-event pair TDOAs with the standard
    GCC-PHAT -> peak ladder (physical lag convention), then refine the
    microphone geometry.

    signals: (K, M, N) recordings of K test events.  source_positions:
    (K, 3) known emitter positions, or ``None`` for joint self-calibration
    (the events are estimated too — ``self_calibrate_array``; returns
    ``SelfCalResult``).  mic_init: (M, 3) surveyed coordinates.  With
    ``weight_by_snr`` each pair residual is weighted by its
    correlation-peak SNR (models/tdoa.compute_weights), so multipath-hit
    pairs are downweighted exactly as in localization.
    """
    signals = jnp.asarray(signals)
    k, m, n = signals.shape
    pairs = np.array([(i, j) for i in range(m) for j in range(i + 1, m)],
                     np.int32)
    pi, pj = pairs[:, 0], pairs[:, 1]
    corr = gccphat.gcc_phat_all_pairs(signals, pi, pj, nfft=nfft, band=band,
                                      fs=fs)                # (K, P, nfft)
    res = tdoa_ops.time_delays_from_corr(
        corr, n, n, fs, num_peaks=1, threshold_method=threshold_method,
        max_expected_delay=max_expected_delay, lag_mode="physical")
    td = -res.delays[..., 0]                                # (K, P)
    weights = None
    if weight_by_snr:
        weights = tdoa_ops.compute_weights(tdoa_ops.correlation_snr(corr))
    if source_positions is None:
        sc = self_calibrate_array(td, mic_init, pi, pj, c, weights=weights)
        return SelfCalResult(sc.mic_positions, sc.source_positions, sc.cost,
                             sc.initial_cost, tdoas=td)
    out = refine_mic_positions(td, source_positions, mic_init, pi, pj, c,
                               weights=weights, sweeps=sweeps)
    return GeometryCalResult(out.mic_positions, out.cost, out.initial_cost,
                             tdoas=td)
