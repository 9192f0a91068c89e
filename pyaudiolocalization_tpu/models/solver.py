"""TDOA source-position solvers: weighted residuals, clustering-based
initialization, bounds, vmapped Levenberg-Marquardt, and an on-device
differential-evolution population.

Counterpart of the reference's solver stack: the residual system
(utils.py:384-405), hyperbola-midpoint initial guesses + clustering
(utils.py:304-362), extended bounds (utils.py:364-382), the scipy
least_squares restart loop (main.py:261-274) and the differential_evolution
fallback (main.py:281-292).  Design: restarts are a vmapped LM
with a static iteration count; DE is a resident (pop, 3) population evolved
under lax.scan — no per-candidate host round trips.

Sign convention: residual r = (||x - mic_j|| - ||x - mic_i||) - c * td,
matching utils.py:398-404.  In 'physical' lag mode the TDOA fed here must be
td = (arrival_j - arrival_i) = -(peak lag)/fs (see models/tdoa.py).
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cluster as cluster_ops


# ---------------------------------------------------------------------------
# Residual system (utils.py:384-405)
# ---------------------------------------------------------------------------

def tdoa_residuals(x: jnp.ndarray, mic_positions: jnp.ndarray,
                   pairs_i: jnp.ndarray, pairs_j: jnp.ndarray,
                   tdoas: jnp.ndarray, c, weights: jnp.ndarray) -> jnp.ndarray:
    """r_p = w_p * ((d_j - d_i) - c * td_p) for each pair p; x is (3,)."""
    d = jnp.linalg.norm(x[None, :] - mic_positions, axis=-1)    # (M,)
    di = jnp.take(d, pairs_i)
    dj = jnp.take(d, pairs_j)
    return weights * ((dj - di) - c * tdoas)


def tdoa_residuals_and_jac(x, mic_positions, pairs_i, pairs_j, tdoas, c, weights):
    """Closed-form residuals + Jacobian (P, 3):
    dr/dx = w * ((x - mic_j)/d_j - (x - mic_i)/d_i)."""
    diff = x[None, :] - mic_positions                            # (M, 3)
    d = jnp.linalg.norm(diff, axis=-1)
    unit = diff / jnp.maximum(d, 1e-12)[:, None]
    di = jnp.take(d, pairs_i)
    dj = jnp.take(d, pairs_j)
    r = weights * ((dj - di) - c * tdoas)
    jac = weights[:, None] * (jnp.take(unit, pairs_j, 0) - jnp.take(unit, pairs_i, 0))
    return r, jac


# ---------------------------------------------------------------------------
# Initialization (utils.py:304-362) and bounds (utils.py:364-382)
# ---------------------------------------------------------------------------

def pair_guesses(mic_positions: jnp.ndarray, pairs_i: jnp.ndarray,
                 pairs_j: jnp.ndarray, tdoas: jnp.ndarray, c
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hyperbola-midpoint guess per pair (utils.py:321-334): from the pair
    midpoint, step (c|td|)/2 along -(mic_j - mic_i) when td > 0, else +.
    Returns (guesses (P, 3), valid mask) — degenerate pairs (coincident
    mics) are masked like the reference's `continue`."""
    mi = jnp.take(mic_positions, pairs_i, 0)
    mj = jnp.take(mic_positions, pairs_j, 0)
    direction = mj - mi
    norm = jnp.linalg.norm(direction, axis=-1)
    valid = norm > 0
    # Guard must be representable in float32 (1e-300 flushes to 0 -> 0/0
    # NaN poisons every downstream consumer of the masked row).
    unit = direction / jnp.where(valid, norm, 1.0)[:, None]
    midpoint = (mi + mj) / 2.0
    offset = (c * jnp.abs(tdoas)) / 2.0
    sign = jnp.where(tdoas > 0, -1.0, 1.0)
    return midpoint + sign[:, None] * offset[:, None] * unit, valid


def optimal_cluster_count(points: jnp.ndarray, valid: jnp.ndarray,
                          key: jax.Array, max_clusters: int = 5,
                          method: str = "kmeans", eps: float = 0.001,
                          min_samples: int = 2) -> jnp.ndarray:
    """Silhouette-selected cluster count (utils.py:273-302), branchless:
    evaluate every k in 2..min(max_clusters, n) and pick the best score
    (strict improvement, like the reference's `>`)."""
    if method not in ("kmeans", "dbscan"):
        # Reference raises for unknown methods (utils.py:298-302).
        raise ValueError("Unknown clustering method. Use 'kmeans' or 'dbscan'.")
    return _optimal_cluster_count_jit(points, valid, key,
                                      max_clusters=max_clusters,
                                      method=method, eps=eps,
                                      min_samples=min_samples)


@functools.partial(jax.jit, static_argnames=("max_clusters", "method", "eps",
                                             "min_samples"))
def _optimal_cluster_count_jit(points, valid, key, *, max_clusters, method,
                               eps, min_samples) -> jnp.ndarray:
    n = points.shape[0]
    n_valid = jnp.sum(valid)
    if method == "dbscan":
        res = cluster_ops.dbscan(points, eps, min_samples, valid)
        labels = jnp.maximum(res.labels, 0)
        in_cluster = (res.labels >= 0) & valid
        score = cluster_ops.silhouette_score(points, labels,
                                             num_clusters=n, valid=in_cluster)
        enough = jnp.sum(in_cluster) >= 2
        return jnp.where(enough & (score > 0), res.num_clusters, 1)
    best_k = jnp.asarray(1)
    best_score = jnp.asarray(-1.0, points.dtype)
    upper = min(max_clusters, n)
    for k in range(2, upper + 1):
        km = cluster_ops.kmeans(points, k, jax.random.fold_in(key, k),
                                valid=valid)
        score = cluster_ops.silhouette_score(points, km.labels, k, valid)
        feasible = k <= n_valid
        better = feasible & (score > best_score)
        best_k = jnp.where(better, k, best_k)
        best_score = jnp.where(better, score, best_score)
    return jnp.where(n_valid < 2, 1, best_k)


@functools.partial(jax.jit, static_argnames=("clustering_method", "eps",
                                             "min_samples", "max_clusters"))
def heuristic_initial_guesses(mic_positions: jnp.ndarray,
                              pairs_i: jnp.ndarray, pairs_j: jnp.ndarray,
                              tdoas: jnp.ndarray, c, key: jax.Array,
                              clustering_method: str = "kmeans",
                              eps: float = 0.001, min_samples: int = 2,
                              max_clusters: int = 5
                              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Clustered initial guesses + the mic centroid
    (heuristic_initialization_adaptive, utils.py:304-362).

    Returns (guesses, valid) with static shape (G, 3): G = max_clusters + 1
    for kmeans, P + 1 for dbscan.  Invalid rows are filled with the centroid
    (harmless duplicate restarts for the solver).  Jitted at definition so
    eager callers (the compat layer) get one compiled graph per shape.
    """
    centroid = jnp.mean(mic_positions, 0)
    points, pvalid = pair_guesses(mic_positions, pairs_i, pairs_j, tdoas, c)
    n = points.shape[0]

    if clustering_method == "kmeans":
        # ALL k = 1..max_clusters cluster in one batched run
        # (cluster_ops.kmeans_multi); the silhouette-selected k
        # (optimal_cluster_count semantics, utils.py:273-302) then picks the
        # variant — k is data-dependent, so every variant's centers are
        # evaluated and the winner selected by mask.
        n_valid = jnp.sum(pvalid)
        upper_k = min(max_clusters, n)
        km = cluster_ops.kmeans_multi(points, max_clusters, key, iters=10,
                                      valid=pvalid)
        scores = jax.vmap(
            lambda lab: cluster_ops.silhouette_score(points, lab,
                                                     max_clusters, pvalid)
        )(km.labels)                               # (K,)
        best_k = jnp.asarray(1)
        best_score = jnp.asarray(-1.0, points.dtype)
        for k in range(2, upper_k + 1):
            better = (k <= n_valid) & (scores[k - 1] > best_score)
            best_k = jnp.where(better, k, best_k)
            best_score = jnp.where(better, scores[k - 1], best_score)
        num = jnp.where(n_valid < 2, 1, best_k)
        k_cols = jnp.arange(max_clusters)
        stacked_valid = k_cols[None, :] <= k_cols[:, None]
        stacked = jnp.where(stacked_valid[:, :, None], km.centers,
                            centroid[None, None, :])
        sel = jnp.clip(num - 1, 0, max_clusters - 1)
        guesses = stacked[sel]
        gvalid = stacked_valid[sel]
    elif clustering_method == "dbscan":
        res = cluster_ops.dbscan(points, eps, min_samples, pvalid)
        # Mean of each cluster (utils.py:348-352); up to P clusters.
        onehot = ((res.labels[:, None] == jnp.arange(n)[None, :]) &
                  (res.labels[:, None] >= 0) & pvalid[:, None])
        counts = jnp.sum(onehot, 0)
        sums = onehot.T.astype(points.dtype) @ points
        means = sums / jnp.maximum(counts, 1)[:, None]
        gvalid = counts > 0
        guesses = jnp.where(gvalid[:, None], means, centroid[None, :])
        # Reference: empty clustering -> centroid only (utils.py:353-354).
    else:
        # Unknown method -> centroid only (utils.py:355-356).
        guesses = jnp.tile(centroid[None, :], (1, 1))
        gvalid = jnp.ones(1, bool)

    # No valid pair guesses at all -> centroid only (utils.py:316-317,336-337).
    any_pairs = jnp.any(pvalid)
    guesses = jnp.where(any_pairs, guesses,
                        jnp.broadcast_to(centroid, guesses.shape))
    gvalid = jnp.where(any_pairs, gvalid,
                       jnp.arange(guesses.shape[0]) < 1)

    # Always append the centroid unless already present (utils.py:358-361).
    present = jnp.any(gvalid & jnp.all(
        jnp.abs(guesses - centroid[None, :]) <= 1e-6, -1))
    guesses = jnp.concatenate([guesses, centroid[None, :]], 0)
    gvalid = jnp.concatenate([gvalid, ~present[None]], 0)
    guesses = jnp.where(gvalid[:, None], guesses, centroid[None, :])
    return guesses, gvalid


def dynamic_bounds(mic_positions: jnp.ndarray, tdoas: jnp.ndarray, c,
                   buffer: float = 5.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extended per-axis box (dynamic_bounds_extended, utils.py:364-382):
    mic min/max -/+ (buffer + max(75th pct of c|td|, 1.0))."""
    margin_extra = jnp.percentile(c * jnp.abs(tdoas), 75.0)
    margin = buffer + jnp.maximum(margin_extra, 1.0)
    lower = jnp.min(mic_positions, 0) - margin
    upper = jnp.max(mic_positions, 0) + margin
    return lower, upper


# ---------------------------------------------------------------------------
# Bounded Levenberg-Marquardt, vmapped over restarts (main.py:261-274)
# ---------------------------------------------------------------------------

class LMResult(NamedTuple):
    x: jnp.ndarray
    cost: jnp.ndarray


def _solve3(a_mat: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 solve (Cramer via cofactors), fully elementwise.

    Replaces ``jnp.linalg.solve``'s batched tiny LU factorizations with
    elementwise arithmetic that fuses into the LM step; the damped JtJ is
    well-conditioned by construction (diagonal floor in lm_solve), so
    Cramer in f32 matches LU to ~2e-7."""
    a, b, c = a_mat[..., 0, 0], a_mat[..., 0, 1], a_mat[..., 0, 2]
    d, e, f = a_mat[..., 1, 0], a_mat[..., 1, 1], a_mat[..., 1, 2]
    g, h, i = a_mat[..., 2, 0], a_mat[..., 2, 1], a_mat[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    x0 = co_a * rhs[..., 0] + (c * h - b * i) * rhs[..., 1] \
        + (b * f - c * e) * rhs[..., 2]
    x1 = co_b * rhs[..., 0] + (a * i - c * g) * rhs[..., 1] \
        + (c * d - a * f) * rhs[..., 2]
    x2 = co_c * rhs[..., 0] + (b * g - a * h) * rhs[..., 1] \
        + (a * e - b * d) * rhs[..., 2]
    return jnp.stack([x0, x1, x2], -1) / det[..., None]


def lm_solve(x0: jnp.ndarray, mic_positions, pairs_i, pairs_j, tdoas, c,
             weights, lower, upper, iters: int = 60,
             lam0: float = 1e-3, ftol: float = 1e-6, xtol: float = 1e-6,
             gtol: float = 1e-6) -> LMResult:
    """Projected Levenberg-Marquardt on the weighted TDOA system;
    cost = 0.5 * sum(r^2) (scipy's convention).

    Runs under ``lax.while_loop`` with the reference's scipy stopping rules
    (least_squares ftol/xtol/gtol = 1e-6, main.py:262-273): stop when an
    accepted step improves the cost by <= ftol*cost, moves x by
    <= xtol*(xtol + ||x||), when the gradient inf-norm falls below gtol, or
    after ``iters`` iterations.  Typical consistent TDOA systems converge in
    ~10-20 iterations, so the data-dependent exit is ~3x cheaper than a
    static 60-step scan at identical results (vmapped restarts run until the
    slowest lane converges)."""

    def cost_fn(x):
        r = tdoa_residuals(x, mic_positions, pairs_i, pairs_j, tdoas, c, weights)
        return 0.5 * jnp.sum(r * r)

    def cond(state):
        _, _, _, it, done = state
        return (it < iters) & ~done

    def body(state):
        x, lam, cost, it, done = state
        r, jac = tdoa_residuals_and_jac(
            x, mic_positions, pairs_i, pairs_j, tdoas, c, weights)
        jtj = jac.T @ jac
        jtr = jac.T @ r
        A = jtj + lam * jnp.diag(jnp.maximum(jnp.diag(jtj), 1e-12))
        delta = _solve3(A, -jtr)
        x_new = jnp.clip(x + delta, lower, upper)
        new_cost = cost_fn(x_new)
        accept = new_cost < cost
        step = jnp.linalg.norm(x_new - x)
        conv_f = accept & ((cost - new_cost) <= ftol * cost)
        conv_x = accept & (step <= xtol * (xtol + jnp.linalg.norm(x)))
        conv_g = jnp.max(jnp.abs(jtr)) <= gtol
        stuck = lam >= 1e12  # rejections piled up; no step can be accepted
        x = jnp.where(accept, x_new, x)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12),
                        jnp.minimum(lam * 2.0, 1e12))
        return (x, lam, cost, it + 1, done | conv_f | conv_x | conv_g | stuck)

    x0 = jnp.clip(x0, lower, upper)
    state = (x0, jnp.asarray(lam0, x0.dtype), cost_fn(x0), jnp.asarray(0),
             jnp.asarray(False))
    x, _, cost, _, _ = jax.lax.while_loop(cond, body, state)
    return LMResult(x, cost)


def multi_start_lm(guesses: jnp.ndarray, mic_positions, pairs_i, pairs_j,
                   tdoas, c, weights, lower, upper,
                   iters: int = 60) -> LMResult:
    """Vmapped restarts + argmin-cost selection (the reference's restart
    loop, main.py:261-274)."""
    solve = jax.vmap(lambda g: lm_solve(
        g, mic_positions, pairs_i, pairs_j, tdoas, c, weights, lower, upper,
        iters))
    res = solve(guesses)
    # NaN-safe selection: a poisoned restart (NaN cost) must lose, not win
    # (jnp.argmin propagates NaN as the minimum).
    cost = jnp.where(jnp.isnan(res.cost), jnp.inf, res.cost)
    best = jnp.argmin(cost)
    return LMResult(res.x[best], cost[best])


def multi_start_lm_robust(guesses: jnp.ndarray, mic_positions, pairs_i,
                          pairs_j, tdoas, c, weights, lower, upper,
                          iters: int = 60,
                          huber_k: float = 1.345) -> LMResult:
    """Outlier-robust LM: exhaustive leave-k-out consensus (least median
    of squares) followed by a Huber-weighted refit.

    Reverberant scenes corrupt individual pairs (a reflection peak outbids
    the direct path), and squared loss lets one gross outlier drag the fix
    meters away; reweighting from the corrupted fit (plain IRLS) cannot
    recover because the initial fit already sits in the outliers' basin
    (measured on the 10 dB reverberant eval regime: IRLS left the hit
    rate at the plain-LM 84%).  Instead, solve every pair subset with k
    pairs removed (k = 2 for P >= 6, 1 for P >= 4, else 0; subsets are
    static so the whole enumeration vmaps), score each candidate by the
    MEDIAN absolute residual over ALL pairs, take the least-median fix,
    and refit once with Huber weights from its MAD scale.  Same regime
    measured: 84% -> 97% hit, p90 0.63 m -> 0.026 m; on clean scenes the
    subset fits agree and the result matches plain multi_start_lm.
    P is small (M(M-1)/2), so jnp.median here is fine (the sort ban in
    the working notes is for big arrays)."""
    p = int(pairs_i.shape[0])
    drop = 2 if p >= 6 else (1 if p >= 4 else 0)
    ones = jnp.ones_like(weights)
    if drop == 0:
        return multi_start_lm(guesses, mic_positions, pairs_i, pairs_j,
                              tdoas, c, weights, lower, upper, iters)
    combos = list(itertools.combinations(range(p), drop))
    masks = np.ones((len(combos), p))
    for row, gone in enumerate(combos):
        masks[row, list(gone)] = 0.0
    masks = jnp.asarray(masks, tdoas.dtype)                 # (S, P) static

    def solve_subset(mask):
        best = multi_start_lm(guesses, mic_positions, pairs_i, pairs_j,
                              tdoas, c, weights * mask, lower, upper, iters)
        r = jnp.abs(tdoa_residuals(best.x, mic_positions, pairs_i, pairs_j,
                                   tdoas, c, ones))
        return best.x, jnp.median(r)

    xs, med = jax.vmap(solve_subset)(masks)
    i = jnp.argmin(med)
    x = xs[i]
    # Huber-weighted refit on all pairs from the least-median fix (floor
    # the MAD scale at 1 mm so a near-perfect fit never zeroes weights)
    r = jnp.abs(tdoa_residuals(x, mic_positions, pairs_i, pairs_j, tdoas,
                               c, ones))
    s = jnp.maximum(med[i] / 0.6745, 1e-3)
    w = weights * jnp.minimum(1.0, huber_k * s / jnp.maximum(r, 1e-12))
    return multi_start_lm(x[None, :], mic_positions, pairs_i, pairs_j,
                          tdoas, c, w, lower, upper, iters)


# ---------------------------------------------------------------------------
# Box-constrained L-BFGS-B (the reference's DE polish, main.py:281-292:
# scipy differential_evolution(polish=True) refines with L-BFGS-B)
# ---------------------------------------------------------------------------

class LBFGSBResult(NamedTuple):
    x: jnp.ndarray
    fun: jnp.ndarray


def lbfgsb_minimize(objective, x0: jnp.ndarray, lower: jnp.ndarray,
                    upper: jnp.ndarray, history: int = 10,
                    maxiter: int = 100, pgtol: float = 1e-5,
                    ftol: float = 2.220446049250313e-09) -> LBFGSBResult:
    """Projected L-BFGS for box constraints, jit/vmap-safe (static shapes,
    lax.while_loop).  Direction from the standard two-loop recursion over a
    ring buffer of (s, y) pairs with active-set gradient masking; step from
    a projected-Armijo backtracking search; stopping rules match scipy's
    L-BFGS-B defaults (projected-gradient infinity norm <= pgtol, or
    relative f decrease <= ftol = factr * eps with factr = 1e7).

    Converges to the same box-constrained minimizers as scipy's Fortran
    L-BFGS-B on smooth problems (pinned in tests/test_solver_lbfgsb.py);
    the Cauchy-point/subspace mechanics of the Fortran code are replaced
    by gradient projection, which changes the trajectory, not the fixed
    points (the KKT conditions agree).
    """
    dim = x0.shape[0]
    grad = jax.grad(lambda x: jnp.asarray(objective(x)))
    proj = lambda x: jnp.clip(x, lower, upper)
    # division guard representable in float32 (1e-300 flushes to 0 there)
    tiny = float(jnp.finfo(jnp.result_type(x0, jnp.float32)).tiny)

    def active_set(x, g):
        # dims pressed against a bound by the gradient (KKT-inactive)
        return ((x <= lower) & (g > 0)) | ((x >= upper) & (g < 0))

    def direction(g, S, Y, rho, count, head):
        # two-loop recursion over the valid ring-buffer entries
        m = S.shape[0]
        idx = (head - 1 - jnp.arange(m)) % m          # newest -> oldest
        valid = jnp.arange(m) < count

        def bwd(carry, k):
            q, alpha = carry
            i = idx[k]
            a = jnp.where(valid[k], rho[i] * jnp.dot(S[i], q), 0.0)
            q = q - a * Y[i]
            return (q, alpha.at[i].set(a)), None

        (q, alpha), _ = jax.lax.scan(bwd, (g, jnp.zeros(m)), jnp.arange(m))
        newest = (head - 1) % m
        gamma = jnp.where(
            count > 0,
            jnp.dot(S[newest], Y[newest]) /
            jnp.maximum(jnp.dot(Y[newest], Y[newest]), tiny),
            1.0)
        r = gamma * q

        def fwd(r, k):
            i = idx[m - 1 - k]
            b = jnp.where(valid[m - 1 - k], rho[i] * jnp.dot(Y[i], r), 0.0)
            return r + (alpha[i] - b) * S[i], None

        r, _ = jax.lax.scan(fwd, r, jnp.arange(m))
        return -r

    def line_search(x, f, d):
        # projected backtracking: accept P(x + a*d) on sufficient decrease
        def cond(st):
            a, ok, _, _, tries = st
            return (~ok) & (tries < 30)

        def body(st):
            a, _, xn, fn, tries = st
            xa = proj(x + a * d)
            fa = jnp.asarray(objective(xa))
            decrease = fa <= f - 1e-4 * jnp.sum((x - xa) ** 2) / \
                jnp.maximum(a, tiny)
            ok = decrease & jnp.isfinite(fa)
            return (jnp.where(ok, a, 0.5 * a),
                    ok,
                    jnp.where(ok, xa, xn),
                    jnp.where(ok, fa, fn),
                    tries + 1)

        a0 = jnp.asarray(1.0)
        st = (a0, jnp.asarray(False), x, f, jnp.asarray(0))
        _, ok, xn, fn, _ = jax.lax.while_loop(cond, body, st)
        return ok, xn, fn

    m = history

    def step(state):
        x, f, g, S, Y, rho, head, count, it, _ = state
        active = active_set(x, g)
        gm = jnp.where(active, 0.0, g)
        d = direction(gm, S, Y, rho, count, head)
        # restrict the step to the free subspace: the ring-buffer history
        # couples bound dims back into d, which breaks descent at a face
        d = jnp.where(active, 0.0, d)
        # safeguard: fall back to steepest descent when curvature is junk
        d = jnp.where(jnp.dot(d, gm) < 0, d, -gm)
        ok, xn, fn = line_search(x, f, d)
        xn = jnp.where(ok, xn, x)
        fn = jnp.where(ok, fn, f)
        gn = grad(xn)
        s, y = xn - x, gn - g
        sy = jnp.dot(s, y)
        store = ok & (sy > 1e-10 * jnp.linalg.norm(s) * jnp.linalg.norm(y))
        pos = head % m
        S = jnp.where(store, S.at[pos].set(s), S)
        Y = jnp.where(store, Y.at[pos].set(y), Y)
        rho = jnp.where(store, rho.at[pos].set(1.0 / jnp.maximum(sy, tiny)),
                        rho)
        head = jnp.where(store, head + 1, head)
        count = jnp.where(store, jnp.minimum(count + 1, m), count)
        pg = jnp.max(jnp.abs(proj(xn - gn) - xn))
        fdrop = (f - fn) / jnp.maximum(
            jnp.maximum(jnp.abs(f), jnp.abs(fn)), 1.0)
        done = (pg <= pgtol) | (ok & (fdrop <= ftol)) | (~ok)
        return (xn, fn, gn, S, Y, rho, head, count, it + 1, done)

    x0 = proj(jnp.asarray(x0, jnp.result_type(x0, jnp.float32)))
    f0 = jnp.asarray(objective(x0))
    g0 = grad(x0)
    state = (x0, f0, g0,
             jnp.zeros((m, dim), x0.dtype), jnp.zeros((m, dim), x0.dtype),
             jnp.zeros(m, x0.dtype), jnp.asarray(0), jnp.asarray(0),
             jnp.asarray(0), jnp.asarray(False))
    state = jax.lax.while_loop(
        lambda s: (~s[-1]) & (s[-2] < maxiter), step, state)
    return LBFGSBResult(state[0], state[1])


# ---------------------------------------------------------------------------
# Differential evolution (main.py:281-292), resident on device
# ---------------------------------------------------------------------------

class DEResult(NamedTuple):
    x: jnp.ndarray
    energy: jnp.ndarray


def differential_evolution(objective, lower: jnp.ndarray, upper: jnp.ndarray,
                           key: jax.Array, popsize: int = 15,
                           maxiter: int = 1000, tol: float = 1e-6,
                           mutation: Tuple[float, float] = (0.5, 1.0),
                           recombination: float = 0.7,
                           polish_fn=None,
                           init: Optional[jnp.ndarray] = None) -> DEResult:
    """best1bin DE with dithered mutation and latin-hypercube init, matching
    the reference's scipy parameters (main.py:281-292); the population lives
    on device and evolves under lax.while_loop with scipy's convergence rule
    (std(energies) <= atol + tol*|mean(energies)|).
    """
    dim = lower.shape[0]
    pop_n = popsize * dim
    k_init, k_loop = jax.random.split(key)

    # Latin hypercube init: stratified uniform samples, permuted per dim.
    segs = (jnp.arange(pop_n) + jax.random.uniform(k_init, (dim, pop_n))) / pop_n
    perms = jax.vmap(lambda k: jax.random.permutation(k, pop_n))(
        jax.random.split(jax.random.fold_in(k_init, 1), dim))
    samples = jnp.take_along_axis(segs, perms, 1).T        # (pop, dim)
    pop = lower[None, :] + samples * (upper - lower)[None, :]
    if init is not None:
        # Seed the population with caller-provided candidates (clipped into
        # bounds), e.g. the clustering-based heuristic guesses — TDOA
        # landscapes have competitive far-field basins that a pure
        # latin-hypercube start frequently converges into (as does scipy's,
        # tol=0.01 — the reference's DE fallback shares the failure mode).
        k = min(init.shape[0], pop_n)
        pop = pop.at[:k].set(jnp.clip(init[:k], lower[None, :], upper[None, :]))
    energies = jax.vmap(objective)(pop)

    def converged(state):
        _, _, energies, it = state
        mean = jnp.mean(energies)
        return (jnp.std(energies) <= 1e-8 + tol * jnp.abs(mean)) | (it >= maxiter)

    def body(state):
        key, pop, energies, it = state
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        best = pop[jnp.argmin(energies)]
        f = jax.random.uniform(k1, (), minval=mutation[0], maxval=mutation[1])
        # Two distinct random partners per member (approximate sampling
        # without replacement via independent draws + reroll-free offset).
        r1 = jax.random.randint(k2, (pop_n,), 0, pop_n)
        r2 = (r1 + 1 + jax.random.randint(k3, (pop_n,), 0, pop_n - 1)) % pop_n
        mutant = best[None, :] + f * (pop[r1] - pop[r2])
        mutant = jnp.clip(mutant, lower[None, :], upper[None, :])
        cross = jax.random.uniform(k4, (pop_n, dim)) < recombination
        # binomial crossover: ensure at least one dim from the mutant.
        forced = jax.random.randint(jax.random.fold_in(k4, 1), (pop_n,), 0, dim)
        cross = cross.at[jnp.arange(pop_n), forced].set(True)
        trial = jnp.where(cross, mutant, pop)
        trial_e = jax.vmap(objective)(trial)
        better = trial_e < energies
        pop = jnp.where(better[:, None], trial, pop)
        energies = jnp.where(better, trial_e, energies)
        return (key, pop, energies, it + 1)

    state = (k_loop, pop, energies, jnp.asarray(0))
    state = jax.lax.while_loop(lambda s: ~converged(s), body, state)
    _, pop, energies, _ = state
    best_idx = jnp.argmin(energies)
    x, e = pop[best_idx], energies[best_idx]
    if polish_fn is not None:  # scipy polish=True runs L-BFGS-B; we polish
        x, e = polish_fn(x)    # with the same bounded LM used elsewhere
    return DEResult(x, e)
