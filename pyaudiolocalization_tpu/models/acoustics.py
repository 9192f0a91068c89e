"""Acoustic geometry: speed of sound, reflections, attenuation, and the
image-source multipath model as a dense masked tensor program.

Counterpart of the reference's L2 layer (utils.py:15-106, materials.py).
The reference builds image sources with a Python BFS over reflection orders,
deduplicating by 6-decimal-rounded coordinate tuples and culling by an
attenuation rule (utils.py:67-106).  Here the no-immediate-repeat reflection
tree for (P planes, order K) is a *static* structure — P·(P-1)^(k-1) nodes
per order, enumerated on the host — and only the geometry and the
acceptance masks are computed on device, preserving the reference's exact
BFS traversal/dedupe/threshold semantics as a sequential masked scan over
the (small) node list.  Reflecting a node across its own plane returns its
parent's position, which is always already "seen", so dropping immediate
repeats changes nothing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def speed_of_sound(temperature, humidity, pressure: float = 101.325):
    """331 + 0.6 T + 0.0124 H + 0.0006 (p - 101.325), with the reference's
    out-of-range clamps to 20 degC / 50 % (utils.py:15-27)."""
    t = jnp.where((temperature < -50) | (temperature > 50), 20.0, temperature)
    h = jnp.where((humidity < 0) | (humidity > 100), 50.0, humidity)
    return 331.0 + 0.6 * t + 0.0124 * h + 0.0006 * (pressure - 101.325)


def speed_of_sound_host(temperature: float, humidity: float,
                        pressure: float = 101.325) -> float:
    """Host-side scalar version (same clamps): callers that need a concrete
    Python float should not pay a device dispatch + fetch for three
    multiplies."""
    t = 20.0 if (temperature < -50 or temperature > 50) else temperature
    h = 50.0 if (humidity < 0 or humidity > 100) else humidity
    return 331.0 + 0.6 * t + 0.0124 * h + 0.0006 * (pressure - 101.325)


def reflect_point_across_plane(point: jnp.ndarray, plane: jnp.ndarray) -> jnp.ndarray:
    """Mirror ``point`` (..., 3) across plane ax+by+cz+d=0 given as (..., 4)
    (utils.py:29-42).  Degenerate planes (a=b=c=0) must be rejected by the
    caller — under jit we cannot raise on data."""
    normal = plane[..., :3]
    d = plane[..., 3]
    denom = jnp.sum(normal * normal, -1)
    factor = 2.0 * (jnp.sum(normal * point, -1) + d) / denom
    return point - normal * factor[..., None]


def distance(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.norm(p1 - p2, axis=-1)


def calculate_attenuation(dist, material_id, frequency,
                          absorption_table: jnp.ndarray,
                          freq_table: jnp.ndarray):
    """(1/max(d, 0.1)) * exp(-freq_coeff * f * d) * exp(-absorption * d)
    (utils.py:50-65), with materials as id-indexed tables.  Note SURVEY.md
    Q2: with the reference's coefficient values and f in Hz this underflows
    to ~0 — reproduced faithfully."""
    d = jnp.maximum(dist, 0.1)
    absorption = jnp.take(absorption_table, material_id)
    fcoeff = jnp.take(freq_table, material_id)
    return (1.0 / d) * jnp.exp(-fcoeff * frequency * d) * jnp.exp(-absorption * d)


def attenuation_freq_slope(dist, material_id, freq_table: jnp.ndarray):
    """d(log gain)/d(frequency) of the attenuation law: the reference's
    exp(-freq_coeff * f * d) term (utils.py:50-65) is log-linear in f with
    slope -freq_coeff * d.  Per-bin rendering (absorption_mode='per-bin')
    evaluates the SAME law at every rfft bin instead of the carrier:
    gain(f) = gain(0) * exp(-slope * f), with gain referenced at f=0 so the
    exponent argument is never positive (f32-safe; see
    simulator._scene_geometry per_bin)."""
    d = jnp.maximum(dist, 0.1)
    return jnp.take(freq_table, material_id) * d


def log_attenuation(dist, material_id, frequency,
                    absorption_table: jnp.ndarray,
                    freq_table: jnp.ndarray):
    """log(calculate_attenuation(...)): exact in float32 where the linear
    form underflows (exp(-90) flushes to zero under XLA's FTZ — SURVEY.md
    Q2 distances do this for the reference's default materials; the
    reference survives only because float64 NumPy keeps ~1e-40 subnormals
    that per-mic normalization then rescales)."""
    d = jnp.maximum(dist, 0.1)
    absorption = jnp.take(absorption_table, material_id)
    fcoeff = jnp.take(freq_table, material_id)
    return -jnp.log(d) - fcoeff * frequency * d - absorption * d


# ---------------------------------------------------------------------------
# Static reflection tree
# ---------------------------------------------------------------------------

class ReflectionTree(NamedTuple):
    """Dense no-immediate-repeat reflection tree (host-side, static).

    node_plane[i]: plane reflected across to create node i.
    node_parent[i]: index of the parent node, or -1 for order-1 nodes
    (children of the true source).
    node_order[i]: reflection order (1..max_order), BFS-sorted.
    """
    node_plane: np.ndarray
    node_parent: np.ndarray
    node_order: np.ndarray


@functools.lru_cache(maxsize=32)
def reflection_tree(num_planes: int, max_order: int) -> ReflectionTree:
    planes, parents, orders = [], [], []
    frontier = [(-1, -1)]  # (node_index, plane_of_node); root = true source
    for order in range(1, max_order + 1):
        new_frontier = []
        for node_idx, node_plane in frontier:
            for p in range(num_planes):
                if p == node_plane:
                    continue  # own-plane child == parent position, always a dup
                planes.append(p)
                parents.append(node_idx)
                orders.append(order)
                new_frontier.append((len(planes) - 1, p))
        frontier = new_frontier
    return ReflectionTree(np.array(planes, np.int32),
                          np.array(parents, np.int32),
                          np.array(orders, np.int32))


class ImageSources(NamedTuple):
    positions: jnp.ndarray   # (I, 3) image-source positions (dense tree)
    material_ids: jnp.ndarray  # (I,) material id per node (its plane's)
    accepted: jnp.ndarray    # (I,) bool — survives dedupe + attenuation rule
    orders: jnp.ndarray      # (I,) reflection order


def image_sources(source: jnp.ndarray,
                  plane_coeffs: jnp.ndarray,
                  plane_material_ids: jnp.ndarray,
                  mic_positions: jnp.ndarray,
                  frequency,
                  absorption_table: jnp.ndarray,
                  freq_table: jnp.ndarray,
                  max_order: int,
                  absorption_threshold: float = 0.01,
                  round_decimals: int = 6) -> ImageSources:
    """Device-side image-source generation matching
    generate_image_sources_iterative (utils.py:67-106) node for node.

    Returns the dense tree with an acceptance mask instead of a ragged list;
    ``positions[accepted]`` in node order equals the reference's output list.
    """
    num_planes = int(plane_coeffs.shape[0])
    if num_planes == 0 or max_order == 0:
        z3 = jnp.zeros((0, 3), source.dtype)
        zi = jnp.zeros((0,), jnp.int32)
        zb = jnp.zeros((0,), bool)
        return ImageSources(z3, zi, zb, zi)

    tree = reflection_tree(num_planes, max_order)
    num_nodes = len(tree.node_plane)
    node_plane = jnp.asarray(tree.node_plane)
    node_parent = jnp.asarray(tree.node_parent)

    # Positions: iterate orders; each node reflects its parent's position
    # (the true source for order 1).  Node count is static and small.
    positions = jnp.zeros((num_nodes, 3), source.dtype)

    def compute_pos(i, pos):
        parent = node_parent[i]
        base = jnp.where(parent < 0, source,
                         pos[jnp.maximum(parent, 0)])
        refl = reflect_point_across_plane(base, plane_coeffs[node_plane[i]])
        return pos.at[i].set(refl)

    positions = jax.lax.fori_loop(0, num_nodes, compute_pos, positions)

    material_ids = jnp.take(plane_material_ids, node_plane)

    # Attenuation acceptance rule: mean over mics > thr AND min > thr/2
    # (utils.py:97-99), with each node's own material — evaluated in log
    # space (stable logsumexp mean) so float32 runs don't flush the
    # reference-scale exp(-90) attenuations to zero (SURVEY.md Q2).
    dists = jnp.linalg.norm(
        positions[:, None, :] - mic_positions[None, :, :], axis=-1)  # (I, M)
    la = log_attenuation(dists, material_ids[:, None], frequency,
                         absorption_table, freq_table)
    if absorption_threshold > 0:
        log_thr = float(np.log(absorption_threshold))
        k = jnp.max(la, -1)
        log_mean = k + jnp.log(jnp.mean(jnp.exp(la - k[:, None]), -1))
        att_ok = (log_mean > log_thr) & (
            jnp.min(la, -1) > float(np.log(absorption_threshold / 2.0)))
    else:  # non-positive threshold accepts everything (attenuation > 0)
        att_ok = jnp.ones(num_nodes, bool)

    # Sequential BFS-order dedupe against previously ACCEPTED nodes and the
    # true source, by equality of 6-decimal-rounded coordinates
    # (utils.py:82,90-91); a node is only considered if its parent was
    # accepted (the reference expands accepted images only).
    q = jnp.round(positions, round_decimals)
    q_src = jnp.round(source, round_decimals)
    same_as_src = jnp.all(q == q_src[None, :], -1)

    def accept_step(i, acc):
        parent = node_parent[i]
        parent_ok = jnp.where(parent < 0, True, acc[jnp.maximum(parent, 0)])
        earlier = jnp.arange(num_nodes) < i
        dup = jnp.any(earlier & acc & jnp.all(q == q[i][None, :], -1)) | same_as_src[i]
        ok = parent_ok & ~dup & att_ok[i]
        return acc.at[i].set(ok)

    accepted = jax.lax.fori_loop(0, num_nodes, accept_step,
                                 jnp.zeros(num_nodes, bool))
    return ImageSources(positions, material_ids, accepted,
                        jnp.asarray(tree.node_order))
