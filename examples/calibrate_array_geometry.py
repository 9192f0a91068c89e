"""Array-geometry self-calibration: recover jittered microphone positions
from a handful of test emissions at surveyed source positions.

The reference's calibration (calibration.py:4-48) estimates per-microphone
DELAY offsets and assumes the microphone coordinates are exact.  Real
deployments survey mic positions to a few centimeters at best — and a 3 cm
coordinate error is ~90 us of arrival-time error, an order of magnitude
above the TDOA resolution of a broadband capture.  This example plays K
noise bursts from known positions, measures pair TDOAs with the standard
GCC-PHAT ladder, and refines the geometry with
``models/arraycal.calibrate_array_geometry`` (one jitted Jacobi
block-coordinate Gauss-Newton scan).

Run:  PYTHONPATH=. python examples/calibrate_array_geometry.py
"""

import jax
import jax.numpy as jnp
import numpy as np

from pyaudiolocalization_tpu.models.acoustics import speed_of_sound
from pyaudiolocalization_tpu.models.arraycal import calibrate_array_geometry
from pyaudiolocalization_tpu.models.simulator import simulate_signals_fast

FS = 48000.0
C = float(speed_of_sound(20.0, 50.0))

nominal = np.array([
    [0.0, 0.0, 0.0],
    [1.0, 0.0, 0.0],
    [0.5, 1.0, 0.0],
    [0.5, 0.5, 1.0],
])
rng = np.random.default_rng(11)
true_mics = nominal + rng.uniform(-0.03, 0.03, nominal.shape)  # survey error

# Eight test emissions spread through (and slightly beyond) the array volume
# — events coplanar with a mic leave its out-of-plane coordinate weakly
# constrained, so spread them in 3-D.
sources = np.array([
    [0.2, 0.3, 0.6], [0.9, 0.8, 0.4], [0.1, 0.9, 0.9], [0.8, 0.1, 0.8],
    [0.5, 0.6, 0.2], [0.3, 0.2, 1.1], [1.1, 0.5, 0.7], [0.6, 1.0, 1.0],
])

print(f"simulating {len(sources)} calibration events at {FS/1000:.0f} kHz …")
signals = jnp.stack([
    simulate_signals_fast(
        sources[k], true_mics, FS, C, 0.1, "noise", 500.0,
        None, None, jnp.asarray([0.01]), jnp.asarray([1e-6]),
        0, 1e-4, key=jax.random.PRNGKey(100 + k))
    for k in range(len(sources))])

result = calibrate_array_geometry(signals, sources, nominal, FS, C,
                                  max_expected_delay=0.02)

init_err = np.linalg.norm(nominal - true_mics, axis=-1)
final_err = np.linalg.norm(np.asarray(result.mic_positions) - true_mics,
                           axis=-1)
print(f"residual cost: {float(result.initial_cost):.3e} -> "
      f"{float(result.cost):.3e}")
for i in range(len(nominal)):
    print(f"  mic {i}: survey error {init_err[i]*1e3:6.2f} mm -> "
          f"calibrated {final_err[i]*1e3:5.2f} mm")
print(f"worst mic: {init_err.max()*1e3:.1f} mm -> {final_err.max()*1e3:.2f} mm"
      f"  (TDOA sample quantization at {FS/1000:.0f} kHz is "
      f"{C/FS*1e3:.1f} mm of range)")


# --- Unknown event positions: joint self-calibration (needs >= 5 mics) ---
# A 4-mic array is structurally unidentifiable from TDOAs alone (each
# event's 3 independent TDOAs are exactly consumed by its own unknown
# position), so this part uses a 6-mic array.  Absolute positions inherit
# the rigid (data-null) component of the survey error; the inter-mic
# SHAPE — what TDOA localization actually consumes — recovers to the
# measurement floor.
mics6 = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                  [0.0, 0.0, 1.0], [1.0, 1.0, 0.0], [0.5, 0.5, 1.2]])
true6 = mics6 + rng.uniform(-0.03, 0.03, mics6.shape)
sources12 = np.vstack([sources, [[0.9, 0.2, 0.2], [0.2, 0.8, 0.3],
                                 [0.7, 0.7, 1.1], [0.4, 0.1, 0.9]]])
signals6 = jnp.stack([
    simulate_signals_fast(
        sources12[k], true6, FS, C, 0.1, "noise", 500.0,
        None, None, jnp.asarray([0.01]), jnp.asarray([1e-6]),
        0, 1e-4, key=jax.random.PRNGKey(300 + k))
    for k in range(len(sources12))])
joint = calibrate_array_geometry(signals6, None, mics6, FS, C,
                                 max_expected_delay=0.02)


def _pairwise(m):
    iu = np.triu_indices(len(m), 1)
    return np.linalg.norm(m[:, None] - m[None, :], axis=-1)[iu]


shape_err = np.abs(_pairwise(np.asarray(joint.mic_positions))
                   - _pairwise(true6))
shape_init = np.abs(_pairwise(mics6) - _pairwise(true6))
print(f"\nself-calibration (event positions unknown, 6 mics, "
      f"{len(sources12)} events):")
print(f"  worst inter-mic distance error: {shape_init.max()*1e3:.1f} mm "
      f"(survey) -> {shape_err.max()*1e3:.2f} mm (calibrated)")
