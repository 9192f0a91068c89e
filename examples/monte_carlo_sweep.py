"""Monte-Carlo sweep (no reference counterpart): thousands of
randomized scenes as one sharded XLA graph, with checkpoint/resume.

On a multi-chip host the scene axis shards across the mesh; on one chip (or
CPU) it runs as a single vmapped graph.  Try:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/monte_carlo_sweep.py
"""

import jax

from pyaudiolocalization_tpu.parallel import (
    SweepSpec, make_mesh, monte_carlo_sweep, run_sweep_checkpointed)

spec = SweepSpec(
    fs=16000.0, duration=0.25, signal_type="noise",
    source_box_lo=(0.1, 0.1, 0.1), source_box_hi=(0.9, 0.9, 0.9),
    mic_jitter=0.0, snr_db=(20.0, 40.0),
    plane_coeffs=((1.0, 0.0, 0.0, -5.0),), plane_material_ids=(1,),
    max_reflections=1)

devices = jax.devices()
mesh = make_mesh() if len(devices) > 1 else None
print(f"{len(devices)} device(s); mesh={'yes' if mesh else 'no'}")

num = 64 if mesh is None else 8 * len(devices)
summary = monte_carlo_sweep(spec, jax.random.PRNGKey(0), num, mesh=mesh)
print(f"{num} scenes: RMSE={float(summary.rmse):.4f} m, "
      f"hit@10cm={float(summary.hit_rate):.2%}")

# Long sweeps: chunked with .npz checkpoints; rerunning resumes.
summary = run_sweep_checkpointed(
    spec, seed=0, num_scenes=num, chunk_scenes=num // 4,
    checkpoint_path="/tmp/sweep_checkpoint.npz", mesh=mesh, log_fn=print)
print(f"checkpointed sweep: RMSE={float(summary.rmse):.4f} m")

# Multi-source scenes: two simultaneous talkers per scene, localized with
# iterative-suppression SRP-PHAT; result fields gain a source axis and
# estimates come back matched to ground truth by best assignment.
multi = SweepSpec(
    fs=16000.0, duration=0.25, signal_type="noise", solver="srp",
    mic_positions=((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                   (0.0, 0.0, 1.0), (1.0, 1.0, 0.0), (1.0, 0.0, 1.0),
                   (0.0, 1.0, 1.0), (1.0, 1.0, 1.0)),
    num_sources=2, source_min_separation=0.4,
    source_box_lo=(0.1, 0.1, 0.1), source_box_hi=(0.9, 0.9, 0.9),
    snr_db=(20.0, 40.0))
summary = monte_carlo_sweep(multi, jax.random.PRNGKey(2), num, mesh=mesh)
print(f"2-source sweep: per-source RMSE={float(summary.rmse):.4f} m, "
      f"hit@10cm={float(summary.hit_rate):.2%}")
