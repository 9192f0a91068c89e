"""Multi-host (multi-process) execution — SURVEY.md §5.8's target shape.

The reference is a single-process NumPy program; the rebuild's distributed
story is JAX-native: one process per host, connected by
``jax.distributed.initialize``, with every array sharded over the GLOBAL
device mesh and XLA inserting the cross-host collectives (psum) — no
MPI/NCCL code of our own.

``initialize()`` wraps ``jax.distributed.initialize`` with environment
fallbacks, and ``global_scene_mesh()`` builds the sweep's 1-D scene mesh
over all processes' devices.  After that, ``monte_carlo_sweep(...,
mesh=global_scene_mesh())`` just works: scene keys are sharded over the
global mesh (each process materializes only its addressable shards) and the
summary statistics come back fully replicated on every host.

Tested by tests/test_multihost.py: two coordinated CPU processes with four
virtual devices each run a sharded sweep over the 8-device global mesh and
must agree on the replicated summary (run with ``pytest -m multihost``).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from .sweep import SCENE_AXIS, Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Connect this process to the JAX distributed runtime.

    Arguments default to the standard environment variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) so
    launchers can configure purely through the environment; on clusters JAX
    recognizes (e.g. SLURM) ``jax.distributed.initialize()`` auto-detects
    everything and all three may stay None.  Safe to call once per process,
    before any devices are used."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        v = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("JAX_PROCESS_ID")
        process_id = int(v) if v else None
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_scene_mesh(axis_name: str = SCENE_AXIS) -> Mesh:
    """1-D scene mesh over the GLOBAL device list (all processes).  Device
    order is jax.devices() order, which is identical on every process —
    a requirement for Mesh construction in multi-process programs."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def is_multiprocess() -> bool:
    return jax.process_count() > 1
