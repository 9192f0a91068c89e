"""Two-process CPU multi-host sweep (SURVEY.md §5.8 shape; VERDICT r1 #5).

Spawns two coordinated worker processes (jax.distributed.initialize over a
localhost coordinator), each with FOUR virtual CPU devices, and runs
``monte_carlo_sweep`` over the 8-device GLOBAL mesh.  Both processes must
produce identical, finite replicated summaries.

Excluded from the default suite (slow: two cold JAX processes); run with
``pytest -m multihost``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

WORKER = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    # Force exactly FOUR local devices (strip any inherited count, e.g. the
    # unit suite's 8): 2 processes x 4 devices = the 8-device global mesh.
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "host_platform_device_count" not in f]
    os.environ["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=4"])
    import jax
    jax.config.update("jax_platforms", "cpu")

    from pyaudiolocalization_tpu.parallel import multihost
    multihost.initialize()  # coordinator/process env vars set by the test

    from pyaudiolocalization_tpu.parallel import SweepSpec, monte_carlo_sweep

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    mesh = multihost.global_scene_mesh()
    spec = SweepSpec(fs=8000.0, duration=0.05, signal_type="noise",
                     source_box_lo=(0.2, 0.2, 0.2),
                     source_box_hi=(0.8, 0.8, 0.8), snr_db=(25.0, 35.0))
    summary = monte_carlo_sweep(spec, jax.random.PRNGKey(0), 16, mesh=mesh)

    # Sharding-correctness oracle (VERDICT r3 #4): scene keys are
    # split(seed)[i], so every ADDRESSABLE shard of the 2-host run must
    # reproduce the corresponding slice of an unsharded single-process run
    # of the same keys.  A scrambled scene->device mapping would pass the
    # replicated-summary checks but fail here.
    import numpy as np
    single = monte_carlo_sweep(spec, jax.random.PRNGKey(0), 16, mesh=None)
    est_single = np.asarray(single.results.estimate)
    shard_dev = 0.0
    n_local = 0
    for shard in summary.results.estimate.addressable_shards:
        ref = est_single[shard.index]
        shard_dev = max(shard_dev,
                        float(np.max(np.abs(np.asarray(shard.data) - ref))))
        n_local += ref.shape[0]
    assert n_local == 8, n_local  # half the scenes live on this host

    print(json.dumps({
        "process": jax.process_index(),
        "rmse": float(summary.rmse),
        "mean_error": float(summary.mean_error),
        "hit_rate": float(summary.hit_rate),
        "rmse_single": float(single.rmse),
        "shard_dev": shard_dev,
    }))
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.multihost
def test_two_process_sweep(tmp_path):
    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "PYTHONPATH": os.pathsep.join(
                [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
                + env.get("PYTHONPATH", "").split(os.pathsep)),
        })
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    assert {o["process"] for o in outs} == {0, 1}
    for o in outs:
        assert np.isfinite(o["rmse"]) and np.isfinite(o["hit_rate"])
    # The summary is psum-replicated over the global mesh: both hosts must
    # agree exactly.
    assert outs[0]["rmse"] == outs[1]["rmse"]
    assert outs[0]["mean_error"] == outs[1]["mean_error"]
    assert outs[0]["hit_rate"] == outs[1]["hit_rate"]
    # Per-scene equality vs the unsharded run (checked inside each worker
    # over its addressable shards) and summary agreement with it.
    for o in outs:
        assert o["shard_dev"] < 1e-5, o["shard_dev"]
        assert abs(o["rmse"] - o["rmse_single"]) < 1e-5 * (1 + o["rmse"])
    # Physics smoke: the sweep localizes (free-field broadband scenes).
    assert outs[0]["rmse"] < 0.5
    assert outs[0]["hit_rate"] >= 0.75
