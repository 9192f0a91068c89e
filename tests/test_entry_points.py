"""Script entry points and import hygiene: chip_smoke.py and bench.py refuse
to run without a GPU, the package runs without its optional plotting/audio
dependencies, and the compile cache goes where it is told."""

import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_cpu_before_any_phase(capsys, monkeypatch):
    """No hidden fallback: on the CPU backend chip_smoke exits non-zero with
    a clear message, runs no phase and prints no result line."""
    smoke = _load("chip_smoke")
    ran = []
    for name in ("phase_demo", "phase_scene", "phase_sweeps",
                 "phase_streaming", "phase_reference", "phase_four"):
        monkeypatch.setattr(smoke, name, lambda *a, _n=name: ran.append(_n))
    assert smoke.main([]) != 0
    assert smoke.main(["--four"]) != 0
    out, err = capsys.readouterr()
    assert ran == []
    assert "phase" not in out and '"ok"' not in out
    assert "no GPU" in err


def test_bench_refuses_cpu(capsys, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    bench = _load("bench")
    monkeypatch.setattr(bench, "bench_gcc_phat",
                        lambda *a: pytest.fail("bench ran on the CPU"))
    assert bench.main() != 0
    out, err = capsys.readouterr()
    assert out == "" and "no GPU" in err


def test_package_runs_without_optional_dependencies(tmp_path):
    """Import and localize (physical mode, and parity mode, which always
    plots) with matplotlib, sklearn and soundfile blocked: plots are skipped,
    nothing else needs them."""
    script = textwrap.dedent("""
        import copy, sys
        for name in ("matplotlib", "sklearn", "soundfile"):
            sys.modules[name] = None
        import numpy as np
        import pyaudiolocalization_tpu as pal
        cfg = copy.deepcopy(pal.DEFAULT_CONFIG)
        cfg.update(fs=8000, duration=0.25, signal_type="noise",
                   source_position=[0.3, 0.6, 0.4])
        cfg["localization"].update(
            analyze_correlation=False, visualize_correlation=False,
            lag_mode="physical", sync_mode="none")
        res = pal.localize_sound_source(cfg, show_plots=False)
        err = np.linalg.norm(res["estimated_position"] - [0.3, 0.6, 0.4])
        assert err < 0.05, err
        cfg["localization"].update(lag_mode="reference",
                                   sync_mode="reference")
        res = pal.localize_sound_source(cfg, show_plots=False)
        assert np.all(np.isfinite(res["estimated_position"]))
        print("OK")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
    assert "matplotlib is not installed" in proc.stderr
    assert not any(tmp_path.iterdir())          # no figure was written


def test_plots_skip_without_matplotlib(tmp_path, monkeypatch):
    from pyaudiolocalization_tpu.utils import plotting
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    plotting.plot_localization_3d(np.zeros((4, 3)), np.ones(3), np.ones(3),
                                  show_plot=False)
    plotting.plot_correlation_heatmap(np.eye(4), np.zeros((4, 3)),
                                      show_plot=False, save_path="h.png")
    assert not any(tmp_path.iterdir())


def _recorded_cache_updates(monkeypatch):
    from pyaudiolocalization_tpu.utils import compile_cache
    calls = {}
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return compile_cache, calls


def test_compile_cache_honours_env_var(tmp_path, monkeypatch):
    compile_cache, calls = _recorded_cache_updates(monkeypatch)
    target = tmp_path / "cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert compile_cache.enable_compile_cache(subdir="cpu-x") == str(target)
    assert calls["jax_compilation_cache_dir"] == str(target)
    assert target.is_dir()


def test_compile_cache_defaults_to_checkout(monkeypatch):
    compile_cache, calls = _recorded_cache_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache(min_compile_time_secs=0.5)
    assert Path(path).resolve() == (ROOT / ".jax_cache").resolve()
    assert calls["jax_compilation_cache_dir"] == path
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.5
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_compile_cache_subdir(monkeypatch):
    compile_cache, calls = _recorded_cache_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache(subdir="cpu-test")
    assert Path(path).resolve() == (ROOT / ".jax_cache" / "cpu-test").resolve()
