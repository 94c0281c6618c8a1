"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of its
phases runs at a tiny size and returns what the script compares, in the
shapes it compares them.  The GPU run itself is ``python chip_smoke.py``."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_cpu_only(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_on_cpu_only():
    proc = _run_cpu_only(REPO / "chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_exits_nonzero_outside_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    proc = _run_cpu_only(script, tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _golden(smoke):
    out = smoke.phase_golden(scenarios=[0, 2], n_steps=30)
    for key in ("f64", "f32", "reference"):
        assert out[key].shape == (2,)
    smoke._check("golden f64", out["f64"], out["reference"],
                 smoke.GOLDEN_F64_RTOL)
    smoke._check("golden f32", out["f32"], out["reference"],
                 smoke.GOLDEN_F32_RTOL)
    # conftest pins the pre-FMA CPU ISA: every float64 stream is bitwise
    assert out["bitwise"] == 2
    assert out["env_steps"] == 2 * 2 * 30


def _suite(smoke):
    out = smoke.phase_suite(n_configs=3, replicas=8, n_steps=16,
                            ref_replicas=4)
    assert out["value"].shape == out["reference"].shape == (3, 4)
    assert out["reference"].dtype == np.float64
    smoke._check("suite", out["value"], out["reference"],
                 smoke.F32_VS_F64_RTOL)
    assert out["env_steps"] == 3 * 8 * 16


def _rl(smoke):
    out = smoke.phase_rl(batch=16, n_step_calls=2, rollout_steps=4,
                         ref_envs=4)
    for kind in ("discrete", "continuous"):
        assert out[kind]["value"].shape == out[kind]["reference"].shape == (4,)
        smoke._check(kind, out[kind]["value"], out[kind]["reference"],
                     smoke.F32_VS_F64_RTOL)
    assert out["env_steps"] == 2 * 16 * 6


def _training(smoke):
    out = smoke.phase_training(scenario=1, batch=16, rollout_len=4)
    assert out["losses"].shape == (2,)
    assert np.isfinite(out["losses"]).all()
    assert out["value"].shape == out["reference"].shape == (1,)
    smoke._check("loss", out["value"], out["reference"],
                 smoke.TRAIN_LOSS_RTOL)


def _planners(smoke):
    out = smoke.phase_planners(scenarios=[0, 1], n_steps=2, saa_steps=2,
                               saa_samples=3)
    for key in ("f64", "f32", "cpu_f64", "host"):
        assert out[key].shape == (2,), key
    smoke._check("f64 vs cpu", out["f64"], out["cpu_f64"], smoke.MPC_F64_RTOL)
    smoke._check("f64 vs host", out["f64"], out["host"], smoke.HOST_MPC_RTOL)
    assert out["saa_rewards"].shape == (2,)
    assert np.isfinite(out["saa_rewards"]).all()


@pytest.mark.parametrize("phase", [_golden, _suite, _rl, _training, _planners],
                         ids=["golden", "suite", "rl", "training", "planners"])
def test_phase_runs_at_tiny_size(phase):
    phase(_load_smoke())


def test_compile_cache_respects_env_dir(monkeypatch, tmp_path):
    import jax

    from pymgrid_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_checkout(monkeypatch):
    import jax

    from pymgrid_tpu.utils.compile_cache import (
        DEFAULT_CACHE_DIR,
        enable_compile_cache,
    )

    assert DEFAULT_CACHE_DIR == REPO / ".jax_cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
