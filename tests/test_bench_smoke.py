"""Execute every bench.py code path at tiny sizes on CPU.

This test runs ``bench.main()`` end-to-end — suite rollout,
BatchedDiscreteEnv RL paths, the lockstep sweep and the log-materializing
collect rollout — so no benchmark path reaches the device without having
run once.
"""
import importlib.util
import json
import os
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {
    "PYMGRID_BENCH_CONFIGS": "2",
    "PYMGRID_BENCH_REPLICAS": "4",
    "PYMGRID_BENCH_STEPS": "10",
    "PYMGRID_BENCH_REPEATS": "1",
    "PYMGRID_BENCH_RL_BATCH": "8",
    "PYMGRID_BENCH_RL_STEPS": "3",
    "PYMGRID_BENCH_RL_LOOP_STEPS": "3",
    "PYMGRID_BENCH_SWEEP_BATCH": "16",
    "PYMGRID_BENCH_SWEEP_STEPS": "5",
    "PYMGRID_BENCH_COLLECT_REPLICAS": "4",
    "PYMGRID_BENCH_COLLECT_STEPS": "5",
    "PYMGRID_BENCH_COLLECT_CONFIGS": "2",
}


def _load_bench():
    path = os.path.join(REPO_ROOT, "bench.py")
    spec = importlib.util.spec_from_file_location("bench_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def bench(monkeypatch, tmp_path):
    for key, value in TINY.items():
        monkeypatch.setenv(key, value)
    # a set cache directory makes bench.main() leave the test process's
    # compilation-cache config alone (JAX read the variable at import)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("PYMGRID_BENCH_SKIP_EXTRAS", raising=False)
    return _load_bench()


def test_main_prints_complete_json(bench, capsys):
    bench.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(line)

    assert result["metric"] == "batched_env_steps_per_sec_per_chip_pymgrid25_suite"
    assert result["unit"] == "env_steps/s/chip"
    for field in ("value", "vs_baseline", "rl_env_steps_per_sec",
                  "rl_fused_steps_per_sec", "continuous_env_steps_per_sec",
                  "collect_steps_per_sec", "engine_sweep_steps_per_sec"):
        assert result[field] > 0, field
    assert result["n_configs"] == 2
    assert result["total_envs"] == 8
    device = result["device"]
    assert device["platform"] == "cpu" and device["count"] >= 1
    assert device["kind"] and device["name_power_limit"]


def test_collect_rollout_materializes_full_stepoutput(bench):
    import numpy as np

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu.parallel.suite import SuiteRunner

    n_configs, replicas, n_steps = 2, 3, 6
    microgrids = [Microgrid.from_scenario(n) for n in range(n_configs)]
    runner = SuiteRunner(microgrids, batch_per_config=replicas, dtype=np.float32)
    policy = make_marginal_cost_policy(runner.spec)
    fn = runner.rollout_fn(policy, n_steps, auto_reset=True, collect=True)

    acc, outs = fn(runner.params, runner.make_keys(seed=0))
    # full time-major StepOutput: (configs, replicas, steps, ...) per field
    assert acc.shape == (n_configs, replicas)
    assert outs.reward.shape == (n_configs, replicas, n_steps)
    assert outs.done.shape == (n_configs, replicas, n_steps)
    assert outs.obs.shape[:3] == (n_configs, replicas, n_steps)
    assert outs.obs.shape[3] > 0
    assert outs.log_row.shape[:3] == (n_configs, replicas, n_steps)
    assert outs.log_row.shape[3] > 0
    assert np.isfinite(np.asarray(outs.reward)).all()
    assert np.isfinite(np.asarray(outs.log_row)).all()
    # collect=False checksum must agree with the collect=True run
    fn_fast = runner.rollout_fn(policy, n_steps, auto_reset=True, collect=False)
    acc_fast = fn_fast(runner.params, runner.make_keys(seed=0))
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(acc_fast))


def test_chip_report_writer_computes_measured_deltas(tmp_path):
    """RESULTS_CHIP.md generation (tools/run_benchmarks._write_chip_report):
    host-table parsing, per-scenario delta columns, and the measured summary
    line all run on canned rows without touching a solver."""
    path = os.path.join(REPO_ROOT, "tools", "run_benchmarks.py")
    spec = importlib.util.spec_from_file_location("run_benchmarks_ut", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    out = tmp_path / "chip.md"
    rows = [(0, 1_039_882.62, 8759, 112.9), (3, 101_810_000.0, 8759, 170.5)]
    module._write_chip_report(rows, enum_bits=5, out=out)

    text = out.read_text()
    assert "enum_bits=5" in text
    assert "Measured this run" in text
    # scenario 0 host cost comes from RESULTS.md; delta must be computed
    assert "1,033,040.53" in text and "+0.66%" in text
    assert text.strip().splitlines()[-1].startswith("| **total (matched)** |")
