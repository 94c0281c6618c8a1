"""Heterogeneous suite batching: neutral padding exactness and suite runs."""
import numpy as np
import pytest

import pymgrid_tpu
from pymgrid_tpu.algos import RuleBasedControl
from pymgrid_tpu.core.compiled import CompiledMicrogrid
from pymgrid_tpu.core.rollout import make_priority_policy, make_rollout_fn
from pymgrid_tpu.parallel.suite import SuiteRunner, build_suite, normalize_to_superset


# scenario 0: grid only; scenario 4: genset only; scenario 1: both
@pytest.mark.parametrize("n", [0, 4, 1])
def test_neutral_padding_is_exact(n):
    """Padded config trajectories equal the original config bitwise."""
    mg = pymgrid_tpu.Microgrid.from_scenario(n)
    rbc = RuleBasedControl(mg)
    plain_log = rbc.run_compiled(max_steps=60)

    padded = normalize_to_superset(pymgrid_tpu.Microgrid.from_scenario(n))
    padded_rbc = RuleBasedControl(padded)
    padded_log = padded_rbc.run_compiled(max_steps=60)

    # compare shared columns (padded adds neutral-module columns)
    for col in plain_log.columns:
        assert col in padded_log.columns, f"missing {col}"
        np.testing.assert_array_equal(
            plain_log[col].values.astype(float),
            padded_log[col].values.astype(float),
            err_msg=str(col),
        )

    # neutral modules contributed nothing
    if ("genset", 0, "genset_production") not in plain_log.columns:
        assert np.all(padded_log[("genset", 0, "genset_production")].values == 0)
    if ("grid", 0, "grid_import") not in plain_log.columns:
        assert np.all(padded_log[("grid", 0, "grid_import")].values == 0)
        assert np.all(padded_log[("grid", 0, "grid_export")].values == 0)


def test_build_suite_shared_spec():
    mgs = [pymgrid_tpu.Microgrid.from_scenario(n) for n in (0, 1, 4)]
    spec, params = build_suite(mgs, dtype=np.float64)
    assert params["battery"]["max_capacity"].shape == (3, 1)
    assert params["load"]["ts"].shape[0] == 3
    assert spec.n_genset == spec.n_grid == 1


def test_suite_runner_matches_individual():
    """Each config's suite-run rewards equal its solo compiled run."""
    import jax

    scenarios = (0, 4)
    mgs = [pymgrid_tpu.Microgrid.from_scenario(n) for n in scenarios]
    runner = SuiteRunner(mgs, batch_per_config=2, dtype=np.float64)

    padded0 = normalize_to_superset(pymgrid_tpu.Microgrid.from_scenario(scenarios[0]))
    rbc = RuleBasedControl(padded0)
    policy = make_priority_policy(runner.spec, rbc.priority_list)

    fn = runner.rollout_fn(policy, 40, auto_reset=True, collect=True)
    keys = runner.make_keys(seed=0)
    acc, outs = fn(runner.params, keys)
    rewards = outs.reward
    assert np.asarray(rewards).shape == (2, 2, 40)

    # solo runs per config with same keys
    from pymgrid_tpu.core.engine import make_reset_fn

    reset_fn = jax.jit(make_reset_fn(runner.spec))
    solo = make_rollout_fn(runner.spec, policy, 40, auto_reset=True, collect=False)
    for c, n in enumerate(scenarios):
        cfg_params = jax.tree.map(lambda x: x[c], runner.params)
        for b in range(2):
            state = reset_fn(cfg_params, keys[c, b])
            _, (r, _) = solo(cfg_params, state)
            np.testing.assert_array_equal(np.asarray(r), np.asarray(rewards)[c, b])


def test_suite_runner_sharded():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 devices")
    from pymgrid_tpu.parallel import make_batch_mesh

    mesh = make_batch_mesh(4)
    mgs = [pymgrid_tpu.Microgrid.from_scenario(n) for n in (0, 1, 4, 22)]
    runner = SuiteRunner(mgs, batch_per_config=2, dtype=np.float64, mesh=mesh)
    padded0 = normalize_to_superset(pymgrid_tpu.Microgrid.from_scenario(0))
    policy = make_priority_policy(
        runner.spec, RuleBasedControl(padded0).priority_list
    )
    fn = runner.rollout_fn(policy, 20)
    acc = fn(runner.params, runner.make_keys(seed=1))
    assert np.asarray(acc).shape == (4, 2)
    assert np.isfinite(np.asarray(acc)).all()


def test_runtime_rbc_matches_host_all_scenarios():
    """One runtime-ordered RBC policy reproduces every scenario's host RBC
    bitwise in a single heterogeneous program."""
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy

    scenarios = list(range(25))
    mgs = [pymgrid_tpu.Microgrid.from_scenario(n) for n in scenarios]
    runner = SuiteRunner(mgs, batch_per_config=1, dtype=np.float64)
    policy = make_marginal_cost_policy(runner.spec)
    fn = runner.rollout_fn(policy, 40, auto_reset=False, collect=True)
    _, outs = fn(runner.params, runner.make_keys(seed=0))
    rewards = outs.reward

    for c, n in enumerate(scenarios):
        host_log = RuleBasedControl(
            pymgrid_tpu.Microgrid.from_scenario(n)
        ).run_compiled(max_steps=40)
        np.testing.assert_array_equal(
            np.asarray(rewards)[c, 0],
            host_log[("balance", 0, "reward")].values,
            err_msg=f"scenario {n}",
        )


def test_randomized_initial_step_matches_shifted_host():
    """randomize_initial_step starts each replica at a distinct key-derived
    step and its trajectory equals the host RBC started at that step
    (the benchmark mode of bench.py: distinct per-replica work)."""
    import jax
    import jax.numpy as jnp

    n_steps, B = 30, 3
    mgs = [pymgrid_tpu.Microgrid.from_scenario(0)]
    runner = SuiteRunner(mgs, batch_per_config=B, dtype=np.float64)
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy

    policy = make_marginal_cost_policy(runner.spec)
    fn = runner.rollout_fn(
        policy, n_steps, auto_reset=False, collect=True,
        randomize_initial_step=True,
    )
    keys = runner.make_keys(seed=3)
    _, outs = fn(runner.params, keys)
    rewards = np.asarray(outs.reward)[0]          # (B, n_steps)

    # derive each replica's start the same way the runner does
    ts_lengths = [m.ts_length for m in runner.spec.log_order if m.ts_length]
    max_start = min(ts_lengths) - 1
    t0s = [
        int(jax.random.randint(
            jax.random.fold_in(keys[0, b], 0x51A7), (), 0, max_start
        ))
        for b in range(B)
    ]
    assert len(set(t0s)) > 1, "replicas should start at distinct steps"

    for b, t0 in enumerate(t0s):
        mg = pymgrid_tpu.Microgrid.from_scenario(0)
        mg.initial_step = t0
        mg.reset()
        host_log = RuleBasedControl(mg).run_compiled(max_steps=n_steps)
        np.testing.assert_array_equal(
            rewards[b],
            host_log[("balance", 0, "reward")].values,
            err_msg=f"replica {b} (t0={t0})",
        )


def test_block_prefetch_bitwise_matches_per_step():
    """The block-prefetch rollout (sequential-wrap resets, one (BLK, W)
    row slice per replica per 8 steps) is bitwise-equal to the per-step
    path with identical reset semantics — including across episode wraps,
    where predictions read the patched [max_start, max_start+BLK) rows."""
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy

    mgs = [pymgrid_tpu.Microgrid.from_scenario(n) for n in (0, 1)]
    runner = SuiteRunner(mgs, batch_per_config=4, dtype=np.float64)
    policy = make_marginal_cost_policy(runner.spec)
    keys = runner.make_keys(seed=11)

    # shorten the wrap cycle so episodes actually end within the test:
    # trim final_step via the host microgrids instead (keep it simple —
    # 48 steps with year-long series never wraps; the wrap case is covered
    # by construction on short scenarios below)
    fn_blk = runner.rollout_fn(policy, 48, auto_reset=True, collect=False,
                               randomize_initial_step=True,
                               block_prefetch=True)
    fn_seq = runner.rollout_fn(policy, 48, auto_reset=True, collect=False,
                               randomize_initial_step=True,
                               block_prefetch=False)
    np.testing.assert_array_equal(
        np.asarray(fn_blk(runner.params, keys)),
        np.asarray(fn_seq(runner.params, keys)),
    )


def test_block_prefetch_bitwise_across_wrap():
    """Same equality on a SHORT series so every replica wraps repeatedly
    (the patched-row prediction case)."""
    import warnings

    from pymgrid_tpu.core.rollout import make_marginal_cost_policy

    warnings.filterwarnings("ignore")
    rng = np.random.RandomState(0)
    T = 40
    from pymgrid_tpu.microgrid import Microgrid as MG
    from pymgrid_tpu.modules import (
        BatteryModule, GridModule, LoadModule, RenewableModule,
    )

    def make_mg():
        return MG([
            BatteryModule(min_capacity=10, max_capacity=100, max_charge=50,
                          max_discharge=50, efficiency=0.9,
                          battery_cost_cycle=0.02, init_soc=0.5),
            ("pv", RenewableModule(time_series=50 * rng.rand(T))),
            LoadModule(time_series=60 * rng.rand(T)),
            GridModule(max_import=100, max_export=100,
                       time_series=rng.rand(T, 3)),
        ])

    runner = SuiteRunner([make_mg()], batch_per_config=6, dtype=np.float64)
    policy = make_marginal_cost_policy(runner.spec)
    keys = runner.make_keys(seed=5)
    fn_blk = runner.rollout_fn(policy, 160, auto_reset=True, collect=False,
                               randomize_initial_step=True,
                               block_prefetch=True)
    fn_seq = runner.rollout_fn(policy, 160, auto_reset=True, collect=False,
                               randomize_initial_step=True,
                               block_prefetch=False)
    np.testing.assert_array_equal(
        np.asarray(fn_blk(runner.params, keys)),
        np.asarray(fn_seq(runner.params, keys)),
    )
