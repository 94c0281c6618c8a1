"""Lockstep init-charge sweep (``make_lockstep_sweep_fn``) against the general
rollout vmapped over replicas, on the benchmark's sweep workload: every
replica starts from a different battery charge and runs marginal-cost RBC,
all replicas sharing the simulated time.  Covers the three pymgrid25
families: grid-only, genset + weak grid, and grid-less genset-only.
"""
import numpy as np
import pytest


@pytest.mark.parametrize(
    "scenario", [0, 1, 2], ids=["grid_only", "genset_weak_grid", "gridless"]
)
def test_lockstep_sweep_matches_vmapped_rollout(scenario):
    import jax
    import jax.numpy as jnp

    import pymgrid_tpu
    from pymgrid_tpu.core.engine import make_reset_fn
    from pymgrid_tpu.core.rollout import (
        lockstep_states,
        make_lockstep_sweep_fn,
        make_marginal_cost_policy,
        make_rollout_fn,
    )
    from pymgrid_tpu.core.spec import extract_spec

    B, T = 16, 96
    mg = pymgrid_tpu.Microgrid.from_scenario(scenario)
    spec, params, _ = extract_spec(mg, dtype=np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    pb = params["battery"]
    init = np.linspace(float(pb["min_capacity"][0]),
                       float(pb["max_capacity"][0]), B, dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = jax.jit(jax.vmap(make_reset_fn(spec), in_axes=(None, 0)))(
        jparams, keys)
    states = {**states, "battery_charge": jnp.asarray(init)[:, None]}
    policy = make_marginal_cost_policy(spec)

    fn = make_rollout_fn(spec, policy, T, auto_reset=False, collect=False)
    _, (rewards, _) = jax.jit(jax.vmap(fn, in_axes=(None, 0)))(jparams, states)
    rewards = np.asarray(rewards)
    assert rewards.shape == (B, T)
    ref = np.zeros(B, np.float32)
    for t in range(T):  # the sweep's left fold over time
        ref = ref + rewards[:, t]

    sweep = make_lockstep_sweep_fn(spec, policy, T)
    final, acc = sweep(jparams, lockstep_states(spec, jparams, states))
    assert acc.shape == (B,) and acc.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(acc), ref)
    # distinct starting charges give distinct returns
    assert len(np.unique(np.asarray(acc))) > 1
    assert int(final["step"]) == int(states["step"][0]) + T
