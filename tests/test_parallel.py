"""Batched/sharded execution: vmap-vs-single equivalence and mesh runs."""
import numpy as np
import pytest

import pymgrid_tpu
import pymgrid_tpu.modules as M
from helpers.factories import module_params, build_microgrid

from pymgrid_tpu.algos import RuleBasedControl
from pymgrid_tpu.core.compiled import CompiledMicrogrid
from pymgrid_tpu.core.rollout import make_priority_policy, make_rollout_fn
from pymgrid_tpu.parallel import BatchedMicrogrid, BatchedDiscreteEnv, make_batch_mesh


def _microgrid(seed=29, **kwargs):
    params = module_params(seed=seed, **kwargs)
    mods, _ = build_microgrid(M, params)
    return pymgrid_tpu.Microgrid(mods)


def test_vmap_matches_single():
    """Each replica of a batched rollout equals its own single rollout."""
    mg = _microgrid()
    rbc = RuleBasedControl(mg)

    batched = BatchedMicrogrid(rbc.microgrid, batch_size=4, dtype=np.float64)
    policy = make_priority_policy(batched.spec, rbc.priority_list)
    states = batched.reset(seed=0)
    final, (rewards, dones) = batched.rollout(policy, 50, seed=0, collect=False)
    assert rewards.shape == (4, 50)

    # replica-wise single rollouts with the same keys
    import jax

    compiled = CompiledMicrogrid(rbc.microgrid, dtype=np.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    single_fn = make_rollout_fn(compiled.spec, policy, 50, auto_reset=True, collect=False)
    for b in range(4):
        reset_fn = batched._reset_fn
        state_b = jax.jit(reset_fn)(compiled.params, keys[b])
        _, (r_b, _) = single_fn(compiled.params, state_b)
        np.testing.assert_array_equal(np.asarray(r_b), np.asarray(rewards)[b])


def test_batched_rollout_matches_host_rbc():
    """Replica 0 of the deterministic RBC rollout equals the host RBC."""
    mg = _microgrid()
    rbc = RuleBasedControl(mg)
    host_log = RuleBasedControl(mg).run(max_steps=60)
    host_rewards = host_log[("balance", 0, "reward")].values

    batched = BatchedMicrogrid(rbc.microgrid, batch_size=3, dtype=np.float64)
    policy = make_priority_policy(batched.spec, rbc.priority_list)
    _, (rewards, dones) = batched.rollout(
        policy, 60, seed=0, auto_reset=False, collect=False
    )
    for b in range(3):
        np.testing.assert_array_equal(np.asarray(rewards)[b], host_rewards)


def test_sharded_mesh_rollout():
    """Rollout over an 8-device CPU mesh matches the unsharded result."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

    mg = _microgrid()
    rbc = RuleBasedControl(mg)
    mesh = make_batch_mesh(8)

    batched_plain = BatchedMicrogrid(rbc.microgrid, batch_size=16, dtype=np.float64)
    batched_mesh = BatchedMicrogrid(
        rbc.microgrid, batch_size=16, dtype=np.float64, mesh=mesh
    )
    policy = make_priority_policy(batched_mesh.spec, rbc.priority_list)

    _, (r_plain, _) = batched_plain.rollout(policy, 30, seed=1, collect=False)
    _, (r_mesh, _) = batched_mesh.rollout(policy, 30, seed=1, collect=False)
    np.testing.assert_array_equal(np.asarray(r_plain), np.asarray(r_mesh))

    # replicas actually live across devices
    states = batched_mesh.reset(seed=1)
    sharding = states["battery_charge"].sharding
    assert len(sharding.device_set) == 8


def test_batched_discrete_env_matches_host():
    from pymgrid_tpu.envs import DiscreteMicrogridEnv

    params = module_params(seed=31)
    mods, _ = build_microgrid(M, params)
    env = DiscreteMicrogridEnv(mods)

    batched = BatchedDiscreteEnv(env, batch_size=2, dtype=np.float64)
    states = batched.reset(seed=0)

    rng = np.random.RandomState(0)
    action_seq = rng.randint(env.action_space.n, size=25)
    env.reset()
    for step, a in enumerate(action_seq):
        host_obs, host_r, host_d, _ = env.step(int(a))
        states, out = batched.step(states, np.full(2, a))
        for b in range(2):
            assert float(out.reward[b]) == host_r, f"step {step} replica {b}"
            assert bool(out.done[b]) == host_d
        np.testing.assert_array_equal(
            np.asarray(out.obs[0]), np.asarray(host_obs, dtype=float)
        )


def test_auto_reset():
    mg = _microgrid(timesteps=20)
    rbc = RuleBasedControl(mg)
    batched = BatchedMicrogrid(rbc.microgrid, batch_size=2, dtype=np.float64)
    policy = make_priority_policy(batched.spec, rbc.priority_list)
    final, (rewards, dones) = batched.rollout(
        policy, 45, seed=0, auto_reset=True, collect=False
    )
    dones = np.asarray(dones)
    assert dones.sum() > 0  # episodes ended and restarted
    assert np.isfinite(np.asarray(rewards)).all()
    # after done the state rewound: step counter stays within episode bounds
    assert int(np.asarray(final["step"]).max()) <= 20


def test_batched_discrete_env_large_action_space_compiles():
    """1440 discrete actions (4 batteries + genset + grid): the table-driven
    policy keeps compile cost O(n_controllable), where a lax.switch over all
    priority lists would explode (reference warns >1000 actions)."""
    import time

    import pymgrid_tpu
    from pymgrid_tpu.envs import DiscreteMicrogridEnv

    rng = np.random.RandomState(3)
    T = 60
    mods = [
        M.LoadModule(time_series=60 * rng.rand(T), forecast_horizon=0),
        M.RenewableModule(time_series=40 * rng.rand(T), forecast_horizon=0),
        M.GridModule(max_import=150, max_export=150,
                     time_series=rng.rand(T, 3), forecast_horizon=0),
        M.GensetModule(running_min_production=5, running_max_production=40,
                       genset_cost=0.5),
    ] + [
        M.BatteryModule(min_capacity=0, max_capacity=80, max_charge=40,
                        max_discharge=40, efficiency=0.9, init_soc=0.5)
        for _ in range(4)
    ]
    env = DiscreteMicrogridEnv(mods)
    assert env.action_space.n > 1000

    batched = BatchedDiscreteEnv(env, batch_size=4, dtype=np.float64)
    states = batched.reset(seed=0)
    t0 = time.time()
    states, out = batched.step(states, np.array([0, 1, 7, 1337]))
    compile_s = time.time() - t0
    assert np.isfinite(np.asarray(out.reward)).all()
    # generous bound: a 1440-branch switch would take minutes
    assert compile_s < 120, f"compile took {compile_s:.1f}s"


def test_batched_continuous_env_matches_host():
    """BatchedContinuousEnv stepping the host env's flat normalized actions
    is bitwise-equal to ContinuousMicrogridEnv."""
    from pymgrid_tpu.envs import ContinuousMicrogridEnv
    from pymgrid_tpu.parallel import BatchedContinuousEnv

    params = module_params(seed=47)
    mods, _ = build_microgrid(M, params)
    env = ContinuousMicrogridEnv(mods)
    batched = BatchedContinuousEnv(env, batch_size=2, dtype=np.float64)
    assert batched.action_dim == env.action_space.shape[0]

    states = batched.reset(seed=0)
    rng = np.random.RandomState(3)
    action_seq = rng.rand(25, batched.action_dim)
    env.reset()
    for step, a in enumerate(action_seq):
        host_obs, host_r, host_d, _ = env.step(a)
        states, out = batched.step(states, np.tile(a, (2, 1)))
        for b in range(2):
            assert float(out.reward[b]) == host_r, f"step {step} replica {b}"
            assert bool(out.done[b]) == host_d
        np.testing.assert_array_equal(
            np.asarray(out.obs[0]), np.asarray(host_obs, dtype=float)
        )


def test_batched_continuous_env_genset_goal():
    """Genset [goal, production] rows flow through the flat layout: goal>=0.5
    requests ON, goal<0.5 requests OFF, visible in the engine state."""
    from pymgrid_tpu.envs import ContinuousMicrogridEnv
    from pymgrid_tpu.parallel import BatchedContinuousEnv

    params = module_params(seed=48, start_up_time=0, wind_down_time=0)
    mods, _ = build_microgrid(M, params)
    env = ContinuousMicrogridEnv(mods)
    batched = BatchedContinuousEnv(env, batch_size=1, dtype=np.float64)

    # locate the genset segment in the flat layout
    offset = 0
    for name, boxes in env._nested_action_space.items():
        width = sum(box.shape[0] for box in boxes)
        if name == "genset":
            genset_off = offset
            break
        offset += width
    else:
        raise AssertionError("no genset in layout")

    states = batched.reset(seed=0)
    for goal, expect in ((1.0, 1), (0.0, 0)):
        act = np.full((1, batched.action_dim), 0.5)
        act[0, genset_off] = goal
        states, _ = batched.step(states, act)
        assert int(states["genset"]["current_status"][0, 0]) == expect


def test_fused_rollout_matches_step_loop_discrete():
    """BatchedDiscreteEnv.rollout (one lax.scan program) is bitwise-equal to
    the python step() loop, and keep_logs returns the stacked log rows."""
    from pymgrid_tpu.envs import DiscreteMicrogridEnv

    params = module_params(seed=49)
    mods, _ = build_microgrid(M, params)
    env = DiscreteMicrogridEnv(mods)
    batched = BatchedDiscreteEnv(env, batch_size=3, dtype=np.float64)

    rng = np.random.RandomState(7)
    action_seq = rng.randint(batched.n_actions, size=(11, 3))

    states = batched.reset(seed=0)
    loop_states = states
    loop_outs = []
    for a in action_seq:
        loop_states, out = batched.step(loop_states, a)
        loop_outs.append(out)

    fused_states, outs = batched.rollout(batched.reset(seed=0), action_seq)
    assert outs.log_row is None
    for t, out in enumerate(loop_outs):
        np.testing.assert_array_equal(np.asarray(outs.obs[t]), np.asarray(out.obs))
        np.testing.assert_array_equal(
            np.asarray(outs.reward[t]), np.asarray(out.reward)
        )
        np.testing.assert_array_equal(np.asarray(outs.done[t]), np.asarray(out.done))
    import jax

    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        fused_states,
        loop_states,
    )

    _, outs_logged = batched.rollout(batched.reset(seed=0), action_seq,
                                     keep_logs=True)
    assert outs_logged.log_row.shape[:2] == (11, 3)
    np.testing.assert_array_equal(
        np.asarray(outs_logged.log_row[-1]), np.asarray(loop_outs[-1].log_row)
    )

    with pytest.raises(ValueError):
        batched.rollout(batched.reset(seed=0), action_seq[:, :2])


def test_fused_rollout_matches_step_loop_continuous():
    """BatchedContinuousEnv.rollout equals the python step() loop bitwise."""
    from pymgrid_tpu.envs import ContinuousMicrogridEnv
    from pymgrid_tpu.parallel import BatchedContinuousEnv

    params = module_params(seed=50)
    mods, _ = build_microgrid(M, params)
    env = ContinuousMicrogridEnv(mods)
    batched = BatchedContinuousEnv(env, batch_size=2, dtype=np.float64)

    rng = np.random.RandomState(11)
    action_seq = rng.rand(9, 2, batched.action_dim)

    loop_states = batched.reset(seed=0)
    rewards = []
    for a in action_seq:
        loop_states, out = batched.step(loop_states, a)
        rewards.append(np.asarray(out.reward))

    _, outs = batched.rollout(batched.reset(seed=0), action_seq)
    np.testing.assert_array_equal(np.asarray(outs.reward), np.stack(rewards))

    with pytest.raises(ValueError):
        batched.rollout(batched.reset(seed=0), action_seq[0])


def test_fused_rollout_keep_obs_false_drops_obs_only():
    """keep_obs=False drops the stacked observations (rewards unchanged) —
    the evaluation fast path where XLA eliminates obs construction."""
    from pymgrid_tpu.envs import DiscreteMicrogridEnv

    params = module_params(seed=51)
    mods, _ = build_microgrid(M, params)
    env = DiscreteMicrogridEnv(mods)
    batched = BatchedDiscreteEnv(env, batch_size=2, dtype=np.float64)
    acts = np.random.RandomState(5).randint(batched.n_actions, size=(7, 2))

    _, full = batched.rollout(batched.reset(seed=0), acts)
    _, lean = batched.rollout(batched.reset(seed=0), acts, keep_obs=False)
    assert lean.obs is None and lean.log_row is None
    np.testing.assert_array_equal(np.asarray(lean.reward), np.asarray(full.reward))
    np.testing.assert_array_equal(np.asarray(lean.done), np.asarray(full.done))
