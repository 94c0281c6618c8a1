"""Compiled-engine equivalence against the host layer.

The host layer is bitwise-equal to the reference (test_reference_parity); here
the jit-compiled engine is held to the same standard against the host layer
in float64 on CPU: identical rewards, observations, dones, and full logs.
"""
import zlib

import numpy as np
import pandas as pd
import pytest

import pymgrid_tpu.modules as M
from pymgrid_tpu import Microgrid
from pymgrid_tpu.core.compiled import CompiledMicrogrid

from helpers.factories import module_params, build_microgrid
from helpers.modular_microgrid import get_modular_microgrid
from pymgrid_tpu.algos import RuleBasedControl


def make_host(seed=0, include=("genset", "battery", "pv", "load", "grid"), **kwargs):
    params = module_params(seed=seed, **kwargs)
    mods, _ = build_microgrid(M, params, include)
    return Microgrid(mods)


def host_flat_obs(mg):
    return mg.state_series(normalized=True).values.astype(np.float64)


def run_equivalence(mg, n_steps=40, seed=0, normalized=False, atol=0.0):
    compiled = CompiledMicrogrid(mg, dtype=np.float64)
    state = compiled.initial_state(seed=123)

    np.random.seed(seed)
    rows = []
    for step in range(n_steps):
        action = mg.sample_action()
        _, host_reward, host_done, _ = mg.run(action, normalized=normalized)

        eng_action = compiled.action_to_arrays(action)
        state, out = compiled.step(state, eng_action, normalized=normalized)
        rows.append(np.asarray(out.log_row))

        assert float(out.reward) == host_reward or abs(float(out.reward) - host_reward) <= atol, (
            f"step {step}: engine reward {float(out.reward)!r} != host {host_reward!r}"
        )
        assert bool(out.done) == host_done, f"step {step}: done mismatch"

        np.testing.assert_allclose(
            np.asarray(out.obs), host_flat_obs(mg), rtol=0, atol=atol,
            err_msg=f"step {step}: obs mismatch",
        )

    host_log = mg.get_log()
    eng_log = compiled.log_frame(np.stack(rows))
    assert list(host_log.columns) == list(eng_log.columns), (
        f"column order mismatch:\nhost={list(host_log.columns)}\n"
        f"eng ={list(eng_log.columns)}"
    )
    np.testing.assert_allclose(
        host_log.values.astype(np.float64),
        eng_log.values.astype(np.float64),
        rtol=0,
        atol=atol,
    )


CONFIGS = {
    "full": dict(),
    "weak_grid": dict(weak_grid=True),
    "no_genset": dict(include=("battery", "pv", "load", "grid")),
    "no_grid": dict(include=("genset", "battery", "pv", "load")),
    "islanded_min": dict(include=("pv", "load")),
    "slow_genset": dict(start_up_time=3, wind_down_time=2),
    "lossy_battery": dict(efficiency=0.5),
    "oracle_forecast": dict(forecaster="oracle", forecast_horizon=5),
    "oracle_long": dict(forecaster="oracle", forecast_horizon=23),
}


@pytest.mark.parametrize("name", CONFIGS)
def test_engine_bitwise_equivalence(name):
    kwargs = dict(CONFIGS[name])
    include = kwargs.pop("include", ("genset", "battery", "pv", "load", "grid"))
    mg = make_host(seed=zlib.crc32(name.encode()) % 997, include=include, **kwargs)
    run_equivalence(mg, n_steps=40, seed=1)


def test_engine_normalized_actions():
    mg = make_host(seed=21)
    run_equivalence(mg, n_steps=30, seed=2, normalized=True)


def test_engine_off_end_obs():
    """Observations past the end of the series use the midpoint fill."""
    mg = make_host(seed=33, timesteps=25, forecaster="oracle", forecast_horizon=6)
    run_equivalence(mg, n_steps=25, seed=3)


def test_engine_gaussian_forecast_statistics():
    """Gaussian forecasts can't match the host RNG; check shape and bounds."""
    mg = make_host(seed=5, forecaster=1.0, forecast_horizon=4)
    compiled = CompiledMicrogrid(mg, dtype=np.float64)
    state = compiled.initial_state(seed=7)
    np.random.seed(11)
    for _ in range(5):
        action = mg.sample_action()
        state, out = compiled.step(
            state, compiled.action_to_arrays(action), normalized=False
        )
        obs = np.asarray(out.obs)
        assert obs.shape == (compiled.spec.obs_dim,)
        assert np.all(obs >= -1e-9) and np.all(obs <= 1 + 1e-9)


def test_engine_reward_shaping():
    from pymgrid_tpu.microgrid.reward_shaping import PVCurtailmentShaper

    params = module_params(seed=41)
    mods, _ = build_microgrid(M, params)
    mg = Microgrid(mods, reward_shaping_func=PVCurtailmentShaper())
    compiled = CompiledMicrogrid(mg, dtype=np.float64)
    state = compiled.initial_state(seed=3)
    np.random.seed(17)
    for step in range(20):
        action = mg.sample_action()
        _, host_shaped, _, _ = mg.run(action, normalized=False)
        state, out = compiled.step(
            state, compiled.action_to_arrays(action), normalized=False
        )
        assert float(out.shaped_reward) == host_shaped, f"step {step}"


def test_engine_multiple_modules_per_kind():
    """Two loads, two renewables, two batteries: exercises slot indexing and
    the balance-sum ordering with longer operand lists."""
    rng = np.random.RandomState(77)
    mods = [
        M.BatteryModule(min_capacity=0, max_capacity=100, max_charge=40,
                        max_discharge=40, efficiency=0.9, init_soc=0.6),
        ("aux_battery", M.BatteryModule(min_capacity=5, max_capacity=50,
                                        max_charge=20, max_discharge=25,
                                        efficiency=0.8, init_soc=0.4)),
        ("pv", M.RenewableModule(time_series=40 * rng.rand(80))),
        ("wind", M.RenewableModule(time_series=20 * rng.rand(80))),
        M.LoadModule(time_series=45 * rng.rand(80)),
        ("load_2", M.LoadModule(time_series=25 * rng.rand(80))),
        M.GridModule(max_import=150, max_export=80,
                     time_series=rng.rand(80, 3)),
    ]
    mg = Microgrid(mods)
    run_equivalence(mg, n_steps=40, seed=9)


def test_engine_two_gensets():
    rng = np.random.RandomState(78)
    mods = [
        M.GensetModule(running_min_production=5, running_max_production=40,
                       genset_cost=0.4, start_up_time=2, wind_down_time=1),
        ("backup_genset", M.GensetModule(running_min_production=0,
                                         running_max_production=20,
                                         genset_cost=0.7, start_up_time=0,
                                         wind_down_time=0, init_start_up=False)),
        M.BatteryModule(min_capacity=0, max_capacity=80, max_charge=30,
                        max_discharge=30, efficiency=1.0, init_soc=0.5),
        ("pv", M.RenewableModule(time_series=30 * rng.rand(80))),
        M.LoadModule(time_series=50 * rng.rand(80)),
    ]
    mg = Microgrid(mods)
    run_equivalence(mg, n_steps=40, seed=10)


def _polynomial_fuel_cost(production):
    """Traceable callable genset cost: quadratic fuel curve."""
    return 0.4 * production + 0.001 * (production * production)


def _derated_transition_model(external_energy_change, efficiency, **kwargs):
    """Traceable custom battery transition, written branchlessly so it runs
    identically on numpy floats (host) and jnp tracers (engine).

    Bounds-safe: module bounds are always computed with the nominal
    efficiency (reference battery_module.py:283-291), so a custom model must
    retain less on charge (x0.9) and draw less on discharge (/1.1) or the
    host's min-capacity clamp assertion can fire mid-episode.
    """
    is_charge = external_energy_change >= 0
    return (
        external_energy_change * (0.9 * efficiency) * is_charge
        + external_energy_change / (1.1 * efficiency) * (1 - is_charge)
    )


def test_engine_callable_genset_cost():
    """A traceable callable genset_cost compiles into the engine and stays
    bitwise-equal to the host (reference genset_module.py:183-186)."""
    rng = np.random.RandomState(21)
    mods = [
        M.GensetModule(running_min_production=5, running_max_production=50,
                       genset_cost=_polynomial_fuel_cost, co2_per_unit=2.0,
                       cost_per_unit_co2=0.1, start_up_time=1, wind_down_time=1),
        M.BatteryModule(min_capacity=0, max_capacity=80, max_charge=30,
                        max_discharge=30, efficiency=0.9, init_soc=0.5),
        ("pv", M.RenewableModule(time_series=30 * rng.rand(80))),
        M.LoadModule(time_series=50 * rng.rand(80)),
    ]
    mg = Microgrid(mods)
    run_equivalence(mg, n_steps=40, seed=11)


def test_engine_custom_battery_transition():
    """A traceable battery_transition_model compiles into the engine and
    stays bitwise-equal to the host (reference battery_module.py:149-189)."""
    rng = np.random.RandomState(22)
    mods = [
        M.BatteryModule(min_capacity=0, max_capacity=100, max_charge=40,
                        max_discharge=40, efficiency=0.9, init_soc=0.5,
                        battery_cost_cycle=0.02,
                        battery_transition_model=_derated_transition_model),
        ("pv", M.RenewableModule(time_series=40 * rng.rand(80))),
        M.LoadModule(time_series=50 * rng.rand(80)),
        M.GridModule(max_import=100, max_export=100,
                     time_series=rng.rand(80, 3)),
    ]
    mg = Microgrid(mods)
    run_equivalence(mg, n_steps=40, seed=12)


def test_engine_untraceable_callable_raises():
    """A value-branching callable fails with guidance, not a cryptic trace."""
    def bad_cost(production):
        if production > 10:  # concretizes a tracer
            return 0.5 * production
        return 0.6 * production

    rng = np.random.RandomState(23)
    mods = [
        M.GensetModule(running_min_production=5, running_max_production=50,
                       genset_cost=bad_cost),
        ("pv", M.RenewableModule(time_series=30 * rng.rand(60))),
        M.LoadModule(time_series=50 * rng.rand(60)),
    ]
    mg = Microgrid(mods)
    with pytest.raises(NotImplementedError, match="not.*traceable|host"):
        compiled = CompiledMicrogrid(mg, dtype=np.float64)
        state = compiled.initial_state(seed=0)
        action = compiled.action_to_arrays(mg.sample_action())
        compiled.step(state, action, normalized=False)


def test_gaussian_forecast_numpy_rng_parity():
    """Seeded gaussian-forecast trajectories: engine == host bitwise.

    The engine replays the host's global-numpy-RNG noise stream from a
    precomputed HBM bank (core/noise_bank.py), closing the last documented
    parity hole (docs/parity.md: engine used jax.random).  Runs to the data
    end so the truncated off-end draws are covered too.
    """
    mg = get_modular_microgrid()
    mg.set_forecaster(0.1, forecast_horizon=5)

    np.random.seed(1234)
    host_log = RuleBasedControl(mg).run()

    np.random.seed(1234)
    eng_log = RuleBasedControl(mg).run_compiled(numpy_rng_noise=True)

    assert list(host_log.columns) == list(eng_log.columns)
    np.testing.assert_array_equal(
        host_log.values.astype(float), eng_log.values.astype(float)
    )


def test_many_module_balance_drift_bounded():
    """>7 balance operands: np.sum's pairwise tree becomes data-dependent on
    the host (entry count varies with source/sink roles), so bitwise equality
    is guaranteed only below 8 operands (docs/parity.md).  This quantifies the
    drift for a 12-module microgrid: per-step rewards may differ in the last
    ulp, and the accumulated full-horizon cost must stay within 1e-12
    relative."""
    import pymgrid_tpu.modules as MM

    rng = np.random.RandomState(7)
    T = 150
    mods = [
        MM.LoadModule(time_series=60 * rng.rand(T), forecast_horizon=0),
        MM.LoadModule(time_series=40 * rng.rand(T), forecast_horizon=0),
        ("pv", MM.RenewableModule(time_series=50 * rng.rand(T), forecast_horizon=0)),
        ("pv2", MM.RenewableModule(time_series=30 * rng.rand(T), forecast_horizon=0)),
    ]
    for k in range(4):
        mods.append(
            MM.BatteryModule(
                min_capacity=5, max_capacity=80 + 10 * k, max_charge=40,
                max_discharge=40, efficiency=0.9, battery_cost_cycle=0.02,
                init_soc=0.4 + 0.05 * k,
            )
        )
    mods.append(
        MM.GridModule(max_import=200, max_export=200,
                      time_series=rng.rand(T, 3), forecast_horizon=0)
    )
    mods.append(
        MM.GensetModule(running_min_production=5, running_max_production=40,
                        genset_cost=0.5)
    )

    mg = Microgrid(mods)
    assert mg.n_modules >= 11

    host_log = RuleBasedControl(mg).run(max_steps=140)
    eng_log = RuleBasedControl(mg).run_compiled(max_steps=140)

    host_r = host_log[("balance", 0, "reward")].values
    eng_r = eng_log[("balance", 0, "reward")].values
    # per-step: last-ulp level
    np.testing.assert_allclose(eng_r, host_r, rtol=1e-12, atol=1e-9)
    # accumulated full-horizon cost: tighter than 1e-12 relative
    assert abs(eng_r.sum() - host_r.sum()) <= 1e-12 * abs(host_r.sum())


# ---------------------------------------------------------------------------
# user-defined forecasters in the compiled engine
# ---------------------------------------------------------------------------
def _damped_vector_forecast(val_c, val_c_n, n):
    """Vectorized row-wise user forecaster: geometric damping toward the
    current row.  Branchless — runs identically on numpy rows (host) and jnp
    tracers (engine)."""
    return 0.9 * val_c_n + 0.1 * val_c


def _scalar_damped_forecast(val_c, v, n_i):
    """Scalar-only user forecaster: rejects vector windows so the host
    classifies it scalar and auto-vectorizes (forecast/forecaster.py)."""
    if v.shape != val_c.shape:
        raise ValueError("scalar forecaster takes one row at a time")
    return 0.5 * v + 0.5 * val_c


def _user_forecast_microgrid(seed, forecaster, horizon, timesteps=120,
                             with_grid=True):
    # user forecasters go on the 1-feature pv/load series only: the
    # reference's sign validation is ambiguous on multi-feature rows and
    # rejects a vectorized callable on a (T, 4) grid series the same way
    # (forecaster.py:356-361 in the reference)
    rng = np.random.RandomState(seed)
    mods = [
        M.BatteryModule(min_capacity=10, max_capacity=100, max_charge=50,
                        max_discharge=50, efficiency=0.9,
                        battery_cost_cycle=0.02, init_soc=0.5),
        ("pv", M.RenewableModule(time_series=50 * rng.rand(timesteps),
                                 forecaster=forecaster,
                                 forecast_horizon=horizon)),
        M.LoadModule(time_series=60 * rng.rand(timesteps),
                     forecaster=forecaster, forecast_horizon=horizon),
    ]
    if with_grid:
        mods.append(
            M.GridModule(max_import=100, max_export=100,
                         time_series=rng.rand(timesteps, 3),
                         forecaster="oracle", forecast_horizon=horizon)
        )
    return Microgrid(mods)


def test_engine_user_forecaster_vectorized():
    """A traceable vectorized UserDefinedForecaster compiles into the engine
    and stays bitwise-equal to the host (reference forecaster.py:283-373)."""
    mg = _user_forecast_microgrid(61, _damped_vector_forecast, 6)
    run_equivalence(mg, n_steps=40, seed=13)


def test_engine_user_forecaster_scalar():
    """A scalar user forecaster is re-vectorized as a trace-time unroll."""
    mg = _user_forecast_microgrid(62, _scalar_damped_forecast, 4,
                                  with_grid=False)
    run_equivalence(mg, n_steps=30, seed=14)


def test_engine_user_forecaster_off_end():
    """Off-end user forecasts revert to the midpoint fill rows (the host's
    pad-then-clip sequence)."""
    mg = _user_forecast_microgrid(63, _damped_vector_forecast, 6,
                                  timesteps=25)
    run_equivalence(mg, n_steps=25, seed=15)


def test_engine_user_forecaster_stochastic_bank():
    """np.random inside a user callable would freeze at trace time — the
    engine instead pre-samples one realization per step into an HBM bank
    at spec extraction (the noise-bank mechanism generalized to arbitrary
    stochastic callables).  Every
    engine episode replays that realization; parity with the host is
    distributional, not bitwise (docs/parity.md #13)."""
    import jax
    import jax.numpy as jnp

    from pymgrid_tpu.core.engine import make_reset_fn, make_step_fn
    from pymgrid_tpu.core.spec import extract_spec

    def noisy(val_c, val_c_n, n):
        return val_c_n * (1 + 0.01 * np.abs(np.random.rand(*np.shape(val_c_n))))

    mg = _user_forecast_microgrid(64, noisy, 4)
    np.random.seed(1234)
    spec, params, _ = extract_spec(mg, dtype=np.float64)
    assert any(m.forecaster == "user_bank" for m in spec.log_order)
    assert "user_bank" in params["renewable"]

    jparams = jax.tree.map(jnp.asarray, params)
    step_fn = jax.jit(make_step_fn(spec, normalized=False))
    reset_fn = jax.jit(make_reset_fn(spec))

    def episode(seed):
        state = reset_fn(jparams, jax.random.PRNGKey(seed))
        obs_rows = []
        zero = {"battery": jnp.zeros(1, np.float64),
                "genset": jnp.zeros((0, 2), np.float64),
                "grid": jnp.zeros(1, np.float64)}
        for _ in range(5):
            state, out = step_fn(jparams, state, zero)
            obs_rows.append(np.asarray(out.obs))
        return np.stack(obs_rows)

    a, b = episode(0), episode(0)
    np.testing.assert_array_equal(a, b)  # episodes replay the realization

    # the bank realization actually perturbs the forecast (not oracle):
    # rebuild with the same module structure but an oracle forecaster
    mg2 = _user_forecast_microgrid(64, "oracle", 4)
    spec2, params2, _ = extract_spec(mg2, dtype=np.float64)
    jparams2 = jax.tree.map(jnp.asarray, params2)
    step2 = jax.jit(make_step_fn(spec2, normalized=False))
    state2 = jax.jit(make_reset_fn(spec2))(jparams2, jax.random.PRNGKey(0))
    zero = {"battery": jnp.zeros(1, np.float64),
            "genset": jnp.zeros((0, 2), np.float64),
            "grid": jnp.zeros(1, np.float64)}
    _, out2 = step2(jparams2, state2, zero)
    assert not np.array_equal(a[0], np.asarray(out2.obs))


def test_lockstep_sweep_bitwise_matches_vmapped_rollout():
    """make_lockstep_sweep_fn (shared scalar step in the scan carry, reward
    accumulated, no episode buffers — the general-engine counterpart of the
    Pallas sweep kernel) is bitwise-equal per step to vmapping the general
    rollout, on both the grid-only and genset families."""
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

    for scen in (0, 1):
        mg = pymgrid_tpu.Microgrid.from_scenario(scen)
        spec, params, _ = extract_spec(mg, dtype=np.float64)
        jparams = jax.tree.map(jnp.asarray, params)
        B, T = 5, 60
        reset_fn = make_reset_fn(spec)
        keys = jax.random.split(jax.random.PRNGKey(0), B)
        states = jax.jit(jax.vmap(reset_fn, in_axes=(None, 0)))(jparams, keys)
        pb = params["battery"]
        init = jnp.linspace(float(pb["min_capacity"][0]),
                            float(pb["max_capacity"][0]), B)
        states = {**states, "battery_charge": init[:, None]}
        policy = make_marginal_cost_policy(spec)

        fn = make_rollout_fn(spec, policy, T, auto_reset=False, collect=False)
        _, (rewards, _) = jax.jit(jax.vmap(fn, in_axes=(None, 0)))(
            jparams, states)
        rew = np.asarray(rewards)
        ref = np.zeros(B)
        for t in range(T):  # same left-fold order as the sweep's carry
            ref = ref + rew[:, t]

        sweep = make_lockstep_sweep_fn(spec, policy, T)
        _, acc = sweep(jparams, lockstep_states(spec, jparams, states))
        np.testing.assert_array_equal(np.asarray(acc), ref,
                                      err_msg=f"scenario {scen}")
