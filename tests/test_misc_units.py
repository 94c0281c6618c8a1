"""Trajectories, reward shapers, logger, spaces, and env extras."""
import numpy as np
import pytest

from pymgrid_tpu.microgrid.trajectory import (
    DeterministicTrajectory,
    FixedLengthStochasticTrajectory,
    StochasticTrajectory,
)
from pymgrid_tpu.microgrid.reward_shaping import (
    BatteryDischargeShaper,
    PVCurtailmentShaper,
)
from pymgrid_tpu.utils.logger import ModularLogger
from pymgrid_tpu.utils.space import Box, ModuleSpace
from pymgrid_tpu.utils.serialize import yaml_dump, yaml_load

from helpers.modular_microgrid import get_modular_microgrid


class TestTrajectories:
    def test_deterministic(self):
        traj = DeterministicTrajectory(10, 50)
        assert traj(0, 100) == (10, 50)
        assert yaml_load(yaml_dump(traj)) == traj

    def test_stochastic_bounds(self):
        traj = StochasticTrajectory()
        np.random.seed(0)
        for _ in range(50):
            initial, final = traj(0, 100)
            assert 0 <= initial <= final < 100  # final==initial possible upstream

    def test_fixed_length(self):
        traj = FixedLengthStochasticTrajectory(24)
        np.random.seed(0)
        for _ in range(50):
            initial, final = traj(0, 100)
            assert final - initial == 24
        with pytest.raises(ValueError):
            traj(0, 20)
        assert yaml_load(yaml_dump(traj)) == traj

    def test_microgrid_episode_length(self):
        mg = get_modular_microgrid()
        traj = FixedLengthStochasticTrajectory(30)
        mg2 = get_modular_microgrid()
        mg2.trajectory_func = traj
        np.random.seed(1)
        mg2.reset()
        assert mg2.final_step - mg2.modules.get_attrs("initial_step", unique=True).item() >= 0

    def test_trajectory_validation(self):
        from pymgrid_tpu import Microgrid

        mods = get_modular_microgrid(modules_only=True)
        with pytest.raises(TypeError):
            Microgrid(mods, trajectory_func="not-callable")
        with pytest.raises(TypeError):
            Microgrid(mods, trajectory_func=lambda i, f: (0.5, 10))
        with pytest.raises(ValueError):
            Microgrid(mods, trajectory_func=lambda i, f: (50, 10))


class TestRewardShaping:
    def test_pv_curtailment_shaper(self):
        mg = get_modular_microgrid()
        # rename renewable to 'pv' (shaper sums the module named 'pv')
        mods = get_modular_microgrid(modules_only=True, remove_modules=["renewable"])
        from pymgrid_tpu.modules import RenewableModule
        from pymgrid_tpu import Microgrid

        mods.append(("pv", RenewableModule(time_series=50 * np.ones(100))))
        mg = Microgrid(mods, reward_shaping_func=PVCurtailmentShaper())
        action = mg.get_empty_action()
        action.update({"genset": [np.array([1.0, 50.0])], "battery": [50.0], "grid": [0.0]})
        obs, shaped, done, info = mg.run(action, normalized=False)
        # massive oversupply -> full pv curtailed
        assert shaped == pytest.approx(-50.0)

    def test_battery_discharge_shaper_range(self):
        mg = get_modular_microgrid()
        mg.reward_shaping_func = BatteryDischargeShaper()
        np.random.seed(0)
        for _ in range(10):
            _, shaped, _, _ = mg.run(mg.sample_action())
            assert -1 - 1e-9 <= shaped <= 1 + 1e-9

    def test_shaper_yaml(self):
        assert isinstance(yaml_load(yaml_dump(PVCurtailmentShaper())), PVCurtailmentShaper)


class TestLogger:
    def test_nan_backfill(self):
        logger = ModularLogger()
        logger.log(a=1)
        logger.log(a=2, b=3)
        assert logger["a"] == [1, 2]
        assert np.isnan(logger["b"][0]) and logger["b"][1] == 3
        assert len(logger) == 2

    def test_flush(self):
        logger = ModularLogger()
        logger.log(x=1.0)
        d = logger.flush()
        assert d == {"x": [1.0]}
        assert len(logger) == 0

    def test_round_trip(self):
        logger = ModularLogger()
        logger.log(x=1.0, y=2.0)
        logger.log(x=3.0, y=4.0)
        assert ModularLogger.from_raw(logger.raw()) == logger


class TestSpaces:
    def test_normalize_round_trip(self):
        space = ModuleSpace(unnormalized_low=-10, unnormalized_high=30)
        val = 17.5
        assert space.denormalize(space.normalize(val)) == pytest.approx(val)

    def test_zero_spread(self):
        space = ModuleSpace(unnormalized_low=5, unnormalized_high=5)
        assert space.normalize(5) == 0.0
        assert space.denormalize(0.0) == 5

    def test_out_of_bounds_warns(self):
        space = ModuleSpace(unnormalized_low=0, unnormalized_high=1)
        with pytest.warns(UserWarning):
            space.normalize(5.0)

    def test_box_sample_contains(self):
        box = Box(low=np.zeros(3), high=np.ones(3), seed=0)
        s = box.sample()
        assert box.contains(s)
        assert not box.contains(np.full(3, 2.0))


class TestEnvExtras:
    def test_remove_action(self):
        from pymgrid_tpu.envs import DiscreteMicrogridEnv

        env = DiscreteMicrogridEnv(get_modular_microgrid(modules_only=True))
        n = env.action_space.n
        env.remove_action(0)
        assert env.action_space.n == n - 1
        env.step(0)

    def test_action_space_cardinality(self):
        """factorial(n_controllable) * 2^n_gensets before dedup/removal
        (reference ``tests/envs/test_discrete.py:73-80``)."""
        from math import factorial

        from pymgrid_tpu.envs import DiscreteMicrogridEnv

        env = DiscreteMicrogridEnv(
            get_modular_microgrid(modules_only=True),
            remove_redundant_gensets=False,
        )
        # genset (2 elements) + battery + grid: permutations of 4 elements
        # with the genset pair deduped to first occurrence
        assert env.action_space.n == 12

    def test_env_yaml_load(self):
        from pymgrid_tpu.envs import DiscreteMicrogridEnv

        mg = get_modular_microgrid()
        env = DiscreteMicrogridEnv.load(mg.dump())
        assert env.action_space.n > 0
        env.step(env.sample_action())


@pytest.mark.parametrize("n", range(25))
def test_all_scenarios_smoke(n):
    """Per-scenario smoke: env construction, obs dims, log growth, reset
    (reference ``tests/envs/test_discrete.py:35-191``)."""
    from pymgrid_tpu.envs import DiscreteMicrogridEnv

    env = DiscreteMicrogridEnv.from_scenario(n)
    obs = env.reset()
    assert obs.shape == env.observation_space.shape
    for step in range(3):
        obs, reward, done, info = env.step(step % env.action_space.n)
    assert len(env.get_log()) == 3
    env.reset()
    assert env.current_step == 0

