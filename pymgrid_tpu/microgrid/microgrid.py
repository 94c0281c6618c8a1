"""The ``Microgrid`` host class.

Behavioral mirror of the reference central class
(``src/pymgrid/microgrid/microgrid.py:15``): a container of modules stepped
through a three-phase energy dispatch (fixed -> controllable -> flex) with
per-module rewards and full logging.

This host class is the single-instance, numpy-float64 semantic specification.
The compiled engine path (:mod:`pymgrid_tpu.core`) extracts a struct-of-arrays
description from it (:func:`pymgrid_tpu.core.spec.extract_spec`) and runs the
identical three-phase dispatch under ``jit``/``vmap``/``lax.scan``.
"""
from copy import deepcopy
from warnings import warn

import numpy as np
import yaml

from pymgrid_tpu.microgrid.step import MicrogridStep
from pymgrid_tpu.modules import ModuleContainer, UnbalancedEnergyModule
from pymgrid_tpu.utils.logger import ModularLogger
from pymgrid_tpu.utils.space import MicrogridSpace
from pymgrid_tpu.utils.serialize import (
    PymgridDumper,
    PymgridLoader,
    yaml_dump,
    yaml_load,
    add_numpy_pandas_representers,
    add_numpy_pandas_constructors,
    dump_data,
)

__all__ = ["Microgrid", "DEFAULT_HORIZON"]

DEFAULT_HORIZON = 23


class Microgrid(yaml.YAMLObject):
    """A microgrid: a container of modules plus the energy-balance dispatch.

    Parameters mirror the reference (``microgrid/microgrid.py:100-128``).
    """

    yaml_tag = "!Microgrid"
    yaml_dumper = PymgridDumper
    yaml_loader = PymgridLoader

    def __init__(
        self,
        modules,
        add_unbalanced_module=True,
        loss_load_cost=10.0,
        overgeneration_cost=2.0,
        reward_shaping_func=None,
        trajectory_func=None,
    ):
        self._modules = self._build_container(
            modules, add_unbalanced_module, loss_load_cost, overgeneration_cost
        )

        self.microgrid_action_space = MicrogridSpace(
            self._modules.get_attrs("action_space", "module_type", as_pandas=False),
            "act",
        )
        self.microgrid_observation_space = MicrogridSpace(
            self._modules.get_attrs("observation_space", as_pandas=False), "obs"
        )

        self._initial_step = self._consensus_initial_step()
        self._final_step = self._consensus_final_step()

        self.reward_shaping_func = reward_shaping_func
        self.trajectory_func = self._validate_trajectory_func(trajectory_func)

        self._balance_logger = ModularLogger()
        self._microgrid_logger = ModularLogger()

    # --------------------------------------------------------- construction
    def _build_container(self, modules, add_unbalanced_module, loss_load_cost, overgeneration_cost):
        if isinstance(modules, (str, bytes, dict)) or not hasattr(modules, "__iter__"):
            raise TypeError("modules must be list-like of modules.")
        module_list = deepcopy(list(modules))
        if add_unbalanced_module:
            module_list.append(
                self._get_unbalanced_energy_module(loss_load_cost, overgeneration_cost)
            )
        return ModuleContainer(module_list)

    def _get_unbalanced_energy_module(self, loss_load_cost, overgeneration_cost):
        return UnbalancedEnergyModule(
            raise_errors=False,
            loss_load_cost=loss_load_cost,
            overgeneration_cost=overgeneration_cost,
        )

    def _validate_trajectory_func(self, trajectory_func):
        if trajectory_func is None:
            return None
        if not callable(trajectory_func):
            raise TypeError("trajectory_func must be callable.")

        probe = trajectory_func(self._initial_step, self._final_step)
        try:
            start, stop = probe
            if not (isinstance(start, int) and isinstance(stop, int)):
                raise ValueError
        except (TypeError, ValueError):
            raise TypeError(f"trajectory func must return two integer values, not {probe}")

        if start < self._initial_step:
            raise ValueError(
                f"trajectory_func returned initial_step value ({start}) less "
                f"than env's initial step: ({self._initial_step})"
            )
        if stop > self._final_step:
            raise ValueError(
                f"trajectory_func returned final_step value ({stop}) greater "
                f"than env's final step: ({self._final_step})"
            )
        if start >= stop:
            raise ValueError(
                f"trajectory_func returned values ({start}, {stop}) such "
                f"that initial_step was greater than or equal to final_step."
            )
        return trajectory_func

    # ----------------------------------------------------------- containers
    @property
    def modules(self):
        return self._modules

    @property
    def fixed(self):
        return self._modules.fixed

    @property
    def flex(self):
        return self._modules.flex

    @property
    def controllable(self):
        return self._modules.controllable

    @property
    def module_list(self):
        return self._modules.to_list()

    @property
    def n_modules(self):
        return len(self._modules)

    # ----------------------------------------------------------------- yaml
    def dump(self, stream=None):
        return yaml_dump(self, stream=stream)

    @classmethod
    def load(cls, stream):
        return yaml_load(stream)

    @classmethod
    def to_yaml(cls, dumper, data):
        add_numpy_pandas_representers()
        return dumper.represent_mapping(
            cls.yaml_tag, data.serialize(dumper.stream), flow_style=cls.yaml_flow_style
        )

    @classmethod
    def from_yaml(cls, loader, node):
        add_numpy_pandas_constructors()
        mapping = loader.construct_mapping(node, deep=True)

        if "scenario" in mapping:
            scenario_number = mapping.pop("scenario")
            if len(mapping):
                warn(f"Ignoring keys {mapping.keys()} when loading from scenario.")
            return cls.from_scenario(scenario_number)

        instance = cls(mapping["modules"], add_unbalanced_module=False)
        instance._balance_logger = instance._balance_logger.from_raw(
            mapping.get("balance_log")
        )
        instance.trajectory_func = mapping.get("trajectory_func", None)
        instance._initial_step = mapping.get("initial_step", instance.initial_step)
        instance._final_step = mapping.get("final_step", instance.final_step)
        return instance

    def serialize(self, dumper_stream):
        payload = {
            "modules": self._modules.to_tuples(),
            "trajectory_func": self.trajectory_func,
            "initial_step": self.initial_step,
            "final_step": self.final_step,
            **self._balance_logger.serialize("balance_log"),
        }
        return dump_data(payload, dumper_stream, self.yaml_tag)

    @classmethod
    def from_scenario(cls, microgrid_number=0):
        """Load one of the packaged *pymgrid25* benchmark microgrids."""
        from pymgrid_tpu.paths import scenario_yaml_path

        if microgrid_number not in range(25):
            raise TypeError(
                f"Invalid microgrid_number {microgrid_number}, must be an integer "
                f"in the range [0, 25)."
            )
        with open(scenario_yaml_path(microgrid_number), "r") as f:
            return cls.load(f)

    @classmethod
    def from_nonmodular(cls, nonmodular):
        from pymgrid_tpu.convert import to_modular

        return to_modular(nonmodular)

    def to_nonmodular(self):
        from pymgrid_tpu.convert import to_nonmodular

        return to_nonmodular(self)

    # ---------------------------------------------------------------- steps
    @property
    def current_step(self):
        return self._modules.get_attrs("current_step", unique=True).item()

    def _consensus_initial_step(self):
        gathered = self.modules.get_attrs("initial_step", unique=True)
        try:
            return gathered.item()
        except ValueError:
            if gathered.empty:
                return 0
            raise

    def _consensus_final_step(self):
        gathered = self.modules.get_attrs("final_step", unique=True)
        try:
            return gathered.item()
        except ValueError:
            if gathered.empty:
                return np.inf
            raise

    @property
    def initial_step(self):
        return self._initial_step

    @initial_step.setter
    def initial_step(self, value):
        self._set_initial_step(value)

    def _set_initial_step(self, value, modules_only=False):
        self.set_module_attr("initial_step", value)
        if not modules_only:
            self._initial_step = self._consensus_initial_step()

    @property
    def final_step(self):
        return self._final_step

    @final_step.setter
    def final_step(self, value):
        self._set_final_step(value)

    def _set_final_step(self, value, modules_only=False):
        self.set_module_attr("final_step", value)
        if not modules_only:
            self._final_step = self._consensus_final_step()

    # ---------------------------------------------------------------- state
    def state_dict(self, normalized=False):
        return {
            name: [module.state_dict(normalized=normalized) for module in modules]
            for name, modules in self._modules.iterdict()
        }

    def state_series(self, normalized=False):
        import pandas as pd

        flattened = {}
        for name, per_module_states in self.state_dict(normalized=normalized).items():
            for num, state in enumerate(per_module_states):
                for key, value in state.items():
                    flattened[(name, num, key)] = value
        return pd.Series(flattened)

    def to_normalized(self, data_dict, act=False, obs=False):
        assert act + obs == 1
        return {
            name: [
                module.to_normalized(value, act=act, obs=obs)
                for module, value in zip(module_list, data_dict[name])
            ]
            for name, module_list in self._modules.iterdict()
            if name in data_dict
        }

    def from_normalized(self, data_dict, act=False, obs=False):
        assert act + obs == 1
        return {
            name: [
                module.from_normalized(value, act=act, obs=obs)
                for module, value in zip(module_list, data_dict[name])
            ]
            for name, module_list in self._modules.iterdict()
            if name in data_dict
        }

    # ------------------------------------------------------------ broadcast
    def set_module_attr(self, attr_name, value):
        touched = 0
        for module in self._modules.iterlist():
            if hasattr(module, attr_name):
                setattr(module, attr_name, value)
                touched += 1
        if not touched:
            raise AttributeError(f"No module has attribute '{attr_name}'.")

    def set_forecaster(
        self,
        forecaster,
        forecast_horizon=DEFAULT_HORIZON,
        forecaster_increase_uncertainty=False,
        forecaster_relative_noise=False,
    ):
        common = dict(
            forecast_horizon=forecast_horizon,
            forecaster_increase_uncertainty=forecaster_increase_uncertainty,
            forecaster_relative_noise=forecaster_relative_noise,
        )

        if isinstance(forecaster, dict):
            for module_name, module_forecaster in forecaster.items():
                if module_name not in self._modules.names():
                    raise NameError(f"Unrecognized module {module_name}.")
                for module in self._modules[module_name]:
                    try:
                        module.set_forecaster(module_forecaster, **common)
                    except AttributeError:
                        pass
            return

        for module in self._modules.iterlist():
            try:
                module.set_forecaster(forecaster, **common)
            except AttributeError:
                pass

    def get_forecast_horizon(self):
        horizons = [
            module.forecast_horizon
            for module in self._modules.iterlist()
            if hasattr(module, "forecast_horizon")
        ]
        if not horizons:
            warn(
                f"No forecast horizon found in microgrid.modules. Using default "
                f"horizon {DEFAULT_HORIZON}"
            )
            return DEFAULT_HORIZON
        if np.min(horizons) != np.max(horizons):
            raise ValueError(f"Mismatched forecast_horizons found: {horizons}")
        return horizons[0]

    def get_cost_info(self):
        return self._modules.get_attrs(
            "production_marginal_cost", "absorption_marginal_cost", as_pandas=False
        )

    # ------------------------------------------------------------- sampling
    def _actionable_modules(self, sample_flex_modules):
        source = self._modules if sample_flex_modules else self._modules.controllable
        return {
            name: module_list
            for name, module_list in source.to_dict().items()
            if module_list[0].action_space.shape[0]
        }

    def sample_action(self, strict_bound=False, sample_flex_modules=False):
        """Uniform random action dict over modules with non-empty action spaces."""
        return {
            name: [m.sample_action(strict_bound=strict_bound) for m in module_list]
            for name, module_list in self._actionable_modules(sample_flex_modules).items()
        }

    def get_empty_action(self, sample_flex_modules=False):
        return {
            name: [None] * len(module_list)
            for name, module_list in self._actionable_modules(sample_flex_modules).items()
        }

    # -------------------------------------------------------------- logging
    def get_log(self, as_frame=True, drop_singleton_key=False):
        """Full log as a ``(module_name, module_number, field)`` MultiIndex
        DataFrame (reference ``microgrid/microgrid.py:434-475``)."""
        import pandas as pd

        columns = {}
        for name, modules in self._modules.iterdict():
            for j, module in enumerate(modules):
                for field, series in module.log_dict().items():
                    columns[(name, j, field)] = series

        for field, series in self._balance_logger.to_dict().items():
            columns[("balance", 0, field)] = series

        for field, series in self._microgrid_logger.items():
            columns[(field, 0, "")] = series

        frame = pd.DataFrame(
            columns, index=pd.RangeIndex(start=self.initial_step, stop=self.current_step)
        )
        frame.columns = pd.MultiIndex.from_tuples(
            frame.columns.to_list(), names=["module_name", "module_number", "field"]
        )

        if drop_singleton_key:
            frame.columns = frame.columns.remove_unused_levels()

        return frame if as_frame else frame.to_dict()

    @property
    def log(self):
        return self.get_log()

    def _get_log_dict(self, provided_energy, absorbed_energy, log_dict=None, prefix=None):
        tag = "" if prefix is None else prefix + "_"
        out = {
            tag + "provided_to_microgrid": provided_energy,
            tag + "absorbed_from_microgrid": absorbed_energy,
        }
        if log_dict:
            out.update(log_dict)
        return out

    # -------------------------------------------------------------- control
    def reset(self):
        """Reset all modules (re-rolling the trajectory) and flush logs."""
        self._roll_trajectory()
        out = {
            name: [module.reset() for module in module_list]
            for name, module_list in self.modules.iterdict()
        }
        out["balance"] = self._balance_logger.flush()
        out["other"] = self._microgrid_logger.flush()
        return out

    def _roll_trajectory(self):
        if self.trajectory_func is None:
            return
        start, stop = self.trajectory_func(self._initial_step, self._final_step)
        self._set_initial_step(start, modules_only=True)
        self._set_final_step(stop, modules_only=True)

    def run(self, control, normalized=True):
        """Advance the microgrid one step.

        Three phases (``microgrid/microgrid.py:227-325``):

        1. fixed modules step with a zero action (loads absorb their demand);
        2. controllable modules consume their entries of ``control``;
        3. flex modules balance the residual — sinks absorb any excess in
           container order, sources supply any deficit; the balancing module
           reconciles whatever remains.

        Returns the gym-style 4-tuple ``(obs, reward, done, info)``.
        """
        pending = control.copy()
        accumulator = MicrogridStep(
            reward_shaping_func=self.reward_shaping_func, cost_info=self.get_cost_info()
        )

        # phase 1: fixed modules, zero action
        for name, modules in self.fixed.iterdict():
            for module in modules:
                accumulator.append(name, *module.step(0.0, normalized=False))

        fixed_provided, fixed_consumed, _, _ = accumulator.balance()
        log_dict = self._get_log_dict(fixed_provided, fixed_consumed, prefix="fixed")

        # phase 2: controllable modules consume their control entries
        for name, modules in self.controllable.iterdict():
            if name not in pending:
                raise ValueError(
                    f'Control for module "{name}" not found. Available controls:'
                    f"\n\t{control.keys()}"
                )
            module_controls = pending.pop(name)
            try:
                paired = list(zip(modules, module_controls))
            except TypeError:
                paired = list(zip(modules, [module_controls]))

            for module, module_control in paired:
                accumulator.append(name, *module.step(module_control, normalized=normalized))

        provided, consumed, _, _ = accumulator.balance()
        difference = provided - consumed

        log_dict = self._get_log_dict(
            provided - fixed_provided,
            consumed - fixed_consumed,
            log_dict=log_dict,
            prefix="controllable",
        )

        if len(pending) > 0:
            warn(f"\nIgnoring the following keys in passed control:\n {list(pending.keys())}")

        # phase 3: flex modules absorb the surplus / cover the shortfall
        if difference > 0:
            surplus = difference
            for name, modules in self.flex.iterdict():
                for module in modules:
                    if not module.is_sink:
                        sink_request = 0.0
                    elif module.max_consumption < surplus:
                        sink_request = -1.0 * module.max_consumption
                    else:
                        sink_request = -1.0 * surplus
                    accumulator.append(name, *module.step(sink_request, normalized=False))
                    surplus += sink_request
        else:
            shortfall = -difference
            for name, modules in self.flex.iterdict():
                for module in modules:
                    if not module.is_source:
                        contribution = 0.0
                    elif module.max_production < shortfall:
                        contribution = module.max_production
                    else:
                        contribution = shortfall
                    accumulator.append(name, *module.step(contribution, normalized=False))
                    shortfall -= contribution

        provided, consumed, reward, shaped_reward = accumulator.balance()
        log_dict = self._get_log_dict(provided, consumed, log_dict=log_dict, prefix="overall")
        self._balance_logger.log(reward=reward, shaped_reward=shaped_reward, **log_dict)

        if not np.isclose(provided, consumed):
            raise RuntimeError(
                "Microgrid modules unable to balance energy production with "
                "consumption.\n"
            )

        return accumulator.output()

    # --------------------------------------------------------------- dunder
    def _dir_additions(self):
        return {
            x
            for x in dir(self._modules)
            if not x.startswith("_")
            and not callable(getattr(self._modules, x))
            and x in self._modules
        }

    def __dir__(self):
        return sorted(set(super().__dir__()) | self._dir_additions())

    def __getnewargs__(self):
        return (self.modules.to_tuples(),)

    def __len__(self):
        lengths = []
        for module in self.modules.iterlist():
            try:
                lengths.append(len(module))
            except TypeError:
                pass
        return min(lengths)

    def __eq__(self, other):
        if type(self) != type(other):
            return NotImplemented
        return (
            self.modules.to_dict() == other.modules.to_dict()
            and self._balance_logger == other._balance_logger
            and self.trajectory_func == other.trajectory_func
        )

    def __repr__(self):
        census = ", ".join(
            f"{name} x {len(modules)}" for name, modules in self._modules.iterdict()
        )
        return f"Microgrid([{census}])"

    def __getattr__(self, item):
        if item.startswith("__") or item == "_modules":
            raise AttributeError(item)
        if item in self._modules:
            return self._modules[item]
        return object.__getattribute__(self, item)
