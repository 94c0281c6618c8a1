"""Factories building matched (reference, pymgrid_tpu) microgrid pairs."""
import numpy as np


def module_params(seed=0, timesteps=120, weak_grid=False, start_up_time=None,
                  wind_down_time=None, forecaster=None, forecast_horizon=23,
                  efficiency=0.9):
    rng = np.random.RandomState(seed)
    sut = rng.randint(0, 3) if start_up_time is None else start_up_time
    wdt = rng.randint(0, 3) if wind_down_time is None else wind_down_time
    pv_ts = 50 * rng.rand(timesteps)
    load_ts = 60 * rng.rand(timesteps)
    grid_ts = rng.rand(timesteps, 4)
    grid_ts[:, 3] = (rng.rand(timesteps) > 0.3).astype(float) if weak_grid else 1.0
    fc = dict(forecaster=forecaster, forecast_horizon=forecast_horizon)
    return dict(
        genset=dict(
            running_min_production=10,
            running_max_production=50,
            genset_cost=0.5,
            co2_per_unit=2.0,
            cost_per_unit_co2=0.1,
            start_up_time=sut,
            wind_down_time=wdt,
        ),
        battery=dict(
            min_capacity=10,
            max_capacity=100,
            max_charge=50,
            max_discharge=50,
            efficiency=efficiency,
            battery_cost_cycle=0.02,
            init_soc=0.5,
        ),
        pv=dict(time_series=pv_ts, **fc),
        load=dict(time_series=load_ts, **fc),
        grid=dict(
            max_import=100,
            max_export=100,
            time_series=grid_ts,
            cost_per_unit_co2=0.1,
            **fc,
        ),
    )


def build_microgrid(namespace, params, include=("genset", "battery", "pv", "load", "grid"),
                    **microgrid_kwargs):
    """Build a microgrid from a module namespace (reference pymgrid or ours)."""
    modules = []
    if "genset" in include:
        modules.append(namespace.GensetModule(**params["genset"]))
    if "battery" in include:
        modules.append(namespace.BatteryModule(**params["battery"]))
    if "pv" in include:
        modules.append(("pv", namespace.RenewableModule(**params["pv"])))
    if "load" in include:
        modules.append(namespace.LoadModule(**params["load"]))
    if "grid" in include:
        modules.append(namespace.GridModule(**params["grid"]))
    return modules, microgrid_kwargs


def make_pair(seed=0, include=("genset", "battery", "pv", "load", "grid"),
              **kwargs):
    """Return (reference_microgrid, our_microgrid) with identical params."""
    from helpers.reference import import_reference
    import pymgrid_tpu
    import pymgrid_tpu.modules as our_modules

    microgrid_kwargs = {
        k: kwargs.pop(k)
        for k in ("loss_load_cost", "overgeneration_cost", "reward_shaping_func",
                  "trajectory_func")
        if k in kwargs
    }

    pymgrid = import_reference()
    import pymgrid.modules as ref_modules

    params = module_params(seed=seed, **kwargs)
    ref_mods, _ = build_microgrid(ref_modules, params, include)
    our_mods, _ = build_microgrid(our_modules, params, include)
    return (
        pymgrid.Microgrid(ref_mods, **microgrid_kwargs),
        pymgrid_tpu.Microgrid(our_mods, **microgrid_kwargs),
    )
