#!/usr/bin/env python
"""Scenario-0 structural analysis: why the discrete action space cannot
beat rule-based control, and what the continuous ceiling is.

What it computes:

* the two discrete priority orderings and price-threshold mixtures of
  them never beat battery-first RBC (holding charge blocks absorbing the
  next day's free PV excess);
* a handcrafted continuous battery-dispatch policy (charge from the grid
  at the 0.22 night price, discharge against the 0.59 peak residual,
  grid follows) realizes ~5.2% below RBC's full-year cost — the target
  ES then learns (examples/train_es.py --continuous).

Run: python examples/scenario0_structure.py [--cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--steps", type=int, default=8758)
    args = parser.parse_args()
    from pymgrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    from jax import lax

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.engine import make_reset_fn, make_step_fn
    from pymgrid_tpu.core.rollout import (
        make_marginal_cost_policy,
        make_table_policy,
    )
    from pymgrid_tpu.core.spec import extract_spec
    from pymgrid_tpu.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv

    N = args.steps

    # ---- tariff structure --------------------------------------------
    mg = Microgrid.from_scenario(0)
    mods = {}
    for name, ms in mg.modules.iterdict():
        for m in ms:
            mods.setdefault(name, m)
    gts = np.asarray(mods["grid"].time_series)
    price = gts[:, 0]
    pv = np.asarray(mods["pv"].time_series).ravel()
    load = -np.asarray(mods["load"].time_series).ravel()
    b = mods["battery"]
    resid = np.maximum(load - pv, 0)
    print("TOU levels and residual load (load beyond PV) per level:")
    for lvl in np.unique(price):
        m = price == lvl
        print(f"  price {lvl}: residual hours {int((m & (resid > 0)).sum())}, "
              f"residual sum {resid[m].sum():,.0f}")
    eff = b.efficiency
    margin = price.max() * eff - price.min() / eff - 2 * b.battery_cost_cycle
    print(f"night->peak round-trip margin/unit: {margin:.4f}; "
          f"usable capacity/day {b.max_capacity - b.min_capacity:,.1f}")

    # ---- shared eval machinery ---------------------------------------
    def eval_policy(env, spec, params, act_fn, label):
        step_fn = make_step_fn(spec, normalized=False)
        reset_fn = make_reset_fn(spec)
        dtype = np.float32

        @jax.jit
        def run(key):
            state = reset_fn(params, key)
            zero = {"battery": jnp.zeros(spec.n_battery, dtype),
                    "genset": jnp.zeros((spec.n_genset, 2), dtype),
                    "grid": jnp.zeros(spec.n_grid, dtype)}
            state, _ = step_fn(params, state, zero)

            def body(carry, _):
                state, acc = carry
                a = act_fn(params, state)
                state, out = step_fn(params, state, a)
                return (state, acc + out.reward), None

            (_, acc), _ = lax.scan(
                body, (state, jnp.asarray(0.0, dtype)), None, length=N)
            return acc

        r = float(run(jax.random.PRNGKey(123)))
        print(f"  {label}: {r:,.2f}")
        return r

    # ---- discrete space ----------------------------------------------
    env = DiscreteMicrogridEnv.from_scenario(0)
    spec, params, _ = extract_spec(env, dtype=np.float32)
    params = jax.tree.map(jnp.asarray, params)
    table_policy = make_table_policy(spec, [list(pl) for pl in env.actions_list])
    rbc = make_marginal_cost_policy(spec)
    bat_idx = 0 if env.actions_list[0][0].module[0] == "battery" else 1
    price_ts = params["grid"]["ts"][0][:, 0]

    print(f"discrete action space over {N} steps:")
    r_rbc = eval_policy(env, spec, params, rbc, "RBC (battery-first)")
    for label, rule in (
        ("always grid-first", lambda p, s: jnp.int32(1 - bat_idx)),
        ("battery-first iff price >= 0.25",
         lambda p, s: jnp.where(price_ts[s["step"]] >= 0.25, bat_idx,
                                1 - bat_idx).astype(jnp.int32)),
        ("battery-first iff price >= 0.50",
         lambda p, s: jnp.where(price_ts[s["step"]] >= 0.50, bat_idx,
                                1 - bat_idx).astype(jnp.int32)),
    ):
        eval_policy(env, spec, params,
                    lambda p, s, rule=rule: table_policy(p, s, rule(p, s)),
                    label)

    # ---- continuous space: handcrafted arbitrage ---------------------
    cenv = ContinuousMicrogridEnv.from_scenario(0)
    cspec, cparams, _ = extract_spec(cenv, dtype=np.float32)
    cparams = jax.tree.map(jnp.asarray, cparams)
    pb = cparams["battery"]
    grid_ts = cparams["grid"]["ts"][0]
    load_ts = cparams["load"]["ts"][0]
    pv_ts = cparams["renewable"]["ts"][0]

    def arb(params, state):
        t = state["step"]
        p = grid_ts[t, 0]
        load0 = -load_ts[t, 0]
        pv0 = pv_ts[t, 0]
        charge = state["battery_charge"][0]
        e = pb["efficiency"][0]
        res = jnp.maximum(load0 - pv0, 0.0)
        max_dis = jnp.minimum(pb["max_discharge"][0],
                              charge - pb["min_capacity"][0]) * e
        max_chg = jnp.minimum(pb["max_charge"][0],
                              pb["max_capacity"][0] - charge) / e
        bat = jnp.where(p >= 0.50, jnp.minimum(max_dis, res),
                        jnp.where(p <= 0.23, -max_chg, 0.0))
        need = res - jnp.maximum(bat, 0.0) + jnp.maximum(-bat, 0.0)
        grid = jnp.clip(need, 0.0, params["grid"]["max_import"][0])
        return {"battery": bat.reshape(1).astype(np.float32),
                "genset": jnp.zeros((cspec.n_genset, 2), np.float32),
                "grid": grid.reshape(1).astype(np.float32)}

    print("continuous space (battery dispatch + grid follower):")
    r_arb = eval_policy(cenv, cspec, cparams, arb,
                        "handcrafted night->peak arbitrage")
    print(f"handcrafted vs RBC: {(1 - r_arb / r_rbc) * 100:+.2f}% cost")


if __name__ == "__main__":
    main()
