#!/usr/bin/env python
"""Evolution-strategies training on the compiled engine: optimize the
FULL-YEAR return directly.

Why ES here: scenario 0's discrete action space is two priority orderings
and the win over rule-based control is *inter-temporal* — hold battery
charge through cheap TOU hours, discharge at the 0.59/kWh peak.  A2C with
64-128-step rollouts converges to exactly-RBC on this scenario: the
arbitrage credit spans ~12 simulated hours and drowns in the advantage
noise.  OpenAI-style ES (antithetic perturbations, centered-rank shaping)
optimizes the whole-episode objective with no credit assignment at all —
and the fused rollout makes that affordable: one generation evaluates the
entire population's full-year episodes as ONE device program
(``vmap(episode) o lax.scan(year)``, reward accumulated in the carry, zero
per-step HBM traffic).

Run: python examples/train_es.py [--scenario 0] [--pop 256] [--gens 150]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def build_es(scenario=0, pop=256, sigma=0.05, lr=0.02, hidden=32,
             n_steps=8758, dtype=np.float32, continuous=False):
    """Returns ``run(gens, seed)`` evaluating a pop of antithetic
    perturbations per generation, all device-resident.

    ``continuous=False``: the policy picks among the discrete env's
    priority orderings (argmax over MLP logits).  ``continuous=True``: the
    MLP drives the battery DISPATCH directly (tanh output scaled to the
    state's true charge/discharge room) with the grid following the
    residual — the parameterization that can express night->peak
    grid-charging arbitrage, which no priority ordering can (scenario 0's
    peak residual load is 597k units/yr at a +0.247/unit round-trip
    margin; a handcrafted threshold version realizes -5.2% cost vs RBC)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax

    from pymgrid_tpu.core.engine import make_reset_fn, make_step_fn
    from pymgrid_tpu.core.rollout import (
        make_marginal_cost_policy,
        make_table_policy,
    )
    from pymgrid_tpu.core.spec import extract_spec
    from pymgrid_tpu.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv

    if continuous:
        env = ContinuousMicrogridEnv.from_scenario(scenario)
        spec, params, _ = extract_spec(env, dtype=dtype)
        n_out = 1
    else:
        env = DiscreteMicrogridEnv.from_scenario(scenario)
        spec, params, _ = extract_spec(env, dtype=dtype)
        n_out = env.action_space.n
    from pymgrid_tpu.core.tables import ensure_tables

    params = ensure_tables(spec, params)  # one fused row gather per step
    params = jax.tree.map(jnp.asarray, params)
    obs_dim = spec.obs_dim

    if not continuous:
        table_policy = make_table_policy(
            spec, [list(pl) for pl in env.actions_list]
        )
    step_fn = make_step_fn(spec, normalized=False)
    reset_fn = make_reset_fn(spec)

    if continuous and (spec.n_battery != 1 or spec.n_grid != 1
                       or spec.n_genset != 0):
        raise NotImplementedError(
            "continuous ES mode currently targets the battery+grid family "
            "(scenario 0-family arbitrage demonstration)"
        )

    sizes = [obs_dim, hidden, n_out]
    shapes = []
    for m, n in zip(sizes[:-1], sizes[1:]):
        shapes += [(m, n), (n,)]
    dim = sum(int(np.prod(s)) for s in shapes)

    def unflatten(flat):
        layers, off = [], 0
        for s in shapes:
            k = int(np.prod(s))
            layers.append(flat[off:off + k].reshape(s))
            off += k
        return layers

    def mlp(flat, x):
        layers = unflatten(flat)
        for i in range(0, len(layers) - 2, 2):
            x = jax.nn.tanh(x @ layers[i] + layers[i + 1])
        return x @ layers[-2] + layers[-1]

    def eval_start(params, key):
        """Reset + one zero-action bootstrap step: the identical start state
        the RBC baseline and train_rl evaluations use."""
        state = reset_fn(params, key)
        zero = {
            "battery": jnp.zeros(spec.n_battery, dtype),
            "genset": jnp.zeros((spec.n_genset, 2), dtype),
            "grid": jnp.zeros(spec.n_grid, dtype),
        }
        state, out = step_fn(params, state, zero)
        return state, out.obs

    def policy_action(theta_flat, params, state, obs):
        out = mlp(theta_flat, obs.astype(jnp.float32))
        if not continuous:
            return table_policy(params, state, jnp.argmax(out))
        # battery dispatch scaled to the state's true room; grid follows
        pb = params["battery"]
        charge = state["battery_charge"][0]
        eff = pb["efficiency"][0]
        max_dis = jnp.minimum(
            pb["max_discharge"][0], charge - pb["min_capacity"][0]
        ) * eff
        max_chg = jnp.minimum(
            pb["max_charge"][0], pb["max_capacity"][0] - charge
        ) / eff
        u = jnp.tanh(out[0]).astype(dtype)
        bat = jnp.where(u >= 0, u * max_dis, u * max_chg)
        t = state["step"]
        load = -params["load"]["ts"][0][t, 0]
        pv = params["renewable"]["ts"][0][t, 0]
        resid = jnp.maximum(load - pv, 0.0)
        need = resid - jnp.maximum(bat, 0.0) + jnp.maximum(-bat, 0.0)
        g = 0
        status = params["grid"]["ts"][g][t, 3]
        grid = jnp.clip(need, 0.0, params["grid"]["max_import"][g] * status)
        return {
            "battery": bat.reshape(1).astype(dtype),
            "genset": jnp.zeros((spec.n_genset, 2), dtype),
            "grid": grid.reshape(1).astype(dtype),
        }

    def episode_return(theta_flat, params, key):
        """Greedy full-episode return (raw rewards, no resets): the same
        surface the policy-vs-RBC comparison reports."""
        state, obs = eval_start(params, key)

        def body(carry, _):
            state, obs, acc = carry
            action = policy_action(theta_flat, params, state, obs)
            state, out = step_fn(params, state, action)
            return (state, out.obs, acc + out.reward), None

        (_, _, acc), _ = lax.scan(
            body, (state, obs, jnp.asarray(0.0, dtype)), None, length=n_steps
        )
        return acc

    optimizer = optax.adam(lr)
    half = pop // 2

    import functools

    @functools.partial(jax.jit, static_argnums=())
    def es_generation(theta_flat, opt_state, params, key, eval_key):
        eps = jax.random.normal(key, (half, dim), jnp.float32)
        eps = jnp.concatenate([eps, -eps])                  # antithetic
        thetas = theta_flat[None, :] + sigma * eps
        returns = jax.vmap(
            lambda tf: episode_return(tf, params, eval_key)
        )(thetas)
        # centered-rank shaping: scale-free, robust to the cost magnitudes
        ranks = jnp.argsort(jnp.argsort(returns)).astype(jnp.float32)
        shaped = ranks / (pop - 1) - 0.5
        grad = -(shaped[:, None] * eps).mean(axis=0) / sigma
        updates, opt_state = optimizer.update(grad, opt_state)
        theta_flat = optax.apply_updates(theta_flat, updates)
        return theta_flat, opt_state, returns.max(), returns.mean()

    def rbc_baseline(seed=123):
        rbc_policy = make_marginal_cost_policy(spec)

        @jax.jit
        def run_rbc(params, key):
            state, _ = eval_start(params, key)

            def body(carry, _):
                state, acc = carry
                action = rbc_policy(params, state)
                state, out = step_fn(params, state, action)
                return (state, acc + out.reward), None

            (_, acc), _ = lax.scan(
                body, (state, jnp.asarray(0.0, dtype)), None, length=n_steps
            )
            return acc

        return float(run_rbc(params, jax.random.PRNGKey(seed)))

    def eval_theta(theta_flat, seed=123):
        return float(jax.jit(episode_return)(
            theta_flat, params, jax.random.PRNGKey(seed)
        ))

    def run(gens=150, seed=0, log_every=10, eval_seed=123):
        key = jax.random.PRNGKey(seed)
        theta = 0.01 * jax.random.normal(
            jax.random.fold_in(key, 0), (dim,), jnp.float32
        )
        opt_state = optimizer.init(theta)
        eval_key = jax.random.PRNGKey(eval_seed)
        best = -np.inf
        history = []
        for g in range(gens):
            gkey = jax.random.fold_in(key, 1000 + g)
            theta, opt_state, r_max, r_mean = es_generation(
                theta, opt_state, params, gkey, eval_key
            )
            r_max = float(r_max)
            history.append(r_max)
            best = max(best, r_max)
            if g % log_every == 0:
                print(f"gen {g}: best-of-pop {r_max:,.2f} "
                      f"mean {float(r_mean):,.2f}", flush=True)
        return theta, history

    run.rbc_baseline = rbc_baseline
    run.eval_theta = eval_theta
    run.pop, run.dim, run.n_steps = pop, dim, n_steps
    return run


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", type=int, default=0)
    parser.add_argument("--pop", type=int, default=256)
    parser.add_argument("--gens", type=int, default=150)
    parser.add_argument("--sigma", type=float, default=0.05)
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--steps", type=int, default=8758)
    parser.add_argument("--continuous", action="store_true",
                        help="MLP battery dispatch + grid follower "
                             "(continuous env) instead of discrete "
                             "priority-ordering selection")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU backend")
    args = parser.parse_args()

    from pymgrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    run = build_es(scenario=args.scenario, pop=args.pop, sigma=args.sigma,
                   lr=args.lr, hidden=args.hidden, n_steps=args.steps,
                   continuous=args.continuous)
    rbc = run.rbc_baseline()
    print(f"RBC return over {args.steps} steps: {rbc:,.2f}", flush=True)
    t0 = time.time()
    theta, history = run(gens=args.gens)
    dt = time.time() - t0
    pol = run.eval_theta(theta)
    steps = args.pop * args.steps * args.gens
    print(f"ES: {args.gens} gens x pop {args.pop} = {steps:,} env steps in "
          f"{dt:.1f}s ({steps / dt / 1e6:.2f}M steps/s)")
    print(f"final greedy policy return {pol:,.2f} vs RBC {rbc:,.2f} "
          f"({'BEATS' if pol > rbc else 'below'}, "
          f"{(1 - pol / rbc) * 100:+.2f}% cost)" if rbc < 0 else "")


if __name__ == "__main__":
    main()
