#!/usr/bin/env python
"""Micro-profile the batched RL env path vs the suite rollout.

Times the fused BatchedDiscreteEnv.rollout (with/without obs) and a
suite-style rollout on the same scenario, printing env-steps/s for each
variant.  Runs on the default JAX device (the GPU where there is one);
``--cpu`` pins the CPU backend.

Usage: python tools/profile_env.py [--batch 2048] [--steps 100] [--cpu]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, repeats=3):
    """Best wall seconds of ``fn(*args)``, waiting for the device."""
    import jax

    jax.block_until_ready(fn(*args))  # compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend")
    ap.add_argument("--scenario", type=int, default=0)
    args = ap.parse_args()

    import jax

    from pymgrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from pymgrid_tpu.envs import DiscreteMicrogridEnv
    from pymgrid_tpu.parallel.batched_env import BatchedDiscreteEnv

    B, T = args.batch, args.steps
    env = DiscreteMicrogridEnv.from_scenario(args.scenario)
    batched = BatchedDiscreteEnv(env, batch_size=B, dtype=np.float32)
    rng = np.random.RandomState(0)
    action_seq = jnp.asarray(rng.randint(batched.n_actions, size=(T, B)), jnp.int32)
    states = batched.reset(seed=0)

    for keep_obs in (True, False):
        wall = timeit(
            lambda: batched.rollout(states, action_seq, keep_obs=keep_obs)
        )
        print(
            f"fused rollout keep_obs={keep_obs}: "
            f"{B * T / wall / 1e6:.2f}M env-steps/s  ({wall:.3f}s)"
        )

    # suite-style rollout on the same scenario (marginal-cost policy, obs
    # checksummed, not materialized)
    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu.parallel.suite import SuiteRunner

    runner = SuiteRunner(
        [Microgrid.from_scenario(args.scenario)], batch_per_config=B,
        dtype=np.float32,
    )
    policy = make_marginal_cost_policy(runner.spec)
    fn = runner.rollout_fn(policy, T, auto_reset=True, collect=False)
    keys = runner.make_keys(seed=0)
    wall = timeit(fn, runner.params, keys)
    print(
        f"suite rollout (obs checksummed): "
        f"{B * T / wall / 1e6:.2f}M env-steps/s  ({wall:.3f}s)"
    )


if __name__ == "__main__":
    main()
