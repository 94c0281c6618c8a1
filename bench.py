#!/usr/bin/env python
"""Throughput benchmark: batched env-steps/s/chip on the pymgrid25 suite.

All 25 benchmark scenarios are normalized onto one shared spec (neutral
padding, bit-exact — see pymgrid_tpu/parallel/suite.py) and run as ONE jitted
program: priority-list policy + three-phase dispatch + observation
construction fused per step, scan over time, vmapped over replicas, vmapped
over configs, with episode auto-reset.  Observations are consumed
(checksummed) every step so the RL-facing obs path is measured work.

Every replica starts at a key-derived random initial step
(``randomize_initial_step=True``): with a shared start and an in-engine
policy all replicas of a config are bitwise-identical, and XLA then
eliminates the replica dimension from the compiled program, so such a run
would measure broadcastable work instead of per-replica simulation.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "env_steps/s/chip", "vs_baseline": N,
   "device": {...}, ...}
vs_baseline is relative to 1M env-steps/s/chip (BASELINE.md).  ``device``
names the platform, kind and count as JAX reports them and the cards' name
and power limit as ``nvidia-smi`` reports them.

Besides the headline suite number, the same line carries the RL-facing
paths a user would actually train on: ``rl_fused_steps_per_sec`` (the
engine figure: BatchedDiscreteEnv.rollout, one device program, obs
returned), ``rl_env_steps_per_sec`` / ``continuous_env_steps_per_sec``
(python ``step()`` loops: one dispatch per step, so they measure per-call
launch and host overhead on top of the engine), ``engine_sweep_steps_per_sec``
(lockstep init-charge sweep: shared simulated time, rewards accumulated in
the carry) and ``collect_steps_per_sec`` (log-materializing rollout, full
StepOutput incl. log rows written to device memory).

Timings wait for the device with ``jax.block_until_ready`` on the result.

Env knobs: PYMGRID_BENCH_REPLICAS (default 20480 per config -> 512k envs),
PYMGRID_BENCH_STEPS (default 1000), PYMGRID_BENCH_REPEATS (3),
PYMGRID_BENCH_CONFIGS (default 25), PYMGRID_BENCH_SKIP_EXTRAS=1 to print the
suite number alone.  Extras: PYMGRID_BENCH_RL_BATCH (65536),
PYMGRID_BENCH_RL_STEPS (100; fused — the (T,B,obs) episode buffer bounds T
at B=65536), PYMGRID_BENCH_RL_LOOP_STEPS (100), PYMGRID_BENCH_SWEEP_BATCH
(131072), PYMGRID_BENCH_SWEEP_STEPS (2000), PYMGRID_BENCH_COLLECT_REPLICAS
(1024), PYMGRID_BENCH_COLLECT_STEPS (100), PYMGRID_BENCH_COLLECT_CONFIGS
(=CONFIGS).
Every code path here is exercised at tiny sizes by tests/test_bench_smoke.py.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _mark(msg):
    """Stage marker on stderr: stdout stays one JSON line."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _timed(fn, *args):
    """Wall seconds of one call, waiting for every output on the device."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def build_suite_rollout(n_configs, replicas, n_steps, dtype=np.float32):
    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu.parallel.suite import SuiteRunner

    microgrids = [Microgrid.from_scenario(n) for n in range(n_configs)]
    runner = SuiteRunner(microgrids, batch_per_config=replicas, dtype=dtype)

    # per-config rule-based control: deployment order from each config's
    # marginal costs at runtime (bitwise-equal to the host RBC, tested)
    policy = make_marginal_cost_policy(runner.spec)

    fn = runner.rollout_fn(
        policy, n_steps, auto_reset=True, collect=False,
        randomize_initial_step=True,   # distinct per-replica work
    )
    keys = runner.make_keys(seed=0)
    return fn, runner.params, keys


def bench_rl_env_step(batch_size=65536, n_steps=100, dtype=np.float32, seed=0):
    """User-facing RL path: BatchedDiscreteEnv.step with obs returned."""
    import jax
    import jax.numpy as jnp

    from pymgrid_tpu.envs import DiscreteMicrogridEnv
    from pymgrid_tpu.parallel.batched_env import BatchedDiscreteEnv

    env = DiscreteMicrogridEnv.from_scenario(0)
    batched = BatchedDiscreteEnv(env, batch_size=batch_size, dtype=dtype)
    rng = np.random.RandomState(seed)
    # actions on the device up front: the loop times stepping, not uploads
    action_seq = jnp.asarray(
        rng.randint(batched.n_actions, size=(n_steps, batch_size)), jnp.int32
    )

    states = batched.reset(seed=seed)
    jax.block_until_ready(batched.step(states, action_seq[0]))  # compile

    def loop(states):
        for k in range(n_steps):
            states, out = batched.step(states, action_seq[k])
        return states, out

    return batch_size * n_steps / _timed(loop, states)


def bench_rl_fused_rollout(batch_size=65536, n_steps=100, dtype=np.float32,
                           seed=0):
    """Same work as bench_rl_env_step but via BatchedDiscreteEnv.rollout:
    the whole action sequence runs as ONE device program (lax.scan), so the
    number reflects engine throughput instead of per-step dispatch cost."""
    import jax
    import jax.numpy as jnp

    from pymgrid_tpu.envs import DiscreteMicrogridEnv
    from pymgrid_tpu.parallel.batched_env import BatchedDiscreteEnv

    env = DiscreteMicrogridEnv.from_scenario(0)
    batched = BatchedDiscreteEnv(env, batch_size=batch_size, dtype=dtype)
    rng = np.random.RandomState(seed)
    action_seq = jnp.asarray(
        rng.randint(batched.n_actions, size=(n_steps, batch_size)), jnp.int32
    )

    def rollout(states):
        return batched.rollout(states, action_seq, shared_step=True)

    states = batched.reset(seed=seed)
    jax.block_until_ready(rollout(states))  # compile
    return batch_size * n_steps / _timed(rollout, states)


def bench_continuous_env_step(batch_size=65536, n_steps=100, dtype=np.float32,
                              seed=0):
    """Continuous RL path: BatchedContinuousEnv.step with obs returned."""
    import jax
    import jax.numpy as jnp

    from pymgrid_tpu.envs import ContinuousMicrogridEnv
    from pymgrid_tpu.parallel.batched_env import BatchedContinuousEnv

    env = ContinuousMicrogridEnv.from_scenario(1)  # genset + weak grid
    batched = BatchedContinuousEnv(env, batch_size=batch_size, dtype=dtype)
    rng = np.random.RandomState(seed)
    action_seq = jnp.asarray(
        rng.rand(n_steps, batch_size, batched.action_dim).astype(dtype)
    )

    states = batched.reset(seed=seed)
    jax.block_until_ready(batched.step(states, action_seq[0]))  # compile

    def loop(states):
        for k in range(n_steps):
            states, out = batched.step(states, action_seq[k])
        return states, out

    return batch_size * n_steps / _timed(loop, states)


def build_lockstep_sweep(batch_size=131072, n_steps=2000, seed=0):
    """Init-charge sweep of the scenario-0 (grid-only) family: every replica
    starts from a different battery charge, so trajectories are distinct per
    replica (no replica dedup possible) and each is a full marginal-cost-RBC
    rollout; all replicas share the simulated time
    (:func:`~pymgrid_tpu.core.rollout.make_lockstep_sweep_fn`).  Returns
    ``(sweep, params, lockstep_states)``."""
    import jax
    import jax.numpy as jnp

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.engine import make_reset_fn
    from pymgrid_tpu.core.rollout import (
        lockstep_states,
        make_lockstep_sweep_fn,
        make_marginal_cost_policy,
    )
    from pymgrid_tpu.core.spec import extract_spec

    spec, params, _ = extract_spec(Microgrid.from_scenario(0), dtype=np.float32)
    pb = params["battery"]
    init = np.linspace(
        float(pb["min_capacity"][0]), float(pb["max_capacity"][0]),
        batch_size, dtype=np.float32,
    )
    jparams = jax.tree.map(jnp.asarray, params)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch_size)
    states = jax.jit(jax.vmap(make_reset_fn(spec), in_axes=(None, 0)))(
        jparams, keys
    )
    states = {**states, "battery_charge": jnp.asarray(init)[:, None]}
    sweep = make_lockstep_sweep_fn(spec, make_marginal_cost_policy(spec),
                                   n_steps)
    return sweep, jparams, lockstep_states(spec, jparams, states)


def bench_lockstep_sweep(batch_size=131072, n_steps=2000, seed=0):
    """env-steps/s of :func:`build_lockstep_sweep`'s workload."""
    import jax

    sweep, params, states = build_lockstep_sweep(batch_size, n_steps, seed)
    jax.block_until_ready(sweep(params, states))  # compile
    return batch_size * n_steps / _timed(sweep, params, states)


def bench_collect_rollout(replicas=1024, n_steps=100, n_configs=25,
                          dtype=np.float32):
    """Log-materializing rollout: the full time-major StepOutput pytree
    (obs/reward/shaped_reward/done/log rows/balance scalars) written to
    device memory every step, as a data-collection run would.  The episode
    buffer is one packed row per env-step (suite.py collect mode), so 25
    configs x 1024 replicas x 100 steps is a few GB of device memory."""
    import jax

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu.parallel.suite import SuiteRunner

    microgrids = [Microgrid.from_scenario(n) for n in range(n_configs)]
    runner = SuiteRunner(microgrids, batch_per_config=replicas, dtype=dtype)
    policy = make_marginal_cost_policy(runner.spec)
    fn = runner.rollout_fn(
        policy, n_steps, auto_reset=True, collect=True,
        randomize_initial_step=True,
    )
    keys = runner.make_keys(seed=0)

    _, outs = jax.block_until_ready(fn(runner.params, keys))  # compile
    assert outs.obs.shape[-2] == n_steps and outs.log_row.ndim == 4
    return n_configs * replicas * n_steps / _timed(fn, runner.params, keys)


def device_info():
    """The device block of the JSON line: JAX's view plus ``nvidia-smi``'s."""
    import jax

    from pymgrid_tpu.utils.profiling import gpu_name_and_power_limit

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "name_power_limit": gpu_name_and_power_limit(),
    }


def main():
    import jax

    from pymgrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_configs = int(os.environ.get("PYMGRID_BENCH_CONFIGS", 25))
    replicas = int(os.environ.get("PYMGRID_BENCH_REPLICAS", 20480))
    n_steps = int(os.environ.get("PYMGRID_BENCH_STEPS", 1000))
    repeats = int(os.environ.get("PYMGRID_BENCH_REPEATS", 3))

    device = device_info()
    _mark(f"device {device}")

    rollout, params, keys = build_suite_rollout(n_configs, replicas, n_steps)
    _mark("suite built; compiling + warmup run")
    jax.block_until_ready(rollout(params, keys))
    _mark("warmup done; timing")

    best = float("inf")
    for r in range(repeats):
        wall = _timed(rollout, params, keys)
        best = min(best, wall)
        _mark(f"repeat {r}: {wall:.4f}s")

    total_envs = n_configs * replicas
    steps_per_sec = total_envs * n_steps / best

    result = {
        "metric": "batched_env_steps_per_sec_per_chip_pymgrid25_suite",
        "value": round(steps_per_sec, 1),
        "unit": "env_steps/s/chip",
        "vs_baseline": round(steps_per_sec / 1e6, 3),
        "n_configs": n_configs,
        "replicas_per_config": replicas,
        "total_envs": total_envs,
        "n_steps": n_steps,
        "backend": jax.default_backend(),
        "n_chips_visible": device["count"],
        "device": device,
        "wall_s": round(best, 4),
    }

    result["note"] = (
        "replicas start at randomized steps (distinct per-replica work).  "
        "Auto-resets are sequential-wrap ((t+1) mod max_start; "
        "parallel/suite.py block-prefetch, bitwise-tested vs the per-step "
        "path): per-replica time rows come as one contiguous (8, W) slice "
        "per 8 steps instead of 8 row gathers.  engine_sweep_steps_per_sec "
        "shows the shared-time ceiling on the same dispatch math"
    )

    if not int(os.environ.get("PYMGRID_BENCH_SKIP_EXTRAS", 0)):
        rl_batch = int(os.environ.get("PYMGRID_BENCH_RL_BATCH", 65536))
        loop_steps = int(os.environ.get("PYMGRID_BENCH_RL_LOOP_STEPS", 100))
        _mark("extras: BatchedDiscreteEnv RL path")
        result["rl_env_steps_per_sec"] = round(
            bench_rl_env_step(batch_size=rl_batch, n_steps=loop_steps), 1
        )
        _mark("extras: fused BatchedDiscreteEnv rollout")
        result["rl_fused_steps_per_sec"] = round(
            bench_rl_fused_rollout(
                batch_size=rl_batch,
                n_steps=int(os.environ.get("PYMGRID_BENCH_RL_STEPS", 100)),
            ),
            1,
        )
        _mark("extras: BatchedContinuousEnv path")
        result["continuous_env_steps_per_sec"] = round(
            bench_continuous_env_step(batch_size=rl_batch, n_steps=loop_steps),
            1,
        )
        result["loop_numbers_note"] = (
            "rl_env_steps_per_sec and continuous_env_steps_per_sec time "
            "python step() loops: one dispatch per step, not engine "
            "throughput (rl_fused_steps_per_sec is the engine figure)"
        )
        _mark("extras: lockstep init-charge sweep")
        result["engine_sweep_steps_per_sec"] = round(
            bench_lockstep_sweep(
                batch_size=int(os.environ.get("PYMGRID_BENCH_SWEEP_BATCH", 131072)),
                n_steps=int(os.environ.get("PYMGRID_BENCH_SWEEP_STEPS", 2000)),
            ),
            1,
        )
        _mark("extras: collect rollout")
        result["collect_steps_per_sec"] = round(
            bench_collect_rollout(
                replicas=int(os.environ.get("PYMGRID_BENCH_COLLECT_REPLICAS", 1024)),
                n_steps=int(os.environ.get("PYMGRID_BENCH_COLLECT_STEPS", 100)),
                n_configs=int(os.environ.get("PYMGRID_BENCH_COLLECT_CONFIGS", n_configs)),
            ),
            1,
        )

    print(json.dumps(result))


if __name__ == "__main__":
    main()
