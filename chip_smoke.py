#!/usr/bin/env python
"""Run the main paths once on the GPU and check each against a plain reference.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-gpus   # four cards: the sharded paths only

Phases (one card), in one process, each through the public entry points:

1. device   — the default JAX device must be a GPU; nothing falls back to
              the CPU.
2. golden   — full-year RBC (``RuleBasedControl.run_compiled``) of all 25
              pymgrid25 scenarios in float64 and float32, against the frozen
              float64 reference streams of the real pymgrid
              (``tests/fixtures/golden_rbc.npz``).
3. suite    — ``SuiteRunner``: 25 configs x 4096 replicas, randomized starts,
              auto-reset, rewards only, 1000 steps, float32; per-replica
              totals against the same program on the CPU backend in float64.
4. rl       — ``BatchedDiscreteEnv`` and ``BatchedContinuousEnv`` on scenario
              1 at 65,536 envs: reset, 5 ``step`` calls, a 100-step
              ``rollout(shared_step=True)``; rewards against the CPU backend
              in float64 on the first 64 envs.
5. training — ``examples/train_rl.build_training`` (A2C, scenario 1, batch
              4096, rollout 128), two ``train_chunk`` dispatches, MLP
              products at ``"highest"`` precision; the first iteration's loss
              against the same iteration on the CPU backend.
6. planners — ``SuiteMPC`` over the 25 scenarios for 24 steps as one
              execution in float64 and float32, against the same float64
              program on the CPU backend and against the host
              ``ModelPredictiveControl`` (scipy HiGHS); ``BatchedSAA`` on
              scenario 0 for a few steps.

``--four-gpus`` runs the suite (24 configs: the config axis must divide the
mesh) sharded over ``make_batch_mesh(4)`` and two A2C chunks with the learner
replicated over the same mesh, each against the same program on one card.

Each phase prints one line with its wall time, its rate and the cards' name
and power limit.  A failed check raises, and the script exits non-zero.  The
last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# ---------------------------------------------------------------- tolerances
# float64 engine year vs the reference's float64 stream: the CPU engine is
# bitwise equal under --xla_cpu_max_isa=AVX; another backend may contract
# a*b+c into one rounding, which moves a yearly total by a few ulps per step
GOLDEN_F64_RTOL = 1e-9
# float32 engine year vs the float64 reference stream
GOLDEN_F32_RTOL = 1e-4
# float32 device results vs float64 on the CPU backend (suite totals, RL env
# rewards, SuiteMPC realized costs)
F32_VS_F64_RTOL = 1e-4
# float64 SuiteMPC on the device vs float64 SuiteMPC on the CPU backend:
# the same interior-point iterations in another summation order
MPC_F64_RTOL = 1e-6
# float64 SuiteMPC vs the host HiGHS MPC: the tests/test_lp_mpc.py gate,
# applied to the scenarios it gates there (grid-only 0, genset + weak grid
# 1); on the others the interior point (centre of a flat optimal face) and
# the simplex (a vertex) may realize different, equal-objective plans, so
# their gap is reported, not gated
HOST_MPC_RTOL = 1e-4
HOST_MPC_GATED = (0, 1)
# A2C first-iteration loss, float32 at "highest" matmul precision, device
# vs CPU backend (same math, other reduction order)
TRAIN_LOSS_RTOL = 1e-4
# one card vs four: the suite has no cross-replica reduction (totals equal
# bit for bit); the A2C gradient mean is a psum in another order
SHARDED_SUITE_RTOL = 0.0
SHARDED_LOSS_RTOL = 1e-5


def _blocked(fn, *args):
    """``(result, wall seconds)`` of one call, waiting for the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _max_rel(value, reference):
    value = np.asarray(value, np.float64)
    reference = np.asarray(reference, np.float64)
    return float(np.max(np.abs(value - reference)
                        / np.maximum(np.abs(reference), 1e-300)))


def _check(name, value, reference, rtol):
    np.testing.assert_allclose(
        np.asarray(value, np.float64), np.asarray(reference, np.float64),
        rtol=rtol, atol=0.0, err_msg=name,
    )


# -------------------------------------------------------------------- phases
def phase_golden(scenarios=range(25), n_steps=None):
    """RBC years through the engine in float64 and float32 against the
    frozen reference streams.  Returns totals per scenario (``f64``,
    ``f32``, ``reference``) and ``bitwise``: how many float64 streams equal
    the reference bit for bit."""
    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos import RuleBasedControl

    fixture = REPO / "tests" / "fixtures" / "golden_rbc.npz"
    totals = {"f64": [], "f32": [], "reference": []}
    bitwise = env_steps = 0
    with np.load(fixture) as golden:
        for n in scenarios:
            ref = golden[f"scenario_{n}_reward"][:n_steps]
            rbc = RuleBasedControl(Microgrid.from_scenario(n))
            for tag, dtype in (("f64", "float64"), ("f32", "float32")):
                log = rbc.run_compiled(max_steps=n_steps, dtype=dtype)
                stream = log[("balance", 0, "reward")].values
                if stream.shape != ref.shape:
                    raise AssertionError(
                        f"scenario {n} {tag}: {stream.shape} != {ref.shape}")
                totals[tag].append(stream.astype(np.float64).sum())
                if tag == "f64":
                    bitwise += bool(np.array_equal(stream, ref))
            totals["reference"].append(ref.sum())
            env_steps += 2 * len(ref)
    out = {k: np.asarray(v) for k, v in totals.items()}
    out["bitwise"] = bitwise
    out["env_steps"] = env_steps
    return out


def _suite_fn(n_configs, replicas, n_steps, dtype, mesh=None):
    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu.parallel.suite import SuiteRunner

    mgs = [Microgrid.from_scenario(n) for n in range(n_configs)]
    runner = SuiteRunner(mgs, batch_per_config=replicas, dtype=dtype,
                         mesh=mesh)
    fn = runner.rollout_fn(
        make_marginal_cost_policy(runner.spec), n_steps, auto_reset=True,
        collect=False, randomize_initial_step=True,
    )
    return fn, runner


def phase_suite(n_configs=25, replicas=4096, n_steps=1000, ref_replicas=8,
                seed=0):
    """Randomized-start suite rollout in float32; the first ``ref_replicas``
    replicas of every config rerun on the CPU backend in float64.  Returns
    ``value``/``reference`` of shape (n_configs, ref_replicas)."""
    import jax
    import jax.numpy as jnp

    fn, runner = _suite_fn(n_configs, replicas, n_steps, np.float32)
    keys = runner.make_keys(seed=seed)
    _blocked(fn, runner.params, keys)  # compile
    acc, wall = _blocked(fn, runner.params, keys)

    ref_keys = np.asarray(keys)[:, :ref_replicas]
    with jax.default_device(_cpu()):
        ref_fn, ref_runner = _suite_fn(n_configs, ref_replicas, n_steps,
                                       np.float64)
        reference = np.asarray(ref_fn(ref_runner.params,
                                      jnp.asarray(ref_keys)))
    return {
        "value": np.asarray(acc)[:, :ref_replicas],
        "reference": reference,
        "env_steps": n_configs * replicas * n_steps,
        "run_s": wall,
    }


def _rl_rewards(kind, batch, step_actions, rollout_actions, dtype):
    """Rewards (n_steps, batch) of reset -> step x k -> shared-step rollout."""
    import jax.numpy as jnp

    from pymgrid_tpu.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv
    from pymgrid_tpu.parallel.batched_env import (
        BatchedContinuousEnv,
        BatchedDiscreteEnv,
    )

    if kind == "discrete":
        env = BatchedDiscreteEnv(DiscreteMicrogridEnv.from_scenario(1),
                                 batch_size=batch, dtype=dtype)
    else:
        env = BatchedContinuousEnv(ContinuousMicrogridEnv.from_scenario(1),
                                   batch_size=batch, dtype=dtype)
        step_actions = step_actions.astype(dtype)
        rollout_actions = rollout_actions.astype(dtype)

    def run():
        states = env.reset(seed=0)
        rewards = []
        for a in step_actions:
            states, out = env.step(states, jnp.asarray(a))
            rewards.append(out.reward)
        _, outs = env.rollout(states, jnp.asarray(rollout_actions),
                              shared_step=True)
        return jnp.concatenate([jnp.stack(rewards), outs.reward])

    return run


def phase_rl(batch=65536, n_step_calls=5, rollout_steps=100, ref_envs=64,
             seed=0):
    """Discrete and continuous batched envs in float32; the first
    ``ref_envs`` envs rerun on the CPU backend in float64.  Returns, per
    kind, per-env reward totals ``value``/``reference`` of shape
    (ref_envs,)."""
    import jax

    from pymgrid_tpu.envs import ContinuousMicrogridEnv, DiscreteMicrogridEnv

    rng = np.random.RandomState(seed)
    n_actions = DiscreteMicrogridEnv.from_scenario(1).action_space.n
    action_dim = int(np.prod(
        ContinuousMicrogridEnv.from_scenario(1).action_space.shape))
    n_total = n_step_calls + rollout_steps
    actions = {
        "discrete": rng.randint(n_actions, size=(n_total, batch)),
        "continuous": rng.rand(n_total, batch, action_dim),
    }
    out = {"env_steps": 0, "run_s": 0.0}
    for kind, acts in actions.items():
        run = _rl_rewards(kind, batch, acts[:n_step_calls],
                          acts[n_step_calls:], np.float32)
        _blocked(run)  # compile
        rewards, wall = _blocked(run)
        with jax.default_device(_cpu()):
            ref_run = _rl_rewards(kind, ref_envs, acts[:n_step_calls, :ref_envs],
                                  acts[n_step_calls:, :ref_envs], np.float64)
            reference = np.asarray(ref_run())
        out[kind] = {
            "value": np.asarray(rewards, np.float64)[:, :ref_envs].sum(axis=0),
            "reference": reference.sum(axis=0),
        }
        out["env_steps"] += batch * n_total
        out["run_s"] += wall
    return out


def _a2c_losses(scenario, batch, rollout_len, n_chunks, mesh=None):
    """Losses of ``n_chunks`` one-iteration ``train_chunk`` dispatches, each
    resuming the previous one's parameters and Adam moments, and the wall
    seconds of each (the first two may compile: the second one's inputs
    are the first one's device outputs).  Also returns ``run`` and the
    final ``(theta, opt_state)``."""
    from examples.train_rl import build_training

    run = build_training(scenario=scenario, batch=batch,
                         rollout_len=rollout_len, mesh=mesh,
                         matmul_precision="highest")
    losses, walls = [], []
    theta = opt_state = None
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        theta, opt_state, _ = run(iters=1, log_every=1, theta=theta,
                                  opt_state=opt_state, losses=losses)
        walls.append(time.perf_counter() - t0)
    return np.asarray(losses), walls, theta, opt_state, run


def phase_training(scenario=1, batch=4096, rollout_len=128):
    """Two A2C ``train_chunk`` dispatches on the device; one on the CPU
    backend.  Returns ``losses`` (2,) and ``reference`` (1,); the rate is
    timed on a third, warm dispatch."""
    import jax

    losses, _, theta, opt_state, run = _a2c_losses(scenario, batch,
                                                   rollout_len, 2)
    t0 = time.perf_counter()
    run(iters=1, log_every=1, theta=theta, opt_state=opt_state)
    wall = time.perf_counter() - t0
    with jax.default_device(_cpu()):
        reference = _a2c_losses(scenario, batch, rollout_len, 1)[0]
    return {
        "losses": losses,
        "value": losses[:1],
        "reference": reference,
        "env_steps": batch * rollout_len,
        "run_s": wall,
    }


def _suite_mpc_costs(mgs, n_steps, dtype, repeats=1):
    """Realized cost per scenario of a one-execution SuiteMPC run, and the
    wall seconds of the last of ``repeats`` runs (the first compiles)."""
    from pymgrid_tpu.algos.mpc_suite import SuiteMPC

    suite = SuiteMPC(mgs, dtype=dtype)
    for _ in range(repeats):
        t0 = time.perf_counter()
        rewards, _ = suite.run_scanned(n_steps, chunk=None)
        wall = time.perf_counter() - t0
    return -np.asarray(rewards, np.float64).sum(axis=0), wall


def phase_planners(scenarios=range(25), n_steps=24, saa_steps=6,
                   saa_samples=10):
    """SuiteMPC in float64 (twice: the second run is timed) and float32,
    each run one device execution; the float64 program again on the CPU
    backend; the host HiGHS MPC; and a short BatchedSAA run.  Returns
    realized costs per scenario."""
    import warnings

    import jax

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos import ModelPredictiveControl
    from pymgrid_tpu.algos.saa_jax import BatchedSAA

    warnings.filterwarnings("ignore")
    scenarios = list(scenarios)
    mgs = [Microgrid.from_scenario(n) for n in scenarios]
    f64, wall = _suite_mpc_costs(mgs, n_steps, np.float64, repeats=2)
    f32, _ = _suite_mpc_costs(mgs, n_steps, np.float32)
    np.random.seed(1000)  # the SAA sampler draws from numpy's global RNG
    saa = BatchedSAA(Microgrid.from_scenario(0), n_samples=saa_samples,
                     preset_to_use=85, dtype=np.float32, solver_kind="box")
    saa_rewards, _ = saa.run_scanned(saa_steps)

    with jax.default_device(_cpu()):
        cpu_f64, _ = _suite_mpc_costs(mgs, n_steps, np.float64)
    host = np.asarray([
        -ModelPredictiveControl(Microgrid.from_scenario(n))
        .run(max_steps=n_steps)[("balance", 0, "reward")].values[:n_steps]
        .sum()
        for n in scenarios
    ])
    return {
        "scenarios": scenarios,
        "f64": f64,
        "f32": f32,
        "cpu_f64": cpu_f64,
        "host": host,
        "saa_rewards": np.asarray(saa_rewards),
        "env_steps": len(scenarios) * n_steps,
        "run_s": wall,
    }


# --------------------------------------------------------------- four cards
def _shard_report(x, n_devices):
    """Assert every device of the mesh holds a shard of ``x`` and has
    device memory in use (the CPU backend keeps no memory statistics)."""
    devices = {s.device for s in x.addressable_shards}
    if len(devices) != n_devices:
        raise AssertionError(f"shards on {len(devices)} of {n_devices} devices")
    in_use = {}
    for d in sorted(devices, key=lambda d: d.id):
        stats = d.memory_stats()
        if stats is None and d.platform == "cpu":
            in_use[d.id] = None
            continue
        in_use[d.id] = stats["bytes_in_use"]
        if in_use[d.id] <= 0:
            raise AssertionError(f"device {d.id} has no memory in use")
    return in_use


def phase_sharded_suite(n_devices=4, n_configs=24, replicas=4096,
                        n_steps=1000, seed=0):
    from pymgrid_tpu.parallel import make_batch_mesh

    mesh = make_batch_mesh(n_devices)
    fn, runner = _suite_fn(n_configs, replicas, n_steps, np.float32, mesh=mesh)
    keys = runner.make_keys(seed=seed)
    _blocked(fn, runner.params, keys)  # compile
    acc, wall = _blocked(fn, runner.params, keys)
    in_use = _shard_report(acc, n_devices)

    one_fn, one_runner = _suite_fn(n_configs, replicas, n_steps, np.float32)
    reference = np.asarray(one_fn(one_runner.params, np.asarray(keys)))
    return {
        "value": np.asarray(acc),
        "reference": reference,
        "bytes_in_use": in_use,
        "env_steps": n_configs * replicas * n_steps,
        "run_s": wall,
    }


def phase_sharded_training(n_devices=4, scenario=1, batch=4096,
                           rollout_len=128):
    from pymgrid_tpu.parallel import make_batch_mesh

    mesh = make_batch_mesh(n_devices)
    losses, walls, theta, _, _ = _a2c_losses(scenario, batch, rollout_len, 2,
                                             mesh=mesh)
    in_use = _shard_report(theta["policy"][0]["w"], n_devices)
    reference = _a2c_losses(scenario, batch, rollout_len, 2)[0]
    return {
        "value": losses,
        "reference": reference,
        "bytes_in_use": in_use,
        "env_steps": batch * rollout_len,
        "run_s": walls[-1],
    }


# ---------------------------------------------------------------------- main
class _CompileMeter:
    """Seconds spent in XLA compilation and persistent-cache hits/misses,
    from JAX's monitoring events."""

    def __init__(self):
        import jax

        self.seconds, self.hits, self.misses = 0.0, 0, 0

        def on_duration(event, duration, **kwargs):
            if event == "/jax/core/compile/backend_compile_duration":
                self.seconds += duration

        def on_event(event, **kwargs):
            if event == "/jax/compilation_cache/cache_hits":
                self.hits += 1
            elif event == "/jax/compilation_cache/cache_misses":
                self.misses += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)

    def snapshot(self):
        return self.seconds, self.hits, self.misses


def _report(card, meter, name, wall, env_steps, run_s, detail):
    """One phase line: wall, rate, compile share, card."""
    seconds, hits, misses = meter.snapshot()
    rate = f"{env_steps / run_s:,.0f} env-steps/s" if run_s else "n/a"
    print(f"[{name}] wall {wall:.2f} s | rate {rate} (timed run "
          f"{run_s:.4f} s) | compile {seconds:.1f} s total, cache "
          f"{hits} hits / {misses} misses | {detail} | card {card}",
          flush=True)


def _run_one_card(card, meter):
    t0 = time.perf_counter()
    g = phase_golden()
    wall = time.perf_counter() - t0
    _check("golden f64 yearly totals", g["f64"], g["reference"],
           GOLDEN_F64_RTOL)
    _check("golden f32 yearly totals", g["f32"], g["reference"],
           GOLDEN_F32_RTOL)
    rel32 = np.abs(g["f32"] - g["reference"]) / np.abs(g["reference"])
    _report(card, meter, "golden", wall, g["env_steps"], wall,
            f"rate over the phase wall, compilation and host logs included; "
            f"25 scenario-years x (f64, f32); f64 max rel "
            f"{_max_rel(g['f64'], g['reference']):.3e} (rtol "
            f"{GOLDEN_F64_RTOL:g}), {g['bitwise']}/25 streams bitwise; f32 "
            f"worst scenario {int(rel32.argmax())} rel {rel32.max():.3e} "
            f"(rtol {GOLDEN_F32_RTOL:g})")

    t0 = time.perf_counter()
    s = phase_suite()
    wall = time.perf_counter() - t0
    _check("suite totals f32 vs CPU f64", s["value"], s["reference"],
           F32_VS_F64_RTOL)
    _report(card, meter, "suite", wall, s["env_steps"], s["run_s"],
            f"25 configs x 4096 replicas x 1000 steps f32; max rel vs CPU "
            f"f64 on 8 replicas/config {_max_rel(s['value'], s['reference']):.3e}"
            f" (rtol {F32_VS_F64_RTOL:g})")

    t0 = time.perf_counter()
    r = phase_rl()
    wall = time.perf_counter() - t0
    detail = []
    for kind in ("discrete", "continuous"):
        _check(f"rl {kind} rewards f32 vs CPU f64", r[kind]["value"],
               r[kind]["reference"], F32_VS_F64_RTOL)
        detail.append(f"{kind} max rel "
                      f"{_max_rel(r[kind]['value'], r[kind]['reference']):.3e}")
    _report(card, meter, "rl", wall, r["env_steps"], r["run_s"],
            "65536 envs, 5 steps + 100-step shared-step rollout, f32; "
            + ", ".join(detail) + f" on 64 envs vs CPU f64 (rtol "
            f"{F32_VS_F64_RTOL:g})")

    t0 = time.perf_counter()
    t = phase_training()
    wall = time.perf_counter() - t0
    if not np.isfinite(t["losses"]).all():
        raise AssertionError(f"non-finite A2C losses {t['losses']}")
    _check("A2C first-iteration loss vs CPU", t["value"], t["reference"],
           TRAIN_LOSS_RTOL)
    _report(card, meter, "training", wall, t["env_steps"], t["run_s"],
            f"A2C scenario 1, batch 4096, rollout 128, matmul 'highest', "
            f"rate of a third warm dispatch (rollout + grad + Adam); "
            f"losses {t['losses'].tolist()}, CPU first loss "
            f"{t['reference'][0]!r}, rel "
            f"{_max_rel(t['value'], t['reference']):.3e} (rtol "
            f"{TRAIN_LOSS_RTOL:g})")

    t0 = time.perf_counter()
    p = phase_planners()
    wall = time.perf_counter() - t0
    _check("SuiteMPC f64 device vs CPU", p["f64"], p["cpu_f64"], MPC_F64_RTOL)
    gated = [p["scenarios"].index(n) for n in HOST_MPC_GATED]
    _check("SuiteMPC f64 vs host HiGHS MPC", p["f64"][gated],
           p["host"][gated], HOST_MPC_RTOL)
    if not np.isfinite(p["saa_rewards"]).all():
        raise AssertionError("non-finite BatchedSAA rewards")
    rel_host = np.abs(p["f64"] - p["host"]) / np.abs(p["host"])
    rel32 = np.abs(p["f32"] - p["f64"]) / np.abs(p["f64"])
    _report(card, meter, "planners", wall, p["env_steps"], p["run_s"],
            f"SuiteMPC 25 scenarios x 24 steps, one execution, rate of the "
            f"second f64 run; f64 vs CPU "
            f"{_max_rel(p['f64'], p['cpu_f64']):.3e} (rtol {MPC_F64_RTOL:g});"
            f" vs host HiGHS on {HOST_MPC_GATED} "
            f"{rel_host[gated].max():.3e} (rtol {HOST_MPC_RTOL:g}), all 25 "
            f"median {np.median(rel_host):.3e} max {rel_host.max():.3e} "
            f"(scenario {p['scenarios'][int(rel_host.argmax())]}); f32 vs "
            f"f64 max {rel32.max():.3e}; BatchedSAA {len(p['saa_rewards'])} "
            f"steps finite")


def _run_four_cards(card, meter):
    t0 = time.perf_counter()
    s = phase_sharded_suite()
    wall = time.perf_counter() - t0
    _check("suite 4 cards vs 1", s["value"], s["reference"],
           SHARDED_SUITE_RTOL)
    _report(card, meter, "suite x4", wall, s["env_steps"], s["run_s"],
            f"24 configs x 4096 replicas x 1000 steps f32 over "
            f"make_batch_mesh(4); max rel vs one card "
            f"{_max_rel(s['value'], s['reference']):.3e} (rtol "
            f"{SHARDED_SUITE_RTOL:g}); bytes in use per device "
            f"{s['bytes_in_use']}")

    t0 = time.perf_counter()
    t = phase_sharded_training()
    wall = time.perf_counter() - t0
    _check("A2C losses 4 cards vs 1", t["value"], t["reference"],
           SHARDED_LOSS_RTOL)
    _report(card, meter, "training x4", wall, t["env_steps"], t["run_s"],
            f"A2C batch 4096 over make_batch_mesh(4), 2 chunks, rate of the "
            f"second (it may compile); losses "
            f"{t['value'].tolist()} vs one card {t['reference'].tolist()} "
            f"(rtol {SHARDED_LOSS_RTOL:g}); bytes in use per device "
            f"{t['bytes_in_use']}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-gpus", action="store_true",
                        help="run only the paths sharded over four cards, "
                             "each against one card")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (default device "
              f"{devices[0].platform}); this script checks the GPU path "
              f"and does not run on the CPU", file=sys.stderr)
        return 2
    need = 4 if args.four_gpus else 1
    if len(devices) < need:
        print(f"chip_smoke: {need} GPUs needed, {len(devices)} found",
              file=sys.stderr)
        return 2

    from pymgrid_tpu.utils.compile_cache import enable_compile_cache
    from pymgrid_tpu.utils.profiling import gpu_name_and_power_limit

    cache_dir = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    card = gpu_name_and_power_limit()
    meter = _CompileMeter()
    print(f"[device] {len(devices)} x {devices[0].device_kind} "
          f"({devices[0].platform}); nvidia-smi: {card}; compile cache "
          f"{cache_dir}", flush=True)

    t0 = time.perf_counter()
    if args.four_gpus:
        _run_four_cards(card, meter)
    else:
        _run_one_card(card, meter)
    seconds, hits, misses = meter.snapshot()
    print(f"[total] wall {time.perf_counter() - t0:.1f} s, compile "
          f"{seconds:.1f} s, cache {hits} hits / {misses} misses | card "
          f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
