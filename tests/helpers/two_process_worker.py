"""Worker for the real 2-process ``jax.distributed`` test.

Launched twice by ``tests/test_multiprocess.py`` with
``JAX_PLATFORMS=cpu`` and 2 virtual devices per process (4 global).
Exercises the multi-process branches of
:mod:`pymgrid_tpu.parallel.distributed` — ``from_process_local`` (via
``jax.make_array_from_process_local_data``) and ``fetch`` (via
``process_allgather``) — plus a cross-host reduction under jit.
"""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def main():
    process_id = int(sys.argv[1])
    port = sys.argv[2]

    import jax

    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=process_id,
    )

    import jax.numpy as jnp
    import numpy as np

    from pymgrid_tpu.parallel import distributed as dist

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, len(jax.devices())

    mesh = dist.global_batch_mesh()
    assert dist.local_batch_size(4) == 2

    local_rows = np.arange(4.0).reshape(2, 2) + 10.0 * process_id
    global_tree = dist.from_process_local(mesh, {"x": local_rows})
    assert global_tree["x"].shape == (4, 2)

    total = jax.jit(lambda t: jnp.sum(t["x"]))(global_tree)

    fetched = dist.fetch(global_tree["x"])
    expected = np.concatenate(
        [np.arange(4.0).reshape(2, 2), np.arange(4.0).reshape(2, 2) + 10.0]
    )
    np.testing.assert_array_equal(fetched, expected)
    assert float(total) == expected.sum()

    # ---- fused BatchedDiscreteEnv rollout under the 2-process mesh ----
    # (parity + throughput on the same fused path users train on)
    import time

    from pymgrid_tpu.envs import DiscreteMicrogridEnv
    from pymgrid_tpu.parallel.batched_env import BatchedDiscreteEnv

    B, T = 8, 12
    env = DiscreteMicrogridEnv.from_scenario(0)
    rng = np.random.RandomState(0)
    action_seq = rng.randint(env.action_space.n, size=(T, B))

    meshed = BatchedDiscreteEnv(env, batch_size=B, dtype=np.float32, mesh=mesh)
    states = meshed.reset(seed=0)
    t0 = time.perf_counter()
    _, outs = meshed.rollout(states, action_seq)
    rewards_mesh = dist.fetch(outs.reward)
    wall = time.perf_counter() - t0
    print(f"proc {process_id} fused mesh rollout: "
          f"{B * T / max(wall, 1e-9) / jax.process_count():,.0f} "
          f"env-steps/s/process", flush=True)

    # parity: the process-spanning mesh run equals a single-device run
    plain = BatchedDiscreteEnv(env, batch_size=B, dtype=np.float32)
    _, outs_plain = plain.rollout(plain.reset(seed=0), action_seq)
    np.testing.assert_array_equal(
        np.asarray(rewards_mesh), np.asarray(outs_plain.reward)
    )
    obs_mesh = dist.fetch(outs.obs)
    np.testing.assert_array_equal(
        np.asarray(obs_mesh), np.asarray(outs_plain.obs)
    )
    print(f"proc {process_id} mesh-vs-single parity OK", flush=True)

    print(f"proc {process_id} OK total={float(total)}", flush=True)


if __name__ == "__main__":
    main()
