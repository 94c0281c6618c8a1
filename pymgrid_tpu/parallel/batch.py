"""Replica batching and device-mesh sharding.

The reference is strictly single-process, single-env
(``microgrid/microgrid.py:255-314``).  Here thousands of replicas of a config
step in lockstep: ``vmap`` adds the replica axis, ``lax.scan`` runs time, and
a ``jax.sharding.Mesh`` over a ``batch`` axis lays replicas across chips —
XLA inserts any collectives (metric reductions ride ICI).

Params (module constants + time series) are replicated; per-replica state is
sharded along ``batch``.  One compiled program serves any replica count that
divides the mesh.
"""
import numpy as np

from pymgrid_tpu.core.engine import make_reset_fn, make_step_fn
from pymgrid_tpu.core.rollout import make_rollout_fn

__all__ = ["BatchedMicrogrid", "make_batch_mesh"]


def make_batch_mesh(n_devices=None, axis_name="batch", devices=None):
    """1-D device mesh over the batch axis."""
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


class BatchedMicrogrid:
    """Vmapped/sharded engine over replicas of one microgrid config.

    Parameters
    ----------
    microgrid : Microgrid
        Host config to compile.
    batch_size : int
        Number of replicas stepping in lockstep.
    dtype : dtype, default float32
        Engine dtype (float32 for throughput; float64 for parity work).
    mesh : jax.sharding.Mesh or None
        If given, replicas shard along its ``batch`` axis; params replicate.
    """

    def __init__(self, microgrid, batch_size, dtype=np.float32, mesh=None,
                 normalized_actions=False):
        import jax
        from pymgrid_tpu.core.spec import extract_spec

        self.batch_size = batch_size
        self.mesh = mesh
        self.spec, params, _ = extract_spec(microgrid, dtype=dtype)
        self.params = jax.tree.map(jax.numpy.asarray, params)

        self._reset_fn = make_reset_fn(self.spec)
        self._step_fn = make_step_fn(self.spec, normalized=normalized_actions)

        self._state_sharding = None
        self._param_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._state_sharding = NamedSharding(mesh, P("batch"))
            self._param_sharding = NamedSharding(mesh, P())
            self.params = jax.device_put(self.params, self._param_sharding)

        def batch_reset(params, keys):
            return jax.vmap(self._reset_fn, in_axes=(None, 0))(params, keys)

        def batch_step(params, state, action):
            return jax.vmap(self._step_fn, in_axes=(None, 0, 0))(
                params, state, action
            )

        if mesh is not None:
            shard = self._state_sharding
            self._batch_reset = jax.jit(batch_reset, out_shardings=shard)
            self._batch_step = jax.jit(batch_step)
        else:
            self._batch_reset = jax.jit(batch_reset)
            self._batch_step = jax.jit(batch_step)

    # ------------------------------------------------------------------ api
    def reset(self, seed=0):
        import jax

        keys = jax.random.split(jax.random.PRNGKey(seed), self.batch_size)
        if self._state_sharding is not None:
            keys = jax.device_put(keys, self._state_sharding)
        return self._batch_reset(self.params, keys)

    def step(self, state, action):
        """Step all replicas; ``action`` arrays carry a leading batch axis."""
        return self._batch_step(self.params, state, action)

    def make_batched_rollout(self, policy, n_steps, auto_reset=True, collect=False):
        """Jitted ``(params, states) -> (final_states, outputs)`` over the
        batch; outputs are time-major with a replica axis."""
        import jax

        rollout = make_rollout_fn(
            self.spec,
            policy,
            n_steps,
            auto_reset=auto_reset,
            collect=collect,
        )

        def batched(params, states):
            return jax.vmap(
                lambda s: rollout(params, s), in_axes=0
            )(states)

        if self.mesh is not None:
            return jax.jit(
                batched,
                in_shardings=(self._param_sharding, self._state_sharding),
            )
        return jax.jit(batched)

    def rollout(self, policy, n_steps, seed=0, auto_reset=True, collect=False):
        states = self.reset(seed)
        fn = self.make_batched_rollout(policy, n_steps, auto_reset, collect)
        return fn(self.params, states)
