"""Vectorized RL environments over the compiled engine.

``BatchedDiscreteEnv`` exposes the discrete priority-list env as a batched
``reset/step`` pair: B replicas step in lockstep on device, integer actions
index a precomputed priority-ordering table
(:func:`~pymgrid_tpu.core.rollout.make_table_policy`, the SURVEY §7 masked
deployment scan) so compile time stays O(n_controllable) no matter how large
the ``n!·2^g`` action space grows, and episodes auto-reset.  This is the
batched analog of :class:`~pymgrid_tpu.envs.DiscreteMicrogridEnv` for RL
training loops.

``BatchedContinuousEnv`` is its continuous-action sibling (the batched
analog of :class:`~pymgrid_tpu.envs.ContinuousMicrogridEnv`): actions are
``(B, action_dim)`` arrays in the env's flattened normalized layout
(sorted module names, genset rows [goal, production]); the engine
denormalizes and dispatches exactly like the host env's
``run(action, normalized=True)``.
"""
import numpy as np

from pymgrid_tpu.core.engine import make_reset_fn, make_step_fn
from pymgrid_tpu.core.rollout import make_table_policy
from pymgrid_tpu.core.tables import ensure_tables

__all__ = ["BatchedDiscreteEnv", "BatchedContinuousEnv"]

def _shard_inputs(env, states, action_seq, seq_spec):
    """Place host rollout inputs onto the env's mesh.

    Single-process: plain ``device_put``.  Multi-process: the action block
    is assembled per-process via ``make_array_from_callback`` (a
    ``device_put`` onto a process-spanning sharding is rejected by jax);
    states already carry the global sharding from ``reset``.
    """
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    seq_sharding = NamedSharding(env.mesh, seq_spec)
    if jax.process_count() > 1:
        host_seq = np.asarray(action_seq)
        action_seq = jax.make_array_from_callback(
            host_seq.shape, seq_sharding, lambda idx: host_seq[idx]
        )
        return states, action_seq
    action_seq = jax.device_put(action_seq, seq_sharding)
    states = jax.device_put(states, env._state_sharding)
    return states, action_seq




def _fused_rollout(env, states, action_seq, keep_logs, keep_obs=True,
                   shared_step=False):
    """Run a whole action sequence as ONE device program.

    ``lax.scan`` over time, ``vmap`` over replicas: a python ``step()``
    loop dispatches one device call per step (launch- and host-bound),
    while this path compiles the full T-step rollout into a single
    execution.  Log rows are dropped from the stacked output unless
    requested — T·B rows of ~n_log_fields each would otherwise dominate
    HBM for long rollouts.  ``keep_obs=False`` additionally drops the
    stacked observations, letting XLA dead-code-eliminate the per-step
    observation construction (forecast window gathers + normalization)
    on evaluation rollouts where only rewards matter.

    ``shared_step=True``: all replicas provably share the simulated time
    (true for ``reset()`` states — same start, and auto-resets fire
    simultaneously since ``done`` depends only on ``t``), so ``step`` (and
    deterministic forecast state) ride the scan carry UNBATCHED: every
    time-row read is one broadcast gather instead of B tile-amplified
    per-replica gathers (the lockstep-sweep trick, core/rollout.py).
    Bitwise-identical outputs; requires states whose ``step`` entries are
    all equal (as ``reset()`` returns).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    key = (bool(keep_logs), bool(keep_obs), bool(shared_step))
    fn = env._rollout_cache.get(key)
    if fn is None:
        if shared_step:
            det_forecast = env.spec.numpy_noise or not any(
                m.forecaster == "gaussian" for m in env.spec.log_order
            )
            state_axes = {
                "step": None,
                "battery_charge": 0,
                "genset": 0,
                "rng": 0,
                "forecast": None if det_forecast else 0,
            }
            batch_step = jax.vmap(
                env._single_step, in_axes=(None, state_axes, 0),
                out_axes=(state_axes, 0),
            )
        else:
            batch_step = jax.vmap(env._single_step, in_axes=(None, 0, 0))

        def run(params, states, seq):
            # episode buffers are stored FIELD-MAJOR, (T, d, B) with the
            # batch minor: the engine builds obs/log rows by stacking many
            # per-field (B,) arrays, so each field is one contiguous block
            # of the step's slab; one transpose after the scan restores the
            # (T, B, d) API layout.
            def body(states, a):
                states, out = batch_step(params, states, a)
                out = out._replace(
                    log_row=out.log_row.T if keep_logs else None,
                    obs=out.obs.T if keep_obs else None,
                )
                return states, out

            states, outs = lax.scan(body, states, seq)
            if keep_obs:
                outs = outs._replace(obs=jnp.swapaxes(outs.obs, 1, 2))
            if keep_logs:
                outs = outs._replace(log_row=jnp.swapaxes(outs.log_row, 1, 2))
            return states, outs

        fn = jax.jit(run)
        env._rollout_cache[key] = fn
    return fn(env.params, states, action_seq)


class BatchedDiscreteEnv:
    def __init__(self, env, batch_size=1, dtype=np.float32, mesh=None,
                 auto_reset=True):
        import jax
        import jax.numpy as jnp
        from pymgrid_tpu.core.spec import extract_spec

        self.batch_size = batch_size
        self.n_actions = env.action_space.n
        self.auto_reset = auto_reset
        self.mesh = mesh
        self.spec, params, _ = extract_spec(env, dtype=dtype)
        self.params = ensure_tables(
            self.spec, jax.tree.map(jnp.asarray, params)
        )
        self.obs_dim = self.spec.obs_dim

        table_policy = make_table_policy(
            self.spec, [list(pl) for pl in env.actions_list]
        )
        # obs_layout='env': the engine emits observations directly in the
        # env's flattened (sorted-name) layout — no post-hoc permutation
        step_fn = make_step_fn(self.spec, normalized=False, obs_layout="env")
        reset_fn = make_reset_fn(self.spec)

        def single_step(params, state, action_idx):
            action = table_policy(params, state, action_idx)
            new_state, out = step_fn(params, state, action)
            if self.auto_reset:
                fresh = reset_fn(params, new_state["rng"])
                new_state = jax.tree.map(
                    lambda f, n: jnp.where(out.done, f, n), fresh, new_state
                )
            return new_state, out

        self._state_sharding = None
        kwargs = {}
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._state_sharding = NamedSharding(mesh, P("batch"))
            self.params = jax.device_put(self.params, NamedSharding(mesh, P()))

        self._single_step = single_step
        self._rollout_cache = {}
        self._batch_reset = jax.jit(
            lambda params, keys: jax.vmap(reset_fn, in_axes=(None, 0))(params, keys)
        )
        self._batch_step = jax.jit(
            lambda params, states, idxs: jax.vmap(
                single_step, in_axes=(None, 0, 0)
            )(params, states, idxs)
        )

    def rollout(self, states, action_seq, keep_logs=False, keep_obs=True,
                shared_step=False):
        """Fused T-step rollout: ``action_seq`` is ``(T, B)`` integer
        actions; returns ``(final_states, outs)`` with ``outs`` a
        time-major stacked StepOutput (``log_row`` is ``None`` unless
        ``keep_logs``; ``obs`` is ``None`` if ``keep_obs=False`` — 4-10x
        faster for reward-only evaluation).  Equivalent to T ``step()``
        calls but compiled as one program — see :func:`_fused_rollout`.

        ``shared_step=True`` (opt-in): all replicas carry ONE simulated
        time (valid for ``reset()`` states — same start, simultaneous
        auto-resets), eliminating per-replica time-row gathers.  The
        returned final states keep the shared-scalar ``step``; pass them
        back only to another ``shared_step`` rollout."""
        import jax
        import jax.numpy as jnp

        action_seq = jnp.asarray(action_seq, jnp.int32)
        if action_seq.ndim != 2 or action_seq.shape[1] != self.batch_size:
            raise ValueError(
                f"action_seq must have shape (T, {self.batch_size}), "
                f"got {action_seq.shape}"
            )
        if self._state_sharding is not None:
            from jax.sharding import PartitionSpec as P

            states, action_seq = _shard_inputs(
                self, states, action_seq, P(None, "batch")
            )
        if shared_step and jnp.ndim(states["step"]) > 0:
            det_forecast = self.spec.numpy_noise or not any(
                m.forecaster == "gaussian" for m in self.spec.log_order
            )
            states = dict(states)
            states["step"] = jax.tree.map(lambda x: x[0], states["step"])
            if det_forecast:
                states["forecast"] = jax.tree.map(
                    lambda x: x[0], states["forecast"]
                )
        return _fused_rollout(self, states, action_seq, keep_logs, keep_obs,
                              shared_step=shared_step)

    def reset(self, seed=0):
        """Returns batched initial states for B replicas (pass to
        :meth:`step`/:meth:`rollout`; observations come from step outputs)."""
        import jax

        keys = jax.random.split(jax.random.PRNGKey(seed), self.batch_size)
        if self._state_sharding is not None:
            keys = jax.device_put(keys, self._state_sharding)
        states = self._batch_reset(self.params, keys)
        return states

    def step(self, states, action_indices):
        """Step with integer actions (B,); returns (new_states, StepOutput)."""
        import jax.numpy as jnp

        action_indices = jnp.asarray(action_indices, jnp.int32)
        return self._batch_step(self.params, states, action_indices)

    def save_states(self, path, states):
        """Checkpoint a batch state pytree (sharded arrays write
        cooperatively on a multi-host mesh)."""
        from pymgrid_tpu.utils.checkpoint import save_state

        save_state(path, states)

    def restore_states(self, path):
        """Restore a checkpoint onto this env's sharding; resuming a rollout
        from it is bitwise-identical to an uninterrupted run."""
        from pymgrid_tpu.utils.checkpoint import restore_state

        template = self.reset(seed=0)
        return restore_state(path, template=template)


class BatchedContinuousEnv:
    """Batched continuous-action env over the compiled engine.

    ``env`` is a host :class:`~pymgrid_tpu.envs.ContinuousMicrogridEnv`;
    its flattened normalized action layout (gym Dict spaces sort module
    names; reference ``envs/continuous/continuous.py:7``, with the
    documented controllable-modules deviation) defines ``action_dim``.
    ``step(states, actions)`` takes ``(B, action_dim)`` values in [0, 1]
    and returns ``(new_states, StepOutput)`` with observations in the
    env's flattened order.
    """

    def __init__(self, env, batch_size=1, dtype=np.float32, mesh=None,
                 auto_reset=True):
        import jax
        import jax.numpy as jnp
        from pymgrid_tpu.core.spec import extract_spec

        self.batch_size = batch_size
        self.auto_reset = auto_reset
        self.mesh = mesh
        self.spec, params, _ = extract_spec(env, dtype=dtype)
        self.params = ensure_tables(
            self.spec, jax.tree.map(jnp.asarray, params)
        )
        self.obs_dim = self.spec.obs_dim
        spec = self.spec

        # flat action segments in the env's flatten order (sorted names)
        by_module = {(ref.name, ref.num): ref for ref in spec.controllable}
        segments = []
        for name, boxes in env._nested_action_space.items():
            for num, box in enumerate(boxes):
                ref = by_module[(name, num)]
                segments.append((ref.kind, ref.slot, box.shape[0]))
        self.action_dim = sum(width for _, _, width in segments)

        step_fn = make_step_fn(spec, normalized=True, obs_layout="env")
        reset_fn = make_reset_fn(spec)
        jdtype = jnp.dtype(spec.dtype)

        def to_engine_action(flat):
            action = {
                "battery": jnp.zeros(spec.n_battery, jdtype),
                "genset": jnp.zeros((spec.n_genset, 2), jdtype),
                "grid": jnp.zeros(spec.n_grid, jdtype),
            }
            offset = 0
            for kind, slot, width in segments:
                seg = jnp.asarray(flat[offset : offset + width], jdtype)
                if kind == "genset":
                    action["genset"] = action["genset"].at[slot].set(seg)
                else:
                    action[kind] = action[kind].at[slot].set(seg[0])
                offset += width
            return action

        def single_step(params, state, flat_action):
            new_state, out = step_fn(params, state, to_engine_action(flat_action))
            if self.auto_reset:
                fresh = reset_fn(params, new_state["rng"])
                new_state = jax.tree.map(
                    lambda f, n: jnp.where(out.done, f, n), fresh, new_state
                )
            return new_state, out

        self._state_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._state_sharding = NamedSharding(mesh, P("batch"))
            self.params = jax.device_put(self.params, NamedSharding(mesh, P()))

        self._single_step = single_step
        self._rollout_cache = {}
        self._batch_reset = jax.jit(
            lambda params, keys: jax.vmap(reset_fn, in_axes=(None, 0))(params, keys)
        )
        self._batch_step = jax.jit(
            lambda params, states, acts: jax.vmap(
                single_step, in_axes=(None, 0, 0)
            )(params, states, acts)
        )

    def rollout(self, states, action_seq, keep_logs=False, keep_obs=True,
                shared_step=False):
        """Fused T-step rollout: ``action_seq`` is ``(T, B, action_dim)``
        normalized actions; returns ``(final_states, outs)`` with ``outs``
        a time-major stacked StepOutput (``log_row`` is ``None`` unless
        ``keep_logs``; ``obs`` dropped if ``keep_obs=False``).  Equivalent
        to T ``step()`` calls but compiled as one program — see
        :func:`_fused_rollout` (incl. the ``shared_step`` contract)."""
        import jax
        import jax.numpy as jnp

        action_seq = jnp.asarray(action_seq)
        expect = (self.batch_size, self.action_dim)
        if action_seq.ndim != 3 or action_seq.shape[1:] != expect:
            raise ValueError(
                f"action_seq must have shape (T, {self.batch_size}, "
                f"{self.action_dim}), got {action_seq.shape}"
            )
        if self._state_sharding is not None:
            from jax.sharding import PartitionSpec as P

            states, action_seq = _shard_inputs(
                self, states, action_seq, P(None, "batch")
            )
        if shared_step and jnp.ndim(states["step"]) > 0:
            det_forecast = self.spec.numpy_noise or not any(
                m.forecaster == "gaussian" for m in self.spec.log_order
            )
            states = dict(states)
            states["step"] = jax.tree.map(lambda x: x[0], states["step"])
            if det_forecast:
                states["forecast"] = jax.tree.map(
                    lambda x: x[0], states["forecast"]
                )
        return _fused_rollout(self, states, action_seq, keep_logs, keep_obs,
                              shared_step=shared_step)

    def reset(self, seed=0):
        """Batched initial states for B replicas."""
        import jax

        keys = jax.random.split(jax.random.PRNGKey(seed), self.batch_size)
        if self._state_sharding is not None:
            keys = jax.device_put(keys, self._state_sharding)
        return self._batch_reset(self.params, keys)

    def step(self, states, actions):
        """Step with normalized actions (B, action_dim) in [0, 1]."""
        import jax.numpy as jnp

        actions = jnp.asarray(actions)
        if actions.shape != (self.batch_size, self.action_dim):
            raise ValueError(
                f"actions must have shape {(self.batch_size, self.action_dim)}, "
                f"got {actions.shape}"
            )
        return self._batch_step(self.params, states, actions)

    def sample_actions(self, rng):
        """Uniform random normalized actions from a numpy RandomState."""
        return rng.rand(self.batch_size, self.action_dim)
