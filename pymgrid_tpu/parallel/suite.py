"""Heterogeneous config batching: the whole pymgrid25 suite as ONE program.

The 25 benchmark scenarios differ only in the presence of the genset and/or
grid modules.  Each scenario is normalized onto a superset structure
(load, pv, balancing, battery, genset, grid) by inserting *neutral* modules
for absent slots — zero-capacity grid (no import/export possible) and a
zero-production genset.  A neutral module's contribution to every phase of
the dispatch is exactly +/-0.0, so trajectories are bit-for-bit identical to
the unpadded config (tested), while all configs share one
:class:`~pymgrid_tpu.core.spec.MicrogridSpec`.

Params then stack along a leading config axis and the engine runs under
``vmap(configs) o vmap(replicas) o scan(time)`` — one XLA program for
``n_configs x batch`` microgrids, shardable over a device mesh.
"""
import numpy as np

from pymgrid_tpu.core.engine import make_reset_fn, make_step_fn
from pymgrid_tpu.core.spec import extract_spec

__all__ = ["normalize_to_superset", "build_suite", "SuiteRunner"]

_CANONICAL_ORDER = ("load", "renewable", "balancing", "battery", "genset", "grid")


def _neutral_grid(T, horizon, forecaster, initial_step=0, final_step=-1):
    from pymgrid_tpu.modules import GridModule

    ts = np.zeros((T, 4))
    ts[:, 3] = 1.0  # always up; zero prices/co2; zero import/export capacity
    return GridModule(
        max_import=0.0,
        max_export=0.0,
        time_series=ts,
        forecaster=forecaster,
        forecast_horizon=horizon,
        initial_step=initial_step,
        final_step=final_step,
    )


def _neutral_genset(initial_step=0):
    from pymgrid_tpu.modules import GensetModule

    return GensetModule(
        running_min_production=0.0,
        running_max_production=0.0,
        genset_cost=0.0,
        initial_step=initial_step,
    )


def normalize_to_superset(microgrid, horizon=None, include_genset=True):
    """Rebuild ``microgrid`` with modules in canonical order, inserting
    neutral modules for absent kinds.  Returns a new host Microgrid.

    ``include_genset=False`` skips the neutral-genset insertion — used when
    a whole suite group is genset-free, so the shared LP/engine structure
    carries no dead genset slot (and MPC needs no MILP enumeration)."""
    import warnings

    from pymgrid_tpu.core.spec import _KINDS  # noqa: F401
    from pymgrid_tpu.microgrid import Microgrid
    from pymgrid_tpu.modules import (
        BatteryModule,
        GensetModule,
        GridModule,
        LoadModule,
        RenewableModule,
        UnbalancedEnergyModule,
    )

    kind_of = {
        LoadModule: "load",
        RenewableModule: "renewable",
        UnbalancedEnergyModule: "balancing",
        BatteryModule: "battery",
        GensetModule: "genset",
        GridModule: "grid",
    }

    by_kind = {}
    T, h = None, horizon
    initial_step, final_step = 0, -1
    for name, modules in microgrid.modules.iterdict():
        for module in modules:
            kind = kind_of[type(module)]
            if kind in by_kind:
                raise ValueError(
                    f"Suite batching supports one module per kind; duplicate {kind}."
                )
            by_kind[kind] = (name, module)
            if hasattr(module, "time_series"):
                T = len(module)
                initial_step = module.initial_step
                final_step = module.final_step
                if h is None:
                    h = module.forecast_horizon

    forecaster = "oracle" if h else None
    ordered = []
    for kind in _CANONICAL_ORDER:
        if kind in by_kind:
            ordered.append(by_kind[kind])
        elif kind == "grid":
            ordered.append(
                ("grid", _neutral_grid(T, h or 0, forecaster, initial_step, final_step))
            )
        elif kind == "genset":
            if not include_genset:
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ordered.append(("genset", _neutral_genset(initial_step)))
        else:
            raise ValueError(f"Microgrid missing required module kind {kind}.")

    return Microgrid(ordered, add_unbalanced_module=False)


def build_suite(microgrids, dtype=np.float32, include_genset=True):
    """Extract one shared spec and config-stacked params from microgrids.

    Returns ``(spec, stacked_params)`` where every array in ``stacked_params``
    carries a leading ``n_configs`` axis.
    """
    import jax

    specs, params_list = [], []
    for mg in microgrids:
        normalized = normalize_to_superset(mg, include_genset=include_genset)
        spec, params, _ = extract_spec(normalized, dtype=dtype)
        specs.append(spec)
        params_list.append(params)

    first = specs[0]
    for i, spec in enumerate(specs[1:], 1):
        if spec != first:
            raise ValueError(
                f"Config {i} does not normalize onto the shared spec "
                f"(module structure differs)."
            )

    stacked = jax.tree.map(lambda *xs: np.stack(xs), *params_list)
    from pymgrid_tpu.core.tables import ensure_tables

    stacked = ensure_tables(first, stacked, config_axis=True)
    return first, stacked


class SuiteRunner:
    """Run B replicas of each of N configs in lockstep on device.

    ``rollout(policy_builder, n_steps)`` compiles one program:
    scan over time inside, vmapped over replicas, vmapped over configs,
    optionally sharded over a mesh along the config axis (cross-chip
    communication is only the final metric reduction).
    """

    def __init__(self, microgrids, batch_per_config, dtype=np.float32, mesh=None):
        import jax
        import jax.numpy as jnp

        self.spec, params = build_suite(microgrids, dtype=dtype)
        self.params = jax.tree.map(jnp.asarray, params)
        self.n_configs = len(microgrids)
        self.batch_per_config = batch_per_config
        self.mesh = mesh

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._param_sharding = NamedSharding(mesh, P("batch"))
            self.params = jax.device_put(self.params, self._param_sharding)

    def rollout_fn(self, policy, n_steps, auto_reset=True, collect=False,
                   randomize_initial_step=False, block_prefetch=None):
        """Jitted ``(params, keys) -> per-config, per-replica outputs``.

        With ``collect=False`` (throughput mode) returns the scalar
        reward+obs checksum per env.  With ``collect=True`` returns
        ``(checksum, StepOutput)`` where the ``StepOutput`` pytree is
        time-major over the full episode — the same collect contract as
        :func:`pymgrid_tpu.core.rollout.make_rollout_fn` (obs, rewards,
        dones, log rows all materialized to HBM every step).

        ``randomize_initial_step=True`` starts (and auto-resets) every
        replica at a key-derived uniform step in ``[initial_step,
        min_ts_length - 1)`` — the engine analog of the host's stochastic
        trajectory functions.  This is also the honest-benchmarking mode:
        with a shared deterministic start and an in-engine policy, all
        replicas of a config are bitwise-identical and XLA *deduplicates
        the replica dimension entirely* (verified in the compiled HLO), so
        throughput measured that way is phantom.  Distinct starts force
        real per-replica work.
        """
        import jax
        import jax.numpy as jnp
        from jax import lax

        spec = self.spec
        step_fn = make_step_fn(spec, normalized=False)
        reset_fn = make_reset_fn(spec)

        BLK = 8
        if randomize_initial_step:
            ts_lengths = [m.ts_length for m in spec.log_order if m.ts_length]
            max_start = (min(ts_lengths) if ts_lengths else 1) - 1

            def do_reset(params, key):
                t0 = jax.random.randint(
                    jax.random.fold_in(key, 0x51A7),
                    (),
                    jnp.asarray(params["initial_step"], jnp.int32),
                    jnp.int32(max_start),
                )
                return reset_fn(params, key, t0)
        else:
            do_reset = reset_fn

        # ---- block-prefetch eligibility -------------------------------
        # With SEQUENTIAL-wrap auto-resets (a finished replica continues at
        # (t+1) mod max_start instead of a fresh random step) every
        # replica's time index is affine in the step count, so the rows for
        # BLK consecutive steps are ONE contiguous (BLK, W) slice per
        # replica instead of BLK separate row gathers — an ~BLK-fold cut in
        # gather count (docs: bench.py note).  Exactness across the wrap:
        # every episode ends at t = min(final_step) - 1, so rows
        # [max_start, max_start + BLK) are only ever *predicted* by
        # post-wrap steps; patching them with rows [i0, i0 + BLK) makes the
        # prediction exact (verified bitwise vs the per-step path,
        # tests/test_suite.py).
        if block_prefetch is None:
            block_prefetch = (randomize_initial_step and auto_reset
                              and not collect)
        use_block = bool(block_prefetch)
        if use_block:
            if not (randomize_initial_step and auto_reset and not collect):
                raise ValueError(
                    "block_prefetch requires randomize_initial_step, "
                    "auto_reset and collect=False"
                )
            fs = np.concatenate([
                np.asarray(self.params[k]["final_step"]).reshape(-1)
                for k in ("load", "renewable", "grid")
            ])
            if (n_steps % BLK or "step_table" not in self.params
                    or fs.size == 0 or int(fs.min()) != max_start):
                use_block = False  # per-step fallback keeps exactness

        def step_one(params, state):
            action = policy(params, state)
            new_state, out = step_fn(params, state, action)
            if auto_reset:
                fresh = do_reset(params, new_state["rng"])
                new_state = jax.tree.map(
                    lambda f, n: jnp.where(out.done, f, n), fresh, new_state
                )
            return new_state, out

        def step_one_seq(params, state):
            """Blocked-mode step: sequential-wrap reset target."""
            action = policy(params, state)
            new_state, out = step_fn(params, state, action)
            i0 = jnp.asarray(params["initial_step"], jnp.int32)
            target = i0 + jnp.mod(
                new_state["step"] - i0, jnp.int32(max_start) - i0
            )
            fresh = reset_fn(params, new_state["rng"], target)
            new_state = jax.tree.map(
                lambda f, n: jnp.where(out.done, f, n), fresh, new_state
            )
            return new_state, out

        # vmap replicas (shared config params), then vmap configs; the time
        # scan goes OUTSIDE both vmaps so stacked outputs are written as one
        # contiguous time-leading slab per step — scan-inside-vmap turns the
        # per-step write into B*T scalarized update-slices
        seq_mode = randomize_initial_step and auto_reset and not collect
        batched_step = jax.vmap(
            jax.vmap(step_one_seq if seq_mode else step_one,
                     in_axes=(None, 0)),
            in_axes=(0, 0),
        )
        batched_reset = jax.vmap(
            jax.vmap(do_reset, in_axes=(None, 0)), in_axes=(0, 0)
        )

        def blocked_rollout(params, keys):
            states = batched_reset(params, keys)
            n_cfg, B = keys.shape[:2]
            acc0 = jnp.zeros((n_cfg, B), jnp.dtype(spec.dtype))
            W = params["step_table"].shape[-1]
            i0s = np.asarray(self.params["initial_step"]).astype(int).reshape(-1)

            # patch rows [max_start, max_start+BLK) with [i0, i0+BLK): the
            # wrap-prediction rows (see eligibility note above)
            tbl = params["step_table"]
            tbl_b = jnp.stack([
                lax.dynamic_update_slice(
                    tbl[c], tbl[c, i0s[c]:i0s[c] + BLK], (max_start, 0)
                )
                for c in range(n_cfg)
            ])

            def gather_block(tb, t0):
                return lax.dynamic_slice(tb, (t0, jnp.int32(0)), (BLK, W))

            batched_gather = jax.vmap(
                jax.vmap(gather_block, in_axes=(None, 0)), in_axes=(0, 0)
            )

            def block_body(carry, _):
                states, acc = carry
                rows = batched_gather(tbl_b, states["step"])  # (cfg,B,BLK,W)
                for j in range(BLK):
                    sts = {**states, "table_row": rows[:, :, j]}
                    states, out = batched_step(params, sts)
                    acc = acc + out.reward + out.obs.sum(axis=-1)
                return (states, acc), None

            (states, acc), _ = lax.scan(
                block_body, (states, acc0), None, length=n_steps // BLK
            )
            return acc

        if use_block:
            return jax.jit(blocked_rollout)

        def suite_rollout(params, keys):
            states = batched_reset(params, keys)
            n_cfg, B = keys.shape[:2]
            acc0 = jnp.zeros((n_cfg, B), jnp.dtype(spec.dtype))

            def body(carry, _):
                states, acc = carry
                states, out = batched_step(params, states)
                acc = acc + out.reward + out.obs.sum(axis=-1)
                if collect:
                    # flatten (cfg, B) -> one batch dim for the stacked scan
                    # outputs, so each step writes one 3-D slab instead of
                    # cfg*B small update-slices.  Buffers are stored
                    # FIELD-MAJOR, (T, d, cfg*B) with the batch minor, so
                    # each of the ~330 per-field (cfg, B) arrays the engine
                    # stacks into an obs/log row lands as one contiguous
                    # block; the API layout is restored by one big
                    # transpose after the scan.
                    flat = lambda x: x.reshape((n_cfg * B,) + x.shape[2:])
                    dt = jnp.dtype(spec.dtype)
                    scalars = jnp.stack(
                        [flat(out.reward), flat(out.shaped_reward),
                         flat(out.done.astype(dt)), flat(out.provided),
                         flat(out.absorbed)], axis=0,
                    )
                    return (states, acc), (
                        flat(out.obs).T, flat(out.log_row).T, scalars,
                    )
                return (states, acc), None

            (states, acc), outs = lax.scan(
                body, (states, acc0), None, length=n_steps
            )
            if collect:
                # ys are (T, d, cfg*B) field-major: transpose back to the
                # (cfg, B, T, ...) API layout in one copy per buffer
                def unpack(y, d):
                    # (T, d, cfg, B) -> (cfg, B, T, d)
                    return jnp.transpose(
                        y.reshape(n_steps, d, n_cfg, B), (2, 3, 0, 1)
                    )

                obs_y, log_y, scal_y = outs
                scal = unpack(scal_y, 5)
                from pymgrid_tpu.core.engine import StepOutput

                outs = StepOutput(
                    obs=unpack(obs_y, spec.obs_dim),
                    reward=scal[..., 0],
                    shaped_reward=scal[..., 1],
                    done=scal[..., 2] != 0,
                    log_row=unpack(log_y, spec.n_log_fields),
                    provided=scal[..., 3],
                    absorbed=scal[..., 4],
                )
                return acc, outs
            return acc

        return jax.jit(suite_rollout)

    def make_keys(self, seed=0):
        import jax

        keys = jax.random.split(
            jax.random.PRNGKey(seed), self.n_configs * self.batch_per_config
        ).reshape(self.n_configs, self.batch_per_config, -1)
        if self.mesh is not None:
            keys = jax.device_put(keys, self._param_sharding)
        return keys
