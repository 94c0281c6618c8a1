"""Engine rollouts: time-stepping under ``lax.scan`` and in-engine policies.

The reference's control loops (``algos/rbc/rbc.py:87-91``, env stepping) are
Python for-loops; here they compile to a single XLA while-program.  Policies
are pure functions ``(params, state) -> action`` evaluated inside the scan
body, so policy + dispatch + logging fuse into one program per step.
"""
from typing import Callable

import numpy as np

from pymgrid_tpu.core.engine import make_reset_fn, make_step_fn

__all__ = [
    "rollout_policy",
    "rollout_actions",
    "make_lockstep_sweep_fn",
    "lockstep_states",
    "make_priority_policy",
    "make_table_policy",
    "make_marginal_cost_policy",
    "make_random_policy",
]


def make_rollout_fn(spec, policy, n_steps, normalized=False, auto_reset=False,
                    collect=True):
    """Build a jitted ``(params, state) -> (final_state, outputs)`` rollout.

    ``params`` stays a runtime argument (never a closed-over constant): XLA
    rewrites division-by-constant into multiplication by the reciprocal,
    which would break bitwise parity with the numpy host layer.

    ``outputs`` is a time-major :class:`~pymgrid_tpu.core.engine.StepOutput`
    when ``collect``, else ``(rewards, dones)`` only — the low-HBM-traffic
    mode used for throughput benchmarking.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    step_fn = make_step_fn(spec, normalized=normalized)
    reset_fn = make_reset_fn(spec)

    def rollout(params, state):
        def body(state, _):
            action = policy(params, state)
            new_state, out = step_fn(params, state, action)
            if auto_reset:
                fresh = reset_fn(params, new_state["rng"])
                new_state = jax.tree.map(
                    lambda f, n: jnp.where(out.done, f, n), fresh, new_state
                )
            if collect:
                return new_state, out
            return new_state, (out.reward, out.done)

        return lax.scan(body, state, None, length=n_steps)

    return jax.jit(rollout)


def rollout_policy(spec, params, state, policy, n_steps, normalized=False,
                   auto_reset=False, collect=True):
    """One-shot convenience wrapper over :func:`make_rollout_fn`."""
    fn = make_rollout_fn(
        spec, policy, n_steps, normalized=normalized, auto_reset=auto_reset,
        collect=collect,
    )
    return fn(params, state)


def make_lockstep_sweep_fn(spec, policy, n_steps, normalized=False):
    """Rollout for LOCKSTEP replica sweeps: every replica shares the same
    simulated time, only per-replica state (battery charge, genset machine)
    is batched.

    The general path (``vmap(make_rollout_fn(...))``) carries ``step`` per
    replica, so every time-series read lowers to a per-replica gather —
    ~100 MB/step of redundant row traffic at 131k replicas — and the
    vmapped scan stacks ``(B, T)`` episode buffers written one strided
    column per step.  Here ``step`` (and, when no jax-PRNG gaussian
    forecaster is present, the realized forecast) is a SHARED scan carry:
    time-dependent rows are fetched once per step and broadcast, rewards
    accumulate in the carry, and the program writes nothing per step —
    for ANY spec and policy.

    Returns jitted ``(params, states) -> (final_states, cum_reward (B,))``
    where ``states`` is a batched engine state whose ``step`` entry is a
    scalar (see :func:`lockstep_states`).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    step_fn = make_step_fn(spec, normalized=normalized)

    shared_forecast = spec.numpy_noise or not any(
        m.forecaster == "gaussian" for m in spec.log_order
    )
    state_axes = {
        "step": None,
        "battery_charge": 0,
        "genset": 0,
        "rng": 0,
        "forecast": None if shared_forecast else 0,
    }

    def step_one(params, state):
        action = policy(params, state)
        new_state, out = step_fn(params, state, action)
        return new_state, out.reward

    batched_step = jax.vmap(
        step_one, in_axes=(None, state_axes), out_axes=(state_axes, 0)
    )

    def sweep(params, states):
        B = states["battery_charge"].shape[0]
        acc0 = jnp.zeros((B,), jnp.dtype(spec.dtype))

        def body(carry, _):
            states, acc = carry
            states, reward = batched_step(params, states)
            return (states, acc + reward), None

        (states, acc), _ = lax.scan(
            body, (states, acc0), None, length=n_steps
        )
        return states, acc

    return jax.jit(sweep)


def lockstep_states(spec, params, batched_states):
    """Convert per-replica reset states (identical ``step``/forecast) into
    the shared-time layout :func:`make_lockstep_sweep_fn` consumes."""
    import jax

    shared_forecast = spec.numpy_noise or not any(
        m.forecaster == "gaussian" for m in spec.log_order
    )
    out = dict(batched_states)
    out["step"] = jax.tree.map(lambda x: x[0], batched_states["step"])
    if shared_forecast:
        out["forecast"] = jax.tree.map(
            lambda x: x[0], batched_states["forecast"]
        )
    return out


def rollout_actions(spec, params, state, actions, normalized=False):
    """Scan precomputed time-major action arrays through the engine."""
    import jax
    from jax import lax

    step_fn = make_step_fn(spec, normalized=normalized)

    @jax.jit
    def rollout(params, state, actions):
        return lax.scan(lambda s, a: step_fn(params, s, a), state, actions)

    return rollout(params, state, actions)


def _ts_current(params, kind, slot, t, jnp, lax):
    return lax.dynamic_index_in_dim(
        params[kind]["ts"][slot], t, axis=0, keepdims=False
    )


def _row_accessor(spec, params, t, jnp, lax, state=None):
    """``(kind, slot) -> current raw ts row`` at step ``t``.

    One fused lane-rich row-table gather when step-index tables are attached
    (:mod:`pymgrid_tpu.core.tables`; the fast path), per-slot
    ``dynamic_index`` otherwise.  A caller-prefetched ``state["table_row"]``
    (block-prefetch rollouts) takes precedence.  Values are
    bitwise-identical across all three paths.
    """
    raw = None
    if state is not None and "table_row" in state:
        raw = state["table_row"]
    elif "step_table" in params:
        # identical gather expression to the engine step's (same operand,
        # same index) — XLA CSE merges them into one gather per program
        raw = lax.dynamic_index_in_dim(
            params["step_table"], t, axis=0, keepdims=False
        )
    if raw is not None:
        from pymgrid_tpu.core.tables import row_table_layout

        layout, _ = row_table_layout(spec)

        def cur(kind, slot):
            off, width = layout[(kind, slot)]
            return raw[off : off + width]

        return cur
    return lambda kind, slot: _ts_current(params, kind, slot, t, jnp, lax)


def make_priority_policy(spec, priority_list):
    """Compile a priority list into an engine policy.

    Mirrors ``PriorityListAlgo._populate_action``
    (``algos/priority_list/priority_list.py:69-167``): net load = fixed-sink
    consumption minus flex-source availability; walk the (static) list,
    deploying each controllable module against the remainder.  The list is
    unrolled at trace time, so the policy is pure arithmetic.
    """
    import jax.numpy as jnp
    from jax import lax

    dtype = jnp.dtype(spec.dtype)
    by_module = {(ref.name, ref.num): ref for ref in spec.controllable}

    # first element of a multi-action module fixes its goal action
    seen = set()
    elements = []
    for el in priority_list:
        if el.module in seen:
            continue
        seen.add(el.module)
        if el.module not in by_module:
            raise KeyError(f"Priority element {el} has no controllable module")
        elements.append((by_module[el.module], el))

    def policy(params, state):
        t = state["step"]
        cur_row = _row_accessor(spec, params, t, jnp, lax, state=state)
        total_load = jnp.asarray(0.0, dtype)
        for ref in spec.fixed:  # loads: fixed sinks
            row = cur_row("load", ref.slot)
            total_load = total_load + (-row[0])
        renewable = jnp.asarray(0.0, dtype)
        for ref in spec.flex:
            if ref.kind == "renewable":
                row = cur_row("renewable", ref.slot)
                renewable = renewable + row[0]

        remaining = total_load - renewable

        action = {
            "battery": jnp.zeros(spec.n_battery, dtype),
            "genset": jnp.zeros((spec.n_genset, 2), dtype),
            "grid": jnp.zeros(spec.n_grid, dtype),
        }

        for ref, el in elements:
            near_zero = jnp.abs(remaining) <= 1e-4
            if ref.kind == "genset":
                p = params["genset"]
                goal = el.action
                gs = state["genset"]
                cur = gs["current_status"][ref.slot]
                up_ready = gs["steps_until_up"][ref.slot] == 0
                down_ready = gs["steps_until_down"][ref.slot] == 0
                if goal == 1:
                    next_status = jnp.where(cur == 1, 1, jnp.where(up_ready, 1, 0))
                else:
                    next_status = jnp.where(cur == 0, 0, jnp.where(down_ready, 0, 1))
                nsf = next_status.astype(dtype)
                min_p = nsf * p["running_min_production"][ref.slot]
                max_p = nsf * p["running_max_production"][ref.slot]
                produce = jnp.where(
                    remaining < min_p,
                    min_p,
                    jnp.where(remaining > max_p, max_p, remaining),
                )
                energy = jnp.where(
                    near_zero, 0.0, jnp.where(remaining > 0, produce, 0.0)
                )
                action["genset"] = (
                    action["genset"]
                    .at[ref.slot, 0]
                    .set(jnp.asarray(goal, dtype))
                    .at[ref.slot, 1]
                    .set(energy)
                )
            else:
                if ref.kind == "battery":
                    p = params["battery"]
                    charge = state["battery_charge"][ref.slot]
                    eff = p["efficiency"][ref.slot]
                    max_p = (
                        jnp.minimum(
                            p["max_discharge"][ref.slot],
                            charge - p["min_capacity"][ref.slot],
                        )
                        * eff
                    )
                    min_p = jnp.asarray(0.0, dtype)
                    max_c = (
                        jnp.minimum(
                            p["max_charge"][ref.slot],
                            p["max_capacity"][ref.slot] - charge,
                        )
                        / eff
                    )
                else:  # grid
                    p = params["grid"]
                    row = cur_row("grid", ref.slot)
                    status = row[3]
                    max_p = p["max_import"][ref.slot] * status
                    min_p = jnp.asarray(0.0, dtype)
                    max_c = p["max_export"][ref.slot] * status

                produce = jnp.where(
                    remaining < min_p,
                    min_p,
                    jnp.where(remaining > max_p, max_p, remaining),
                )
                consume = jnp.where(-remaining > max_c, -max_c, remaining)
                energy = jnp.where(
                    near_zero, 0.0, jnp.where(remaining > 0, produce, consume)
                )
                action[ref.kind] = action[ref.kind].at[ref.slot].set(energy)

            remaining = remaining - energy

        return action

    return policy


def make_table_policy(spec, priority_lists):
    """Compile ALL priority lists into one table-driven policy
    ``(params, state, action_idx) -> action``.

    Where :func:`make_priority_policy` unrolls one list at trace time (and a
    discrete env would need ``lax.switch`` over all ``n!·2^g`` of them — a
    compile-time explosion, reference warns >1000 actions at
    ``envs/discrete/discrete.py:74``), this encodes every list as integer
    tables ``(kind, slot, goal)[action, position]`` and evaluates a single
    program: per deployment position, compute the three kind-specific energy
    candidates and select by the table entry.  Compile cost is
    O(n_controllable), independent of the number of actions.
    """
    import jax.numpy as jnp
    from jax import lax

    dtype = jnp.dtype(spec.dtype)
    by_module = {(ref.name, ref.num): ref for ref in spec.controllable}
    KINDS = {"battery": 0, "genset": 1, "grid": 2}

    n_actions = len(priority_lists)
    n_positions = len(priority_lists[0])
    kind_t = np.zeros((n_actions, n_positions), np.int32)
    slot_t = np.zeros((n_actions, n_positions), np.int32)
    goal_t = np.zeros((n_actions, n_positions), np.int32)
    for a, pl in enumerate(priority_lists):
        if len(pl) != n_positions:
            raise ValueError("All priority lists must have equal length.")
        for k, el in enumerate(pl):
            ref = by_module[el.module]
            kind_t[a, k] = KINDS[ref.kind]
            slot_t[a, k] = ref.slot
            goal_t[a, k] = el.action

    # single stacked table [kinds | slots | goals]: ONE per-replica lookup
    # instead of three.  For small action spaces the lookup is a one-hot
    # matmul instead of a gather; values are tiny ints, exact in any matmul
    # precision.
    stacked_table = np.concatenate([kind_t, slot_t, goal_t], axis=1)
    use_onehot = n_actions <= 512

    # Static (kind_id, slot) pairs, unrolled at trace time.  All per-position
    # work below selects among these with elementwise ``where`` — NO
    # traced-index gathers or scatters: a vmapped ``x[slot]`` / ``.at[slot]``
    # with per-replica slots lowers to HLO gather/scatter, which is far
    # slower than elementwise selects over a handful of static slots.
    ctrl_refs = [(KINDS[ref.kind], ref.slot) for ref in spec.controllable]

    def policy(params, state, action_idx):
        t = state["step"]
        cur_row = _row_accessor(spec, params, t, jnp, lax, state=state)
        total_load = jnp.asarray(0.0, dtype)
        for ref in spec.fixed:
            row = cur_row("load", ref.slot)
            total_load = total_load + (-row[0])
        renewable = jnp.asarray(0.0, dtype)
        for ref in spec.flex:
            if ref.kind == "renewable":
                row = cur_row("renewable", ref.slot)
                renewable = renewable + row[0]
        remaining = total_load - renewable

        if use_onehot:
            onehot = (action_idx == jnp.arange(n_actions)).astype(dtype)
            vals = onehot @ jnp.asarray(stacked_table, dtype)  # (3*n_pos,)
            row = vals.astype(jnp.int32)
        else:
            row = jnp.asarray(stacked_table)[action_idx]       # one gather
        kinds = row[:n_positions]                              # (n_positions,)
        slots = row[n_positions : 2 * n_positions]
        goals = row[2 * n_positions :]

        def clamp_produce(remaining, min_p, max_p):
            return jnp.where(
                remaining < min_p, min_p,
                jnp.where(remaining > max_p, max_p, remaining),
            )

        def candidate(kind_id, slot, goal, remaining, near_zero):
            """Energy this module would deploy against ``remaining``
            (static kind/slot; ``goal`` traced, genset only)."""
            if kind_id == 0:
                pb = params["battery"]
                charge = state["battery_charge"][slot]
                eff = pb["efficiency"][slot]
                b_max_p = jnp.minimum(
                    pb["max_discharge"][slot], charge - pb["min_capacity"][slot]
                ) * eff
                b_max_c = jnp.minimum(
                    pb["max_charge"][slot], pb["max_capacity"][slot] - charge
                ) / eff
                prod = clamp_produce(remaining, jnp.asarray(0.0, dtype), b_max_p)
                cons = jnp.where(-remaining > b_max_c, -b_max_c, remaining)
                return jnp.where(
                    near_zero, 0.0, jnp.where(remaining > 0, prod, cons)
                )
            if kind_id == 1:
                pg = params["genset"]
                gs = state["genset"]
                cur = gs["current_status"][slot]
                up_ready = gs["steps_until_up"][slot] == 0
                down_ready = gs["steps_until_down"][slot] == 0
                next_on = jnp.where(cur == 1, 1, jnp.where(up_ready, 1, 0))
                next_off = jnp.where(cur == 0, 0, jnp.where(down_ready, 0, 1))
                nsf = jnp.where(goal == 1, next_on, next_off).astype(dtype)
                g_min_p = nsf * pg["running_min_production"][slot]
                g_max_p = nsf * pg["running_max_production"][slot]
                prod = clamp_produce(remaining, g_min_p, g_max_p)
                return jnp.where(
                    near_zero, 0.0, jnp.where(remaining > 0, prod, 0.0)
                )
            pgr = params["grid"]
            row = cur_row("grid", slot)
            status = row[3]
            gr_max_p = pgr["max_import"][slot] * status
            gr_max_c = pgr["max_export"][slot] * status
            prod = clamp_produce(remaining, jnp.asarray(0.0, dtype), gr_max_p)
            cons = jnp.where(-remaining > gr_max_c, -gr_max_c, remaining)
            return jnp.where(
                near_zero, 0.0, jnp.where(remaining > 0, prod, cons)
            )

        # per-module accumulated deployments (each module appears in exactly
        # one position of a deduped list; += of where-masked zeros matches
        # the reference's zeros-init + populate semantics)
        energy_acc = {pair: jnp.asarray(0.0, dtype) for pair in ctrl_refs}
        goal_acc = {pair: jnp.asarray(0.0, dtype) for pair in ctrl_refs}

        for k in range(n_positions):
            kind_k, slot_k, goal_k = kinds[k], slots[k], goals[k]
            near_zero = jnp.abs(remaining) <= 1e-4

            energy_k = jnp.asarray(0.0, dtype)
            for kind_id, slot in ctrl_refs:
                sel = (kind_k == kind_id) & (slot_k == slot)
                e = candidate(kind_id, slot, goal_k, remaining, near_zero)
                energy_k = jnp.where(sel, e, energy_k)
                energy_acc[(kind_id, slot)] = energy_acc[(kind_id, slot)] + (
                    jnp.where(sel, e, 0.0)
                )
                if kind_id == 1:
                    goal_acc[(kind_id, slot)] = goal_acc[(kind_id, slot)] + (
                        jnp.where(sel, goal_k.astype(dtype), 0.0)
                    )

            remaining = remaining - energy_k

        action = {
            "battery": jnp.zeros(spec.n_battery, dtype),
            "genset": jnp.zeros((spec.n_genset, 2), dtype),
            "grid": jnp.zeros(spec.n_grid, dtype),
        }
        if spec.n_battery:
            action["battery"] = jnp.stack(
                [energy_acc.get((0, s), jnp.asarray(0.0, dtype))
                 for s in range(spec.n_battery)]
            )
        if spec.n_genset:
            action["genset"] = jnp.stack(
                [jnp.stack([goal_acc.get((1, s), jnp.asarray(0.0, dtype)),
                            energy_acc.get((1, s), jnp.asarray(0.0, dtype))])
                 for s in range(spec.n_genset)]
            )
        if spec.n_grid:
            action["grid"] = jnp.stack(
                [energy_acc.get((2, s), jnp.asarray(0.0, dtype))
                 for s in range(spec.n_grid)]
            )
        return action

    return policy


def make_marginal_cost_policy(spec):
    """Priority-list RBC with the deployment order computed *at runtime* from
    each config's marginal costs.

    The reference RBC sorts its priority list once at construction
    (``algos/rbc/rbc.py:31-44``): battery at ``battery_cost_cycle``, grid at
    the initial import price, genset at ``fuel + cost_co2*co2_per_unit`` (the
    genset-on element always precedes genset-off on the cost tie, so the goal
    is 1).  Here the same order is derived per config inside the compiled
    program — one policy serves a heterogeneous config batch
    (:mod:`pymgrid_tpu.parallel.suite`).

    Requires at most one module per controllable kind (the suite superset).
    """
    import jax.numpy as jnp
    from jax import lax

    if spec.n_battery > 1 or spec.n_genset > 1 or spec.n_grid > 1:
        raise NotImplementedError(
            "Runtime-ordered RBC supports at most one module per controllable "
            "kind; use make_priority_policy with an explicit list."
        )

    dtype = jnp.dtype(spec.dtype)

    def policy(params, state):
        t = state["step"]
        cur_row = _row_accessor(spec, params, t, jnp, lax, state=state)
        total_load = jnp.asarray(0.0, dtype)
        for ref in spec.fixed:
            row = cur_row("load", ref.slot)
            total_load = total_load + (-row[0])
        renewable = jnp.asarray(0.0, dtype)
        for ref in spec.flex:
            if ref.kind == "renewable":
                row = cur_row("renewable", ref.slot)
                renewable = renewable + row[0]
        remaining = total_load - renewable

        action = {
            "battery": jnp.zeros(spec.n_battery, dtype),
            "genset": jnp.zeros((spec.n_genset, 2), dtype),
            "grid": jnp.zeros(spec.n_grid, dtype),
        }

        # marginal costs (construction-time semantics: initial_step prices)
        costs, deploys = [], []

        def deploy_energy(remaining, min_p, max_p, max_c):
            near_zero = jnp.abs(remaining) <= 1e-4
            produce = jnp.where(
                remaining < min_p, min_p,
                jnp.where(remaining > max_p, max_p, remaining),
            )
            consume = jnp.where(-remaining > max_c, -max_c, remaining)
            return jnp.where(
                near_zero, 0.0, jnp.where(remaining > 0, produce, consume)
            )

        if spec.n_genset:
            pgen = params["genset"]

            def deploy_genset(remaining, action):
                # The reference's default list keeps the genset ON only when
                # running_min_production == 0 (the redundant off-lists are
                # removed); otherwise the first deduped permutation carries
                # the off element (``priority_list.py:40-67``).
                goal = jnp.where(pgen["running_min_production"][0] == 0, 1, 0)
                gs = state["genset"]
                cur = gs["current_status"][0]
                up_ready = gs["steps_until_up"][0] == 0
                down_ready = gs["steps_until_down"][0] == 0
                next_on = jnp.where(cur == 1, 1, jnp.where(up_ready, 1, 0))
                next_off = jnp.where(cur == 0, 0, jnp.where(down_ready, 0, 1))
                next_status = jnp.where(goal == 1, next_on, next_off)
                nsf = next_status.astype(dtype)
                min_p = nsf * pgen["running_min_production"][0]
                max_p = nsf * pgen["running_max_production"][0]
                near_zero = jnp.abs(remaining) <= 1e-4
                produce = jnp.where(
                    remaining < min_p, min_p,
                    jnp.where(remaining > max_p, max_p, remaining),
                )
                e = jnp.where(near_zero, 0.0, jnp.where(remaining > 0, produce, 0.0))
                new_genset = (
                    action["genset"].at[0, 0].set(goal.astype(dtype)).at[0, 1].set(e)
                )
                return e, {**action, "genset": new_genset}

            costs.append(
                pgen["genset_cost"][0]
                + pgen["cost_per_unit_co2"][0] * pgen["co2_per_unit"][0]
            )
            deploys.append(deploy_genset)

        if spec.n_battery:
            pb = params["battery"]

            def deploy_battery(remaining, action):
                charge = state["battery_charge"][0]
                eff = pb["efficiency"][0]
                max_p = jnp.minimum(
                    pb["max_discharge"][0], charge - pb["min_capacity"][0]
                ) * eff
                max_c = jnp.minimum(
                    pb["max_charge"][0], pb["max_capacity"][0] - charge
                ) / eff
                e = deploy_energy(remaining, jnp.asarray(0.0, dtype), max_p, max_c)
                return e, {**action, "battery": action["battery"].at[0].set(e)}

            costs.append(pb["battery_cost_cycle"][0])
            deploys.append(deploy_battery)

        if spec.n_grid:
            pg = params["grid"]

            def deploy_grid(remaining, action):
                row = cur_row("grid", 0)
                status = row[3]
                max_p = pg["max_import"][0] * status
                max_c = pg["max_export"][0] * status
                e = deploy_energy(remaining, jnp.asarray(0.0, dtype), max_p, max_c)
                return e, {**action, "grid": action["grid"].at[0].set(e)}

            costs.append(
                params["grid"]["ts"][0][jnp.asarray(params["initial_step"], jnp.int32)][0]
            )
            deploys.append(deploy_grid)

        order = jnp.argsort(jnp.stack(costs), stable=True)

        for position in range(len(deploys)):
            idx = order[position]
            branch_outs = [d(remaining, action) for d in deploys]
            energies = jnp.stack([e for e, _ in branch_outs])
            remaining = remaining - energies[idx]
            # merge: take the selected branch's action arrays
            merged = {}
            for k in action:
                stacked = jnp.stack([a[k] for _, a in branch_outs])
                merged[k] = stacked[idx]
            action = merged

        return action

    return policy


def make_random_policy(spec, normalized=True):
    """Uniform random actions from the threaded PRNG (for benchmarking)."""
    import jax
    import jax.numpy as jnp

    dtype = jnp.dtype(spec.dtype)

    def policy(params, state):
        key = jax.random.fold_in(state["rng"], 7)
        kb, kg, kr = jax.random.split(key, 3)
        return {
            "battery": jax.random.uniform(kb, (spec.n_battery,), dtype),
            "genset": jax.random.uniform(kg, (spec.n_genset, 2), dtype),
            "grid": jax.random.uniform(kr, (spec.n_grid,), dtype),
        }

    return policy
