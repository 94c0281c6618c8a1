"""The compiled microgrid engine.

``make_step_fn(spec)`` builds a pure function

    step(params, state, action) -> (new_state, StepOutput)

that reproduces the host :meth:`Microgrid.run` three-phase dispatch
(``microgrid/microgrid.py:227-325``) exactly — same module order, same
floating-point summation trees (:mod:`pymgrid_tpu.core.numpy_sum`), same
clipping/cost semantics (:mod:`pymgrid_tpu.core.physics`) — as a single
traced XLA program with no data-dependent Python control flow.  It composes
with ``jax.jit``, ``jax.vmap`` (replica batching) and ``lax.scan`` (time).

Design notes:

* All per-step work is elementwise/gather on tiny operands; XLA fuses the
  whole step into one kernel.  Time series stay in HBM as ``(n, T+pad, f)``
  arrays; the current row and the forecast window are ``dynamic_slice`` ops.
* Off-end observations/forecasts are handled by pre-padding the series with
  the forecaster's midpoint fill rows — no bounds checks in the hot path.
* The genset state machine is branchless integer arithmetic
  (``physics.genset_update_status``).
* Realized forecasts ride in the state so that the value logged at step t is
  the one observed at the end of step t-1 (gaussian forecasters draw fresh
  noise from the threaded PRNG key each step).
"""
from typing import Any, Dict, NamedTuple

import numpy as np

from pymgrid_tpu.core import physics
from pymgrid_tpu.core.numpy_sum import numpy_sum_compat
from pymgrid_tpu.core.tables import (
    logfc_table_layout,
    obs_table_layout,
    row_table_layout,
    tabulable,
)

__all__ = ["StepOutput", "make_step_fn", "make_reset_fn", "ts_obs_part"]


class StepOutput(NamedTuple):
    obs: Any           # (obs_dim,) normalized observation
    reward: Any        # scalar summed module reward
    shaped_reward: Any # scalar (== reward unless spec.shaper)
    done: Any          # scalar bool
    log_row: Any       # (n_log_fields,) per-step log record
    provided: Any      # scalar overall provided energy
    absorbed: Any      # scalar overall absorbed energy


def _trace_custom(ref, thunk):
    """Trace a user callable into the engine, with guidance on failure."""
    try:
        return thunk()
    except Exception as exc:  # tracing-time failure (concretization etc.)
        raise NotImplementedError(
            f"The custom callable on module ({ref.name}, {ref.num}) is not "
            f"JAX-traceable and cannot run in the compiled engine; use the "
            f"host Microgrid.run path, or rewrite the callable with "
            f"jax/numpy-compatible ops (no Python branching on values). "
            f"Original error: {exc!r}"
        ) from exc


def _custom_battery_transition(ref, p, i, eff, charge, max_prod, max_cons,
                               prov, absd, dtype):
    """Trace a user ``battery_transition_model`` for both flow directions.

    The reference calls it with keyword arguments only
    (``battery_module.py:149-189,214-243``): the external energy change is
    negative for a discharge (source) and positive for a charge (sink), and
    the return value is the internal energy change.
    """
    import jax.numpy as jnp

    kwargs = dict(
        min_capacity=p["min_capacity"][i],
        max_capacity=p["max_capacity"][i],
        max_charge=p["max_charge"][i],
        max_discharge=p["max_discharge"][i],
        efficiency=eff,
        battery_cost_cycle=p["battery_cost_cycle"][i],
        max_production=max_prod,
        max_consumption=max_cons,
        state_dict={"soc": charge / p["max_capacity"][i], "current_charge": charge},
    )
    internal_src = _trace_custom(
        ref,
        lambda: jnp.asarray(
            ref.custom_fn(external_energy_change=-1.0 * prov, **kwargs), dtype
        ),
    )
    internal_snk = _trace_custom(
        ref,
        lambda: jnp.asarray(
            ref.custom_fn(external_energy_change=absd, **kwargs), dtype
        ),
    )
    return internal_src, internal_snk


def _kind_max_h(spec, kind):
    hs = [m.forecast_horizon for m in spec.log_order if m.kind == kind]
    return max(hs, default=0)


def _n_feat(kind):
    return 4 if kind == "grid" else 1


def make_reset_fn(spec):
    """Build ``reset(params, key, initial_step=None) -> state``.

    ``initial_step`` optionally overrides ``params['initial_step']`` per
    call (traced) — the engine analog of the host trajectory functions'
    randomized episode starts (``microgrid/trajectory.py``).
    """
    import jax
    import jax.numpy as jnp

    dtype = jnp.dtype(spec.dtype)

    def reset(params, key, initial_step=None):
        if initial_step is None:
            t0 = jnp.asarray(params["initial_step"], jnp.int32)
        else:
            t0 = jnp.asarray(initial_step, jnp.int32)
        state = {
            "step": t0,
            "battery_charge": jnp.asarray(params["battery"]["init_charge"], dtype),
            "genset": {
                "current_status": jnp.asarray(params["genset"]["init_status"], jnp.int32),
                "goal_status": jnp.asarray(params["genset"]["init_status"], jnp.int32),
                "steps_until_up": jnp.where(
                    params["genset"]["init_status"] == 1,
                    0,
                    jnp.asarray(params["genset"]["start_up_time"], jnp.int32),
                ).astype(jnp.int32),
                "steps_until_down": jnp.where(
                    params["genset"]["init_status"] == 1,
                    jnp.asarray(params["genset"]["wind_down_time"], jnp.int32),
                    0,
                ).astype(jnp.int32),
            },
            "rng": key,
        }
        state["forecast"] = _forecasts_at(spec, params, t0, key)
        return state

    return reset


def _gaussian_refs(spec, kind):
    return [m for m in spec.log_order if m.kind == kind and m.forecaster == "gaussian"]


def _oracle_window(spec, params, ref, t):
    """Deterministic forecast window (oracle / fill-padded) at step ``t``."""
    import jax.numpy as jnp
    from jax import lax

    dtype = jnp.dtype(spec.dtype)
    h, f = ref.forecast_horizon, ref.n_features
    ts_slot = params[ref.kind]["ts"][ref.slot]
    return lax.dynamic_slice(ts_slot, (t + 1, jnp.int32(0)), (h, f)).astype(dtype)


def _realized_forecast(spec, params, state, ref, t):
    """Forecast window for ``ref`` valid at current step ``t``.

    Oracle windows are recomputed as dynamic slices of the HBM-resident
    series (cheaper than carrying per-replica state); precomputed-numpy
    gaussian realizations are pure functions of ``t`` (read from the noise
    bank); jax-PRNG gaussian realizations ride in ``state['forecast']`` so
    the value logged at step t is the one observed at the end of step t-1.
    """
    if ref.forecast_horizon == 0:
        return None
    if ref.forecaster == "gaussian":
        if spec.numpy_noise:
            return _numpy_noise_window(spec, params, ref, t)
        gslot = [m.slot for m in _gaussian_refs(spec, ref.kind)].index(ref.slot)
        return state["forecast"][ref.kind][gslot][: ref.forecast_horizon]
    if ref.forecaster == "user":
        return _user_window(spec, params, ref, t)
    if ref.forecaster == "user_bank":
        return _user_bank_window(spec, params, ref, t)
    return _oracle_window(spec, params, ref, t)


def _numpy_noise_window(spec, params, ref, t):
    """Gaussian forecast window from the precomputed numpy-RNG noise bank
    (bitwise host parity) — deterministic in ``t``, so it needs no carried
    state and tabulates (:mod:`pymgrid_tpu.core.tables`)."""
    import jax.numpy as jnp
    from jax import lax

    dtype = jnp.dtype(spec.dtype)
    h, f = ref.forecast_horizon, ref.n_features
    gslot = [m.slot for m in _gaussian_refs(spec, ref.kind)].index(ref.slot)
    window = _oracle_window(spec, params, ref, t)
    noise = lax.dynamic_slice(
        params[ref.kind]["np_noise"][gslot],
        (t, jnp.int32(0), jnp.int32(0)),
        (1, h, f),
    )[0].astype(dtype)
    n_real = jnp.clip(ref.ts_length - 1 - t, 0, h)
    mask = (jnp.arange(h) < n_real)[:, None]
    window = window + noise * mask
    return jnp.clip(
        window,
        params[ref.kind]["obs_low"][ref.slot],
        params[ref.kind]["obs_high"][ref.slot],
    )


def _user_bank_window(spec, params, ref, t):
    """STOCHASTIC user forecast window from the pre-sampled realization
    bank (``core/spec.py:_ts_params``): one host draw per step at spec
    extraction, replayed by every engine episode.  Off-end rows revert to
    the midpoint fill and the result clips to the observation bounds —
    identical post-processing to the traced deterministic path."""
    import jax.numpy as jnp
    from jax import lax

    dtype = jnp.dtype(spec.dtype)
    h, f = ref.forecast_horizon, ref.n_features
    window = _oracle_window(spec, params, ref, t)
    raw = lax.dynamic_slice(
        params[ref.kind]["user_bank"][ref.slot],
        (t, jnp.int32(0), jnp.int32(0)),
        (1, h, f),
    )[0].astype(dtype)
    n_real = jnp.clip(ref.ts_length - 1 - t, 0, h)
    mask = (jnp.arange(h) < n_real)[:, None]
    out = jnp.where(mask, raw, window)
    return jnp.clip(
        out,
        params[ref.kind]["obs_low"][ref.slot],
        params[ref.kind]["obs_high"][ref.slot],
    )


def _user_window(spec, params, ref, t):
    """User-defined forecast window at step ``t``.

    The user callable (validated deterministic at spec extraction,
    ``core/spec.py:_engine_forecast_fn``) is traced on the full fill-padded
    window; rows past the data end revert to the midpoint fill and the result
    is clipped to the observation bounds — the host's truncate/pad/clip
    sequence (``forecast/forecaster.py:218-231``) for row-wise callables.
    """
    import jax.numpy as jnp
    from jax import lax

    dtype = jnp.dtype(spec.dtype)
    h, f = ref.forecast_horizon, ref.n_features
    window = _oracle_window(spec, params, ref, t)
    val_c = lax.dynamic_index_in_dim(
        params[ref.kind]["ts"][ref.slot], t, axis=0, keepdims=False
    ).astype(dtype)
    raw = _trace_custom(
        ref, lambda: jnp.asarray(ref.custom_fn(val_c, window, h, jnp), dtype)
    ).reshape(h, f)
    n_real = jnp.clip(ref.ts_length - 1 - t, 0, h)
    mask = (jnp.arange(h) < n_real)[:, None]
    out = jnp.where(mask, raw, window)
    return jnp.clip(
        out,
        params[ref.kind]["obs_low"][ref.slot],
        params[ref.kind]["obs_high"][ref.slot],
    )


def _forecasts_at(spec, params, t, key):
    """Realized *jax-PRNG gaussian* forecast state {kind: (n_gauss, max_h, f)}
    for current step ``t``.  Deterministic forecasters (and numpy-noise-bank
    gaussians, which are pure functions of ``t``) carry no state."""
    import jax
    import jax.numpy as jnp

    dtype = jnp.dtype(spec.dtype)
    if spec.numpy_noise:
        return {}
    out = {}
    for kind in ("load", "renewable", "grid"):
        refs = _gaussian_refs(spec, kind)
        if not refs:
            continue
        max_h = max(m.forecast_horizon for m in refs)
        f = _n_feat(kind)
        rows = []
        for gslot, ref in enumerate(refs):
            h = ref.forecast_horizon
            window = _oracle_window(spec, params, ref, t)
            key, sub = jax.random.split(key)
            std = params[kind]["noise_std"][ref.slot][:h]
            noise = jax.random.normal(sub, (h, f), dtype) * std
            n_real = jnp.clip(ref.ts_length - 1 - t, 0, h)
            mask = (jnp.arange(h) < n_real)[:, None]
            window = window + noise * mask
            # clip to the observation bounds (reference Forecaster._clip)
            window = jnp.clip(
                window,
                params[kind]["obs_low"][ref.slot],
                params[kind]["obs_high"][ref.slot],
            )
            if h < max_h:
                window = jnp.concatenate(
                    [window, jnp.zeros((max_h - h, f), dtype)], axis=0
                )
            rows.append(window)
        out[kind] = jnp.stack(rows)
    return out


def make_step_fn(spec, normalized=False, obs_layout="log"):
    """Build the engine step function for ``spec``.

    ``normalized`` is static: whether incoming actions are in [0, 1] and must
    be denormalized (genset goal entries are never denormalized,
    ``genset_module.py:119-121``).

    ``obs_layout`` is static: ``"log"`` concatenates observation segments in
    container (log) order; ``"env"`` concatenates them directly in the gym
    env's flattened order (Dict spaces sort module names,
    ``envs/base/base.py:128-163``) so batched envs need no post-hoc
    permutation gather.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    dtype = jnp.dtype(spec.dtype)

    if obs_layout == "log":
        obs_order = None
    elif obs_layout == "env":
        obs_order = tuple(
            sorted(spec.log_order, key=lambda ref: (ref.name, ref.num))
        )
    else:
        raise ValueError(f"obs_layout must be 'log' or 'env', got {obs_layout!r}")

    row_layout, row_width = row_table_layout(spec)
    logfc_layout, _ = logfc_table_layout(spec)

    for ref in spec.fixed:
        if ref.kind != "load":
            raise NotImplementedError(f"fixed-phase kind {ref.kind} unsupported")
    for ref in spec.controllable:
        if ref.kind not in ("battery", "genset", "grid"):
            raise NotImplementedError(f"controllable-phase kind {ref.kind} unsupported")
    for ref in spec.flex:
        if ref.kind not in ("renewable", "balancing"):
            raise NotImplementedError(f"flex-phase kind {ref.kind} unsupported")

    zero = np.array(0.0, dtype)

    strict_fp = dtype == jnp.dtype("float64")

    def no_fma(x):
        """Round a product before it feeds an add (float64 parity mode only).

        XLA/LLVM may contract ``a*b + c`` into a fused multiply-add with a
        single rounding; numpy (the reference) always rounds the product.  An
        optimization barrier pins the op ordering; CPU parity runs must also
        set ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (pre-FMA ISA) since LLVM can
        still contract barrier-pinned scalars.  The float32 fast path is
        left barrier-free — FMA there is an accuracy win, and parity at f32
        is statistical, not bitwise.
        """
        return lax.optimization_barrier(x) if strict_fp else x

    def ts_row(params, kind, slot, t):
        return lax.dynamic_index_in_dim(
            params[kind]["ts"][slot], t, axis=0, keepdims=False
        ).astype(dtype)

    def ts_done(params, kind, slot, t):
        return t >= jnp.asarray(params[kind]["final_step"][slot], jnp.int32) - 1

    def step(params, state, action):
        t = state["step"]
        provided, absorbed = [], []     # append-order traced scalars
        rewards = []                    # strict append order (sequential +=)
        dones = []
        log_vals = {}                   # (name, num, field) -> traced scalar

        # ONE lane-rich row gather covers every module's current ts row AND
        # the outgoing observation's tabulated segments (the obs columns are
        # shifted by one step at table build; bitwise-identical values —
        # see core/tables.py).  The same gather expression appears in the
        # in-engine policies (core/rollout.py), so XLA CSE leaves a single
        # gather per fused policy+step program.
        table_row = None
        logfc_row = None
        if "table_row" in state:
            # caller-provided prefetched row (block-prefetch rollouts,
            # parallel/suite.py): bitwise-identical to the gather below by
            # construction; the fresh new_state dict never carries it
            table_row = state["table_row"]
        elif "step_table" in params:
            table_row = lax.dynamic_index_in_dim(
                params["step_table"], t, axis=0, keepdims=False
            )
        if "logfc_table" in params:
            # gathered from its OWN table so that programs which never
            # materialize log rows (rewards-only rollouts) drop the whole
            # log-forecast gather under DCE — fused into step_table it was
            # ~40% of the per-step gather traffic for nothing
            logfc_row = lax.dynamic_index_in_dim(
                params["logfc_table"], t, axis=0, keepdims=False
            )

        def cur_row(kind, slot):
            if table_row is not None:
                off, width = row_layout[(kind, slot)]
                return table_row[off : off + width]
            return ts_row(params, kind, slot, t)

        def log_window(ref):
            """Realized forecast window for the log row — from the fused
            table gather when tabulated (one row gather instead of
            per-replica window gathers), dynamic otherwise."""
            if logfc_row is not None and (ref.name, ref.num) in logfc_layout:
                off, width = logfc_layout[(ref.name, ref.num)]
                return logfc_row[off : off + width].reshape(
                    ref.forecast_horizon, ref.n_features
                )
            return _realized_forecast(spec, params, state, ref, t)

        # --------------------------------------------------- phase 1: fixed
        for ref in spec.fixed:
            row = cur_row("load", ref.slot)                       # (1,) negative
            load_met = -row[0]
            absorbed.append(load_met)
            rewards.append(zero)
            dones.append(ts_done(params, "load", ref.slot, t))
            lv = {"reward": zero, "load_met": load_met, "load_current": row[0]}
            _log_forecast(lv, ref, log_window(ref))
            log_vals[(ref.name, ref.num)] = lv

        fixed_provided = numpy_sum_compat(provided)
        fixed_absorbed = numpy_sum_compat(absorbed)

        # -------------------------------------------- phase 2: controllable
        new_battery = state["battery_charge"]
        gs = state["genset"]
        new_genset = {k: v for k, v in gs.items()}

        for ref in spec.controllable:
            if ref.kind == "battery":
                i = ref.slot
                p = params["battery"]
                a = jnp.asarray(action["battery"][i], dtype)
                if normalized:
                    a = p["act_low"][i] + no_fma(p["act_spread"][i] * a)
                charge = new_battery[i]
                eff = p["efficiency"][i]
                max_prod = physics.battery_max_production(
                    charge, p["min_capacity"][i], p["max_discharge"][i], eff, xp=jnp
                )
                max_cons = physics.battery_max_consumption(
                    charge, p["max_capacity"][i], p["max_charge"][i], eff, xp=jnp
                )
                is_sink = a < 0
                prov = physics.clip_source(a, zero, max_prod, xp=jnp)
                absd = physics.clip_sink(-a, max_cons, xp=jnp)
                if ref.custom_fn is not None:
                    internal_src, internal_snk = _custom_battery_transition(
                        ref, p, i, eff, charge, max_prod, max_cons, prov, absd, dtype
                    )
                else:
                    internal_src = -prov / eff
                    internal_snk = absd * eff
                prov = jnp.where(is_sink, zero, prov)
                absd = jnp.where(is_sink, absd, zero)
                internal = jnp.where(is_sink, internal_snk, internal_src)
                soc_pre = charge / p["max_capacity"][i]
                charge_new = charge + internal
                charge_new = jnp.where(
                    charge_new < p["min_capacity"][i], p["min_capacity"][i], charge_new
                )
                reward = -1.0 * (jnp.abs(internal) * p["battery_cost_cycle"][i])
                new_battery = new_battery.at[i].set(charge_new)
                provided.append(prov)
                absorbed.append(absd)
                rewards.append(reward)
                dones.append(jnp.asarray(False))
                log_vals[(ref.name, ref.num)] = {
                    "reward": reward,
                    ref.log_fields[1]: prov,
                    ref.log_fields[2]: absd,
                    "soc": soc_pre,
                    "current_charge": charge,
                }
            elif ref.kind == "genset":
                j = ref.slot
                p = params["genset"]
                goal_raw = jnp.asarray(action["genset"][j, 0], dtype)
                energy = jnp.asarray(action["genset"][j, 1], dtype)
                if normalized:
                    energy = p["act_low"][j] + no_fma(p["act_spread"][j] * energy)
                g = physics.round_half_even(goal_raw, xp=jnp).astype(jnp.int32)
                cur, goal_st, up, down = physics.genset_update_status(
                    gs["current_status"][j],
                    gs["goal_status"][j],
                    gs["steps_until_up"][j],
                    gs["steps_until_down"][j],
                    g,
                    jnp.asarray(p["start_up_time"][j], jnp.int32),
                    jnp.asarray(p["wind_down_time"][j], jnp.int32),
                    p["allow_abortion"][j],
                    xp=jnp,
                )
                new_genset["current_status"] = new_genset["current_status"].at[j].set(cur)
                new_genset["goal_status"] = new_genset["goal_status"].at[j].set(goal_st)
                new_genset["steps_until_up"] = new_genset["steps_until_up"].at[j].set(up)
                new_genset["steps_until_down"] = (
                    new_genset["steps_until_down"].at[j].set(down)
                )
                statusf = cur.astype(dtype)
                prov = physics.clip_source(
                    energy,
                    statusf * p["running_min_production"][j],
                    statusf * p["running_max_production"][j],
                    xp=jnp,
                )
                co2 = p["co2_per_unit"][j] * prov
                if ref.custom_fn is not None:
                    fuel = _trace_custom(ref, lambda: jnp.asarray(ref.custom_fn(prov), dtype))
                else:
                    fuel = no_fma(p["genset_cost"][j] * prov)
                reward = -1.0 * (fuel + no_fma(p["cost_per_unit_co2"][j] * co2))
                provided.append(prov)
                rewards.append(reward)
                dones.append(jnp.asarray(False))
                log_vals[(ref.name, ref.num)] = {
                    "reward": reward,
                    "co2_production": co2,
                    ref.log_fields[2]: prov,
                    "current_status": cur.astype(dtype),
                    "goal_status": goal_st.astype(dtype),
                    "steps_until_up": up.astype(dtype),
                    "steps_until_down": down.astype(dtype),
                }
            else:  # grid
                k = ref.slot
                p = params["grid"]
                a = jnp.asarray(action["grid"][k], dtype)
                if normalized:
                    a = p["act_low"][k] + no_fma(p["act_spread"][k] * a)
                row = cur_row("grid", k)                 # (import, export, co2, status)
                status = row[3]
                is_sink = a < 0
                prov = physics.clip_source(a, zero, p["max_import"][k] * status, xp=jnp)
                absd = physics.clip_sink(-a, p["max_export"][k] * status, xp=jnp)
                prov = jnp.where(is_sink, zero, prov)
                absd = jnp.where(is_sink, absd, zero)
                co2 = jnp.where(is_sink, zero, prov * row[2])
                reward_imp = no_fma(-1 * row[0] * prov) + no_fma(
                    -1.0 * p["cost_per_unit_co2"][k] * co2
                )
                reward_exp = row[1] * absd
                reward = jnp.where(is_sink, reward_exp, reward_imp)
                provided.append(prov)
                absorbed.append(absd)
                rewards.append(reward)
                dones.append(ts_done(params, "grid", k, t))
                lv = {
                    "reward": reward,
                    "co2_production": co2,
                    "grid_import": prov,
                    "grid_export": absd,
                    "import_price_current": row[0],
                    "export_price_current": row[1],
                    "co2_per_kwh_current": row[2],
                    "grid_status_current": row[3],
                }
                _log_forecast(lv, ref, log_window(ref))
                log_vals[(ref.name, ref.num)] = lv

        provided_2 = numpy_sum_compat(provided)
        absorbed_2 = numpy_sum_compat(absorbed)
        difference = provided_2 - absorbed_2
        is_excess = difference > 0

        # ---------------------------------------------------- phase 3: flex
        excess = difference
        needed = -difference
        curtailments = []   # (name, value) for shaped rewards
        for ref in spec.flex:
            if ref.kind == "renewable":
                r = ref.slot
                row = cur_row("renewable", r)
                cur = row[0]
                src = jnp.where(cur < needed, cur, needed)
                prov = jnp.where(is_excess, zero, src)
                curtail = cur - prov
                needed = needed - src
                provided.append(prov)
                rewards.append(zero)
                dones.append(ts_done(params, "renewable", r, t))
                lv = {
                    "reward": zero,
                    "curtailment": curtail,
                    ref.log_fields[2]: prov,
                    "renewable_current": cur,
                }
                _log_forecast(lv, ref, log_window(ref))
                log_vals[(ref.name, ref.num)] = lv
                curtailments.append((ref.name, curtail))
            else:  # balancing
                b = ref.slot
                p = params["balancing"]
                absd = jnp.where(is_excess, excess, zero)
                prov = jnp.where(is_excess, zero, needed)
                reward = jnp.where(
                    is_excess,
                    -1.0 * (p["overgeneration_cost"][b] * absd),
                    -1.0 * (p["loss_load_cost"][b] * prov),
                )
                excess = excess + (-absd)
                needed = needed - prov
                provided.append(prov)
                absorbed.append(absd)
                rewards.append(reward)
                dones.append(jnp.asarray(False))
                log_vals[(ref.name, ref.num)] = {
                    "reward": reward,
                    ref.log_fields[1]: prov,
                    ref.log_fields[2]: absd,
                }

        provided_f = numpy_sum_compat(provided)
        absorbed_f = numpy_sum_compat(absorbed)

        reward_total = zero
        for r in rewards:
            reward_total = reward_total + r
        done = jnp.asarray(False)
        for d in dones:
            done = done | d

        shaped = _shaped_reward(spec, reward_total, log_vals, curtailments, jnp)

        # ------------------------------------------------------ advance time
        new_t = t + 1
        key, sub = jax.random.split(state["rng"])
        new_state = {
            "step": new_t,
            "battery_charge": new_battery,
            "genset": new_genset,
            "rng": key,
            "forecast": _forecasts_at(spec, params, new_t, sub),
        }

        obs = _build_obs(
            spec, params, new_state, jnp, dtype, order=obs_order,
            obs_row=None if table_row is None else table_row[row_width:],
        )
        log_row = _build_log_row(
            spec, log_vals, reward_total, shaped,
            provided_f, absorbed_f,
            provided_2 - fixed_provided, absorbed_2 - fixed_absorbed,
            fixed_provided, fixed_absorbed, jnp, dtype,
        )

        return new_state, StepOutput(
            obs=obs,
            reward=reward_total,
            shaped_reward=shaped,
            done=done,
            log_row=log_row,
            provided=provided_f,
            absorbed=absorbed_f,
        )

    return step


def _log_forecast(lv, ref, forecast_slot):
    """Add {component}_forecast_{j} entries from the realized forecast."""
    if ref.forecast_horizon == 0:
        return
    current_fields = [f for f in ref.log_fields if f.endswith("_current")]
    components = [f[: -len("_current")] for f in current_fields]
    for j in range(ref.forecast_horizon):
        for c_idx, comp in enumerate(components):
            lv[f"{comp}_forecast_{j}"] = forecast_slot[j, c_idx]


def _shaped_reward(spec, reward_total, log_vals, curtailments, jnp):
    if spec.shaper is None:
        return reward_total
    if spec.shaper == "pv_curtailment":
        total = 0.0
        for name, curtail in curtailments:
            if name == "pv":
                total = total + curtail
        return -1.0 * total
    if spec.shaper == "battery_discharge":
        def sum_field(name, field):
            total = 0.0
            for (n, num), lv in log_vals.items():
                if n == name and field in lv:
                    total = total + lv[field]
            return total

        battery = sum_field("battery", "discharge_amount")
        load = sum_field("load", "load_met")
        loss = sum_field("unbalanced_energy", "loss_load")
        return jnp.where(load == 0, 0.0, (battery - loss) / jnp.where(load == 0, 1.0, load))
    raise NotImplementedError(spec.shaper)


def ts_obs_part(spec, params, state, ref, jnp, dtype):
    """Normalized observation segment of one ts module at ``state['step']``:
    current row + forecast window (reference
    ``base_timeseries_module.py:90-97``).  Also the row generator for
    :func:`pymgrid_tpu.core.tables.build_tables` — table lookups are
    bitwise-identical to this expression by construction."""
    from jax import lax

    t = state["step"]
    row = lax.dynamic_index_in_dim(
        params[ref.kind]["ts"][ref.slot], t, axis=0, keepdims=False
    ).astype(dtype)
    low = params[ref.kind]["obs_low"][ref.slot]
    spread = params[ref.kind]["obs_spread"][ref.slot]
    vals = [(row - low) / spread]
    if ref.forecast_horizon > 0:
        fc = _realized_forecast(spec, params, state, ref, t)
        vals.append(((fc - low) / spread).reshape(-1))
    return jnp.concatenate([v.reshape(-1) for v in vals])


def _build_obs(spec, params, state, jnp, dtype, order=None, obs_row=None):
    """Assemble the normalized observation at ``state['step']``.

    ``obs_row``, when provided by the step's fused table gather
    (:mod:`pymgrid_tpu.core.tables`), carries the tabulated ts segments;
    otherwise every segment is computed dynamically.
    """
    refs = spec.log_order if order is None else order
    layout = {}
    if obs_row is not None:
        layout, _ = obs_table_layout(spec)

    parts = []
    for ref in refs:
        if ref.kind in ("load", "renewable", "grid"):
            if obs_row is not None and tabulable(spec, ref):
                off, width = layout[(ref.name, ref.num)]
                parts.append(obs_row[off : off + width])
            else:
                parts.append(ts_obs_part(spec, params, state, ref, jnp, dtype))
        elif ref.kind == "battery":
            p = params["battery"]
            charge = state["battery_charge"][ref.slot]
            vec = jnp.stack([charge / p["max_capacity"][ref.slot], charge])
            parts.append(
                (vec - p["obs_low"][ref.slot]) / p["obs_spread"][ref.slot]
            )
        elif ref.kind == "genset":
            p = params["genset"]
            gs = state["genset"]
            vec = jnp.stack(
                [
                    gs["current_status"][ref.slot],
                    gs["goal_status"][ref.slot],
                    gs["steps_until_up"][ref.slot],
                    gs["steps_until_down"][ref.slot],
                ]
            ).astype(dtype)
            parts.append((vec - p["obs_low"][ref.slot]) / p["obs_spread"][ref.slot])
        # balancing: empty state
    if not parts:
        return jnp.zeros((0,), dtype)
    return jnp.concatenate(parts)


def _build_log_row(
    spec, log_vals, reward, shaped, overall_p, overall_a,
    ctrl_p, ctrl_a, fixed_p, fixed_a, jnp, dtype,
):
    vals = []
    for ref in spec.log_order:
        lv = log_vals[(ref.name, ref.num)]
        for field in ref.log_fields:
            vals.append(lv[field])
    vals += [reward, shaped, overall_p, overall_a, ctrl_p, ctrl_a, fixed_p, fixed_a]
    return jnp.stack([jnp.asarray(v, dtype) for v in vals])
