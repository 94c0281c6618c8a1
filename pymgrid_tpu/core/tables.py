"""Precomputed step-index tables: the fast path for t-dependent values.

Everything the engine reads per step that depends only on the step index
``t`` — raw current time-series rows, and the full normalized observation
segment of every deterministic-forecast module (current row + forecast
window, reference ``base_timeseries_module.py:90-97``) — is tabulated once
at construction into two HBM-resident tables:

* ``row_table``  ``(T, R)`` — raw current rows of every ts module,
* ``obs_table``  ``(T, D)`` — normalized ts observation segments.

The per-replica step then performs ONE lane-rich row gather per table
instead of ~30 per-module ``dynamic_slice`` ops with 1- or 4-wide minor
dimensions: a vmapped gather with a tiny minor dimension moves little
data per index, while an embedding-style row gather from a ``(T, ~128)``
table reads whole rows.

Bitwise parity is guaranteed by construction: each table row is computed
by the *engine's own* observation/row code (vmapped over ``arange(T)``),
so the gathered value is the identical float sequence the untabulated
path would produce.  A module is tabulable unless its forecast draws
runtime noise from the jax PRNG (``GaussianNoiseForecaster`` with
``numpy_rng_noise=False``); non-tabulable modules keep the dynamic path.
"""
import numpy as np

__all__ = [
    "tabulable",
    "row_table_layout",
    "obs_table_layout",
    "logfc_table_layout",
    "build_tables",
    "ensure_tables",
]


def tabulable(spec, ref):
    """Whether ``ref``'s observation segment is a pure function of t."""
    if ref.kind not in ("load", "renewable", "grid"):
        return False
    return ref.forecaster != "gaussian" or spec.numpy_noise


def row_table_layout(spec):
    """Static column layout of ``row_table``: {(kind, slot): (offset, width)}."""
    layout, offset = {}, 0
    for kind, n, width in (
        ("load", spec.n_load, 1),
        ("renewable", spec.n_renewable, 1),
        ("grid", spec.n_grid, 4),
    ):
        for slot in range(n):
            layout[(kind, slot)] = (offset, width)
            offset += width
    return layout, offset


def obs_table_layout(spec):
    """Static column layout of ``obs_table``:
    {(name, num): (offset, width)} over tabulable ts refs in log order."""
    layout, offset = {}, 0
    for ref in spec.log_order:
        if tabulable(spec, ref):
            layout[(ref.name, ref.num)] = (offset, ref.obs_dim)
            offset += ref.obs_dim
    return layout, offset


def logfc_table_layout(spec):
    """Static column layout of the raw log-forecast segment:
    {(name, num): (offset, width=h*f)} over tabulable ts refs with a
    forecast horizon.  These are the UNNORMALIZED realized forecast windows
    logged per step (``{comp}_forecast_j`` fields) — without tabulation
    every materialized log row pays one per-replica window gather per
    forecasting module."""
    layout, offset = {}, 0
    for ref in spec.log_order:
        if tabulable(spec, ref) and ref.forecast_horizon > 0:
            width = ref.forecast_horizon * ref.n_features
            layout[(ref.name, ref.num)] = (offset, width)
            offset += width
    return layout, offset


def _table_length(params):
    lengths = [
        params[k]["ts"].shape[-2]
        for k in ("load", "renewable", "grid")
        if params[k]["ts"].shape[-3]
    ]
    return max(lengths) if lengths else 0


def build_tables(spec, params, config_axis=False):
    """Compute ``{"row_table": (T, R), "obs_table": (T, D)}`` for ``params``.

    Rows are produced by the engine's own per-step expressions vmapped over
    the step index, so table lookups are bitwise-identical to the dynamic
    path.  ``params`` stays a runtime argument of the jitted builder (the
    engine's reciprocal-folding rule, see ``core/rollout.py``).

    With ``config_axis=True``, every leaf of ``params`` carries a leading
    config axis (suite batching, :mod:`pymgrid_tpu.parallel.suite`) and the
    tables come back as ``(n_configs, T, ...)`` — one compile serves all
    configs.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from pymgrid_tpu.core import engine as eng

    dtype = jnp.dtype(spec.dtype)
    T = _table_length(params)
    row_layout, row_width = row_table_layout(spec)
    obs_layout, obs_width = obs_table_layout(spec)
    _, logfc_width = logfc_table_layout(spec)

    def row_at(params, t):
        parts = []
        for kind in ("load", "renewable", "grid"):
            n = {"load": spec.n_load, "renewable": spec.n_renewable,
                 "grid": spec.n_grid}[kind]
            for slot in range(n):
                parts.append(
                    lax.dynamic_index_in_dim(
                        params[kind]["ts"][slot], t, axis=0, keepdims=False
                    ).astype(dtype)
                )
        if not parts:
            return jnp.zeros((0,), dtype)
        return jnp.concatenate(parts)

    def obs_at(params, t):
        state = {"step": t}
        parts = []
        for ref in spec.log_order:
            if tabulable(spec, ref):
                parts.append(
                    eng.ts_obs_part(spec, params, state, ref, jnp, dtype)
                )
        if not parts:
            return jnp.zeros((0,), dtype)
        return jnp.concatenate(parts)

    def logfc_at(params, t):
        state = {"step": t}
        parts = []
        for ref in spec.log_order:
            if tabulable(spec, ref) and ref.forecast_horizon > 0:
                window = eng._realized_forecast(spec, params, state, ref, t)
                parts.append(window.reshape(-1))
        if not parts:
            return jnp.zeros((0,), dtype)
        return jnp.concatenate(parts)

    if T == 0:
        width = row_width + obs_width
        shape = (1, width) if not config_axis else (1, 1, width)
        lshape = (1, logfc_width) if not config_axis else (1, 1, logfc_width)
        return {"step_table": jnp.zeros(shape, dtype),
                "logfc_table": jnp.zeros(lshape, dtype)}

    ts_idx = jnp.arange(T, dtype=jnp.int32)
    tables = {}
    for name, fn in (
        ("row_table", row_at),
        ("obs_table", obs_at),
        ("logfc_table", logfc_at),
    ):
        over_t = jax.vmap(fn, in_axes=(None, 0))
        if config_axis:
            over_t = jax.vmap(over_t, in_axes=(0, None))
        tables[name] = jax.jit(over_t)(params, ts_idx)

    # The CORE table: row t = [raw rows at t | normalized obs at t+1].
    # The engine consumes observations only at new_t = t + 1, so shifting
    # the obs columns lets a SINGLE per-replica gather at t serve the
    # policy's current rows AND the step's outgoing observation; the final
    # obs row repeats (matching the dynamic path's index clamping).  The
    # raw log-forecast windows live in their OWN table: rewards-only
    # programs DCE that gather away entirely (fused in, it was ~40% of the
    # per-step gather traffic — the dominant cost of a suite rollout).
    obs = tables["obs_table"]
    shifted = jnp.concatenate([obs[..., 1:, :], obs[..., -1:, :]], axis=-2)
    step_table = jnp.concatenate(
        [tables["row_table"], shifted], axis=-1
    )
    return {"step_table": step_table, "logfc_table": tables["logfc_table"]}


def ensure_tables(spec, params, config_axis=False):
    """Return ``params`` with step-index tables attached (idempotent)."""
    if "step_table" in params:
        return params
    out = dict(params)
    out.update(build_tables(spec, params, config_axis=config_axis))
    return out
