"""Batched on-chip model predictive control.

Receding-horizon MPC where the horizon problem is solved *on the device* for a
whole batch of replicas at once (:mod:`pymgrid_tpu.core.lp`), and the
resulting first-step control feeds the compiled engine — planner and
simulator in one jitted program per step:

    state -> (c, b, h) from HBM time-series windows -> batched interior-point
    LP solve -> first-block controls -> three-phase dispatch -> state'

The LP is the reference MPC's modular formulation (same block matrices as
:class:`pymgrid_tpu.algos.mpc.ModelPredictiveControl`, which this class
reuses as the builder).

**Genset (MILP) support.**  The genset on/off boolean ``u_t`` makes the
horizon problem a MILP (reference ``algos/mpc/mpc.py:85-97``): the genset is
semi-continuous, ``p_t in {0} U [p_min, p_max]``.  On the device this is
solved by exploiting that fixing the status pattern ``u in {0,1}^H`` only
changes the inequality right-hand side ``h`` (cap rows become ``p_max*u``,
dedicated minimum rows become ``-p_min*u``) while the constraint *matrices*
stay shared — so every candidate pattern is one more problem in a batched
IPM solve:

1. solve the LP relaxation (``p in [0, p_max]``, exactly the MILP's natural
   relaxation since ``u`` carries no cost);
2. steps whose relaxed production lands strictly inside ``(0, p_min)`` are
   the fractional decisions; all others are provably optimal to round
   (keeping the relaxed solution feasible at equal cost);
3. enumerate the ``2^k`` on/off patterns over the ``k`` most fractional
   steps (``k = enum_bits``, default 5) around the rounded base pattern and
   solve them *as one batch*; take the cheapest.

When no step is fractional the relaxation is integral and the result is the
exact MILP optimum; otherwise the enumeration bounds the gap by construction
(validated against host HiGHS MILP in ``tests/test_lp_mpc.py``).

Status: float64 solves match HiGHS to ~1e-5 objective.  The batched dense
Cholesky of the normal equations is the hot spot of every solve.

:class:`ProblemTemplate` factors the (c, b, h) assembly so the stochastic
variant (:mod:`pymgrid_tpu.algos.saa_jax`) can drive the same LP from
sampled futures.
"""
import numpy as np

__all__ = ["BatchedMPC", "ProblemTemplate"]


class ProblemTemplate:
    """Static LP structure for one microgrid + assembly from horizon vectors.

    Wraps the host MPC's block matrices; ``assemble`` is traceable and maps
    per-horizon vectors (load, pv, prices, co2, grid status, initial SOC) to
    the LP data ``(c, b, h)``.  For genset configs the inequality system is
    extended with H semi-continuity minimum rows (``-p_t <= -p_min*u_t``)
    whose right-hand sides :meth:`apply_genset_pattern` fills per status
    pattern.
    """

    def __init__(self, microgrid, iters=30, dtype=np.float64, relax_genset=False,
                 matmul_precision="float32", build_solver=True,
                 newton_refine=None, solver_kind="ipm"):
        import jax
        import jax.numpy as jnp
        from scipy import sparse

        from pymgrid_tpu.algos.mpc import ModelPredictiveControl
        from pymgrid_tpu.core.lp import make_batched_ipm_solver
        from pymgrid_tpu.core.spec import extract_spec

        self.host_mpc = ModelPredictiveControl(microgrid)
        self.relax_genset = relax_genset

        self.spec, params, _ = extract_spec(microgrid, dtype=dtype)

        self.params = jax.tree.map(jnp.asarray, params)
        self.horizon = self.host_mpc.horizon
        self.idx = self.host_mpc._idx
        self.block = self.host_mpc._block
        self.rows_per_step = self.host_mpc._rows_per_step
        self.has_genset = self.host_mpc.has_genset
        self.dtype = jnp.dtype(dtype)
        self.costs_static = jnp.asarray(np.asarray(self.host_mpc._costs), dtype)
        self.p_genset_min = float(self.host_mpc.p_genset_min)
        self.p_genset_max = float(self.host_mpc.p_genset_max)

        K_eq = np.asarray(self.host_mpc._A_eq.todense())
        K_in = np.asarray(self.host_mpc._C_ub.todense())
        if self.has_genset:
            # H extra semi-continuity rows: -p_genset_t <= -p_min * u_t
            H, nb = self.horizon, self.block
            min_rows = sparse.lil_matrix((H, K_in.shape[1]))
            for j in range(H):
                min_rows[j, j * nb] = -1.0
            K_in = np.concatenate([K_in, np.asarray(min_rows.todense())], axis=0)
        self.n_in_rows = K_in.shape[0]
        self.matmul_precision = matmul_precision
        # retained for heterogeneous stacking (SuiteMPC builds ONE solver
        # over all scenarios' matrices)
        self.K_eq_np = K_eq
        self.K_in_np = K_in
        self.x_scale_np = self._variable_scales(microgrid)
        self.newton_refine = newton_refine
        if solver_kind == "box":
            # box-structure fast path: 48x48 normal equations + feasibility
            # polish (core/lp.py make_batched_box_ipm_solver)
            from pymgrid_tpu.core.lp import make_batched_box_ipm_solver

            factory = make_batched_box_ipm_solver
        else:
            factory = make_batched_ipm_solver
        self.solver = (
            factory(
                K_eq, K_in, iters=iters, dtype=dtype,
                x_scale=self.x_scale_np,
                newton_refine=newton_refine,
                matmul_precision=matmul_precision,
            )
            if build_solver
            else None
        )

        self.load_ref = next(m for m in self.spec.fixed if m.kind == "load")
        self.pv_ref = next(m for m in self.spec.flex if m.kind == "renewable")
        self.grid_refs = [m for m in self.spec.controllable if m.kind == "grid"]
        self.genset_refs = [m for m in self.spec.controllable if m.kind == "genset"]
        self.battery_ref = next(
            m for m in self.spec.controllable if m.kind == "battery"
        )

    def _variable_scales(self, microgrid):
        """Typical magnitude of each LP variable (per-step block tiled over
        the horizon), for the IPM's static column equilibration: power flows
        scale with their caps, SOC with 1."""
        names = self.host_mpc.microgrid_module_names
        battery = microgrid.modules[names["battery"]].item()
        pv_peak = float(np.abs(
            microgrid.modules[names["renewable"]].item().time_series
        ).max())
        load_peak = float(np.abs(
            microgrid.modules[names["load"]].item().time_series
        ).max())
        if "grid" in names:
            grid = microgrid.modules[names["grid"]].item()
            import_cap, export_cap = grid.max_import, grid.max_export
        else:
            import_cap = export_cap = 0.0

        block = [self.p_genset_max] if self.has_genset else []
        block += [
            import_cap, export_cap,
            battery.max_charge, battery.max_discharge,
            pv_peak, load_peak, 1.0,
        ]
        return np.tile(np.maximum(np.asarray(block, dtype=np.float64), 1.0),
                       self.horizon)

    # ------------------------------------------------------------- assembly
    def grid_windows(self, params, t):
        """(price_import, price_export, co2, limits...) over [t, t+H)."""
        import jax.numpy as jnp
        from jax import lax

        H, dtype = self.horizon, self.dtype
        zero_i = jnp.zeros((), t.dtype)
        if self.grid_refs:
            g = self.grid_refs[0].slot
            grid_win = lax.dynamic_slice(
                params["grid"]["ts"][g], (t, zero_i), (H, 4)
            ).astype(dtype)
            return dict(
                price_imp=grid_win[:, 0],
                price_exp=grid_win[:, 1],
                grid_co2=grid_win[:, 2],
                grid_status_real=grid_win[:, 3],
                p_max_imp=params["grid"]["max_import"][g],
                p_max_exp=params["grid"]["max_export"][g],
                cost_co2=params["grid"]["cost_per_unit_co2"][g],
            )
        zeros = jnp.zeros(H, dtype)
        zero = jnp.asarray(0.0, dtype)
        return dict(
            price_imp=zeros, price_exp=zeros, grid_co2=zeros,
            grid_status_real=jnp.ones(H, dtype),
            p_max_imp=zero, p_max_exp=zero, cost_co2=zero,
        )

    def soc_0(self, params, state):
        pb = params["battery"]
        i = self.battery_ref.slot
        return state["battery_charge"][i] / pb["max_capacity"][i]

    def assemble(self, params, load_vec, pv_vec, grid, grid_status, soc_0):
        """LP data from horizon vectors, in the *relaxed* genset form
        (cap rows at ``p_max``, minimum rows at 0).

        ``load_vec``/``pv_vec``/``grid_status`` are (H,); ``grid`` is the
        dict from :meth:`grid_windows`.
        """
        import jax.numpy as jnp

        H, dtype = self.horizon, self.dtype
        idx, nb, rps = self.idx, self.block, self.rows_per_step

        pb = params["battery"]
        i = self.battery_ref.slot
        e_min = pb["min_soc"][i]
        e_max = jnp.asarray(1.0, dtype)
        p_max_charge = pb["max_charge"][i]
        p_max_discharge = pb["max_discharge"][i]

        b = jnp.zeros(2 * H, dtype).at[:H].set(load_vec - pv_vec).at[H].set(soc_0)

        zero = jnp.asarray(0.0, dtype)
        if self.has_genset:
            per_step = [jnp.asarray(self.p_genset_max, dtype)]
        else:
            per_step = []
        per_step += [e_max, -e_min, p_max_charge, p_max_discharge, zero, zero, zero, zero]
        h = jnp.tile(jnp.stack(per_step), H)
        off = rps - 4
        h = h.at[off::rps].set(grid["p_max_imp"] * grid_status)
        h = h.at[off + 1 :: rps].set(grid["p_max_exp"] * grid_status)
        h = h.at[off + 2 :: rps].set(pv_vec)
        h = h.at[off + 3 :: rps].set(load_vec)
        if self.has_genset:
            # relaxed semi-continuity rows: -p <= 0
            h = jnp.concatenate([h, jnp.zeros(H, dtype)])

        c = self.costs_static
        c = c.at[idx["imp"]::nb].set(
            self.costs_static[idx["imp"]::nb]
            + grid["price_imp"] + grid["grid_co2"] * grid["cost_co2"]
        )
        c = c.at[idx["exp"]::nb].set(
            self.costs_static[idx["exp"]::nb] + grid["price_exp"]
        )
        return c, b, h

    def apply_genset_pattern(self, h, u):
        """Pin the genset status pattern ``u`` (H,) into the rhs ``h``:
        production caps become ``p_max*u``, minimum rows ``-p_min*u``."""
        rps, H = self.rows_per_step, self.horizon
        n_in = rps * H
        u = u.astype(h.dtype)
        h = h.at[0:n_in:rps].set(self.p_genset_max * u)
        h = h.at[n_in:].set(-self.p_genset_min * u)
        return h

    def genset_production(self, x):
        """Per-step genset production (H,) from a solution vector."""
        return x[0 :: self.block]

    def make_candidate_patterns(self, enum_bits):
        """Build ``p_relax (H,) -> (2**k, H)`` status patterns around the
        rounded relaxation.

        The base pattern rounds each step to the *nearer* branch of the
        semi-continuity gap (off below p_min/2, on above) — interior-point
        noise (p ~ 1e-3) must round to off, not on.  The k most ambiguous
        steps (largest distance-to-endpoint score) get enumerated.
        """
        import jax.numpy as jnp
        from jax import lax

        H, dtype = self.horizon, self.dtype
        k_bits = min(enum_bits, H)
        n_combos = 2 ** k_bits
        combo_table = np.array(
            [[(e >> k) & 1 for k in range(k_bits)] for e in range(n_combos)],
            dtype=np.float64,
        )
        p_min = self.p_genset_min
        tol = 1e-7 * max(p_min, 1.0)

        def candidate_patterns(p_relax):
            on_base = (p_relax > 0.5 * p_min).astype(dtype)
            fractional = (p_relax > tol) & (p_relax < p_min - tol)
            score = jnp.where(
                fractional, jnp.minimum(p_relax, p_min - p_relax), -1.0
            )
            _, chosen = lax.top_k(score, k_bits)
            combos = jnp.asarray(combo_table, dtype)
            u_all = jnp.broadcast_to(on_base, (n_combos, H))
            return u_all.at[:, chosen].set(combos)

        return candidate_patterns

    def make_genset_refiner(self, enum_bits=5, enum_chunk=8):
        """Build ``refine(c, b, h) -> (x, u, objective)`` (batched on axis 0):
        solve the LP relaxation, enumerate the ``2^k`` status patterns over
        the ``k`` most fractional steps in batched solves, and return each
        problem's cheapest integral solution.

        ``enum_chunk``: patterns are evaluated ``enum_chunk`` at a time under
        a ``lax.scan`` with only the running best kept in the carry, so the
        compiled program and live memory are independent of ``2^k``, so
        large ``enum_bits`` builds no oversized one-shot program.
        """
        import jax
        import jax.numpy as jnp
        from jax import lax

        H, dtype = self.horizon, self.dtype
        k_bits = min(enum_bits, H)
        n_combos = 2 ** k_bits
        chunk = max(1, min(enum_chunk, n_combos))
        if n_combos % chunk:
            chunk = 1 << (chunk.bit_length() - 1)  # powers of 2 always divide
        n_chunks = n_combos // chunk

        candidate_patterns = self.make_candidate_patterns(enum_bits)

        def refine(c, b, h):
            B = c.shape[0]
            x_rel, _ = self.solver(c, b, h)
            p_rel = jax.vmap(self.genset_production)(x_rel)   # (B, H)
            u_all = jax.vmap(candidate_patterns)(p_rel)       # (B, E, H)

            # (n_chunks, chunk, B, H): scan axis leads
            u_scan = jnp.moveaxis(
                u_all.reshape(B, n_chunks, chunk, H), 0, 2
            ).reshape(n_chunks, chunk, B, H)

            rep = lambda a: jnp.tile(a, (chunk, 1))
            c_rep, b_rep = rep(c), rep(b)

            def eval_chunk(best, u_chunk):
                # u_chunk: (chunk, B, H) -> chunk*B problems in one solve
                h_chunk = jax.vmap(
                    lambda uu: jax.vmap(self.apply_genset_pattern)(h, uu)
                )(u_chunk).reshape(chunk * B, -1)
                x, info = self.solver(c_rep, b_rep, h_chunk)
                x = x.reshape(chunk, B, -1)
                obj = info["objective"].reshape(chunk, B)
                res = info["residual"].reshape(chunk, B)
                # running best per problem
                best_x, best_u, best_obj, best_res = best
                idx = jnp.argmin(obj, axis=0)                  # (B,)
                rows = jnp.arange(B)
                cand = (x[idx, rows], u_chunk[idx, rows], obj[idx, rows],
                        res[idx, rows])
                better = (cand[2] < best_obj)[:, None]
                best = (
                    jnp.where(better, cand[0], best_x),
                    jnp.where(better, cand[1], best_u),
                    jnp.where(better[:, 0], cand[2], best_obj),
                    jnp.where(better[:, 0], cand[3], best_res),
                )
                return best, None

            best0 = (
                jnp.zeros((B, x_rel.shape[1]), dtype),
                jnp.zeros((B, H), dtype),
                jnp.full((B,), jnp.inf, dtype),
                jnp.full((B,), jnp.inf, dtype),
            )
            best, _ = lax.scan(eval_chunk, best0, u_scan)
            return best

        return refine

    def rebalance_first_step(self, params, state, action, load0, pv0,
                             grid_status0):
        """Project the executed first-step controls onto the engine's
        balance manifold.

        The engine charges every unit of step-balance error to the balancing
        module (loss load at 10/unit, overgeneration at 1/unit after free pv
        curtailment), so float32 solver noise in the first-block controls
        leaks real cost on *every* receding-horizon step.  The planner's
        intended production-minus-consumption difference lies in
        ``[-pv0, 0]`` (pv serves the residual for free, curtailment is
        free); this projection clamps the noisy plan back into that band by
        correcting grid, then genset, then battery — each within its true
        bounds — and is a no-op (to solver tolerance) for converged float64
        plans.
        """
        import jax.numpy as jnp

        dtype = self.dtype
        zero = jnp.asarray(0.0, dtype)

        bat_slot = self.battery_ref.slot
        bat = action["battery"][bat_slot]
        genset_p = action["genset"][self.genset_refs[0].slot, 1] if self.has_genset else zero
        genset_u = action["genset"][self.genset_refs[0].slot, 0] if self.has_genset else zero
        grid_diff = action["grid"][self.grid_refs[0].slot] if self.grid_refs else zero

        diff2 = bat + genset_p + grid_diff - load0
        delta = jnp.clip(diff2, -pv0, zero) - diff2   # signed production fix

        if self.grid_refs:
            g = self.grid_refs[0].slot
            lo = -params["grid"]["max_export"][g] * grid_status0
            hi = params["grid"]["max_import"][g] * grid_status0
            new_grid = jnp.clip(grid_diff + delta, lo, hi)
            delta = delta - (new_grid - grid_diff)
            action = {**action, "grid": action["grid"].at[g].set(new_grid)}

        if self.has_genset:
            g = self.genset_refs[0].slot
            new_p = jnp.clip(
                genset_p + delta,
                genset_u * self.p_genset_min,
                genset_u * self.p_genset_max,
            )
            delta = delta - (new_p - genset_p)
            action = {**action, "genset": action["genset"].at[g, 1].set(new_p)}

        pb = params["battery"]
        i = bat_slot
        charge = state["battery_charge"][i]
        eff = pb["efficiency"][i]
        max_prod = jnp.minimum(
            pb["max_discharge"][i], charge - pb["min_capacity"][i]
        ) * eff
        max_cons = jnp.minimum(
            pb["max_charge"][i], pb["max_capacity"][i] - charge
        ) / eff
        new_bat = jnp.clip(bat + delta, -max_cons, jnp.maximum(max_prod, zero))
        action = {**action, "battery": action["battery"].at[i].set(new_bat)}
        return action

    def host_solve(self, c, b, h):
        """HiGHS fallback for one problem (exact LP / genset MILP with the
        same matrices); returns ``(x, u_or_None)`` or ``(None, None)``."""
        host = self.host_mpc
        n_in = self.rows_per_step * self.horizon
        host._c = np.asarray(c, dtype=np.float64)
        host._b_eq = np.asarray(b, dtype=np.float64)
        host._b_ub = np.asarray(h, dtype=np.float64)[:n_in]
        return host._solve()

    def extract_action(self, x, genset_u=None):
        """First-block controls -> engine action arrays."""
        import jax.numpy as jnp

        spec, idx, dtype = self.spec, self.idx, self.dtype
        charge = x[idx["charge"]]
        discharge = x[idx["discharge"]]
        action = {
            "battery": jnp.zeros(spec.n_battery, dtype).at[
                self.battery_ref.slot
            ].set(discharge - charge),
            "genset": jnp.zeros((spec.n_genset, 2), dtype),
            "grid": jnp.zeros(spec.n_grid, dtype),
        }
        if self.grid_refs:
            grid_diff = x[idx["imp"]] - x[idx["exp"]]
            action["grid"] = action["grid"].at[self.grid_refs[0].slot].set(grid_diff)
        if self.has_genset:
            g = self.genset_refs[0].slot
            if genset_u is None:
                status = jnp.round(x[0] > 0).astype(dtype)
            else:
                status = genset_u[0].astype(dtype)
            action["genset"] = (
                action["genset"].at[g, 0].set(status).at[g, 1].set(x[0])
            )
        return action


class BatchedMPC:
    """Receding-horizon MPC batched over replicas, planner on chip.

    ``enum_bits`` bounds the per-step genset MILP enumeration: the ``2^k``
    status patterns over the ``k`` most fractional relaxation steps are
    solved as one extra batched LP solve per step.  ``enum_bits=0`` (or
    ``relax_genset=True``) falls back to rounding the relaxation.
    """

    def __init__(self, microgrid, batch_size=1, iters=30, dtype=np.float64,
                 relax_genset=False, enum_bits=5, enum_chunk=8,
                 host_fallback=True, residual_tol=None, repair_balance=True,
                 outage_aware_repair=False, matmul_precision="float32",
                 newton_refine=None):
        """``host_fallback``: when the on-chip IPM reports a primal residual
        above ``residual_tol`` for a replica, re-solve that replica's problem
        exactly with host HiGHS before acting (graceful degradation; the
        analog of the reference's MOSEK->GLPK fallback, mpc.py:376-399).

        ``repair_balance``: project the executed first-step controls onto
        the engine's balance manifold (grid, then genset, then battery,
        each within bounds) so float32 solver noise cannot leak loss-load /
        overgeneration cost every step.  No-op at float64 tolerance."""
        self.batch_size = batch_size
        self.template = ProblemTemplate(
            microgrid, iters=iters, dtype=dtype, relax_genset=relax_genset,
            matmul_precision=matmul_precision, newton_refine=newton_refine,
        )
        self._host_mpc = self.template.host_mpc
        self.spec = self.template.spec
        self.params = self.template.params
        self.horizon = self.template.horizon
        self._solver = self.template.solver
        self._dtype = self.template.dtype
        self.enum_bits = 0 if relax_genset else enum_bits
        self.enum_chunk = enum_chunk
        self.repair_balance = repair_balance
        self.outage_aware_repair = outage_aware_repair
        self.host_fallback = host_fallback
        self.residual_tol = (
            residual_tol
            if residual_tol is not None
            else (1e-5 if self._dtype == np.float64 else 1e-2)
        )
        self.fallback_count = 0

        self._step_fn = self._build_step()

    # ------------------------------------------------------------------ build
    def _build_step(self):
        import jax
        import jax.numpy as jnp
        from jax import lax

        from pymgrid_tpu.core.engine import make_step_fn

        tpl = self.template
        H = self.horizon
        dtype = self._dtype
        engine_step = make_step_fn(tpl.spec, normalized=False)
        use_enumeration = tpl.has_genset and self.enum_bits > 0
        refine = (
            tpl.make_genset_refiner(enum_bits=self.enum_bits,
                                    enum_chunk=self.enum_chunk)
            if use_enumeration
            else None
        )

        repair = self.repair_balance

        def build_problem(params, state):
            t = state["step"]
            zero_i = jnp.zeros((), t.dtype)
            load_vec = -lax.dynamic_slice(
                params["load"]["ts"][tpl.load_ref.slot], (t, zero_i), (H, 1)
            )[:, 0].astype(dtype)
            pv_vec = lax.dynamic_slice(
                params["renewable"]["ts"][tpl.pv_ref.slot], (t, zero_i), (H, 1)
            )[:, 0].astype(dtype)
            grid = tpl.grid_windows(params, t)
            # modular path uses an always-up grid status over the horizon
            # (reference mpc.py:914)
            grid_status = jnp.ones(H, dtype)
            cbh = tpl.assemble(
                params, load_vec, pv_vec, grid, grid_status, tpl.soc_0(params, state)
            )
            # Step-0 grid status for the balance projection.  Default: the
            # planner's own assumption (always up, reference mpc.py:914) so
            # the projection only removes solver noise and the controller
            # stays comparable to the reference MPC.  ``outage_aware=True``
            # uses the realized status instead — a documented improvement
            # (outage steps re-dispatch to genset/battery instead of
            # becoming loss load).
            if self.outage_aware_repair:
                status0 = grid["grid_status_real"][0]
            else:
                status0 = grid_status[0]
            return cbh, (load_vec[0], pv_vec[0], status0)

        def batched_plan(params, states):
            (c, b, h), step0 = jax.vmap(lambda s: build_problem(params, s))(states)
            if use_enumeration:
                x, u, obj, res = refine(c, b, h)
                actions = jax.vmap(tpl.extract_action)(x, u)
                info = {"objective": obj, "residual": res}
            else:
                x, info = self._solver(c, b, h)
                actions = jax.vmap(tpl.extract_action)(x)
            if repair:
                actions = jax.vmap(
                    lambda s, a, l0, p0, g0: tpl.rebalance_first_step(
                        params, s, a, l0, p0, g0
                    )
                )(states, actions, *step0)
            return actions, info, (c, b, h)

        def batched_act(params, states, actions):
            return jax.vmap(lambda s, a: engine_step(params, s, a))(states, actions)

        self._plan_inner = batched_plan
        self._act_inner = batched_act
        self._plan_fn = jax.jit(batched_plan)
        self._act_fn = jax.jit(batched_act)

        def batched_step(params, states):
            actions, info, cbh = self._plan_fn(params, states)
            if self.host_fallback:
                actions = self._repair_with_host(actions, info, cbh)
            new_states, outs = self._act_fn(params, states, actions)
            return new_states, outs, info

        return batched_step

    def _repair_with_host(self, actions, info, cbh):
        """Re-solve non-converged replicas exactly on the host (HiGHS)."""
        import jax.numpy as jnp

        residual = np.asarray(info["residual"])
        bad = np.flatnonzero(residual > self.residual_tol)
        if bad.size == 0:
            return actions

        tpl = self.template
        c, b, h = (np.asarray(a) for a in cbh)
        for i in bad:
            x, u = tpl.host_solve(c[i], b[i], h[i])
            if x is None:
                continue  # keep the on-chip iterate
            self.fallback_count += 1
            genset_u = jnp.asarray(u, self._dtype) if u is not None else None
            repaired = tpl.extract_action(jnp.asarray(x, self._dtype), genset_u)
            actions = {
                k: v.at[i].set(repaired[k]) for k, v in actions.items()
            }
        return actions

    # -------------------------------------------------------------------- api
    def reset(self, seed=0):
        import jax

        from pymgrid_tpu.core.engine import make_reset_fn

        keys = jax.random.split(jax.random.PRNGKey(seed), self.batch_size)
        reset_fn = make_reset_fn(self.spec)
        return jax.jit(
            lambda p, ks: jax.vmap(reset_fn, in_axes=(None, 0))(p, ks)
        )(self.params, keys)

    def step(self, states):
        """Plan + act for every replica; returns (states, StepOutput, lp_info)."""
        return self._step_fn(self.params, states)

    def run(self, n_steps, seed=0, collect_rewards=True):
        """Receding-horizon MPC for all replicas; returns stacked rewards
        (n_steps, B) and the final states."""
        import numpy as np

        states = self.reset(seed)
        rewards = []
        for _ in range(n_steps):
            states, outs, info = self.step(states)
            if collect_rewards:
                rewards.append(np.asarray(outs.reward))
        return (np.stack(rewards) if collect_rewards else None), states

    def run_scanned(self, n_steps, seed=0, chunk=None):
        """Whole receding-horizon rollout under ``lax.scan``: plan (batched
        LP/MILP solve) + act fused per step, no per-step host dispatch — the
        fast path for full-year tables.  Host fallback is unavailable inside
        the scan (use :meth:`run` for that).

        ``chunk``: split the rollout into fixed-size scan segments compiled
        once and invoked sequentially (default: one execution for all
        ``n_steps``); rewards are fetched to the host after each segment.
        """
        import jax
        import numpy as np
        from jax import lax

        states = self.reset(seed)
        seg = n_steps if chunk is None else min(chunk, n_steps)

        @jax.jit
        def rollout(params, states):
            def body(states, _):
                actions, _, _ = self._plan_inner(params, states)
                new_states, outs = self._act_inner(params, states, actions)
                return new_states, outs.reward

            return lax.scan(body, states, None, length=seg)

        reward_segments = []
        done = 0
        while done < n_steps:
            states, rewards = rollout(self.params, states)
            reward_segments.append(np.asarray(rewards))
            done += seg
        stacked = np.concatenate(reward_segments, axis=0)[:n_steps]
        return stacked, states
