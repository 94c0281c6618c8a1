"""All-25 on-chip MPC: every scenario's receding-horizon controller in ONE
jitted program, year under ``lax.scan``.

``BatchedMPC`` runs one scenario per program.  Here the suite trick
(:mod:`pymgrid_tpu.parallel.suite`: normalize every scenario onto the
superset module structure with neutral genset/grid) is applied to the *LP*:
after normalization all 25 horizon problems share one block structure
(reference ``algos/mpc/mpc.py:231-374``) and differ only in matrix values
(SOC recursions, caps) and right-hand sides, exactly the heterogeneous mode
of :func:`pymgrid_tpu.core.lp.make_batched_ipm_solver` — so each simulated
hour is ONE batched interior-point solve over 25 scenarios (plus one batched
enumeration solve per status-pattern chunk for the genset MILPs), and the
whole year runs as one device-resident scan.

The controller semantics per scenario are identical to
:class:`pymgrid_tpu.algos.mpc_jax.BatchedMPC` (same ``ProblemTemplate``
assembly, MILP enumeration, and first-step balance repair; validated against
it in ``tests/test_mpc_suite.py``).
"""
import numpy as np

__all__ = ["SuiteMPC"]


class SuiteMPC:
    """One-program receding-horizon MPC over heterogeneous scenarios.

    ``enum_bits``/``enum_chunk`` control the genset MILP status-pattern
    enumeration exactly as in :class:`BatchedMPC`; after superset
    normalization every scenario carries a (possibly neutral) genset, and a
    neutral genset's enumeration is a no-op by construction (all candidate
    productions are clamped to its zero capacity).
    """

    def __init__(self, microgrids, iters=30, dtype=np.float32, enum_bits=3,
                 enum_chunk=8, matmul_precision="float32",
                 repair_balance=True, newton_refine=None,
                 solve_mode="triangular", enum_iters=None, enum_refine=0,
                 solver_kind="box", tie_break_eps=None):
        """``enum_iters``/``enum_refine``: fidelity of the MILP
        *enumeration* solves (pattern ranking only needs the objective
        ordering; default ``max(35, iters // 2)`` iterations, no
        refinement).  The winning pattern is re-solved once at full
        ``iters``/``newton_refine`` fidelity before acting, so the executed
        control keeps the sharp-solve quality at a fraction of the
        triangular-solve count (the IPM's per-iteration floor).

        ``tie_break_eps`` (default 0 — an ABLATION option): the storage LP
        has a structurally FLAT optimal face — shifting battery discharge
        between horizon steps that genset/grid serve anyway is cost-free —
        and the host HiGHS simplex lands on an arbitrary vertex while an
        interior-point method converges to the face's center, so
        closed-loop trajectories diverge over 8759 re-plans on the
        degenerate scenarios.  ``eps > 0`` adds a cost bonus on EARLY
        battery discharge (``-eps * (1 - j/H)`` on each discharge_j),
        tilting the face toward a canonical vertex.  HiGHS's vertex choice
        is per-problem pivot luck, so no global tie-break tracks it on every
        scenario; the default is eps=0."""
        import jax
        import jax.numpy as jnp

        from pymgrid_tpu.algos.mpc_jax import ProblemTemplate
        from pymgrid_tpu.core.lp import (
            make_batched_box_ipm_solver,
            make_batched_ipm_solver,
        )
        from pymgrid_tpu.modules import GensetModule
        from pymgrid_tpu.parallel.suite import build_suite, normalize_to_superset

        self.n_scenarios = len(microgrids)
        # a genset-free group needs no neutral-genset slot (and no MILP
        # enumeration at all) — 9x fewer LP solves per step for that group
        self.include_genset = any(
            any(isinstance(m, GensetModule) for m in mg.modules.iterlist())
            for mg in microgrids
        )
        normalized = [
            normalize_to_superset(mg, include_genset=self.include_genset)
            for mg in microgrids
        ]
        self.templates = [
            ProblemTemplate(
                nm, iters=iters, dtype=dtype,
                matmul_precision=matmul_precision, build_solver=False,
            )
            for nm in normalized
        ]
        t0 = self.templates[0]
        for i, t in enumerate(self.templates[1:], 1):
            same = (t.horizon, t.block, t.rows_per_step, t.has_genset,
                    t.n_in_rows) == (t0.horizon, t0.block, t0.rows_per_step,
                                     t0.has_genset, t0.n_in_rows)
            if not same:
                raise ValueError(
                    f"scenario {i} does not share the suite LP structure"
                )
        self.horizon = t0.horizon
        self.dtype = t0.dtype
        self.enum_bits = enum_bits
        self.enum_chunk = enum_chunk
        self.repair_balance = repair_balance
        self.tie_break_eps = float(tie_break_eps or 0.0)
        n0 = self.templates[0].K_eq_np.shape[-1]
        bias = np.zeros((self.n_scenarios, n0), np.float64)
        if self.tie_break_eps:
            H = self.horizon
            for s_i, t in enumerate(self.templates):
                for j in range(H):
                    bias[s_i, t.idx["discharge"] + j * t.block] = -(
                        self.tie_break_eps * (1.0 - j / H)
                    )
        self._tie_bias = jnp.asarray(bias, self.dtype)

        K_eqs = np.stack([t.K_eq_np for t in self.templates])
        K_ins = np.stack([t.K_in_np for t in self.templates])
        x_scales = np.stack([t.x_scale_np for t in self.templates])
        if solver_kind == "box":
            # all pymgrid inequality rows are single-variable bounds -> the
            # 48x48 box-IPM normal equations instead of the slack form's
            # 288x288 (core/lp.py)
            def make(its, refine):
                return make_batched_box_ipm_solver(
                    K_eqs, K_ins, iters=its, dtype=dtype, x_scale=x_scales,
                    newton_refine=refine, matmul_precision=matmul_precision,
                )
        else:
            def make(its, refine):
                return make_batched_ipm_solver(
                    K_eqs, K_ins, iters=its, dtype=dtype, x_scale=x_scales,
                    newton_refine=refine, matmul_precision=matmul_precision,
                    solve_mode=solve_mode,
                )
        self.solver = make(iters, newton_refine)
        if enum_iters is None:
            enum_iters = max(35, iters // 2)
        self.enum_solver = make(enum_iters, enum_refine)

        # one compiled-engine program over the padded suite structure
        self.spec, params = build_suite(
            microgrids, dtype=dtype, include_genset=self.include_genset
        )
        self.params = jax.tree.map(jnp.asarray, params)

        steps = {int(mg.final_step) - int(mg.initial_step)
                 for mg in microgrids}
        if len(steps) != 1:
            raise ValueError(
                f"scenarios disagree on episode length: {sorted(steps)}"
            )
        self.n_steps_year = steps.pop()

        self._build()

    # ------------------------------------------------------------------ build
    def _build(self):
        import jax
        import jax.numpy as jnp
        from jax import lax

        from pymgrid_tpu.core.engine import make_reset_fn, make_step_fn

        S, H, dtype = self.n_scenarios, self.horizon, self.dtype
        tpls = self.templates
        engine_step = make_step_fn(self.spec, normalized=False)
        self._reset_fn = make_reset_fn(self.spec)

        use_enum = tpls[0].has_genset and self.enum_bits > 0
        n_combos = 2 ** min(self.enum_bits, H)
        chunk = max(1, min(self.enum_chunk, n_combos))
        if n_combos % chunk:
            chunk = 1 << (chunk.bit_length() - 1)
        n_chunks = n_combos // chunk
        cand_fns = [t.make_candidate_patterns(self.enum_bits) for t in tpls]

        def slice_cfg(tree_, s):
            return jax.tree.map(lambda x: x[s], tree_)

        def build_problem(tpl, params_s, state_s):
            # per-scenario horizon problem, as BatchedMPC._build_step
            # (mpc_jax.py build_problem; reference mpc.py:898-963)
            t = state_s["step"]
            zero_i = jnp.zeros((), t.dtype)
            load_vec = -lax.dynamic_slice(
                params_s["load"]["ts"][tpl.load_ref.slot], (t, zero_i), (H, 1)
            )[:, 0].astype(dtype)
            pv_vec = lax.dynamic_slice(
                params_s["renewable"]["ts"][tpl.pv_ref.slot], (t, zero_i), (H, 1)
            )[:, 0].astype(dtype)
            grid = tpl.grid_windows(params_s, t)
            # modular path plans with an always-up grid (reference mpc.py:914)
            grid_status = jnp.ones(H, dtype)
            cbh = tpl.assemble(
                params_s, load_vec, pv_vec, grid, grid_status,
                tpl.soc_0(params_s, state_s),
            )
            return cbh, (load_vec[0], pv_vec[0], grid_status[0])

        def refine(c, b, h):
            """Suite-level genset MILP enumeration: the (chunk, S) pattern
            blocks match the heterogeneous solver's (k, S) problem layout,
            so each chunk is one batched solve over chunk*S MILP
            candidates.  Ranking runs on the cheap ``enum_solver``; the
            winning pattern is re-solved at full fidelity."""
            x_rel, _ = self.enum_solver(c, b, h)               # (S, n0)
            u_all = jnp.stack([
                cand_fns[s](tpls[s].genset_production(x_rel[s]))
                for s in range(S)
            ])                                                  # (S, E, H)
            u_scan = jnp.transpose(
                u_all.reshape(S, n_chunks, chunk, H), (1, 2, 0, 3)
            )                                                   # (nc, chunk, S, H)
            c_rep = jnp.tile(c, (chunk, 1))
            b_rep = jnp.tile(b, (chunk, 1))

            def eval_chunk(best, u_chunk):                      # (chunk, S, H)
                h_pat = jnp.stack([
                    jnp.stack([
                        tpls[s].apply_genset_pattern(h[s], u_chunk[k, s])
                        for s in range(S)
                    ])
                    for k in range(chunk)
                ])                                              # (chunk, S, nh)
                x, info = self.enum_solver(
                    c_rep, b_rep, h_pat.reshape(chunk * S, -1)
                )
                x = x.reshape(chunk, S, -1)
                obj = info["objective"].reshape(chunk, S)
                best_x, best_u, best_obj = best
                idx = jnp.argmin(obj, axis=0)
                rows = jnp.arange(S)
                cand = (x[idx, rows], u_chunk[idx, rows], obj[idx, rows])
                better = (cand[2] < best_obj)[:, None]
                best = (
                    jnp.where(better, cand[0], best_x),
                    jnp.where(better, cand[1], best_u),
                    jnp.where(better[:, 0], cand[2], best_obj),
                )
                return best, None

            best0 = (
                jnp.zeros((S, x_rel.shape[1]), dtype),
                jnp.zeros((S, H), dtype),
                jnp.full((S,), jnp.inf, dtype),
            )
            best, _ = lax.scan(eval_chunk, best0, u_scan)
            # accurate re-solve of each scenario's winning pattern
            u_best = best[1]
            h_best = jnp.stack([
                tpls[s].apply_genset_pattern(h[s], u_best[s])
                for s in range(S)
            ])
            x_best, _ = self.solver(c, b, h_best)
            return x_best, u_best

        def plan(params, states):
            per = [
                build_problem(tpls[s], slice_cfg(params, s),
                              slice_cfg(states, s))
                for s in range(S)
            ]
            c = jnp.stack([p[0][0] for p in per])
            b = jnp.stack([p[0][1] for p in per])
            h = jnp.stack([p[0][2] for p in per])
            # flat-face tie-break: prefer the host vertex (discharge early)
            c = c + self._tie_bias
            if use_enum:
                x, u = refine(c, b, h)
                actions = [
                    tpls[s].extract_action(x[s], u[s]) for s in range(S)
                ]
            else:
                x, _ = self.solver(c, b, h)
                actions = [tpls[s].extract_action(x[s]) for s in range(S)]
            if self.repair_balance:
                actions = [
                    tpls[s].rebalance_first_step(
                        slice_cfg(params, s), slice_cfg(states, s),
                        actions[s], *per[s][1],
                    )
                    for s in range(S)
                ]
            return jax.tree.map(lambda *xs: jnp.stack(xs), *actions)

        batched_act = jax.vmap(engine_step, in_axes=(0, 0, 0))

        def step_all(params, states):
            actions = plan(params, states)
            new_states, outs = batched_act(params, states, actions)
            return new_states, outs

        self._step_all = step_all
        self._step_jit = jax.jit(step_all)
        self._scan_cache = {}

    # -------------------------------------------------------------------- api
    def reset(self, seed=0):
        import jax

        keys = jax.random.split(jax.random.PRNGKey(seed), self.n_scenarios)
        return jax.jit(
            jax.vmap(self._reset_fn, in_axes=(0, 0))
        )(self.params, keys)

    def step(self, states):
        """Plan + act for every scenario; returns (states, StepOutput)."""
        return self._step_jit(self.params, states)

    def run_scanned(self, n_steps=None, seed=0, chunk=None, progress=None):
        """Whole suite-year under ``lax.scan``: one device program steps ALL
        scenarios (batched planner + engine act fused per simulated hour).
        ``chunk`` splits the year into fixed-size segments, one device
        execution each (default: one execution for all ``n_steps``).
        ``progress``: optional callable fed one line per finished
        segment."""
        import time as _time

        import jax
        from jax import lax

        n_steps = self.n_steps_year if n_steps is None else n_steps
        states = self.reset(seed)
        seg = n_steps if chunk is None else min(chunk, n_steps)

        rollout = self._scan_cache.get(seg)
        if rollout is None:
            @jax.jit
            def rollout(params, states):
                def body(states, _):
                    states, outs = self._step_all(params, states)
                    return states, outs.reward

                return lax.scan(body, states, None, length=seg)

            self._scan_cache[seg] = rollout

        segments, done = [], 0
        while done < n_steps:
            t0 = _time.time()
            states, rewards = rollout(self.params, states)
            segments.append(np.asarray(rewards))
            done += seg
            if progress is not None:
                progress(
                    f"steps {min(done, n_steps)}/{n_steps} "
                    f"(segment {_time.time() - t0:.1f}s)"
                )
        stacked = np.concatenate(segments, axis=0)[:n_steps]   # (T, S)
        return stacked, states
