"""On-chip sample-average-approximation stochastic MPC.

The on-device counterpart of :class:`pymgrid_tpu.algos.saa.
SampleAverageApproximation` (reference ``algos/saa/saa.py``): at every step,
N sampled futures each define one horizon LP; all N LPs solve in a single
batched interior-point program on the chip, the output at the
``optimal_percentile`` of horizon cost is selected (reference
``determine_optimal_actions``, saa.py:82-110: sorted index
``floor(N * percentile)``), and its first-step control drives the compiled
engine on the *real* data.

Where the reference loops N cvxpy solves per step on the CPU (hours for a
year), here the per-step work is one ``(N, n_var)`` batched LP solve plus a
top-k select — a single fused XLA program.  Sampling (parabolic PV
interpolation, gaussian load noise, Markov-chain outages) reuses the host
:class:`~pymgrid_tpu.utils.data_generator.SampleGenerator` machinery at
construction time; the sampled series then live in HBM.

Semantics mirrored from the reference:

* the current row of every sample is replaced by the realized data before
  solving (saa.py:128 — ``sample.iloc[j] = underlying_data.iloc[j]``);
* ranking is by horizon objective; the reference ranks by
  ``HorizonOutput.compute_cost_over_horizon`` (loss-load + fuel + net import
  cost), we rank by the LP objective, which adds the co2 and battery-cycle
  terms the LP also plans with;
* the sampled grid-status series scales the import/export bounds over the
  horizon (the nonmodular reference path does the same via
  ``_nonmodular_state_values``; set ``use_sampled_grid_status=False`` for
  the modular always-up convention).
"""
import numpy as np

__all__ = ["BatchedSAA"]


class BatchedSAA:
    """Stochastic MPC with all sample-LPs batched on chip.

    Parameters
    ----------
    microgrid : Microgrid
        Modular microgrid.  Genset configs solve each sample's horizon MILP
        via LP relaxation + batched status-pattern enumeration
        (``enum_bits``; see :meth:`ProblemTemplate.make_genset_refiner`).
    n_samples : int, default 10
        Sampled futures per step (the LP batch dimension).
    optimal_percentile : float, default 0.5
        Percentile of horizon cost whose plan is executed.
    forecast_args : dict, optional
        Passed to the host :class:`SampleGenerator` (MAPE presets etc.).
    sampling_args : dict, optional
        Passed to ``sample_from_forecasts``.
    """

    def __init__(self, microgrid, n_samples=10, optimal_percentile=0.5,
                 iters=30, dtype=np.float64, relax_genset=False,
                 forecast_args=None, sampling_args=None, samples=None,
                 preset_to_use=None, enum_bits=5, enum_chunk=8,
                 matmul_precision="float32", newton_refine=None,
                 solver_kind="ipm"):
        import jax
        import jax.numpy as jnp

        from pymgrid_tpu.algos.mpc_jax import ProblemTemplate

        if not 0.0 <= optimal_percentile <= 1.0:
            raise ValueError("percentile must be in [0,1]")

        self.n_samples = n_samples
        self.optimal_percentile = optimal_percentile
        self.enum_bits = 0 if relax_genset else enum_bits
        self.enum_chunk = enum_chunk
        self.template = ProblemTemplate(
            microgrid, iters=iters, dtype=dtype, relax_genset=relax_genset,
            matmul_precision=matmul_precision, newton_refine=newton_refine,
            solver_kind=solver_kind,
        )
        self.spec = self.template.spec
        self.params = self.template.params
        self.horizon = self.template.horizon
        self._dtype = self.template.dtype

        if samples is None:
            samples = self._generate_samples(
                microgrid, n_samples, forecast_args, sampling_args, preset_to_use
            )
        # (N, T) sampled pv/load/grid-status series in HBM
        self.sample_pv = jnp.asarray(
            np.stack([np.asarray(s["pv"], dtype=dtype).reshape(-1) for s in samples])
        )
        self.sample_load = jnp.asarray(
            np.stack([np.asarray(s["load"], dtype=dtype).reshape(-1) for s in samples])
        )
        self.sample_grid = jnp.asarray(
            np.stack([np.asarray(s["grid"], dtype=dtype).reshape(-1) for s in samples])
        )
        self.sample_length = int(self.sample_pv.shape[1])

        self._step_fn = self._build_step()

    @staticmethod
    def _generate_samples(microgrid, n_samples, forecast_args, sampling_args,
                          preset_to_use):
        """Host-side sampling via the legacy generators (construction-time)."""
        from pymgrid_tpu.utils.data_generator import SampleGenerator

        nonmodular = microgrid.to_nonmodular()
        forecast_args = dict(forecast_args or {})
        if preset_to_use is not None:
            forecast_args["preset_to_use"] = preset_to_use
        gen = SampleGenerator(nonmodular, **forecast_args)
        return gen.sample_from_forecasts(n_samples=n_samples,
                                         **(sampling_args or {}))

    # ------------------------------------------------------------------ build
    def _build_step(self):
        import jax
        import jax.numpy as jnp
        from jax import lax

        from pymgrid_tpu.core.engine import make_step_fn

        tpl = self.template
        H = self.horizon
        N = self.n_samples
        dtype = self._dtype
        engine_step = make_step_fn(tpl.spec, normalized=False)
        # reference saa.py:96-99: sorted-cost index floor(N * percentile)
        k = min(int(np.floor(N * self.optimal_percentile)), N - 1)

        def sample_problem(params, state, pv_row, load_row, status_row):
            """LP for one sampled future; row 0 realized (saa.py:128)."""
            t = state["step"]
            zero_i = jnp.zeros((), t.dtype)
            real_load = -lax.dynamic_slice(
                params["load"]["ts"][tpl.load_ref.slot], (t, zero_i), (1, 1)
            )[0, 0].astype(dtype)
            real_pv = lax.dynamic_slice(
                params["renewable"]["ts"][tpl.pv_ref.slot], (t, zero_i), (1, 1)
            )[0, 0].astype(dtype)

            load_vec = lax.dynamic_slice(load_row, (t,), (H,)).at[0].set(real_load)
            pv_vec = lax.dynamic_slice(pv_row, (t,), (H,)).at[0].set(real_pv)

            grid = tpl.grid_windows(params, t)
            status = lax.dynamic_slice(status_row, (t,), (H,)).at[0].set(
                grid["grid_status_real"][0]
            )
            return tpl.assemble(
                params, load_vec, pv_vec, grid, status, tpl.soc_0(params, state)
            )

        use_enumeration = tpl.has_genset and self.enum_bits > 0
        refine = (
            tpl.make_genset_refiner(enum_bits=self.enum_bits,
                                    enum_chunk=self.enum_chunk)
            if use_enumeration
            else None
        )

        self._engine_step = engine_step

        def step(params, state, pv_s, load_s, grid_s):
            c, b, h = jax.vmap(
                lambda p, l, g: sample_problem(params, state, p, l, g)
            )(pv_s, load_s, grid_s)
            if use_enumeration:
                # every sample's horizon MILP: relaxation + pattern
                # enumeration, all N*2^k problems in two batched solves
                x, u, costs, _ = refine(c, b, h)
                chosen = jnp.argsort(costs)[k]
                action = tpl.extract_action(x[chosen], u[chosen])
            else:
                x, info = tpl.solver(c, b, h)           # (N, n_var)
                costs = jnp.sum(c * x, axis=1)          # horizon objectives
                chosen = jnp.argsort(costs)[k]
                action = tpl.extract_action(x[chosen])
            new_state, out = engine_step(params, state, action)
            return new_state, out, costs, chosen

        self._step_inner = step
        return jax.jit(step)

    # -------------------------------------------------------------------- api
    def reset(self, seed=0):
        import jax

        from pymgrid_tpu.core.engine import make_reset_fn

        key = jax.random.PRNGKey(seed)
        return jax.jit(make_reset_fn(self.spec))(self.params, key)

    def step(self, state):
        """Sample-plan-act once; returns (state', StepOutput, sample_costs,
        chosen_index)."""
        return self._step_fn(
            self.params, state, self.sample_pv, self.sample_load, self.sample_grid
        )

    def run(self, n_steps=None, seed=0, verbose=False):
        """Receding-horizon stochastic MPC on the real trajectory.

        Returns (rewards, final_state); total cost is ``-rewards.sum()``.
        """
        max_steps = self.sample_length - self.horizon
        n_steps = max_steps if n_steps is None else min(n_steps, max_steps)

        state = self.reset(seed)
        rewards = []
        for t in range(n_steps):
            state, out, costs, chosen = self.step(state)
            rewards.append(out.reward)  # device arrays; fetched once at the end
            if verbose and t % max(1, n_steps // 20) == 0:
                print(f"SAA step {t}/{n_steps} reward {float(out.reward):.2f} "
                      f"(chose sample {int(chosen)})")
        return np.asarray(rewards, dtype=np.float64), state

    def run_scanned(self, n_steps=None, seed=0, chunk=None):
        """Whole stochastic-MPC year under ``lax.scan`` (sample solves +
        percentile pick + engine step fused per scan iteration).  ``chunk``
        splits it into fixed-size segments, one device execution each
        (default: one execution for all ``n_steps``)."""
        import jax
        from jax import lax

        max_steps = self.sample_length - self.horizon
        n_steps = max_steps if n_steps is None else min(n_steps, max_steps)
        seg = n_steps if chunk is None else min(chunk, n_steps)

        state = self.reset(seed)

        @jax.jit
        def rollout(params, state, pv_s, load_s, grid_s):
            def body(state, _):
                new_state, out, _, _ = self._step_inner(
                    params, state, pv_s, load_s, grid_s
                )
                return new_state, out.reward

            return lax.scan(body, state, None, length=seg)

        reward_segments = []
        done = 0
        while done < n_steps:
            state, rewards = rollout(
                self.params, state, self.sample_pv, self.sample_load, self.sample_grid
            )
            reward_segments.append(np.asarray(rewards, dtype=np.float64))
            done += seg
        stacked = np.concatenate(reward_segments, axis=0)[:n_steps]
        return stacked, state
