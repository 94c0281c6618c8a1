"""Batched on-chip LP solving and MPC."""
import numpy as np
import pytest
from scipy.optimize import linprog

import pymgrid_tpu
from pymgrid_tpu.algos import ModelPredictiveControl
from pymgrid_tpu.core.lp import make_batched_ipm_solver, make_batched_lp_solver


def _random_lps(B=6, n=30, me=8, mi=20, seed=0):
    rng = np.random.RandomState(seed)
    K_eq = rng.randn(me, n)
    K_in = rng.randn(mi, n)
    x_feas = np.abs(rng.randn(B, n))
    b = x_feas @ K_eq.T
    h = x_feas @ K_in.T + np.abs(rng.randn(B, mi))
    c = np.abs(rng.randn(B, n))
    return K_eq, K_in, c, b, h


def test_ipm_matches_highs_random():
    K_eq, K_in, c, b, h = _random_lps()
    solver = make_batched_ipm_solver(K_eq, K_in, iters=30, dtype=np.float64)
    x, info = solver(c, b, h)
    for i in range(c.shape[0]):
        ref = linprog(
            c[i], A_ub=K_in, b_ub=h[i], A_eq=K_eq, b_eq=b[i],
            bounds=(0, None), method="highs",
        )
        rel = abs(float(info["objective"][i]) - ref.fun) / max(1.0, abs(ref.fun))
        assert rel < 1e-5, f"problem {i}: rel={rel}"


def test_pdhg_matches_highs_random():
    K_eq, K_in, c, b, h = _random_lps(seed=3)
    solver = make_batched_lp_solver(K_eq, K_in, iters=20000, restart_every=20000,
                                    dtype=np.float64)
    x, info = solver(c, b, h)
    for i in range(c.shape[0]):
        ref = linprog(
            c[i], A_ub=K_in, b_ub=h[i], A_eq=K_eq, b_eq=b[i],
            bounds=(0, None), method="highs",
        )
        rel = abs(float(info["objective"][i]) - ref.fun) / max(1.0, abs(ref.fun))
        assert rel < 1e-3, f"problem {i}: rel={rel}"


def test_ipm_on_mpc_problem():
    mg = pymgrid_tpu.Microgrid.from_scenario(0)
    host = ModelPredictiveControl(mg)
    host.microgrid.reset()
    host._set_parameters(*host._get_modular_state_values())
    K_eq = np.asarray(host._A_eq.todense())
    K_in = np.asarray(host._C_ub.todense())
    solver = make_batched_ipm_solver(K_eq, K_in, iters=30, dtype=np.float64)
    x, info = solver(host._c[None], host._b_eq[None], host._b_ub[None])
    ref = linprog(
        host._c, A_ub=host._C_ub, b_ub=host._b_ub,
        A_eq=host._A_eq, b_eq=host._b_eq, bounds=(0, None), method="highs",
    )
    rel = abs(float(info["objective"][0]) - ref.fun) / abs(ref.fun)
    assert rel < 1e-4


def test_batched_mpc_rollout_close_to_host():
    from pymgrid_tpu.algos.mpc_jax import BatchedMPC

    mg = pymgrid_tpu.Microgrid.from_scenario(0)
    host_log = ModelPredictiveControl(mg).run(max_steps=24)
    host_cost = -host_log[("balance", 0, "reward")].sum()

    bm = BatchedMPC(pymgrid_tpu.Microgrid.from_scenario(0), batch_size=3,
                    dtype=np.float64)
    rewards, states = bm.run(24)
    chip_cost = -rewards[:, 0].sum()
    assert abs(chip_cost - host_cost) / abs(host_cost) < 1e-4
    # replicas are deterministic copies
    np.testing.assert_array_equal(rewards[:, 0], rewards[:, 1])


def test_batched_mpc_genset_milp_matches_host():
    """On-chip genset MPC (relaxation + batched pattern enumeration) tracks
    the host HiGHS MILP over a 24-step receding-horizon rollout.  Scenario 1
    is the genset + weak-grid benchmark config."""
    from pymgrid_tpu.algos.mpc_jax import BatchedMPC

    mg = pymgrid_tpu.Microgrid.from_scenario(1)
    host_log = ModelPredictiveControl(mg).run(max_steps=24)
    host_cost = -host_log[("balance", 0, "reward")].sum()

    bm = BatchedMPC(pymgrid_tpu.Microgrid.from_scenario(1), batch_size=1,
                    dtype=np.float64)
    rewards, _ = bm.run(24)
    chip_cost = -rewards[:, 0].sum()
    assert abs(chip_cost - host_cost) / abs(host_cost) < 1e-4


def test_batched_mpc_genset_single_solve_matches_milp():
    """First-horizon genset MILP objective: on-chip enumeration vs HiGHS."""
    from pymgrid_tpu.algos.mpc_jax import BatchedMPC

    mg = pymgrid_tpu.Microgrid.from_scenario(1)
    host = ModelPredictiveControl(mg)
    host.microgrid.reset()
    host._set_parameters(*host._get_modular_state_values())
    p_vars, u = host._solve()
    host_obj = float(host._c @ p_vars)

    bm = BatchedMPC(pymgrid_tpu.Microgrid.from_scenario(1), batch_size=1,
                    dtype=np.float64)
    states = bm.reset()
    _, _, info = bm.step(states)
    chip_obj = float(info["objective"][0])
    assert abs(chip_obj - host_obj) / max(1.0, abs(host_obj)) < 1e-4


def test_batched_saa_degenerate_equals_mpc():
    """With every sample equal to the real data, on-chip SAA reduces to
    deterministic on-chip MPC (same LP, any percentile)."""
    import warnings

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos.mpc_jax import BatchedMPC
    from pymgrid_tpu.algos.saa_jax import BatchedSAA
    from pymgrid_tpu.utils.data_generator import return_underlying_data

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mg = Microgrid.from_scenario(0)
        real = return_underlying_data(mg.to_nonmodular())
        saa = BatchedSAA(mg, n_samples=3, optimal_percentile=1.0,
                         samples=[real.copy() for _ in range(3)])
        mpc = BatchedMPC(mg, batch_size=1)

    r_saa, _ = saa.run(n_steps=10)
    r_mpc, _ = mpc.run(10)
    # both solve the same degenerate LP; IPM iterates differ at solver
    # tolerance (~1e-7 relative) between the two assembly paths
    np.testing.assert_allclose(r_saa, r_mpc[:, 0], rtol=1e-5, atol=1e-8)


def test_batched_saa_stochastic():
    """Sampled futures: runs, selects in-range samples, finite rewards."""
    import warnings

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos.saa_jax import BatchedSAA

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mg = Microgrid.from_scenario(0)
        saa = BatchedSAA(mg, n_samples=4, optimal_percentile=0.5,
                         preset_to_use=85)

    state = saa.reset(seed=0)
    for _ in range(5):
        state, out, costs, chosen = saa.step(state)
        assert costs.shape == (4,)
        assert 0 <= int(chosen) < 4
        assert np.isfinite(float(out.reward))
        # median-of-4 rule: floor(4*0.5)=2 -> third-cheapest plan
        assert float(costs[chosen]) == float(np.sort(np.asarray(costs))[2])

    with pytest.raises(ValueError):
        BatchedSAA(mg, optimal_percentile=1.5)


def test_batched_saa_genset():
    """Genset configs: each sample's horizon MILP refines on chip."""
    import warnings

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos.saa_jax import BatchedSAA

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mg = Microgrid.from_scenario(1)
        saa = BatchedSAA(mg, n_samples=3, optimal_percentile=0.85,
                         preset_to_use=85, enum_bits=3)

    state = saa.reset(seed=0)
    for _ in range(3):
        state, out, costs, chosen = saa.step(state)
        assert costs.shape == (3,)
        assert np.isfinite(float(out.reward))


def test_batched_mpc_host_fallback_on_bad_iterates():
    """Starve the IPM (2 iterations) so residuals blow past tolerance: every
    replica must fall back to an exact host HiGHS solve, and the trajectory
    must match a fully-converged run."""
    from pymgrid_tpu.algos.mpc_jax import BatchedMPC

    good = BatchedMPC(pymgrid_tpu.Microgrid.from_scenario(0), batch_size=1,
                      dtype=np.float64)
    starved = BatchedMPC(pymgrid_tpu.Microgrid.from_scenario(0), batch_size=1,
                         dtype=np.float64, iters=2, residual_tol=1e-5)

    r_good, _ = good.run(5)
    r_starved, _ = starved.run(5)
    assert starved.fallback_count >= 5  # every step repaired on host
    # HiGHS picks simplex vertices, the IPM analytic centers: on degenerate
    # optimal faces the realized per-step rewards differ slightly while both
    # plans are optimal — compare trajectories loosely and totals tightly
    np.testing.assert_allclose(r_starved[:, 0], r_good[:, 0], rtol=1e-3)
    assert abs(r_starved.sum() - r_good.sum()) / abs(r_good.sum()) < 1e-4


def test_mpc_use_previous_controls_on_solver_failure():
    """Modular host MPC degrades to the previous plan when a solve fails
    (reference mpc.py:647-661)."""
    mg = pymgrid_tpu.Microgrid.from_scenario(0)
    mpc = ModelPredictiveControl(mg)

    original_solve = mpc._solve
    calls = {"n": 0}

    def flaky_solve():
        calls["n"] += 1
        if calls["n"] == 3:
            return None, None  # simulated solver failure
        return original_solve()

    mpc._solve = flaky_solve
    log = mpc.run(max_steps=5)
    assert len(log) == 5  # the failed step was bridged, not fatal


def test_run_scanned_matches_stepwise():
    """run_scanned (incl. chunked segments) == the python-loop run path."""
    from pymgrid_tpu.algos.mpc_jax import BatchedMPC

    bm = BatchedMPC(pymgrid_tpu.Microgrid.from_scenario(0), batch_size=1,
                    dtype=np.float64, host_fallback=False)
    r_loop, _ = bm.run(10)
    r_scan, _ = bm.run_scanned(10)
    r_chunked, _ = bm.run_scanned(10, chunk=4)

    np.testing.assert_allclose(r_scan[:, 0], r_loop[:, 0], rtol=1e-12)
    np.testing.assert_allclose(r_chunked[:, 0], r_loop[:, 0], rtol=1e-12)


def test_genset_refiner_chunking_invariant():
    """Chunked enumeration (lax.scan over pattern chunks, running-best
    carry) returns the same solution as one-shot enumeration."""
    import jax.numpy as jnp

    from pymgrid_tpu.algos.mpc_jax import ProblemTemplate

    tpl = ProblemTemplate(pymgrid_tpu.Microgrid.from_scenario(1),
                          dtype=np.float64)
    refine_one = tpl.make_genset_refiner(enum_bits=4, enum_chunk=16)
    refine_chunked = tpl.make_genset_refiner(enum_bits=4, enum_chunk=4)

    from pymgrid_tpu.core.engine import make_reset_fn
    import jax

    reset_fn = jax.jit(make_reset_fn(tpl.spec))
    state = reset_fn(tpl.params, jax.random.PRNGKey(0))

    H = tpl.horizon
    t = state["step"]
    zero_i = jnp.zeros((), t.dtype)
    load_vec = -jax.lax.dynamic_slice(
        tpl.params["load"]["ts"][tpl.load_ref.slot], (t, zero_i), (H, 1)
    )[:, 0]
    pv_vec = jax.lax.dynamic_slice(
        tpl.params["renewable"]["ts"][tpl.pv_ref.slot], (t, zero_i), (H, 1)
    )[:, 0]
    grid = tpl.grid_windows(tpl.params, t)
    c, b, h = tpl.assemble(tpl.params, load_vec, pv_vec, grid,
                           jnp.ones(H, np.float64), tpl.soc_0(tpl.params, state))
    c, b, h = c[None], b[None], h[None]

    x1, u1, obj1, res1 = refine_one(c, b, h)
    x2, u2, obj2, res2 = refine_chunked(c, b, h)
    np.testing.assert_allclose(np.asarray(obj1), np.asarray(obj2), rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), rtol=1e-8,
                               atol=1e-10)


def test_ipm_matmul_precision_variants():
    """The matmul_precision knob is accepted and, on CPU (where every
    precision lowers to the same f32/f64 math), solves to the same
    tolerance as the float32 default."""
    K_eq, K_in, c, b, h = _random_lps()
    for prec in ("tensorfloat32", "bfloat16"):
        solver = make_batched_ipm_solver(
            K_eq, K_in, iters=30, dtype=np.float64, matmul_precision=prec
        )
        x, info = solver(c, b, h)
        ref = linprog(
            c[0], A_ub=K_in, b_ub=h[0], A_eq=K_eq, b_eq=b[0],
            bounds=(0, None), method="highs",
        )
        rel = abs(float(info["objective"][0]) - ref.fun) / max(1.0, abs(ref.fun))
        assert rel < 1e-5, f"{prec}: rel={rel}"


def test_box_ipm_pins_degenerate_variables():
    """A variable whose box collapses (hi == lo, e.g. genset-off
    semi-continuity) must be PINNED: before the core/lp.py fix the clamped
    interior start (s0, t0 >= 1e-2) handed it a phantom ~2e-2-wide box the
    s/t update invariant preserved, so "solutions" carried free energy in
    the fixed variable, objectives undershot the true optimum, and
    infeasible genset patterns won the MILP enumeration (scenario 8)."""
    from pymgrid_tpu.core.lp import make_batched_box_ipm_solver

    # min x0 + 2 x1  s.t.  x0 + x1 = 10,  x0 <= u0 (varies), x1 <= 20
    K_eq = np.array([[1.0, 1.0]])
    K_in = np.array([[1.0, 0.0], [0.0, 1.0]])
    for dtype in (np.float64, np.float32):
        solver = make_batched_box_ipm_solver(
            K_eq, K_in, iters=40, dtype=dtype, newton_refine=1,
        )
        c = np.array([[1.0, 2.0], [1.0, 2.0]], dtype)
        b = np.array([[10.0], [10.0]], dtype)
        # problem 0: x0 free up to 20; problem 1: x0 pinned at 0
        h = np.array([[20.0, 20.0], [0.0, 20.0]], dtype)
        x, info = solver(c, b, h)
        x = np.asarray(x, np.float64)
        np.testing.assert_allclose(x[0], [10.0, 0.0], atol=1e-3)
        # pinned variable must be EXACTLY at its bound with the equality
        # carried by x1 — no phantom box
        assert x[1, 0] == 0.0
        np.testing.assert_allclose(x[1, 1], 10.0, atol=1e-3)
        assert float(np.asarray(info["residual"])[1]) < 1e-3
        np.testing.assert_allclose(
            np.asarray(info["objective"], np.float64), [10.0, 20.0],
            rtol=1e-3,
        )
