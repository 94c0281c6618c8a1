"""SuiteMPC: all scenarios' receding-horizon MPC as one batched program.

Validates the heterogeneous batched-IPM path (stacked per-scenario
constraint matrices) against the per-scenario
:class:`BatchedMPC` controller it replaces for table generation.
"""
import warnings

import numpy as np
import pytest

import pymgrid_tpu


@pytest.fixture(scope="module")
def suite_and_batched():
    import jax  # noqa: F401  (conftest pins CPU x64)

    from pymgrid_tpu.algos.mpc_jax import BatchedMPC
    from pymgrid_tpu.algos.mpc_suite import SuiteMPC

    warnings.filterwarnings("ignore")
    scenarios = [0, 4, 1]  # grid-only, genset-only, genset+weak-grid
    mgs = [pymgrid_tpu.Microgrid.from_scenario(n) for n in scenarios]
    T = 20
    suite = SuiteMPC(mgs, dtype=np.float64, enum_bits=2, enum_chunk=4)
    rew_suite, _ = suite.run_scanned(T, chunk=T)

    rew_batched = []
    for mg in mgs:
        bm = BatchedMPC(mg, batch_size=1, dtype=np.float64,
                        host_fallback=False, enum_bits=2, enum_chunk=4)
        r, _ = bm.run_scanned(T, chunk=T)
        rew_batched.append(r[:, 0])
    return scenarios, rew_suite, np.stack(rew_batched, axis=1)


def test_suite_mpc_matches_batched_mpc(suite_and_batched):
    """Each scenario's realized rewards from the one-program SuiteMPC match
    its solo BatchedMPC run (same formulation; solver batching may shift
    the IPM trajectory by float noise)."""
    scenarios, rew_suite, rew_batched = suite_and_batched
    assert rew_suite.shape == rew_batched.shape
    for i, n in enumerate(scenarios):
        scale = max(1.0, np.abs(rew_batched[:, i]).max())
        np.testing.assert_allclose(
            rew_suite[:, i] / scale, rew_batched[:, i] / scale,
            atol=5e-4, err_msg=f"scenario {n}",
        )


def test_suite_mpc_costs_close_to_batched(suite_and_batched):
    scenarios, rew_suite, rew_batched = suite_and_batched
    cost_s = -rew_suite.sum(axis=0)
    cost_b = -rew_batched.sum(axis=0)
    np.testing.assert_allclose(cost_s, cost_b, rtol=1e-4)


def test_suite_mpc_chip_mode_f32_parity():
    """The RESULTS_CHIP table's mode — f32, box IPM, enum_bits=3,
    iters=60, newton_refine=2 — vs the f64 SuiteMPC anchor over a
    year-relevant closed-loop length (the table's exact configuration is
    tested on the CPU, not only observed on the device).

    Also regression-gates the degenerate-box pinning fix (core/lp.py):
    before it, genset-off patterns carried a phantom ~2e-2 box that made
    infeasible patterns win the enumeration and realized costs drift >5%."""
    from pymgrid_tpu.algos.mpc_suite import SuiteMPC

    warnings.filterwarnings("ignore")
    scenarios = [0, 4, 1]  # grid-only, genset-only, genset+weak-grid
    mgs = [pymgrid_tpu.Microgrid.from_scenario(n) for n in scenarios]
    T = 120
    f32 = SuiteMPC(mgs, dtype=np.float32, enum_bits=3, enum_chunk=16,
                   iters=60, newton_refine=2, matmul_precision="float32")
    rew32, _ = f32.run_scanned(T, chunk=T)
    f64 = SuiteMPC(mgs, dtype=np.float64, enum_bits=3, enum_chunk=16)
    rew64, _ = f64.run_scanned(T, chunk=T)
    cost32 = -np.asarray(rew32, np.float64).sum(axis=0)
    cost64 = -np.asarray(rew64).sum(axis=0)
    for i, n in enumerate(scenarios):
        assert abs(cost32[i] / cost64[i] - 1.0) < 0.02, (
            f"scenario {n}: f32 chip-mode cost {cost32[i]:,.2f} vs f64 "
            f"{cost64[i]:,.2f} ({cost32[i] / cost64[i] - 1.0:+.2%})"
        )


def test_suite_mpc_rejects_mismatched_lengths():
    from pymgrid_tpu.algos.mpc_suite import SuiteMPC

    warnings.filterwarnings("ignore")
    a = pymgrid_tpu.Microgrid.from_scenario(0)
    b = pymgrid_tpu.Microgrid.from_scenario(4)
    b.final_step = int(b.final_step) - 7
    with pytest.raises(ValueError, match="disagree"):
        SuiteMPC([a, b], dtype=np.float64, enum_bits=0)
