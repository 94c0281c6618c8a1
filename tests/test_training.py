"""End-to-end RL training example (device learner fed by compiled envs)."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_a2c_training_runs():
    from examples.train_rl import build_training

    run = build_training(scenario=0, batch=64, rollout_len=16)
    theta, opt_state, history = run(iters=8, log_every=100)
    assert len(history) == 8
    assert all(np.isfinite(h) for h in history)
    # device-resident chunking (one lax.scan dispatch per log_every) must
    # match the same iterations dispatched one at a time
    _, _, history_chunked = run(iters=8, log_every=3)
    np.testing.assert_allclose(history_chunked, history, rtol=1e-5)
    # continuation blocks resume the Adam moments: threading
    # (theta, opt_state) through run() must differ from a cold restart
    theta2, opt_state2, _ = run(iters=4, seed=5, theta=theta,
                                opt_state=opt_state)
    assert np.isfinite(
        float(np.asarray(theta2["policy"][0]["w"]).sum()))


def test_a2c_training_sharded():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    from examples.train_rl import build_training
    from pymgrid_tpu.parallel import make_batch_mesh

    mesh = make_batch_mesh(4)
    run = build_training(scenario=0, batch=32, rollout_len=8, mesh=mesh)
    theta, opt_state, history = run(iters=3, log_every=100)
    assert all(np.isfinite(h) for h in history)
