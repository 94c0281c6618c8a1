"""Profiling and runtime-invariant helpers (SURVEY.md §5).

The reference has no tracing/profiling beyond tqdm bars; here:

* :func:`trace` wraps ``jax.profiler.trace`` for xprof/tensorboard captures,
* :class:`Throughput` measures env-steps/s around device computations,
* :func:`check_balance` asserts the energy-balance invariant
  (``np.isclose(provided, consumed)``, the reference's only runtime check,
  ``microgrid/microgrid.py:321``) over engine rollout outputs,
* :func:`checked_step` wraps an engine step with ``checkify`` so NaN and
  balance violations surface as errors inside jit,
* :func:`gpu_name_and_power_limit` names the card a measurement ran on.
"""
import contextlib
import subprocess
import time

import numpy as np

__all__ = ["trace", "Throughput", "check_balance", "checked_step",
           "gpu_name_and_power_limit"]


def gpu_name_and_power_limit():
    """The cards' name and power limit as ``nvidia-smi`` reports them, e.g.
    ``"NVIDIA H100 80GB HBM3, 700.00 W"`` (distinct lines joined by
    ``"; "``), or ``"not available"`` without ``nvidia-smi``.  A card set
    below its maximum power runs slower under load, so every timing is
    reported beside this string."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        return "not available"
    return "; ".join(dict.fromkeys(lines))


@contextlib.contextmanager
def trace(log_dir="/tmp/pymgrid_tpu_trace", create_perfetto_link=False):
    """Capture a jax profiler trace around a block (view with xprof/TB)."""
    import jax

    with jax.profiler.trace(log_dir, create_perfetto_link=create_perfetto_link):
        yield log_dir


class Throughput:
    """Env-steps/s meter: ``with Throughput(n_envs, n_steps) as t: ...``."""

    def __init__(self, n_envs, n_steps):
        self.n_envs = n_envs
        self.n_steps = n_steps
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    @property
    def steps_per_sec(self):
        return self.n_envs * self.n_steps / self.elapsed

    def __repr__(self):
        if self.elapsed is None:
            return "Throughput(pending)"
        return (
            f"Throughput({self.steps_per_sec:,.0f} env-steps/s over "
            f"{self.n_envs}x{self.n_steps} in {self.elapsed:.3f}s)"
        )


def check_balance(outputs, rtol=1e-05, atol=1e-08):
    """Assert provided == consumed for every step of a collected rollout."""
    provided = np.asarray(outputs.provided)
    absorbed = np.asarray(outputs.absorbed)
    bad = ~np.isclose(provided, absorbed, rtol=rtol, atol=atol)
    if bad.any():
        idx = np.argwhere(bad)[:5]
        raise RuntimeError(
            "Microgrid modules unable to balance energy production with "
            f"consumption at indices {idx.tolist()}: "
            f"provided={provided[bad][:5]}, absorbed={absorbed[bad][:5]}"
        )
    return True


def checked_step(spec, normalized=False, rtol=1e-05, atol=1e-08):
    """An engine step wrapped with checkify: returns
    ``(err, (state, output)) = fn(params, state, action)``; ``err.throw()``
    raises on NaN rewards or balance violations."""
    import jax.numpy as jnp
    from jax.experimental import checkify

    from pymgrid_tpu.core.engine import make_step_fn

    step_fn = make_step_fn(spec, normalized=normalized)

    def step(params, state, action):
        new_state, out = step_fn(params, state, action)
        checkify.check(
            jnp.isfinite(out.reward), "non-finite reward {r}", r=out.reward
        )
        checkify.check(
            jnp.isclose(out.provided, out.absorbed, rtol=rtol, atol=atol),
            "energy balance violated: provided {p} != absorbed {a}",
            p=out.provided,
            a=out.absorbed,
        )
        return new_state, out

    return checkify.checkify(step)
