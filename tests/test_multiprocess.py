"""A REAL 2-process ``jax.distributed`` run on the CPU backend.

Everything else in the suite is single-process (8 virtual devices); this
test spawns two coordinated processes (2 virtual devices each, 4 global) and
drives :mod:`pymgrid_tpu.parallel.distributed`'s genuinely multi-process
code paths — ``jax.make_array_from_process_local_data`` assembly, a jitted
cross-process reduction, and ``process_allgather`` fetch.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).parent / "helpers" / "two_process_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_two_process_distributed():
    port = _free_port()

    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_ENABLE_X64", None)
    # the workers run on the CPU backend only: no process of this test
    # opens a GPU, and jax.distributed.initialize runs before backend init
    env.pop("PYTHONPATH", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(i), str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]

    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outputs.append(out)

    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"proc {i} OK" in out, out
