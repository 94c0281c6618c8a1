"""Test configuration.

Tests run on a virtual 8-device CPU mesh so that multi-device sharding logic
is exercised without accelerators.  float64 is enabled so the JAX engine can
be compared bit-for-bit against the numpy host layer (the reference,
Total-RD/pymgrid, is float64 numpy end-to-end).  Checks that need the GPU
live in ``chip_smoke.py``, not under pytest.
"""
import os
import sys

# Both the env vars and the live jax config are forced (jax may already be
# imported by the time this file runs): the test suite always runs on a
# virtual 8-device CPU mesh in float64.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    xla_flags = (xla_flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_max_isa" not in xla_flags:
    # Restrict CPU codegen to a pre-FMA ISA: LLVM otherwise contracts a*b+c
    # into fused multiply-adds (one rounding), breaking bitwise parity with
    # the numpy reference (two roundings).
    xla_flags = (xla_flags + " --xla_cpu_max_isa=AVX").strip()
os.environ["XLA_FLAGS"] = xla_flags
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

try:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
except ImportError:
    pass

sys.path.insert(0, os.path.dirname(__file__))
