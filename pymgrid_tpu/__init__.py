"""pymgrid_tpu: a compiled microgrid simulation engine.

Drop-in API mirror of Total-RD/pymgrid (host layer) plus a compiled
JAX/XLA engine (:mod:`pymgrid_tpu.core`) that batches thousands of microgrids
stepping in lockstep on an accelerator, sharded over device meshes
(:mod:`pymgrid_tpu.parallel`).
"""
from pymgrid_tpu.version import __version__
from pymgrid_tpu.paths import PROJECT_PATH
from pymgrid_tpu.microgrid import Microgrid, DEFAULT_HORIZON

__all__ = ["Microgrid", "DEFAULT_HORIZON", "PROJECT_PATH", "__version__"]


def __getattr__(name):
    # Lazy imports keep `import pymgrid_tpu` light and avoid cycles.
    # NOTE: use importlib, not `from pymgrid_tpu import X` — the latter
    # re-enters this __getattr__ before the submodule import starts and
    # recurses forever.
    import importlib

    if name == "envs":
        return importlib.import_module("pymgrid_tpu.envs")
    if name == "MicrogridGenerator":
        return importlib.import_module("pymgrid_tpu.generator").MicrogridGenerator
    if name == "NonModularMicrogrid":
        return importlib.import_module("pymgrid_tpu.nonmodular").NonModularMicrogrid
    if name == "add_pymgrid_yaml_representers":
        return importlib.import_module(
            "pymgrid_tpu.utils.serialize"
        ).add_pymgrid_yaml_representers
    raise AttributeError(f"module 'pymgrid_tpu' has no attribute {name!r}")
