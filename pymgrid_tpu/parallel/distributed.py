"""Multi-host execution.

The reference has no distributed runtime (SURVEY.md §2.7); the new-build
communication backend is JAX's: ``jax.distributed.initialize`` connects the
hosts, the env batch shards along a global ``batch`` mesh axis, each host
feeds its local replicas, and XLA emits the collectives (metric reductions
over the devices' interconnect, host-crossing ones over the network).
Nothing here depends on the device count — the same code runs one device,
one host, or N hosts.

Typical multi-host program::

    from pymgrid_tpu.parallel import distributed as dist

    dist.initialize()                      # no-op single-process
    mesh = dist.global_batch_mesh()        # all devices on all hosts
    batched = BatchedMicrogrid(mg, batch_size=GLOBAL_B, mesh=mesh)
    states = dist.from_process_local(mesh, local_states)   # per-host feed
    ...
    print(dist.fetch(metrics))             # gather to every host

Validated on a virtual 8-device mesh in CI (tests/test_parallel.py,
tests/test_distributed.py); the driver's ``dryrun_multichip`` compiles the
full training step over the same mesh API.
"""
import numpy as np

__all__ = [
    "initialize",
    "global_batch_mesh",
    "process_count",
    "local_batch_size",
    "from_process_local",
    "fetch",
]


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kwargs):
    """Connect this host to the job (wraps ``jax.distributed.initialize``).

    A no-op when the job is single-process and no coordinator is given
    (the common local / single-host case), and when already initialized.
    """
    import jax

    if coordinator_address is None and num_processes in (None, 1):
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as exc:  # already initialized
        if "already" not in str(exc).lower():
            raise
    return True


def process_count():
    import jax

    return jax.process_count()


def global_batch_mesh(axis_name="batch"):
    """1-D mesh over every device of every connected host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))


def local_batch_size(global_batch):
    """Replicas this host feeds (global batch must divide evenly)."""
    import jax

    n = jax.process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} does not divide over {n} processes"
        )
    return global_batch // n


def from_process_local(mesh, local_data, axis_name="batch"):
    """Assemble a globally-sharded pytree from each host's local shard.

    ``local_data`` holds this host's rows of the global batch axis (axis 0 of
    every leaf).  Single-process, this is just a device_put onto the mesh.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis_name))

    def place(x):
        x = np.asarray(x)
        if jax.process_count() == 1:
            return jax.device_put(x, sharding)
        global_shape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
        return jax.make_array_from_process_local_data(sharding, x, global_shape)

    return jax.tree.map(place, local_data)


def fetch(x):
    """Bring a (possibly process-spanning) array to every host as numpy."""
    import jax

    if jax.process_count() == 1:
        return jax.tree.map(np.asarray, x)
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather(x, tiled=True)
