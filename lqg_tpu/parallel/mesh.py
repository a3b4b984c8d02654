"""Device mesh construction and multi-host bring-up.

The reference's only notion of multi-device execution is NumPyro chain
dispatch over host devices (``main.py:8``).  Here the device mesh is a
first-class object: batch axes of the inference workload (conditions x
trials x chains/particles) shard over mesh axes, with XLA collectives
between devices (NCCL on GPUs).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Initialize the multi-host runtime (one JAX process per host).

    No-op when running single-process.  Arguments default to the standard
    cluster environment variables.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS",
                                     "localhost:12321")
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(axis_sizes: Sequence[Tuple[str, int]],
              devices=None) -> Mesh:
    """Build a mesh with named axes, e.g. ``[("chains", 2), ("dp", 4)]``.

    ``dp`` shards trial/particle batches; ``chains`` shards MCMC chains;
    an ``sp`` axis can shard the horizon for the associative-scan kernels.
    """
    if devices is None:
        devices = jax.devices()
    names = tuple(n for n, _ in axis_sizes)
    shape = tuple(s for _, s in axis_sizes)
    n_needed = int(np.prod(shape))
    if n_needed > len(devices):
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {n_needed} devices, have "
            f"{len(devices)}")
    dev = np.asarray(devices[:n_needed]).reshape(shape)
    return Mesh(dev, names)


def local_mesh(dp: Optional[int] = None, name: str = "dp") -> Mesh:
    """One-axis mesh over all (or ``dp``) local devices."""
    devices = jax.devices()
    dp = len(devices) if dp is None else dp
    return make_mesh([(name, dp)], devices)


def shard_batch(x, mesh: Mesh, axis: str = "dp"):
    """Place an array with its leading axis sharded over ``axis``."""
    spec = PartitionSpec(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(x, mesh: Mesh):
    return jax.device_put(
        x, NamedSharding(mesh, PartitionSpec()))
