"""Sharded inference: trial-parallel likelihood and device-parallel chains.

Greenfield components (the reference has no distributed backend; SURVEY.md
section 2.6): the likelihood's trial batch is data-parallel with a ``psum``
log-likelihood reduction over the mesh, and MCMC chains shard over a mesh
axis so every device runs an independent NUTS chain in SPMD.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lqg_tpu.parallel.mesh import shard_batch


def sharded_log_likelihood(model_builder: Callable, x, mesh: Mesh,
                           axis: str = "dp"):
    """Build a sharded total-log-likelihood function over trials.

    Args:
        model_builder: params dict -> ``System`` (pure, traceable).
        x: trials ``(n, T+1, d)``; ``n`` must divide by the mesh axis size.
        mesh: device mesh with axis ``axis``.

    Returns:
        ``f(params) -> scalar`` - jitted, with trials sharded over ``axis``
        and the per-shard sums reduced with ``psum``.
    """
    x_sharded = shard_batch(jnp.asarray(x), mesh, axis)

    # check_vma=False: the Pallas kernels' outputs carry no varying-axes
    # annotation, which shard_map's type check would otherwise demand
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(axis)), out_specs=P(), check_vma=False)
    def _ll(params, x_shard):
        system = model_builder(params)
        ll = jnp.sum(system.log_likelihood(x_shard))
        return jax.lax.psum(ll, axis)

    _ll_jit = jax.jit(_ll)

    def total_ll(params):
        # the global array is passed as an ARGUMENT (closing over an array
        # that spans non-addressable devices is illegal multi-process)
        return _ll_jit(params, x_sharded)

    return total_ll


def sharded_chains_run(mcmc, rng_key, mesh: Mesh, axis: str = "chains",
                       checkpoint_path=None, **run_kwargs):
    """Run an :class:`lqg_tpu.infer.mcmc.MCMC` with chains sharded over a
    mesh axis.

    Chains are a vmapped batch axis; placing the per-chain keys and initial
    positions with a chain-sharded layout makes XLA partition the whole
    segmented warmup+sampling program (every chunk launch) SPMD across
    devices.  ``mcmc.num_chains`` must divide by the mesh axis size.

    ``checkpoint_path`` forwards to :meth:`MCMC.run` so long sharded runs
    get the same in-flight checkpoint/resume as single-device ones.
    """
    axis_size = mesh.shape[axis]
    if mcmc.num_chains % axis_size:
        raise ValueError(
            f"num_chains={mcmc.num_chains} must divide by mesh axis "
            f"{axis!r} of size {axis_size}")
    return mcmc.run(rng_key,
                    chain_sharding=NamedSharding(mesh, P(axis)),
                    checkpoint_path=checkpoint_path, **run_kwargs)


def sequence_parallel_log_likelihood(system, x, mesh: Mesh, axis: str = "sp"):
    """Likelihood with the HORIZON sharded over a mesh axis.

    Sequence (time) parallelism - a greenfield capability (the reference
    scans T strictly sequentially on one device, ``lqg/system.py:214-233``):
    the joint system's time-stacked operators are sharded over ``axis`` and
    the likelihood is evaluated with the associative-scan formulation
    (:func:`lqg_tpu.parallel.pscan.trial_log_likelihood_assoc`), whose
    O(log T) composition tree XLA partitions into per-shard scans plus
    collectives at shard boundaries.  Use when T is too long for one
    card's sequential latency (T ~ 1e4-1e6).

    Args:
        system: a :class:`lqg_tpu.system.System`.
        x: trials ``(n, T+1, d)``, replicated.
        mesh: mesh with axis ``axis``; its size should divide T.

    Returns:
        ``(n,)`` per-trial log likelihoods (replicated).
    """
    from lqg_tpu.parallel.pscan import trial_log_likelihood_assoc

    tspec = NamedSharding(mesh, P(axis))

    @jax.jit
    def _ll(xr):
        joint = system._joint()
        joint = type(joint)(
            F=jax.lax.with_sharding_constraint(joint.F, tspec),
            G=jax.lax.with_sharding_constraint(joint.G, tspec))
        return trial_log_likelihood_assoc(joint, xr)

    return _ll(jax.device_put(x, NamedSharding(mesh, P())))
