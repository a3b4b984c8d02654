"""Time-stacking helpers.

Semantics match the reference (``/root/reference/lqg/utils.py:6-35``): static
matrices are broadcast to per-timestep stacks, the linear cost terms ``q, r``
and the cross term ``P`` are zeroed, and the terminal cost is the last slice of
the running cost.

The kernels generally do not *need* stacked specs (they broadcast
stationary matrices inside the scan, saving memory bandwidth); stacking exists for
API parity and for genuinely time-varying problems.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from lqg_tpu.spec import LQGSpec


def _zeros(shape, dtype):
    """Concrete (NumPy) zeros for the structurally-zero cost terms.

    ``jnp.zeros`` inside a ``jit``/``vmap`` trace produces a *tracer*, which
    would make ``System._fused_ok``'s is-this-term-zero check unanswerable at
    trace time - silently knocking every traced model (i.e. every NUTS
    leapfrog) off the fused Pallas gains kernel onto the sequential scan.
    NumPy zeros stay concrete through tracing; consumers lift them to device
    constants on use.
    """
    return np.zeros(shape, dtype=dtype)


def time_stack(A: jnp.ndarray, T: int) -> jnp.ndarray:
    """Broadcast a static matrix to a length-``T`` time stack."""
    return jnp.broadcast_to(A[..., None, :, :], A.shape[:-2] + (T,) + A.shape[-2:])


def time_stack_spec(A, B, F, V, W, Q, R, T: int) -> LQGSpec:
    """Build a stacked :class:`LQGSpec` from static matrices.

    Mirrors reference ``time_stack_spec`` (``lqg/utils.py:10-35``): ``q``/``r``
    and ``P`` are zero, ``Qf = Q[-1]``, ``qf = 0``.
    """
    A, B, F, V, W, Q, R = map(jnp.asarray, (A, B, F, V, W, Q, R))

    batch = jnp.broadcast_shapes(
        A.shape[:-2], B.shape[:-2], F.shape[:-2], V.shape[:-2], W.shape[:-2],
        Q.shape[:-2], R.shape[:-2],
    )

    state_dim = Q.shape[-1]
    action_dim = R.shape[-1]

    spec = LQGSpec(
        A=time_stack(A, T),
        B=time_stack(B, T),
        F=time_stack(F, T),
        V=time_stack(V, T),
        W=time_stack(W, T),
        Q=time_stack(Q, T),
        R=time_stack(R, T),
        q=_zeros(batch + (T, state_dim), Q.dtype),
        Qf=jnp.broadcast_to(Q, batch + Q.shape[-2:]),
        qf=_zeros(batch + (state_dim,), Q.dtype),
        P=_zeros(batch + (T, action_dim, state_dim), R.dtype),
        r=_zeros(batch + (T, action_dim), R.dtype),
    )
    return spec


def stationary_spec(A, B, F, V, W, Q, R) -> LQGSpec:
    """Build a *stationary* (no time axis) spec; horizon supplied at solve time.

    This is the preferred layout: kernels broadcast the matrices inside
    their scans, so no ``(T, n, n)`` stacks are ever materialized.
    """
    A, B, F, V, W, Q, R = map(jnp.asarray, (A, B, F, V, W, Q, R))
    state_dim = Q.shape[-1]
    action_dim = R.shape[-1]
    batch = jnp.broadcast_shapes(
        A.shape[:-2], B.shape[:-2], F.shape[:-2], V.shape[:-2], W.shape[:-2],
        Q.shape[:-2], R.shape[:-2],
    )
    return LQGSpec(
        A=A, B=B, F=F, V=V, W=W, Q=Q, R=R,
        q=_zeros(batch + (state_dim,), Q.dtype),
        Qf=jnp.broadcast_to(Q, batch + Q.shape[-2:]),
        qf=_zeros(batch + (state_dim,), Q.dtype),
        P=_zeros(batch + (action_dim, state_dim), R.dtype),
        r=_zeros(batch + (action_dim,), R.dtype),
    )
