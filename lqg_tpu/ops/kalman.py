"""Kalman filter covariance forward pass (gain schedule).

Semantics match reference ``lqg/belief/kf.py:6-21``: a covariance-only forward
recursion producing the time series of Kalman gains

    P <- A P A^T + V V^T            (predict)
    G  = F P F^T + W W^T            (innovation covariance)
    K  = P F^T G^{-1}               (gain)
    P <- (I - K F) P                (update)

Differences from the reference: batch-first einsums over arbitrary leading axes, a
Cholesky solve instead of the reference's explicit ``jnp.linalg.inv``
(``kf.py:12``), and stationary-spec support (no ``(T, n, n)`` stacks in HBM).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax.numpy as jnp
from jax import lax

from lqg_tpu.spec import LQGSpec
from lqg_tpu.ops.linalg import mT, cho_solve, symmetrize


def _step(P, inp, *, jitter: float):
    A, F, V, W = inp

    P = A @ P @ mT(A) + V @ mT(V)
    PFt = P @ mT(F)
    G = symmetrize(F @ PFt + W @ mT(W))
    if jitter:
        G = G + jitter * jnp.eye(G.shape[-1], dtype=G.dtype)
    chol = jnp.linalg.cholesky(G)
    # K = P F^T G^{-1}  ==  (G^{-1} (P F^T)^T)^T  since G is symmetric
    K = mT(cho_solve(chol, mT(PFt)))
    P = symmetrize(P - K @ mT(PFt))

    return P, K


def forward(
    spec: LQGSpec,
    Sigma0: jnp.ndarray,
    horizon: Optional[int] = None,
    jitter: float = 0.0,
) -> jnp.ndarray:
    """Run the covariance recursion; returns Kalman gains ``K``.

    Args:
        spec: stacked layout (time axis at ``-3``) or stationary layout
            (``horizon`` required).
        Sigma0: initial state covariance (batched ok).
        jitter: optional diagonal loading of the innovation covariance.

    Output ``K`` has the time axis leading: ``(T, batch..., n, p)``.

    Note the update uses ``P - K (P F^T)^T``, algebraically identical to the
    reference's ``(I - K F) P`` but with one fewer ``n x n`` matmul and
    guaranteed symmetry.
    """
    import jax

    step = partial(_step, jitter=jitter)
    # stationary specs carry no time axis: A has the same rank as Qf
    stationary = spec.A.ndim == spec.Qf.ndim

    # full-f32 matmuls: reduced-precision (TF32) products compound over
    # long covariance recursions (see lqg_tpu.ops.riccati)
    with jax.default_matmul_precision("highest"):
        if stationary:
            if horizon is None:
                raise ValueError("stationary spec requires explicit horizon")
            consts = (spec.A, spec.F, spec.V, spec.W)
            _, K = lax.scan(lambda c, _: step(c, consts), Sigma0, None,
                            length=horizon)
        else:
            xs = tuple(
                jnp.moveaxis(x, -3, 0)
                for x in (spec.A, spec.F, spec.V, spec.W)
            )
            _, K = lax.scan(step, Sigma0, xs)

    return K
