"""Marginalized trajectory likelihood for partially observed LQG loops.

This implements the inverse-optimal-control core of the reference
(``lqg/system.py:142-257``): the controlled state and the agent's belief form a
joint linear-Gaussian system; conditioning on the observed state dims at each
step and marginalizing the belief yields a closed-form Gaussian likelihood of
the observed trajectories.

Redesign of the hot path (see SURVEY.md section 3.2):

The reference recomputes the full ``(j, j)`` covariance recursion *per trial*
inside a ``vmap`` (``system.py:241``).  But the covariance recursion is
**data-independent** - only the conditional mean depends on the data.  We
therefore split the computation:

1. :func:`conditional_kernel` - one scan per parameter set over the joint
   system, producing the affine mean-transition operators ``(M_t, J_t)`` and
   the Cholesky factors of the innovation covariances.
2. :func:`trial_log_likelihood` - per-trial work is a batched affine scan
   ``mu' = M_t mu + J_t x_t`` with trials packed into the trailing matrix
   dimension, so each scan step is a real ``(j, j) @ (j, n)`` matmul,
   followed by fully parallel triangular solves for the quadratic
   forms.

This drops per-likelihood cost from ``O(n T j^3)`` to ``O(T j^3 + n T j d)``
and turns the trial axis into matmul width.

The observed data dims must be the FIRST ``obs_dim`` entries of the joint
state - the same convention as the reference (``system.py:210-233``); model
classes permute state to satisfy it (see ``swap_dims`` in the model zoo).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from lqg_tpu.spec import LQGSpec
from lqg_tpu.ops.linalg import mT, cho_solve, symmetrize
from lqg_tpu.utils.numerics import kahan_sum

_LOG_2PI = math.log(2.0 * math.pi)


class JointSystem(NamedTuple):
    """Joint (state, belief) linear system, time-leading.

    ``F``: ``(T, j, j)`` transition; ``G``: ``(T, j, c)`` noise scale
    (covariance ``G G^T``), with ``j = xdim + bdim``.
    """

    F: jnp.ndarray
    G: jnp.ndarray


def joint_system(
    dynamics: LQGSpec,
    actor: LQGSpec,
    L: jnp.ndarray,
    K: jnp.ndarray,
    horizon: int,
) -> JointSystem:
    """Assemble the joint (state, belief) system from gains.

    Block structure matches reference ``system.py:167-207``:

        F = [[A_d,         B_d L                                        ],
             [K F_d A_d,   A_a + B_a L - K F_a A_a + K (F_d B_d - F_a B_a) L]]
        G = [[V_d,         0    ],
             [K F_d V_d,   K W_d]]

    ``L``/``K`` are time-leading ``(T, ...)``; spec matrices may be stationary
    or stacked (stacked specs are converted to time-leading here).
    """

    def tl(x, vec=False):
        # time-leading view of a spec field (broadcast if stationary)
        if x.ndim == 2:
            return x[None]
        return jnp.moveaxis(x, -3, 0)

    T = horizon
    A_d, B_d, F_d, V_d, W_d = (tl(dynamics.A), tl(dynamics.B), tl(dynamics.F),
                               tl(dynamics.V), tl(dynamics.W))
    A_a, B_a, F_a = tl(actor.A), tl(actor.B), tl(actor.F)

    BdL = B_d @ L
    KFd = K @ F_d
    top = jnp.concatenate([jnp.broadcast_to(A_d, (T,) + A_d.shape[1:]),
                           jnp.broadcast_to(BdL, (T,) + BdL.shape[1:])], axis=-1)
    bottom_left = KFd @ A_d
    bottom_right = (
        A_a + B_a @ L - K @ (F_a @ A_a) + (K @ (F_d @ B_d - F_a @ B_a)) @ L
    )
    bottom = jnp.concatenate(
        [jnp.broadcast_to(bottom_left, (T,) + bottom_left.shape[1:]),
         jnp.broadcast_to(bottom_right, (T,) + bottom_right.shape[1:])], axis=-1)
    Fj = jnp.concatenate([top, bottom], axis=-2)

    xdim = A_d.shape[-1]
    wcols = W_d.shape[-1]
    zeros = jnp.zeros(Fj.shape[:-2] + (xdim, wcols), dtype=Fj.dtype)
    Vd_b = jnp.broadcast_to(V_d, Fj.shape[:-2] + V_d.shape[-2:])
    g_top = jnp.concatenate([Vd_b, zeros], axis=-1)
    KFdV = KFd @ V_d
    KWd = K @ W_d
    g_bottom = jnp.concatenate(
        [jnp.broadcast_to(KFdV, Fj.shape[:-2] + KFdV.shape[-2:]),
         jnp.broadcast_to(KWd, Fj.shape[:-2] + KWd.shape[-2:])], axis=-1)
    Gj = jnp.concatenate([g_top, g_bottom], axis=-2)

    return JointSystem(F=Fj, G=Gj)


class ConditionalKernel(NamedTuple):
    """Data-independent part of the conditioned/marginalized recursion.

    With ``d = obs_dim`` and ``j`` the joint dim:

    * ``M``: ``(T, j, j)`` mean transition ``mu_{t+1} = M_t mu_t + J_t x_t``
    * ``J``: ``(T, j, d)`` data gain
    * ``chol``: ``(T+1, d, d)`` Cholesky factors of the innovation
      covariances ``Sigma_t[:d, :d]`` for ``t = 0..T``
    * ``logdet_score``: scalar, ``sum_{t=1..T} log det(2 pi Sigma_t[:d,:d])``
    """

    M: jnp.ndarray
    J: jnp.ndarray
    chol: jnp.ndarray
    logdet_score: jnp.ndarray


def conditional_kernel(joint: JointSystem, obs_dim: int,
                       jitter: float = 0.0) -> ConditionalKernel:
    """Run the data-free covariance recursion once per parameter set.

    Covariance update matches reference ``system.py:223-230``:

        Sigma' = F Sigma F^T + G G^T - J (Sigma F^T)[:d, :]

    with ``J = (F Sigma)[:, :d] Sigma[:d, :d]^{-1}`` (via Cholesky solves
    instead of ``linalg.solve``).  Initialization: ``Sigma_0 = G_0 G_0^T``
    (``system.py:212``).
    """
    Fj, Gj = joint
    d = obs_dim
    eye_d = jitter * jnp.eye(d, dtype=Fj.dtype) if jitter else None

    Sigma0 = Gj[0] @ mT(Gj[0])

    def step(Sigma, inp):
        F, G = inp
        S = Sigma[..., :d, :d]
        if eye_d is not None:
            S = S + eye_d
        chol = jnp.linalg.cholesky(symmetrize(S))
        FS = F @ Sigma
        # J = (F Sigma)[:, :d] S^{-1}  (S symmetric)
        J = mT(cho_solve(chol, mT(FS[..., :, :d])))
        # mean transition: mu' = F mu + J (x - mu[:d]) = (F - J E) mu + J x
        M = F - jnp.pad(J, [(0, 0)] * (J.ndim - 2) + [(0, 0), (0, F.shape[-1] - d)])
        Sigma_new = symmetrize(FS @ mT(F) + G @ mT(G) - J @ mT(FS[..., :, :d]))
        return Sigma_new, (M, J, chol)

    with jax.default_matmul_precision("highest"):
        SigmaT, (M, J, chol) = lax.scan(step, Sigma0, (Fj, Gj))

    ST = SigmaT[..., :d, :d]
    if eye_d is not None:
        ST = ST + eye_d
    chol_T = jnp.linalg.cholesky(symmetrize(ST))
    chols = jnp.concatenate([chol, chol_T[None]], axis=0)

    diag = jnp.diagonal(chols[1:], axis1=-2, axis2=-1)
    # compensated: this scalar multiplies every trial, so its f32 rounding
    # error enters the total likelihood COHERENTLY (x n_trials) - see
    # lqg_tpu.utils.numerics
    logdet_score = (kahan_sum(jnp.sum(2.0 * jnp.log(diag), axis=-1))
                    + chols[1:].shape[0] * d * _LOG_2PI)

    return ConditionalKernel(M=M, J=J, chol=chols, logdet_score=logdet_score)


def _init_mean(x0: jnp.ndarray, joint_dim: int) -> jnp.ndarray:
    """``mu_0 = [x_0, 0...]`` - zero-padded unobserved dims (reference
    ``system.py:210-211``, including its documented simplification)."""
    d = x0.shape[-1]
    return jnp.concatenate(
        [x0, jnp.zeros(x0.shape[:-1] + (joint_dim - d,), dtype=x0.dtype)], axis=-1)


def trial_log_likelihood(kernel: ConditionalKernel, x: jnp.ndarray) -> jnp.ndarray:
    """Per-trial log likelihood of observed trajectories.

    Args:
        kernel: output of :func:`conditional_kernel`.
        x: observed trajectories ``(n, T+1, d)``.

    Returns:
        ``(n,)`` log likelihoods of ``x[:, 1:]`` given the model - the same
        quantity as reference ``System.log_likelihood`` (``system.py:246-248``)
        summed over time (``to_event(1)`` in the reference collapses the time
        axis into the event).

    Trials ride in the trailing matrix dimension so each scan step is a
    ``(j, j) @ (j, n)`` matmul, and the quadratic forms are batched
    triangular solves, fully parallel over ``(T, n)``.
    """
    M, J, chols, logdet_score = kernel
    n, Tp1, d = x.shape
    j = M.shape[-1]

    X = jnp.moveaxis(x, 0, -1)  # (T+1, d, n)
    MU0 = _init_mean(x[:, 0, :], j).T  # (j, n)

    def step(MU, inp):
        M_t, J_t, X_t = inp
        MU_new = M_t @ MU + J_t @ X_t
        return MU_new, MU_new[:d]

    with jax.default_matmul_precision("highest"):
        _, preds = lax.scan(step, MU0, (M, J, X[:-1]))  # (T, d, n)

    e = X[1:] - preds
    w = jax.lax.linalg.triangular_solve(
        chols[1:], e, left_side=True, lower=True)
    # compensated over the T axis: per-trial quads are O(T d) sums whose
    # plain-f32 accumulation noise (~1e-2 nats/trial) otherwise dominates
    # HMC's delta-energy precision (lqg_tpu.utils.numerics)
    quad = kahan_sum(jnp.sum(w * w, axis=1), axis=0)  # (n,)

    return -0.5 * (quad + logdet_score)


def conditional_sigma(joint: JointSystem, obs_dim: int,
                      jitter: float = 0.0) -> jnp.ndarray:
    """Full conditional covariances ``Sigma_t`` for ``t = 1..T`` (data-free).

    Reference-shaped output (``system.py:233-235`` returns the ``(T, j, j)``
    stack), used by ``conditional_distribution`` / the belief-tracking
    posterior.  One scan per parameter set - never per trial.
    """
    Fj, Gj = joint
    d = obs_dim
    eye_d = jitter * jnp.eye(d, dtype=Fj.dtype) if jitter else None

    Sigma0 = Gj[0] @ mT(Gj[0])

    def step(Sigma, inp):
        F, G = inp
        S = Sigma[..., :d, :d]
        if eye_d is not None:
            S = S + eye_d
        chol = jnp.linalg.cholesky(symmetrize(S))
        FS = F @ Sigma
        Jt = mT(cho_solve(chol, mT(FS[..., :, :d])))
        Sigma_new = symmetrize(FS @ mT(F) + G @ mT(G) - Jt @ mT(FS[..., :, :d]))
        return Sigma_new, Sigma_new

    with jax.default_matmul_precision("highest"):
        _, Sigma = lax.scan(step, Sigma0, (Fj, Gj))
    return Sigma


def conditional_mean(kernel: ConditionalKernel, x: jnp.ndarray) -> jnp.ndarray:
    """Full conditional means ``mu_t`` for ``t = 1..T`` per trial.

    Returns ``(n, T, j)`` - reference-shaped (``system.py:233-235``).
    """
    M, J, _, _ = kernel
    j = M.shape[-1]

    X = jnp.moveaxis(x, 0, -1)  # (T+1, d, n)
    MU0 = _init_mean(x[:, 0, :], j).T

    def step(MU, inp):
        M_t, J_t, X_t = inp
        MU_new = M_t @ MU + J_t @ X_t
        return MU_new, MU_new

    with jax.default_matmul_precision("highest"):
        _, mus = lax.scan(step, MU0, (M, J, X[:-1]))  # (T, j, n)
    return jnp.moveaxis(mus, -1, 0)  # (n, T, j)
