"""Associative (parallel-in-time) scans for the Riccati recursions.

The reference computes both Riccati-type recursions strictly sequentially
(``lax.scan`` at ``lqg/control/lqr.py:38`` and ``lqg/belief/kf.py:18``) - at
T=1000 this is 1000 serial dependent steps.  Here the recursions are
reformulated as an associative semigroup so ``jax.lax.associative_scan``
evaluates them in O(log T) depth, enabling horizon (sequence) parallelism
within a chip and, sharded over a mesh axis, across chips.

Math: every covariance/value Riccati step is a linear-fractional map in the
canonical form

    Phi(X) = C + A_e (I + X J)^{-1} X A_e^T

and these maps are closed under composition (the semigroup of
"Riccati/Moebius" maps used in the temporal-parallelization literature on
Kalman filtering and LQ control; see PAPERS.md "The Parallelization of
Riccati Recursion"):

    (Phi_j o Phi_i):  A = A_j (I + C_i J_j)^{-1} A_i
                      C = A_j (I + C_i J_j)^{-1} C_i A_j^T + C_j
                      J = A_i^T (I + J_j C_i)^{-1} J_j A_i + J_i

* Kalman covariance step (predict with (A, Q=VV^T), update with
  (F, R=WW^T)):   element  A_e = (I + Q S)^{-1} A,  C = (I + Q S)^{-1} Q,
  J = A^T (I + S Q)^{-1} S A,  with  S = F^T R^{-1} F.
* Control Riccati step  S_t = Q + A^T (I + S_{t+1} S_B)^{-1} S_{t+1} A
  (zero affine/cross terms):  element  A_e = A^T,  C = Q,  J = S_B
  with  S_B = B R^{-1} B^T.

Requirements: ``W W^T`` / ``R`` invertible (all shipped models satisfy
this); affine cost terms zero (true for every model the reference builds -
``time_stack_spec`` zeroes them).  The sequential kernels remain the
general-path fallback.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from lqg_tpu.spec import LQGSpec
from lqg_tpu.ops.linalg import mT, psd_solve, symmetrize, cho_solve
from lqg_tpu.ops.riccati import Gains


class RicattiElement(NamedTuple):
    A: jnp.ndarray
    C: jnp.ndarray
    J: jnp.ndarray


def _compose(first: RicattiElement, second: RicattiElement) -> RicattiElement:
    """Composition ``second o first`` (apply ``first``, then ``second``)."""
    Ai, Ci, Ji = first
    Aj, Cj, Jj = second
    n = Ai.shape[-1]
    eye = jnp.eye(n, dtype=Ai.dtype)

    M = jnp.linalg.solve(eye + Ci @ Jj, jnp.concatenate([Ai, Ci], axis=-1))
    MAi = M[..., :, :n]
    MCi = M[..., :, n:]
    A = Aj @ MAi
    C = Aj @ MCi @ mT(Aj) + Cj
    Jn = jnp.linalg.solve(eye + Jj @ Ci, Jj @ Ai)
    J = mT(Ai) @ Jn + Ji
    return RicattiElement(A=A, C=symmetrize(C), J=symmetrize(J))


def _apply(e: RicattiElement, X: jnp.ndarray) -> jnp.ndarray:
    n = e.A.shape[-1]
    eye = jnp.eye(n, dtype=e.A.dtype)
    Y = jnp.linalg.solve(eye + X @ e.J, X)
    return symmetrize(e.C + e.A @ Y @ mT(e.A))


def _tl(x, spec: LQGSpec, horizon: int):
    """Time-leading (T, ..., n, m) stack of a spec field."""
    if x.ndim == spec.Qf.ndim:  # stationary
        return jnp.broadcast_to(x[None], (horizon,) + x.shape)
    return jnp.moveaxis(x, -3, 0)


def kalman_forward_assoc(spec: LQGSpec, Sigma0: jnp.ndarray,
                         horizon: Optional[int] = None) -> jnp.ndarray:
    """Kalman gain schedule via associative scan; parity with
    :func:`lqg_tpu.ops.kalman.forward`."""
    if horizon is None:
        horizon = spec.A.shape[-3]
    A = _tl(spec.A, spec, horizon)
    F = _tl(spec.F, spec, horizon)
    V = _tl(spec.V, spec, horizon)
    W = _tl(spec.W, spec, horizon)

    Q = V @ mT(V)
    R = W @ mT(W)
    S = mT(F) @ psd_solve(R, F)

    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    IQS = eye + Q @ S
    AC = jnp.linalg.solve(IQS, jnp.concatenate([A, Q], axis=-1))
    Ae = AC[..., :, :n]
    Ce = symmetrize(AC[..., :, n:])
    Je = symmetrize(mT(A) @ jnp.linalg.solve(eye + S @ Q, S @ A))
    elems = RicattiElement(A=Ae, C=Ce, J=Je)

    # prefix_t = step_t o ... o step_0
    with jax.default_matmul_precision("highest"):
        prefix = lax.associative_scan(
            lambda a, b: _compose(first=a, second=b), elems, axis=0)

    # P_{t|t} = prefix_t(Sigma0) for t = 0..T-1; filtered covs shifted by one
    Pf = jax.vmap(lambda e: _apply(e, Sigma0))(prefix)
    Pf_prev = jnp.concatenate([Sigma0[None], Pf[:-1]], axis=0)  # P_{t-1|t-1}

    # predicted covariance and gain at step t (pointwise, fully parallel)
    Pp = A @ Pf_prev @ mT(A) + Q
    G = symmetrize(F @ Pp @ mT(F) + R)
    K = mT(psd_solve(G, F @ mT(Pp)))
    return K


def lqr_backward_assoc(spec: LQGSpec,
                       horizon: Optional[int] = None) -> Gains:
    """LQR gains via associative scan; parity with
    :func:`lqg_tpu.ops.riccati.backward` for zero affine/cross terms."""
    if horizon is None:
        horizon = spec.A.shape[-3]
    A = _tl(spec.A, spec, horizon)
    B = _tl(spec.B, spec, horizon)
    Q = _tl(spec.Q, spec, horizon)
    R = _tl(spec.R, spec, horizon)

    SB = B @ psd_solve(R, mT(B))
    elems = RicattiElement(A=mT(A), C=Q, J=SB)

    # backward composition: value_t = step_t o step_{t+1} o ... o step_{T-1}
    with jax.default_matmul_precision("highest"):
        prefix = lax.associative_scan(
            lambda a, b: _compose(first=b, second=a), elems, axis=0,
            reverse=True)

    Qf = spec.Qf
    S = jax.vmap(lambda e: _apply(e, Qf))(prefix)  # S_t for t = 0..T-1
    # gains at step t need S_{t+1}
    S_next = jnp.concatenate([S[1:], jnp.broadcast_to(
        Qf, (1,) + Qf.shape)], axis=0)

    H = symmetrize(R + mT(B) @ S_next @ B)
    G = mT(B) @ S_next @ A
    L = -psd_solve(H, G)
    l = jnp.zeros(L.shape[:-2] + (L.shape[-2],), dtype=L.dtype)
    return Gains(L=L, l=l, H=H)


class FilterElement(NamedTuple):
    """Associative element of the parallel (in-time) conditioned filter.

    Parametrizes the Gaussian "transition potential" over consecutive
    *post-conditioning* joint states (the five-matrix form of the
    temporal-parallelization-of-Bayesian-filtering literature; see PAPERS.md):

    ``p(z' | z, data) = N(z'; A z + b, C)`` and the local evidence potential
    on ``z``: ``exp(-z^T J z / 2 + z^T eta)``.

    ``A, C, J``: ``(..., j, j)`` are data-independent and shared across
    trials; ``b, eta``: ``(..., j, n)`` carry the per-trial data in trailing
    columns, so every composition is a shared ``(j, j)`` solve plus
    ``(j, j) @ (j, n)`` matmuls over the trial batch.
    """

    A: jnp.ndarray
    b: jnp.ndarray
    C: jnp.ndarray
    eta: jnp.ndarray
    J: jnp.ndarray


def _compose_filter(first: FilterElement, second: FilterElement) -> FilterElement:
    """Composition ``second o first`` (``first`` covers earlier time)."""
    Ai, bi, Ci, etai, Ji = first
    Aj, bj, Cj, etaj, Jj = second
    j = Ai.shape[-1]
    eye = jnp.eye(j, dtype=Ai.dtype)

    # one shared solve with stacked right-hand sides
    rhs = jnp.concatenate([Ai, Ci, bi + Ci @ etaj], axis=-1)
    M = jnp.linalg.solve(eye + Ci @ Jj, rhs)
    MAi, MCi, Mb = M[..., :j], M[..., j:2 * j], M[..., 2 * j:]
    A = Aj @ MAi
    b = Aj @ Mb + bj
    C = symmetrize(Aj @ MCi @ mT(Aj) + Cj)

    rhs2 = jnp.concatenate([Jj @ Ai, etaj - Jj @ bi], axis=-1)
    N = jnp.linalg.solve(eye + Jj @ Ci, rhs2)
    J = symmetrize(mT(Ai) @ N[..., :j] + Ji)
    eta = mT(Ai) @ N[..., j:] + etai
    return FilterElement(A=A, b=b, C=C, eta=eta, J=J)


def _gauss_terms(chol: jnp.ndarray, e: jnp.ndarray):
    """``(quad per column, logdet + d log 2pi)`` of ``N(e; 0, L L^T)``.

    ``chol``: ``(..., d, d)``; ``e``: ``(..., d, n)``.
    """
    import math

    w = lax.linalg.triangular_solve(chol, e, left_side=True, lower=True)
    quad = jnp.sum(w * w, axis=-2)  # (..., n)
    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    d = chol.shape[-1]
    logdet = 2.0 * jnp.sum(jnp.log(diag), axis=-1) + d * math.log(2 * math.pi)
    return quad, logdet


def trial_log_likelihood_assoc(joint, x: jnp.ndarray,
                               jitter: float = 0.0) -> jnp.ndarray:
    """Parallel-in-time marginalized trajectory likelihood.

    Numerically matches the sequential path
    (:func:`lqg_tpu.ops.gaussian.conditional_kernel` +
    :func:`lqg_tpu.ops.gaussian.trial_log_likelihood`) but evaluates the
    data-conditioned recursion in O(log T) depth via
    ``lax.associative_scan`` - SURVEY.md section 7 "hard part (2)": the
    condition-on-data step makes each timestep affine with data-dependent
    coefficients, which still admits a parallel scan once each *exact*
    conditioning (zero observation noise - the data IS the first ``d`` state
    dims, reference ``lqg/system.py:214-233``) is folded into the preceding
    prediction so every element stays finite:

    With ``E`` the first-``d`` selector, ``Q_t = G_t G_t^T`` and
    ``S_t = E Q_t E^T`` (PD because the observed dims carry process noise),
    the element for the step "propagate the conditioned state through
    ``(F_t, Q_t)``, then condition on ``x_{t+1}``" is

        K = Q E^T S^{-1},      A = (I - K E) F,   b = K x_{t+1},
        C = (I - K E) Q,       J = F^T E^T S^{-1} E F,
        eta = F^T E^T S^{-1} x_{t+1}.

    Sharding the element time axis over a mesh axis makes
    ``associative_scan`` ride collectives between devices - horizon
    (sequence) parallelism across cards.

    Args:
        joint: :class:`lqg_tpu.ops.gaussian.JointSystem` (``F (T, j, j)``,
            ``G (T, j, c)``).
        x: observed trajectories ``(n, T+1, d)``.

    Returns:
        ``(n,)`` log likelihoods of ``x[:, 1:]``.
    """
    Fj, Gj = joint.F, joint.G
    n, Tp1, d = x.shape
    T, j = Fj.shape[0], Fj.shape[-1]
    X = jnp.moveaxis(x, 0, -1)  # (T+1, d, n)
    eye_d = jitter * jnp.eye(d, dtype=Fj.dtype) if jitter else 0.0

    with jax.default_matmul_precision("highest"):
        Q = Gj @ mT(Gj)  # (T, j, j)

        # --- init: z_0 ~ N([x_0; 0], Q_0) conditioned on x_0, propagated
        # through step 0 (reference init simplifications, system.py:210-212)
        Sigma0 = Q[0]
        chol_S0 = jnp.linalg.cholesky(symmetrize(Sigma0[:d, :d]) + eye_d)
        G0 = mT(cho_solve(chol_S0, Sigma0[:d, :]))  # (j, d)
        Sigma0c = Sigma0 - G0 @ Sigma0[:d, :]
        mu0 = jnp.concatenate(
            [X[0], jnp.zeros((j - d, n), dtype=X.dtype)], axis=0)  # (j, n)
        m1p = Fj[0] @ mu0
        P1p = symmetrize(Fj[0] @ Sigma0c @ mT(Fj[0]) + Q[0])

        # score x_1 | x_0
        chol1 = jnp.linalg.cholesky(symmetrize(P1p[:d, :d]) + eye_d)
        quad1, logdet1 = _gauss_terms(chol1, X[1] - m1p[:d])
        ll = -0.5 * (quad1 + logdet1)

        # condition z_1 on x_1 -> filtered moments at t=1
        K1 = mT(cho_solve(chol1, P1p[:d, :]))
        m11 = m1p + K1 @ (X[1] - m1p[:d])
        P11 = symmetrize(P1p - K1 @ P1p[:d, :])

        if T == 1:
            return ll

        # --- generic elements for steps t = 1..T-1 (data x_2..x_T)
        Ft, Qt = Fj[1:], Q[1:]           # (T-1, j, j)
        EF = Ft[:, :d, :]                # E F_t
        St = symmetrize(Qt[:, :d, :d]) + eye_d
        chol_St = jnp.linalg.cholesky(St)
        Kt = mT(cho_solve(chol_St, Qt[:, :d, :]))  # (T-1, j, d)
        A = Ft - Kt @ EF
        C = symmetrize(Qt - Kt @ Qt[:, :d, :])
        SiEF = cho_solve(chol_St, EF)    # S^{-1} E F
        J = symmetrize(mT(EF) @ SiEF)
        xt1 = X[2:]                      # (T-1, d, n)
        b = Kt @ xt1
        eta = mT(EF) @ cho_solve(chol_St, xt1)

        elem0 = FilterElement(
            A=jnp.zeros((1, j, j), dtype=Fj.dtype), b=m11[None],
            C=P11[None], eta=jnp.zeros((1, j, n), dtype=Fj.dtype),
            J=jnp.zeros((1, j, j), dtype=Fj.dtype))
        elems = jax.tree.map(lambda a, g: jnp.concatenate([a, g], axis=0),
                             elem0, FilterElement(A=A, b=b, C=C, eta=eta, J=J))

        # prefix_k = elem_k o ... o elem_0: filtered moments at time k+1
        prefix = lax.associative_scan(
            lambda a, b_: _compose_filter(first=a, second=b_), elems, axis=0)
        m_filt = prefix.b[:-1]   # m_{t|t}, t = 1..T-1  ((T-1, j, n))
        P_filt = prefix.C[:-1]   # P_{t|t}

        # score x_{t+1} | x_{0..t} pointwise (fully parallel over t)
        m_pred = (Ft @ m_filt)[:, :d, :]
        S_pred = EF @ P_filt @ mT(EF) + St
        chol_pred = jnp.linalg.cholesky(symmetrize(S_pred))
        quad, logdet = _gauss_terms(chol_pred, xt1 - m_pred)
        ll = ll - 0.5 * (jnp.sum(quad, axis=0) + jnp.sum(logdet))

    return ll


class AffineElement(NamedTuple):
    M: jnp.ndarray
    c: jnp.ndarray


def affine_scan(M: jnp.ndarray, c: jnp.ndarray, x0: jnp.ndarray):
    """Parallel evaluation of ``x_{t+1} = M_t x_t + c_t``.

    ``M``: (T, n, n); ``c``: (T, n) or (T, n, k) batched columns.  Returns
    the stacked ``x_1..x_T``.  Used for horizon-parallel evaluation of the
    conditional-mean recursion in the likelihood (``lqg_tpu/ops/gaussian``).
    """
    vec = c.ndim == M.ndim - 1
    if vec:
        c = c[..., None]
        x0 = x0[..., None]

    def compose(first, second):
        return AffineElement(M=second.M @ first.M,
                             c=second.M @ first.c + second.c)

    prefix = lax.associative_scan(compose, AffineElement(M=M, c=c), axis=0)
    out = prefix.M @ x0 + prefix.c
    return out[..., 0] if vec else out
