"""Square-root (QR array-form) Riccati and Kalman recursions.

Greenfield numerics layer with no reference counterpart: the reference runs
plain covariance recursions in float64 (``jax_enable_x64`` set globally in
``lqg/optim.py:9-11``) and guards conditioning with eigenvalue clamps
(``lqg/control/lqr.py:26-28``, ``lqg/tracking/point_mass.py:130-144``).  On
an accelerator the natural compute dtype is float32, where the ``P <- (I - KF) P`` style
updates lose symmetry/PSD-ness over long horizons.  The array (QR) form
propagates Cholesky-like factors instead of covariances: every intermediate
is a product of factors, so covariances stay PSD by construction and the
effective precision is roughly doubled (Verhaegen & Van Dooren 1986 style
analysis).

Both recursions keep the framework conventions: batch-first broadcasting over
arbitrary leading axes, stationary (no time axis) or stacked specs, time axis
leading on outputs, and the same :class:`lqg_tpu.ops.riccati.Gains` result
type so :meth:`lqg_tpu.system.System.gains` can swap them in via
``method="sqrt"``.

Restrictions: the square-root Riccati form requires zero affine cost terms
``q, r`` and zero control-state cross term ``P`` (all shipped models satisfy
this; ``time_stack_spec`` zeroes them).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from lqg_tpu.spec import LQGSpec
from lqg_tpu.ops.linalg import mT
from lqg_tpu.ops.riccati import Gains


def psd_sqrt(M: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Symmetric square root of a PSD matrix via eigendecomposition.

    Handles singular inputs (negative eigenvalues are clipped to ``eps``),
    unlike ``jnp.linalg.cholesky``.  Used at recursion *setup* (cost matrices,
    initial covariance), never inside the scans.
    """
    w, V = jnp.linalg.eigh(0.5 * (M + mT(M)))
    w = jnp.clip(w, min=eps)
    return jnp.einsum("...ij,...j,...kj->...ik", V, jnp.sqrt(w), V)


def _vcat(*blocks: jnp.ndarray) -> jnp.ndarray:
    """Stack matrix blocks along rows (axis ``-2``), broadcasting only the
    leading batch axes (row counts may differ)."""
    batch = jnp.broadcast_shapes(*(b.shape[:-2] for b in blocks))
    return jnp.concatenate(
        [jnp.broadcast_to(b, batch + b.shape[-2:]) for b in blocks], axis=-2)


def _tri_factor(M: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular factor ``S`` with ``S S^T = M^T M`` via QR.

    ``M`` is a tall pre-array ``(..., k, n)`` with ``k >= n``; returns the
    transposed R factor with a positive diagonal (canonical Cholesky-like
    orientation, which keeps the factors comparable across steps).
    """
    r = jnp.linalg.qr(M, mode="r")
    d = jnp.diagonal(r, axis1=-2, axis2=-1)
    sign = jnp.where(d < 0, -1.0, 1.0).astype(r.dtype)
    return mT(r * sign[..., None])


def _kf_sqrt_step(S, inp):
    """One array-form Kalman step on the Cholesky-like factor ``S``.

    Predict via QR of ``[S^T A^T; V^T]``; measurement update via QR of the
    block pre-array

        [[W^T,          0 ]            [[Y^T,  Z^T   ]
         [S_pred^T F^T, S_pred^T]]  ->  [0,    S_new^T]]

    whose post-array blocks give the innovation factor ``Y`` (``Y Y^T = G``),
    the updated factor ``S_new``, and the gain ``K = Z Y^{-1}``.
    """
    A, F, V, W = inp
    n = A.shape[-1]
    p = F.shape[-2]

    # predict: S_pred S_pred^T = A S S^T A^T + V V^T
    S_pred = _tri_factor(_vcat(mT(A @ S), mT(V)))

    # measurement update pre-array, shape (..., pw + n, p + n)
    SF = mT(F @ S_pred)  # (..., n, p) = S_pred^T F^T
    top = jnp.concatenate(
        [mT(W), jnp.zeros(W.shape[:-2] + (W.shape[-1], n), W.dtype)], axis=-1)
    bot = jnp.concatenate([SF, mT(S_pred)], axis=-1)
    post = _tri_factor(_vcat(top, bot))

    Y = post[..., :p, :p]  # chol(F P F^T + W W^T)
    Z = post[..., p:, :p]  # P F^T Y^{-T}
    S_new = post[..., p:, p:]

    # K = Z Y^{-1}: solve Y^T K^T = Z^T (Y lower-triangular)
    Kt = lax.linalg.triangular_solve(Y, mT(Z), left_side=True, lower=True,
                                     transpose_a=True)
    return S_new, mT(Kt)


def kalman_forward_sqrt(
    spec: LQGSpec,
    Sigma0: jnp.ndarray,
    horizon: Optional[int] = None,
) -> jnp.ndarray:
    """Square-root Kalman gain schedule; drop-in for
    :func:`lqg_tpu.ops.kalman.forward` with better float32 conditioning.

    Args:
        spec: stacked (time axis at ``-3``) or stationary layout.
        Sigma0: initial state covariance (may be singular; factored via
            :func:`psd_sqrt`).
        horizon: required for stationary specs.

    Returns Kalman gains ``K`` with the time axis leading:
    ``(T, batch..., n, p)``.
    """
    stationary = spec.A.ndim == spec.Qf.ndim
    S0 = psd_sqrt(Sigma0)
    # the scan carry must already have the spec's batch shape
    batch = spec.A.shape[:-2] if stationary else spec.A.shape[:-3]
    batch = jnp.broadcast_shapes(batch, S0.shape[:-2])
    S0 = jnp.broadcast_to(S0, batch + S0.shape[-2:])

    with jax.default_matmul_precision("highest"):
        if stationary:
            if horizon is None:
                raise ValueError("stationary spec requires explicit horizon")
            consts = (spec.A, spec.F, spec.V, spec.W)
            _, K = lax.scan(lambda c, _: _kf_sqrt_step(c, consts), S0, None,
                            length=horizon)
        else:
            xs = tuple(jnp.moveaxis(x, -3, 0)
                       for x in (spec.A, spec.F, spec.V, spec.W))
            _, K = lax.scan(_kf_sqrt_step, S0, xs)
    return K


def _riccati_sqrt_step(U, inp, *, jitter: float):
    """One square-root Riccati step on the cost-to-go factor ``U``
    (``S = U U^T``).

    Gains from the factored Hessian ``H = R + (U^T B)^T (U^T B)``; the value
    update uses the Joseph-form identity

        S_prev = Q + (A + B L)^T S (A + B L) + L^T R L

    (valid at the optimal ``L`` with zero cross term), realized as a QR of the
    stacked factor ``[U^T (A + B L); Rs^T L; Qs^T]``.
    """
    A, B, Qs, R, Rs = inp

    UtB = mT(U) @ B  # (..., n, m)
    H = R + mT(UtB) @ UtB
    if jitter:
        scale = jnp.mean(jnp.diagonal(H, axis1=-2, axis2=-1), axis=-1)
        H = H + (jitter * scale)[..., None, None] * jnp.eye(
            H.shape[-1], dtype=H.dtype)
    cholH = jnp.linalg.cholesky(H)
    G = mT(UtB) @ (mT(U) @ A)  # B^T S A
    y = lax.linalg.triangular_solve(cholH, G, left_side=True, lower=True)
    L = -lax.linalg.triangular_solve(cholH, y, left_side=True, lower=True,
                                     transpose_a=True)

    Acl = A + B @ L
    U_new = _tri_factor(_vcat(mT(U) @ Acl, mT(Rs) @ L, mT(Qs)))
    return U_new, (L, H)


def riccati_backward_sqrt(
    spec: LQGSpec,
    horizon: Optional[int] = None,
    jitter: float = 0.0,
) -> Gains:
    """Square-root Riccati backward pass; drop-in for
    :func:`lqg_tpu.ops.riccati.backward` on specs with zero affine/cross cost
    terms (``q = r = 0``, ``P = 0``).

    The cost matrices are factored once at setup (``Qs Qs^T = Q``,
    ``Rs Rs^T = R`` via :func:`psd_sqrt`, so singular ``Q`` - e.g. the
    tracking error cost ``[[1,-1],[-1,1]]`` - is fine); the recursion then
    touches only factors.

    Returns time-stacked :class:`~lqg_tpu.ops.riccati.Gains` (with ``l = 0``).
    """
    stationary = spec.A.ndim == spec.Qf.ndim
    step = partial(_riccati_sqrt_step, jitter=jitter)

    U_T = psd_sqrt(spec.Qf)
    batch = spec.A.shape[:-2] if stationary else spec.A.shape[:-3]
    batch = jnp.broadcast_shapes(batch, U_T.shape[:-2])
    U_T = jnp.broadcast_to(U_T, batch + U_T.shape[-2:])
    with jax.default_matmul_precision("highest"):
        if stationary:
            if horizon is None:
                raise ValueError("stationary spec requires explicit horizon")
            consts = (spec.A, spec.B, psd_sqrt(spec.Q), spec.R,
                      psd_sqrt(spec.R))
            _, (L, H) = lax.scan(lambda c, _: step(c, consts), U_T, None,
                                 length=horizon, reverse=True)
        else:
            Qs = psd_sqrt(jnp.moveaxis(spec.Q, -3, 0))
            R_t = jnp.moveaxis(spec.R, -3, 0)
            xs = (jnp.moveaxis(spec.A, -3, 0), jnp.moveaxis(spec.B, -3, 0),
                  Qs, R_t, psd_sqrt(R_t))
            _, (L, H) = lax.scan(step, U_T, xs, reverse=True)

    l = jnp.zeros(L.shape[:-1], dtype=L.dtype)
    return Gains(L=L, l=l, H=H)
