"""Finite-horizon generalized LQR: Riccati backward recursion.

Semantics match reference ``lqg/control/lqr.py:16-42`` (affine cost terms and
control-state cross term included), with these differences:

* **Batch-first**: every operation broadcasts over arbitrary leading batch axes
  (parameter particles, conditions, chains).  A vmapped call lowers to the same
  batched einsums, so thousands of Riccati solves share each scan step.
* **Cholesky solves** instead of ``linalg.solve`` on the (symmetric PD)
  control Hessian ``H``.
* The reference's ``eigh`` eigenvalue clamp (``lqr.py:26-28``) is available as
  ``regularize="eigh"`` for parity; the default is the smooth ``"jitter"``
  guard, and ``"none"`` is the trusting fast path (exact whenever ``R > 0``).
* **Stationary specs** (no time axis) are scanned without materializing
  ``(T, n, n)`` stacks in HBM.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from lqg_tpu.spec import LQGSpec
from lqg_tpu.ops.linalg import mT, cho_solve, regularize_spd, symmetrize


class Gains(NamedTuple):
    """Time-stacked LQR feedback gains: ``u_t = L_t x_t + l_t``."""

    L: jnp.ndarray  # (T, m, n) feedback gain
    l: jnp.ndarray  # (T, m)    feedforward term
    H: jnp.ndarray = None  # (T, m, m) control Hessian (regularized)


def _step(carry, inp, *, eps: float, regularize: str):
    S, s = carry
    Q, q, P, R, r, A, B = inp

    SA = S @ A
    H = symmetrize(R + mT(B) @ (S @ B))
    G = P + mT(B) @ SA
    g = r + jnp.einsum("...nm,...n->...m", B, s)

    Ht = regularize_spd(H, eps, regularize)
    chol = jnp.linalg.cholesky(Ht)
    L = -cho_solve(chol, G)
    l = -cho_solve(chol, g)

    # value-function update (uses the unregularized H, as the reference does
    # at lqr.py:33-34)
    HL = H @ L
    S_new = Q + mT(A) @ SA + mT(L) @ HL + mT(L) @ G + mT(G) @ L
    s_new = (
        q
        + jnp.einsum("...nm,...n->...m", A, s)
        + jnp.einsum("...mn,...m->...n", G, l)
        + jnp.einsum("...mn,...m->...n", HL, l)
        + jnp.einsum("...mn,...m->...n", L, g)
    )
    return (symmetrize(S_new), s_new), (L, l, Ht)


def backward(
    spec: LQGSpec,
    horizon: Optional[int] = None,
    eps: float = 1e-8,
    regularize: str = "jitter",
) -> Gains:
    """Run the Riccati backward pass; returns time-stacked :class:`Gains`.

    Args:
        spec: stacked layout (time axis at ``-3``) or stationary layout (no
            time axis, ``horizon`` required).
        horizon: number of steps for stationary specs.
        eps: regularization scale for the control Hessian.
        regularize: ``"jitter"`` (default), ``"none"``, or ``"eigh"``
            (reference parity, ``lqr.py:26-28``).

    Outputs have the time axis *leading* (shape ``(T, batch..., m, n)``); use
    :func:`jnp.moveaxis` if a batch-leading layout is needed.
    """
    step = partial(_step, eps=eps, regularize=regularize)
    stationary = spec.A.ndim == spec.Qf.ndim

    # full-f32 matmuls: reduced-precision (TF32) products compound to
    # percent-level gain error over T=1000 Riccati steps
    ctx = jax.default_matmul_precision("highest")
    if stationary:
        if horizon is None:
            raise ValueError("stationary spec requires explicit horizon")
        consts = (spec.Q, spec.q, spec.P, spec.R, spec.r, spec.A, spec.B)
        with ctx:
            (_, _), (L, l, H) = lax.scan(
                lambda c, _: step(c, consts), (spec.Qf, spec.qf), None,
                length=horizon, reverse=True,
            )
        return Gains(L=L, l=l, H=H)
    else:
        xs = (
            jnp.moveaxis(spec.Q, -3, 0),
            jnp.moveaxis(spec.q, -2, 0),
            jnp.moveaxis(spec.P, -3, 0),
            jnp.moveaxis(spec.R, -3, 0),
            jnp.moveaxis(spec.r, -2, 0),
            jnp.moveaxis(spec.A, -3, 0),
            jnp.moveaxis(spec.B, -3, 0),
        )
        with ctx:
            (_, _), (L, l, H) = lax.scan(step, (spec.Qf, spec.qf), xs,
                                         reverse=True)

    return Gains(L=L, l=l, H=H)


def backward_multiplicative(
    spec: LQGSpec,
    C: jnp.ndarray,
    horizon: Optional[int] = None,
    eps: float = 1e-8,
    regularize: str = "jitter",
) -> Gains:
    """Riccati backward pass with control-multiplicative (signal-dependent)
    noise, after Todorov (2005).

    The dynamics carry an additional noise term ``sum_i eps_i C_i u`` with
    ``eps_i ~ N(0, 1)``: motor noise whose magnitude scales with the control
    signal (Harris & Wolpert 1998).  The optimal controller differs from
    plain LQR only in the control Hessian:

        H = R + B^T S B + sum_i C_i^T S C_i

    which penalizes large controls for the extra noise they inject.  This is
    a greenfield capability: the reference reserves a ``signal_dep_noise``
    prior (``lqg/infer/prior.py:11``) but ships no model using it.

    Args:
        spec: stationary spec (no time axis) with zero affine terms.
        C: control-noise scales ``(k, n, m)`` - ``k`` independent noise
            channels, each mapping controls to state perturbations.
        horizon: number of steps.

    Returns time-stacked :class:`Gains`.
    """
    if spec.A.ndim != spec.Qf.ndim:
        raise ValueError("backward_multiplicative expects a stationary spec")
    if horizon is None:
        raise ValueError("stationary spec requires explicit horizon")

    A, B, Q, R, P = spec.A, spec.B, spec.Q, spec.R, spec.P

    def step(S, _):
        SB = S @ B
        # extra control-dependent-noise penalty: sum_i C_i^T S C_i
        CtSC = jnp.einsum("kni,...nm,kmj->...ij", C, S, C)
        H = symmetrize(R + mT(B) @ SB + CtSC)
        G = P + mT(B) @ (S @ A)
        Ht = regularize_spd(H, eps, regularize)
        chol = jnp.linalg.cholesky(Ht)
        L = -cho_solve(chol, G)
        S_new = symmetrize(Q + mT(A) @ (S @ A) + mT(G) @ L)
        return S_new, (L, Ht)

    S0 = spec.Qf
    with jax.default_matmul_precision("highest"):
        _, (L, H) = lax.scan(step, S0, None, length=horizon, reverse=True)
    l = jnp.zeros(L.shape[:-2] + (L.shape[-2],), dtype=L.dtype)
    return Gains(L=L, l=l, H=H)
