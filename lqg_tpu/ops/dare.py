"""Steady-state (infinite-horizon) LQG via doubling iterations.

Greenfield capability with no reference counterpart: the reference is
strictly finite-horizon (``lqg/control/lqr.py``, ``lqg/belief/kf.py`` scan
all T steps).  For time-invariant problems the Riccati recursions converge
geometrically, so for long horizons the gain schedules are constant except
for boundary transients.  The structure-preserving doubling algorithm (SDA)
squares the recursion: iterate k gives the value function after 2^k steps,
so fixed points arrive in ~10-20 iterations independent of T - an O(log)
replacement for the O(T) scan: a few dozen small matmul rounds instead of
a long sequential dependency chain.

SDA for the DARE ``S = Q + A^T S (I + G S)^{-1} A`` with ``G = B R^{-1} B^T``:

    A_{k+1} = A_k (I + G_k H_k)^{-1} A_k
    G_{k+1} = G_k + A_k (I + G_k H_k)^{-1} G_k A_k^T
    H_{k+1} = H_k + A_k^T H_k (I + G_k H_k)^{-1} A_k

with ``A_0 = A, G_0 = G, H_0 = Q``; ``H_k -> S`` quadratically (Anderson &
Moore 1979; Chu, Fan & Lin 2005).  The filter ARE is the dual problem under
``A -> A^T, G -> F^T (W W^T)^{-1} F, Q -> V V^T``.

**Marginally stable caveat.** The tracking models drive penalized error with
random-walk (unit-eigenvalue) target states, so the infinite-horizon *cost*
diverges even though the *gains* converge (e.g. ``SubjectiveActor``: ``H_k``
grows like the horizon 2^k in the velocity direction while ``L_k`` is at its
fixed point from iterate ~10).  The gain-level solvers therefore monitor the
gain between doubling steps and freeze each batch element once converged,
before the diverging value iterate poisons the solve.  :func:`solve_dare`
(raw fixed-iteration SDA) is only for problems whose ARE solution is finite.

All functions are batch-first and differentiable (plain linear algebra with
``where``-gated updates; fixed iteration count keeps them jit/vmap-friendly).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from lqg_tpu.spec import LQGSpec
from lqg_tpu.ops.linalg import mT, psd_solve, symmetrize


class SteadyState(NamedTuple):
    """Converged stationary LQG gains."""

    L: jnp.ndarray  # (..., m, n) steady-state feedback gain
    K: jnp.ndarray  # (..., n, p) steady-state Kalman gain


def _sda_step(Ak, Gk, Hk):
    n = Ak.shape[-1]
    eye = jnp.eye(n, dtype=Ak.dtype)
    M = jnp.linalg.solve(eye + Gk @ Hk,
                         jnp.broadcast_to(eye, Gk.shape[:-2] + (n, n)))
    AM = Ak @ M
    A_next = AM @ Ak
    G_next = symmetrize(Gk + AM @ (Gk @ mT(Ak)))
    H_next = symmetrize(Hk + mT(Ak) @ (Hk @ (M @ Ak)))
    return A_next, G_next, H_next


def solve_dare(A: jnp.ndarray, G: jnp.ndarray, Q: jnp.ndarray,
               iters: int = 32) -> jnp.ndarray:
    """Solve ``S = Q + A^T S (I + G S)^{-1} A`` by fixed-iteration doubling.

    Args:
        A: open-loop matrix ``(..., n, n)``.
        G: PSD "gain" term (``B R^{-1} B^T`` for control), ``(..., n, n)``.
        Q: PSD constant term, ``(..., n, n)``.
        iters: doubling steps; iterate k covers a ``2^k``-step horizon.

    Requires a finite ARE solution (stabilizable + detectable); for the
    marginally stable tracking models use :func:`steady_control` /
    :func:`steady_filter`, which converge at the gain level.  Batched over
    leading axes; differentiable.
    """
    shape = jnp.broadcast_shapes(A.shape, G.shape, Q.shape)
    A0 = jnp.broadcast_to(A, shape)
    G0 = jnp.broadcast_to(symmetrize(G), shape)
    H0 = jnp.broadcast_to(symmetrize(Q), shape)

    def step(carry, _):
        return _sda_step(*carry), None

    with jax.default_matmul_precision("highest"):
        (_, _, S), _ = lax.scan(step, (A0, G0, H0), None, length=iters)
    return S


def _doubling_gains(A: jnp.ndarray, G: jnp.ndarray, Q: jnp.ndarray,
                    gain_fn: Callable[[jnp.ndarray], jnp.ndarray],
                    iters: int, tol: float) -> jnp.ndarray:
    """Run SDA, computing ``gain_fn(H_k)`` each doubling step, and freeze
    each batch element once its gain stops moving (relative tolerance
    ``tol``; defaulted per dtype by the callers)."""
    shape = jnp.broadcast_shapes(A.shape, G.shape, Q.shape)
    A0 = jnp.broadcast_to(A, shape)
    G0 = jnp.broadcast_to(symmetrize(G), shape)
    H0 = jnp.broadcast_to(symmetrize(Q), shape)
    gain0 = gain_fn(H0)
    done0 = jnp.zeros(shape[:-2], dtype=bool)

    def step(carry, _):
        Ak, Gk, Hk, gain, done = carry
        A_new, G_new, H_new = _sda_step(Ak, Gk, Hk)
        gain_new = gain_fn(H_new)
        delta = jnp.linalg.norm(gain_new - gain, axis=(-2, -1))
        scale = 1.0 + jnp.linalg.norm(gain_new, axis=(-2, -1))
        done_new = done | (delta <= tol * scale)
        keep = done[..., None, None]
        out = (jnp.where(keep, Ak, A_new), jnp.where(keep, Gk, G_new),
               jnp.where(keep, Hk, H_new), jnp.where(keep, gain, gain_new),
               done_new)
        return out, None

    with jax.default_matmul_precision("highest"):
        (_, _, _, gain, _), _ = lax.scan(
            step, (A0, G0, H0, gain0, done0), None, length=iters)
    return gain


def _default_tol(dtype) -> float:
    # a few doubling steps past quadratic convergence: ~eps^(3/4)
    return float(jnp.finfo(dtype).eps) ** 0.75


def steady_control(spec: LQGSpec, iters: int = 32,
                   tol: float = None, jitter: float = 0.0) -> jnp.ndarray:
    """Steady-state LQR feedback gain ``L`` (``u = L x``).

    Requires a stationary spec with zero affine/cross cost terms.  Matches
    the early-time rows of the finite-horizon backward pass for large ``T``.
    """
    A, B, Q, R = spec.A, spec.B, spec.Q, spec.R
    tol = _default_tol(A.dtype) if tol is None else tol
    G = B @ psd_solve(R, mT(B), jitter=jitter)

    def gain_fn(S):
        SB = S @ B
        H = R + mT(B) @ SB
        return -psd_solve(H, mT(SB) @ A, jitter=jitter)

    return _doubling_gains(A, G, Q, gain_fn, iters, tol)


def steady_filter(spec: LQGSpec, iters: int = 32,
                  tol: float = None, jitter: float = 0.0) -> jnp.ndarray:
    """Steady-state Kalman gain ``K``.

    Solves the filter ARE (predicted-state covariance ``P``) as the dual
    DARE and returns ``K = P F^T (F P F^T + W W^T)^{-1}``.  Matches the
    late-time rows of the finite-horizon forward pass for large ``T``.
    """
    A, F, V, W = spec.A, spec.F, spec.V, spec.W
    tol = _default_tol(A.dtype) if tol is None else tol
    VVt = V @ mT(V)
    WWt = W @ mT(W)
    G = mT(F) @ psd_solve(WWt, F, jitter=jitter)

    def gain_fn(P):
        PFt = P @ mT(F)
        return mT(psd_solve(F @ PFt + WWt, mT(PFt), jitter=jitter))

    return _doubling_gains(mT(A), G, VVt, gain_fn, iters, tol)


def steady_state(spec: LQGSpec, iters: int = 32, tol: float = None,
                 jitter: float = 0.0) -> SteadyState:
    """Steady-state gains of a stationary LQG spec; see :class:`SteadyState`."""
    L = steady_control(spec, iters=iters, tol=tol, jitter=jitter)
    K = steady_filter(spec, iters=iters, tol=tol, jitter=jitter)
    return SteadyState(L=L, K=K)
