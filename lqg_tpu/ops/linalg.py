"""Small-matrix linear-algebra helpers, batch-first.

The LQG state dims here are tiny (2-40), so the cost model is dominated by
fusion and batching, not per-matrix FLOPs.  Everything takes arbitrary leading
batch axes and uses Cholesky-based solves (the reference uses
``jnp.linalg.inv`` at ``lqg/belief/kf.py:12`` and ``eigh`` clamps at
``lqg/control/lqr.py:27-28``; Cholesky is both faster and better conditioned,
and avoids the non-differentiability of ``eigh`` at degenerate spectra).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mT(x: jnp.ndarray) -> jnp.ndarray:
    """Transpose the trailing two axes."""
    return jnp.swapaxes(x, -1, -2)


def symmetrize(x: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (x + mT(x))


def psd_solve(M: jnp.ndarray, b: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Solve ``M x = b`` for symmetric positive-definite ``M`` via Cholesky.

    ``b`` may be a matrix or (batched) vector; leading batch axes broadcast.
    """
    M = symmetrize(M)
    if jitter:
        M = M + jitter * jnp.eye(M.shape[-1], dtype=M.dtype)
    chol = jnp.linalg.cholesky(M)
    return cho_solve(chol, b)


def cho_solve(chol: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve ``L L^T x = b`` given lower-triangular ``L`` (batched)."""
    vec = b.ndim == chol.ndim - 1
    if vec:
        b = b[..., None]
    y = jax.lax.linalg.triangular_solve(chol, b, left_side=True, lower=True)
    x = jax.lax.linalg.triangular_solve(chol, y, left_side=True, lower=True,
                                        transpose_a=True)
    return x[..., 0] if vec else x


def tri_logdet(chol: jnp.ndarray) -> jnp.ndarray:
    """``log det(L L^T)`` from the Cholesky factor ``L``."""
    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def make_psd(M: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """Clip eigenvalues of a symmetric matrix to ``>= eps``.

    Parity with reference ``make_psd`` (``lqg/tracking/point_mass.py:130-144``).
    Used only at model-construction time (cheap, not in hot loops).
    """
    M_sym = symmetrize(M)
    eigvals, eigvecs = jnp.linalg.eigh(M_sym)
    eigvals = jnp.clip(eigvals, min=eps)
    return jnp.einsum("...ij,...j,...kj->...ik", eigvecs, eigvals, eigvecs)


def regularize_spd(H: jnp.ndarray, eps: float, mode: str) -> jnp.ndarray:
    """Guard a nominally-PD matrix before solving.

    Modes:

    * ``"none"``  - trust PD-ness (fast path; correct whenever ``R > 0``).
    * ``"jitter"``- add ``eps * mean(diag(H)) * I`` (smooth, differentiable
      everywhere, and *scale-invariant*: the relative perturbation is ``eps``
      regardless of the Hessian's magnitude, which matters because small
      action costs make ``H`` tiny - e.g. ``OptimalActor``'s 1e-3).
    * ``"eigh"``  - reference-parity clamp: lift the smallest eigenvalue to
      ``eps`` if negative-ish (``lqg/control/lqr.py:26-28``, citing section
      5.4.1 of Li's PhD thesis).  Non-smooth at degenerate spectra; only for
      parity testing.
    """
    if mode == "none":
        return H
    if mode == "jitter":
        scale = jnp.mean(jnp.diagonal(H, axis1=-2, axis2=-1), axis=-1)
        lift = eps * (scale + jnp.asarray(1e-30, H.dtype))
        return H + lift[..., None, None] * jnp.eye(H.shape[-1], dtype=H.dtype)
    if mode == "eigh":
        evals = jnp.linalg.eigvalsh(H)
        lift = jnp.maximum(0.0, eps - evals[..., 0])
        return H + lift[..., None, None] * jnp.eye(H.shape[-1], dtype=H.dtype)
    raise ValueError(f"unknown regularization mode: {mode!r}")
