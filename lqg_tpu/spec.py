"""Generalized LQG problem specification.

The spec is the single data contract between the model zoo, the solver kernels,
and the likelihood machinery.  It matches the semantics of the reference
container (``/root/reference/lqg/spec.py:5-19``): a finite-horizon, generalized
(affine cost terms ``q, r`` and cross term ``P``) discrete-time LQG problem

    x_{t+1} = A_t x_t + B_t u_t + V_t eps_t,      eps ~ N(0, I)
    y_t     = F_t x_t + W_t eta_t,                eta ~ N(0, I)
    J       = x_T' Qf x_T + qf' x_T
              + sum_t [ x' Q x + q' x + u' R u + r' u + 2 u' P x ]

``V`` and ``W`` are noise *scale* matrices (Cholesky-factor-like): the process /
observation noise covariances are ``V V^T`` / ``W W^T``.

Design notes (differences from the reference):

* The spec is a registered JAX pytree (``NamedTuple``), so whole specs flow
  through ``jit`` / ``vmap`` / ``scan`` / shardings without unpacking.  Leading
  batch axes (parameter particles, conditions, chains) are first-class: every
  kernel in :mod:`lqg_tpu.ops` is written batch-first with ``einsum``
  contractions so a vmapped spec costs nothing extra.
* Matrices may be stored *stationary* (no leading time axis) and broadcast
  inside the scan kernels, avoiding the ``O(T n^2)`` HBM traffic of
  materialized time stacks.  ``time_stack_spec`` (``lqg_tpu.utils``) produces
  the reference-shaped stacked layout when explicit time variation is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class LQGSpec(NamedTuple):
    """(generalized) LQG specification.

    All fields are arrays.  In the *stacked* layout, every field except
    ``Qf``/``qf`` carries a leading time axis of length ``T``; in the
    *stationary* layout the per-step fields are single matrices and the
    horizon is implied by the caller.  Arbitrary leading batch axes are
    allowed in both layouts.
    """

    Q: jnp.ndarray  # (T, n, n) state cost
    q: jnp.ndarray  # (T, n)   linear state cost
    Qf: jnp.ndarray  # (n, n)  terminal state cost
    qf: jnp.ndarray  # (n,)    linear terminal state cost
    P: jnp.ndarray  # (T, m, n) control-state cross cost
    R: jnp.ndarray  # (T, m, m) control cost
    r: jnp.ndarray  # (T, m)   linear control cost
    A: jnp.ndarray  # (T, n, n) state transition
    B: jnp.ndarray  # (T, n, m) control input
    V: jnp.ndarray  # (T, n, k) process noise scale (cov = V V^T)
    F: jnp.ndarray  # (T, p, n) observation
    W: jnp.ndarray  # (T, p, l) observation noise scale (cov = W W^T)

    @property
    def horizon(self) -> int:
        """Number of time steps T (stacked layout)."""
        return self.A.shape[-3]

    @property
    def state_dim(self) -> int:
        return self.A.shape[-1]

    @property
    def action_dim(self) -> int:
        return self.B.shape[-1]

    @property
    def obs_dim(self) -> int:
        return self.F.shape[-2]

    def astype(self, dtype) -> "LQGSpec":
        return LQGSpec(*(jnp.asarray(x, dtype=dtype) for x in self))
