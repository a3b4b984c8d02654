"""Stochastic/deterministic variational inference and point estimation.

Native replacement for the reference's NumPyro SVI usage: point estimation
(MLE/MAP) is gradient ascent on the :class:`ProbModel` objective with an
optax optimizer inside one ``lax.scan`` (the reference runs NumPyro SVI with
an empty guide + Adam, ``lqg/infer/mle.py:14-25``), and :class:`AutoMVN` is
a full-rank Gaussian guide for variational posteriors / NeuTra
preconditioning (the role of the reference's ``AutoBNAFNormal``,
``lqg/infer/utils.py:21-31``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax
from jax import lax, random

from lqg_tpu.infer.models import ProbModel


def optimize(model: ProbModel, steps: int = 2000, step_size: float = 0.01,
             optimizer=None, return_unconstrained: bool = False,
             chunk_steps: int = 500):
    """Maximize the model objective; returns (constrained params, losses).

    With priors this is MAP estimation; without, MLE - matching the
    reference's ``max_likelihood`` semantics.  With
    ``return_unconstrained=True`` the raw optimum in the model's sampling
    space is appended to the return tuple (needed by NeuTra callers, whose
    sampling space - the flow's eps - has no per-parameter transforms to
    invert through).  ``chunk_steps`` bounds the scan steps per device
    launch (see :func:`fit_auto_mvn`).
    """
    if optimizer is None:
        optimizer = optax.adam(step_size)

    u0 = model.init_unconstrained()
    opt_state = optimizer.init(u0)

    loss_fn = jax.value_and_grad(model.potential)

    def step(carry, _):
        u, opt_state = carry
        loss, g = loss_fn(u)
        updates, opt_state = optimizer.update(g, opt_state, u)
        u = optax.apply_updates(u, updates)
        return (u, opt_state), loss

    chunk = jax.jit(lambda carry, n: lax.scan(step, carry, None, length=n),
                    static_argnums=1)
    carry, losses = (u0, opt_state), []
    for i in range(0, steps, chunk_steps):
        n = min(chunk_steps, steps - i)
        carry, ls = chunk(carry, n)
        ls.block_until_ready()
        losses.append(ls)
    u = carry[0]
    losses = jnp.concatenate(losses)
    if return_unconstrained:
        return model.constrain(u), losses, u
    return model.constrain(u), losses


class AutoMVN(NamedTuple):
    """Full-rank Gaussian guide in unconstrained space:
    ``u = loc + scale_tril @ eps``."""

    loc: jnp.ndarray
    scale_tril: jnp.ndarray

    def sample(self, key, sample_shape=()):
        eps = random.normal(key, tuple(sample_shape) + self.loc.shape)
        return self.loc + jnp.einsum("ij,...j->...i", self.scale_tril, eps)

    def transform(self, eps):
        return self.loc + self.scale_tril @ eps

    def transform_and_logdet(self, eps):
        return self.transform(eps), self.log_det()

    def log_det(self):
        return jnp.sum(jnp.log(jnp.abs(jnp.diag(self.scale_tril))))


def fit_auto_mvn(model: ProbModel, rng_key, steps: int = 5000,
                 step_size: float = 0.003, num_particles: int = 8,
                 chunk_steps: int = 200):
    """Fit a full-rank Gaussian guide by maximizing the ELBO.

    Returns ``(AutoMVN, losses)``.  Used standalone (variational posterior)
    or as the NeuTra preconditioner.  ``chunk_steps`` bounds the scan
    steps per device launch (see :func:`lqg_tpu.infer.flows.fit_auto_iaf`).
    """
    zdim = model.init_unconstrained().shape[0]
    loc0 = model.init_unconstrained()
    log_diag0 = jnp.full((zdim,), -1.0)
    offdiag0 = jnp.zeros((zdim, zdim))

    optimizer = optax.adam(step_size)
    params0 = (loc0, log_diag0, offdiag0)
    opt_state = optimizer.init(params0)

    def guide(params):
        loc, log_diag, off = params
        tril = jnp.tril(off, -1) + jnp.diag(jnp.exp(log_diag))
        return AutoMVN(loc=loc, scale_tril=tril)

    def neg_elbo(params, key):
        g = guide(params)
        eps = random.normal(key, (num_particles, zdim))
        us = jax.vmap(g.transform)(eps)
        # ELBO = E_q[log p(u)] + H[q];  H = log|det| + const
        logp = jax.vmap(model.log_joint_unconstrained)(us)
        return -(jnp.mean(logp) + g.log_det())

    loss_fn = jax.value_and_grad(neg_elbo)

    def step(carry, key):
        params, opt_state = carry
        loss, grads = loss_fn(params, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    chunk = jax.jit(lambda carry, keys: lax.scan(step, carry, keys))
    carry, losses = (params0, opt_state), []
    for i in range(0, steps, chunk_steps):
        n = min(chunk_steps, steps - i)
        carry, ls = chunk(carry, random.split(random.fold_in(rng_key, i), n))
        ls.block_until_ready()
        losses.append(ls)
    (params, _) = carry
    return guide(params), jnp.concatenate(losses)


def laplace_guide(model: ProbModel, eig_floor: float = 1e-6):
    """Laplace (inverse-Hessian) affine guide at the model's init point.

    Computes the exact Hessian of the unconstrained-space potential at
    ``model.init_unconstrained()`` (run a MAP fit first so that point is the
    mode) via forward-over-reverse autodiff and returns
    ``AutoMVN(loc=mode, scale_tril=chol(H^{-1}))`` plus the Hessian
    eigenvalues.  Under Bernstein-von-Mises concentration (~1.2e5
    observations in the data.mat fit) the posterior is locally near-Gaussian,
    so NUTS in the guide's ``eps`` space sees an ~isotropic target.

    Unlike warmup mass adaptation or empirical preconditioning from a
    previous run's draws (both estimate scales from samples, which
    *under*-estimate directions the chains never explored - exactly the
    slow ridge they are meant to fix), the Hessian measures the local metric
    directly and deterministically.  Eigenvalues below ``eig_floor`` times
    the largest are clamped (directions flatter than that are prior-scale
    and do not need more room than the clamp gives them).
    """
    from lqg_tpu.system import force_scan_dispatch

    u0 = model.init_unconstrained()
    potential = lambda u: -model.log_joint_unconstrained(u)
    # forward-over-reverse needs JVPs; the fused Pallas kernels only define
    # reverse-mode custom_vjp adjoints, so pin dispatch to the XLA scans
    with force_scan_dispatch():
        hess = jax.jacfwd(jax.grad(potential))(u0)
    hess = 0.5 * (hess + hess.T)
    w, v = jnp.linalg.eigh(hess)
    w = jnp.maximum(w, eig_floor * jnp.max(w))
    hinv = (v / w) @ v.T
    scale_tril = jnp.linalg.cholesky(0.5 * (hinv + hinv.T))
    return AutoMVN(loc=u0, scale_tril=scale_tril), w
