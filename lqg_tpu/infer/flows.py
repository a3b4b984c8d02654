"""Autoregressive normalizing flows for variational guides and NeuTra.

The reference preconditions NUTS with a block neural autoregressive flow
(``AutoBNAFNormal``, ``lqg/infer/utils.py:21-31``).  This module provides the
native equivalent: an inverse-autoregressive-flow (IAF) guide built from
MADE-masked MLPs in pure JAX.  The forward transform ``eps -> u`` and its
log-determinant evaluate in one pass (triangular Jacobian with gate
diagonals), which is exactly the direction ELBO fitting and NeuTra need; the
slow inverse is never required.

Everything here is a pytree of arrays + pure functions, so guides vmap/jit
cleanly and the NeuTra-reparametrized potential compiles into the same XLA
program as the LQG likelihood.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax, random


def _made_degrees(dim: int, hidden: int, reverse: bool):
    """MADE connectivity degrees: inputs 1..D (or reversed), hidden cycling
    1..D-1 so every hidden unit can feed at least one output."""
    d_in = jnp.arange(1, dim + 1)
    if reverse:
        d_in = d_in[::-1]
    if dim == 1:
        d_hid = jnp.zeros(hidden, dtype=jnp.int32)
    else:
        d_hid = 1 + jnp.arange(hidden) % (dim - 1)
    return d_in, d_hid


def _made_masks(dim: int, hidden: int, reverse: bool):
    """Binary masks (input->hidden, hidden->hidden, hidden->output) enforcing
    that output ``i`` depends only on inputs strictly before ``i`` in the
    layer's ordering."""
    d_in, d_hid = _made_degrees(dim, hidden, reverse)
    m1 = (d_hid[:, None] >= d_in[None, :]).astype(jnp.float32)
    m2 = (d_hid[:, None] >= d_hid[None, :]).astype(jnp.float32)
    m3 = (d_in[:, None] > d_hid[None, :]).astype(jnp.float32)
    return m1, m2, m3


class IAFLayerParams(NamedTuple):
    W1: jnp.ndarray
    b1: jnp.ndarray
    W2: jnp.ndarray
    b2: jnp.ndarray
    Wm: jnp.ndarray
    bm: jnp.ndarray
    Ws: jnp.ndarray
    bs: jnp.ndarray


def _init_iaf_layer(key, dim: int, hidden: int, scale: float = 1e-3):
    """Near-identity initialization: shift/gate heads start tiny so the flow
    begins as (almost) the identity map."""
    ks = random.split(key, 4)
    he = math.sqrt(2.0 / max(dim, 1))
    return IAFLayerParams(
        W1=he * random.normal(ks[0], (hidden, dim)),
        b1=jnp.zeros(hidden),
        W2=math.sqrt(2.0 / hidden) * random.normal(ks[1], (hidden, hidden)),
        b2=jnp.zeros(hidden),
        Wm=scale * random.normal(ks[2], (dim, hidden)),
        bm=jnp.zeros(dim),
        Ws=scale * random.normal(ks[3], (dim, hidden)),
        bs=jnp.zeros(dim),
    )


def _iaf_layer_apply(p: IAFLayerParams, masks, z):
    """One gated IAF layer: ``z' = sigma(s) * z + (1 - sigma(s)) * m`` with
    ``(m, s)`` autoregressive in ``z``.  Returns ``(z', logdet)``."""
    m1, m2, m3 = masks
    h = jnp.tanh((p.W1 * m1) @ z + p.b1)
    h = jnp.tanh((p.W2 * m2) @ h + p.b2)
    m = (p.Wm * m3) @ h + p.bm
    s = (p.Ws * m3) @ h + p.bs
    # +2 bias: gates open near 1 at init, keeping the flow near-identity
    gate = jax.nn.sigmoid(s + 2.0)
    z_new = gate * z + (1.0 - gate) * m
    return z_new, jnp.sum(jax.nn.log_sigmoid(s + 2.0))


class AutoIAF(NamedTuple):
    """IAF guide: base affine ``z0 = loc + exp(log_scale) * eps`` followed by
    ``K`` masked autoregressive layers with alternating variable order.

    Duck-compatible with :class:`lqg_tpu.infer.svi.AutoMVN` (``sample`` /
    ``transform`` / ``transform_and_logdet``).
    """

    loc: jnp.ndarray
    log_scale: jnp.ndarray
    layers: tuple          # tuple of IAFLayerParams
    masks: tuple           # tuple of (m1, m2, m3) per layer

    @property
    def dim(self) -> int:
        return self.loc.shape[0]

    def transform_and_logdet(self, eps):
        z = self.loc + jnp.exp(self.log_scale) * eps
        logdet = jnp.sum(self.log_scale)
        for p, masks in zip(self.layers, self.masks):
            z, ld = _iaf_layer_apply(p, masks, z)
            logdet = logdet + ld
        return z, logdet

    def transform(self, eps):
        return self.transform_and_logdet(eps)[0]

    def sample(self, key, sample_shape=()):
        eps = random.normal(key, tuple(sample_shape) + self.loc.shape)
        if sample_shape == ():
            return self.transform(eps)
        t = self.transform
        for _ in range(len(sample_shape)):
            t = jax.vmap(t)
        return t(eps)


def make_auto_iaf(key, dim: int, hidden: int = 32, num_layers: int = 2,
                  loc=None, init_log_scale: float = 0.0) -> AutoIAF:
    """Construct a near-identity IAF guide over a ``dim``-dimensional space.

    ``init_log_scale`` sets the base-scale start; for sharply concentrated
    posteriors (e.g. ~1e5 observations) start small - sampling N(loc, 1)
    around a MAP whose posterior scale is ~1e-2 gives astronomically
    high-variance ELBO gradients that blow the flow up to NaN.
    """
    keys = random.split(key, num_layers)
    layers = tuple(_init_iaf_layer(k, dim, hidden) for k in keys)
    masks = tuple(_made_masks(dim, hidden, reverse=bool(i % 2))
                  for i in range(num_layers))
    loc = jnp.zeros(dim) if loc is None else jnp.asarray(loc)
    return AutoIAF(loc=loc, log_scale=jnp.full((dim,), init_log_scale),
                   layers=layers, masks=masks)


def fit_auto_iaf(model, rng_key, steps: int = 5000, step_size: float = 5e-3,
                 num_particles: int = 16, hidden: int = 32,
                 num_layers: int = 2, chunk_steps: int = 200,
                 init_log_scale: float = -2.0):
    """Fit an IAF guide to ``model``'s posterior by stochastic ELBO ascent.

    The optimization is a ``lax.scan`` (like the reference's SVI loop,
    ``lqg/infer/utils.py:23-29``) chunked into launches of ``chunk_steps``
    so the host sees progress (and the losses) between launches instead of
    after one multi-minute launch at data scale.
    Returns ``(AutoIAF, losses)``.
    """
    import optax

    u0 = model.init_unconstrained()
    dim = u0.shape[0]
    key_init, key_fit = random.split(rng_key)
    guide0 = make_auto_iaf(key_init, dim, hidden=hidden,
                           num_layers=num_layers, loc=u0,
                           init_log_scale=init_log_scale)

    # optimize only the learnable leaves; the binary masks stay frozen
    masks = guide0.masks
    params0 = (guide0.loc, guide0.log_scale, guide0.layers)

    def as_guide(params) -> AutoIAF:
        loc, log_scale, layers = params
        return AutoIAF(loc=loc, log_scale=log_scale, layers=layers,
                       masks=masks)

    optimizer = optax.adam(step_size)
    opt_state = optimizer.init(params0)

    def neg_elbo(params, key):
        guide = as_guide(params)
        eps = random.normal(key, (num_particles, dim))

        def one(e):
            u, logdet = guide.transform_and_logdet(e)
            return model.log_joint_unconstrained(u) + logdet

        # ELBO = E_eps[log p(f(eps)) + logdet] + H[N(0, I)] (constant)
        return -jnp.mean(jax.vmap(one)(eps))

    loss_fn = jax.value_and_grad(neg_elbo)

    def step(carry, key):
        params, opt_state = carry
        loss, grads = loss_fn(params, key)
        # a single unlucky particle (likelihood NaN at an extreme draw)
        # must not poison the whole fit: skip non-finite updates
        ok = jnp.isfinite(loss)
        for leaf in jax.tree_util.tree_leaves(grads):
            ok = ok & jnp.isfinite(leaf).all()
        grads = jax.tree.map(
            lambda g: jnp.where(ok, g, jnp.zeros_like(g)), grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    chunk = jax.jit(lambda carry, keys: lax.scan(step, carry, keys))
    carry, losses = (params0, opt_state), []
    for i in range(0, steps, chunk_steps):
        n = min(chunk_steps, steps - i)
        carry, ls = chunk(carry, random.split(
            random.fold_in(key_fit, i), n))
        ls.block_until_ready()
        losses.append(ls)
    params = carry[0]
    return as_guide(params), jnp.concatenate(losses)
