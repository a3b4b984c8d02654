"""Probabilistic models over LQG parameters.

The reference expresses these as NumPyro model functions
(``lqg/infer/models.py``); here they are declarative :class:`ProbModel`
objects - a set of named free parameters with transforms and (optional)
priors, plus a pure likelihood function - consumed by the native NUTS/SVI
engines.  Everything traces into one differentiable XLA graph: parameters ->
spec matrices -> gains -> likelihood (the central design fact of the
reference, SURVEY.md section 3.3).

Free parameters are auto-discovered from model constructor signatures exactly
like the reference (``lqg/infer/models.py:9-17``), with the same exclusion
list.

Difference from the reference: the hierarchical multi-condition model evaluates all
conditions in ONE vmapped graph (the reference loops over conditions in
Python, ``models.py:117-130`` - its documented scaling weakness).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lqg_tpu.infer import transforms as tfm
from lqg_tpu.infer.dists import Distribution
from lqg_tpu.infer.priors import DEFAULT_PRIOR
from lqg_tpu.utils.numerics import kahan_sum

# constructor kwargs that are never free parameters
# (parity: lqg/infer/models.py:14)
_EXCLUDED = ("self", "dim", "dt", "T", "process_noise", "delay", "covar")


def get_model_params(model_class) -> Dict[str, float]:
    """Free parameters of a model class = constructor kwargs with defaults,
    minus the exclusion list (reference ``models.py:9-17``)."""
    sig = inspect.signature(model_class.__init__)
    return {name: p.default for name, p in sig.parameters.items()
            if name not in _EXCLUDED}


@dataclass
class ProbModel:
    """A differentiable log-density model over named scalar parameters.

    * ``init``: constrained-space initial values per free parameter.
    * ``priors``: optional prior distribution per parameter; if a parameter
      has no prior the model is a pure-likelihood (MLE) objective in that
      coordinate.
    * ``transforms``: unconstrained -> constrained bijections per parameter.
    * ``log_likelihood``: pure function of the constrained parameter dict.
    """

    init: Dict[str, jnp.ndarray]
    transforms: Dict[str, tfm.Transform]
    log_likelihood: Callable[[Dict[str, jnp.ndarray]], jnp.ndarray]
    priors: Optional[Dict[str, Distribution]] = None
    # Constant shift subtracted inside ``log_likelihood`` (model factories
    # close over it).  HMC/SVI only use potential DIFFERENCES, but float32
    # quantizes the returned scalar at ULP(|value|): at the data.mat fit's
    # ~3e5-nat likelihood that is a ~0.03-nat floor on every delta-energy.
    # Setting this to the MAP's likelihood (fit scripts do, after the MAP
    # fit) keeps the returned value O(1-100) and the accept test exact to
    # ~1e-3 nats.  Captured at TRACE time - set before jitting/running.
    ll_baseline: float = 0.0

    @property
    def names(self) -> List[str]:
        return sorted(self.init.keys())

    # --- constrained <-> unconstrained plumbing ---
    def unconstrain(self, params: Dict[str, Any]) -> jnp.ndarray:
        return jnp.stack([
            jnp.asarray(self.transforms[n].inverse(jnp.asarray(
                params[n], dtype=jnp.result_type(float))))
            for n in self.names])

    def constrain(self, u: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        return {n: self.transforms[n].forward(u[i])
                for i, n in enumerate(self.names)}

    def init_unconstrained(self) -> jnp.ndarray:
        return self.unconstrain(self.init)

    # --- densities ---
    def log_prior(self, params: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        if not self.priors:
            return jnp.zeros(())
        lp = 0.0
        for n in self.names:
            if n in self.priors:
                lp = lp + self.priors[n].log_prob(params[n])
        return lp

    def log_joint_unconstrained(self, u: jnp.ndarray) -> jnp.ndarray:
        """log p(params(u)) + log |J(u)| + log p(x | params(u)).

        Without priors this is a pure-likelihood (MLE) objective: no prior
        term and no Jacobian correction, so the optimum is the MLE of the
        *constrained* parameters (matching the reference's ``numpyro.param``
        point-estimation semantics, ``lqg/infer/mle.py:10-23``).
        """
        params = self.constrain(u)
        if not self.priors:
            return self.log_likelihood(params)
        ljac = 0.0
        for i, n in enumerate(self.names):
            ljac = ljac + self.transforms[n].log_abs_det_jacobian(u[i])
        return self.log_prior(params) + ljac + self.log_likelihood(params)

    def potential(self, u: jnp.ndarray) -> jnp.ndarray:
        """Negative log joint - the NUTS/SVI objective (every f32 product
        at full precision: no TF32)."""
        with jax.default_matmul_precision("highest"):
            return -self.log_joint_unconstrained(u)


def _float(v):
    return jnp.asarray(v, dtype=jnp.result_type(float))


def lqg_model(x, model_type, process_noise=1.0, dt=1.0 / 60.0,
              priors=None, **fixed_params) -> ProbModel:
    """Single-condition model: free params positive-constrained, likelihood
    over all trials (reference ``lqg/infer/models.py:20-34``).

    With ``priors=None`` this is the MLE objective (the reference's
    ``numpyro.param`` sites); pass a prior dict - e.g. ``DEFAULT_PRIOR`` - to
    get the Bayesian ("lifted", ``models.py:134-135``) model.
    """
    n, T, d = x.shape
    x = jnp.asarray(x)

    init, transforms = {}, {}
    for name, default in get_model_params(model_type).items():
        if name in fixed_params:
            continue
        init[name] = _float(default)
        transforms[name] = tfm.positive

    used_priors = None
    if priors is not None:
        used_priors = {n: priors[n] for n in init if n in priors}
        # initialize at the prior MEDIAN (reference ``init_to_median``,
        # lqg/infer/utils.py:18) - for heavy-tailed priors like
        # HalfNormal(50) the mean sits far outside the typical set
        init = {n: (used_priors[n].median if n in used_priors else init[n])
                for n in init}

    model = ProbModel(init=init, transforms=transforms,
                      log_likelihood=None, priors=used_priors)

    def log_likelihood(params):
        full = dict(fixed_params)
        full.update(params)
        lqg = model_type(process_noise=process_noise, dt=dt, T=T - 1, **full)
        lls = lqg.log_likelihood(x[..., :d])            # (n,) per trial
        # compensated total with the baseline spread per trial so partial
        # sums stay small-magnitude (full f32 precision) - see ll_baseline
        return kahan_sum(jnp.ravel(lls) - model.ll_baseline / lls.size)

    model.log_likelihood = log_likelihood
    return model


def lifted_model(x, model_type, process_noise=1.0, dt=1.0 / 60.0,
                 **fixed_params) -> ProbModel:
    """``lqg_model`` with the default priors applied
    (parity with reference ``lifted_model``, ``models.py:134-135``)."""
    return lqg_model(x, model_type, process_noise=process_noise, dt=dt,
                     priors=DEFAULT_PRIOR, **fixed_params)


def common_lqg_model(x, model_type, process_noise=1.0, dt=1.0 / 60.0,
                     priors=None, **fixed_params) -> ProbModel:
    """Multi-condition model with shared parameters and per-condition target
    noise ``sigma_target_{n}`` (reference ``models.py:37-61``).

    Expressed as the special case of :func:`shared_params_lqg_model` where
    every free parameter except ``sigma_target`` is shared.
    """
    shared = [n for n in get_model_params(model_type) if n != "sigma_target"]
    return shared_params_lqg_model(
        x, model_type, process_noise=process_noise, dt=dt, priors=priors,
        shared_params=shared, **fixed_params)


def shared_params_lqg_model(x, model_type, process_noise=1.0, dt=1.0 / 60.0,
                            priors=None, shared_params=None, dim=1,
                            **fixed_params) -> ProbModel:
    """Hierarchical multi-condition model (reference ``models.py:67-130``).

    ``shared_params`` get ONE latent value across conditions; every other
    free parameter gets a per-condition latent ``f"{name}_{n}"``.  All
    conditions evaluate in a single vmapped likelihood graph.
    """
    Nc, N, T, d = x.shape
    x = jnp.asarray(x)

    if priors is None:
        priors = DEFAULT_PRIOR
    shared = set(shared_params or [])
    model_params = set(get_model_params(model_type).keys())
    shared = shared & model_params
    per_cond = sorted(model_params - shared - set(fixed_params))
    shared = sorted(shared - set(fixed_params))

    init, transforms, used_priors = {}, {}, {}
    defaults = get_model_params(model_type)

    for name in shared:
        pr = priors[name]
        init[name] = pr.median
        transforms[name] = tfm.positive
        used_priors[name] = pr
    for name in per_cond:
        for c in range(Nc):
            site = f"{name}_{c}"
            pr = priors.get(site, priors[name])
            init[site] = pr.median
            transforms[site] = tfm.positive
            used_priors[site] = pr

    model = ProbModel(init=init, transforms=transforms,
                      log_likelihood=None, priors=used_priors)

    def log_likelihood(params):
        # assemble (Nc,)-batched condition parameters
        cond_params = {}
        for name in shared:
            cond_params[name] = jnp.broadcast_to(params[name], (Nc,))
        for name in per_cond:
            cond_params[name] = jnp.stack(
                [params[f"{name}_{c}"] for c in range(Nc)])

        # the delay-register models fix dim=1 in their constructors
        # (reference delay.py:44-51); only forward it where accepted
        dim_kw = ({"dim": dim}
                  if "dim" in inspect.signature(model_type.__init__).parameters
                  else {})

        def one_condition(p, xn):
            full = dict(fixed_params)
            full.update(p)
            lqg = model_type(process_noise=process_noise, dt=dt, T=T - 1,
                             **dim_kw, **full)
            return lqg.log_likelihood(xn[..., :d])      # (n,) per trial

        lls = jax.vmap(one_condition)(cond_params, x)   # (Nc, n)
        # compensated cross-trial total with the baseline spread per trial
        # so partial sums stay small-magnitude - see ll_baseline
        return kahan_sum(jnp.ravel(lls) - model.ll_baseline / lls.size)

    model.log_likelihood = log_likelihood
    return model
