"""Inference engine tests: NUTS statistical validity, MLE recovery,
model-introspection parity (reference tests/infer_test.py + SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax import random
import pytest

from lqg_tpu.models import BoundedActor, SubjectiveActor
from lqg_tpu.infer import transforms as tfm
from lqg_tpu.infer.dists import Normal, HalfNormal, LogNormal
from lqg_tpu.infer.models import (ProbModel, get_model_params, lqg_model,
                                  lifted_model, shared_params_lqg_model)
from lqg_tpu.infer.mcmc import MCMC
from lqg_tpu.infer.mle import max_likelihood
from lqg_tpu.infer.utils import infer, sample_from_prior
from lqg_tpu.infer.diagnostics import split_rhat, ess, summary


def test_get_model_params_parity():
    """Free-parameter discovery matches the reference exclusion rules
    (lqg/infer/models.py:9-17)."""
    params = get_model_params(BoundedActor)
    assert set(params) == {"action_variability", "sigma_target",
                           "sigma_cursor", "action_cost"}
    params = get_model_params(SubjectiveActor)
    assert set(params) == {"action_cost", "action_variability", "subj_noise",
                           "subj_vel_noise", "sigma_target", "sigma_cursor"}


def test_distributions_log_prob():
    """Native distributions match scipy."""
    from scipy import stats

    x = np.array([0.3, 1.0, 2.5])
    np.testing.assert_allclose(
        np.asarray(Normal(1.0, 2.0).log_prob(jnp.asarray(x))),
        stats.norm.logpdf(x, 1.0, 2.0), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(HalfNormal(2.0).log_prob(jnp.asarray(x))),
        stats.halfnorm.logpdf(x, scale=2.0), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(LogNormal(0.5, 1.5).log_prob(jnp.asarray(x))),
        stats.lognorm.logpdf(x, 1.5, scale=np.exp(0.5)), rtol=1e-5)


def test_transforms_roundtrip():
    for t in (tfm.Exp(), tfm.Softplus(), tfm.Sigmoid(2.0, 5.0)):
        u = jnp.linspace(-3, 3, 7)
        np.testing.assert_allclose(np.asarray(t.inverse(t.forward(u))),
                                   np.asarray(u), rtol=1e-5, atol=1e-5)
        # jacobian matches autodiff
        g = jax.vmap(jax.grad(lambda v: t.forward(v)))(u)
        np.testing.assert_allclose(np.asarray(t.log_abs_det_jacobian(u)),
                                   np.log(np.abs(np.asarray(g))), rtol=1e-5)


def _gaussian_model():
    mu = jnp.array([1.0, -2.0])
    cov = jnp.array([[2.0, 1.2], [1.2, 1.5]])
    P = jnp.linalg.inv(cov)

    def ll(p):
        z = jnp.stack([p["a"], p["b"]]) - mu
        return -0.5 * z @ P @ z

    return ProbModel(init={"a": jnp.asarray(0.0), "b": jnp.asarray(0.0)},
                     transforms={"a": tfm.identity, "b": tfm.identity},
                     log_likelihood=ll, priors={}), mu, cov


def test_nuts_gaussian_moments():
    """NUTS samples the correct distribution (the core sampler oracle)."""
    model, mu, cov = _gaussian_model()
    m = MCMC(model, num_warmup=500, num_samples=1500,
             num_chains=4).run(random.PRNGKey(0))
    s = m.get_samples()
    a, b = np.asarray(s["a"]), np.asarray(s["b"])
    assert m.divergences == 0
    np.testing.assert_allclose(a.mean(), 1.0, atol=0.15)
    np.testing.assert_allclose(b.mean(), -2.0, atol=0.15)
    np.testing.assert_allclose(a.var(), 2.0, rtol=0.15)
    np.testing.assert_allclose(b.var(), 1.5, rtol=0.15)
    np.testing.assert_allclose(np.cov(a, b)[0, 1], 1.2, rtol=0.25)

    table = m.summary()
    assert all(row["r_hat"] < 1.05 for row in table.values())
    assert all(row["n_eff"] > 200 for row in table.values())


def test_nuts_constrained_target():
    """Positive-constrained sampling: posterior == prior when the likelihood
    is flat, so samples should match the LogNormal prior."""
    prior = LogNormal(0.3, 0.7)
    model = ProbModel(init={"s": jnp.asarray(1.0)},
                      transforms={"s": tfm.positive},
                      log_likelihood=lambda p: jnp.zeros(()),
                      priors={"s": prior})
    m = MCMC(model, num_warmup=500, num_samples=2000,
             num_chains=2).run(random.PRNGKey(1))
    s = np.asarray(m.get_samples()["s"])
    assert (s > 0).all()
    np.testing.assert_allclose(np.log(s).mean(), 0.3, atol=0.1)
    np.testing.assert_allclose(np.log(s).std(), 0.7, rtol=0.15)


@pytest.mark.slow
def test_mle_recovery():
    """Reference mle.py __main__ recovery demo, as a test."""
    true = dict(action_cost=0.5, action_variability=0.25, sigma_target=8.0,
                sigma_cursor=2.0)
    x = BoundedActor(process_noise=1.0, T=500, **true).simulate(
        random.PRNGKey(0), n=20)
    params, losses = max_likelihood(x, steps=800, step_size=0.02)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(float(params["action_variability"]), 0.25,
                               rtol=0.2)
    np.testing.assert_allclose(float(params["sigma_target"]), 8.0, rtol=0.2)
    np.testing.assert_allclose(float(params["action_cost"]), 0.5, rtol=0.5)


@pytest.mark.slow
def test_infer_end_to_end():
    """Reference test_numpyro_distribution NUTS smoke
    (tests/infer_test.py:47-51)."""
    x = BoundedActor(T=200).simulate(random.PRNGKey(0), n=5)
    mcmc = infer(x, num_samples=10, num_warmup=10, model=BoundedActor,
                 max_depth=6, seed=0)
    s = mcmc.get_samples()
    assert set(s) == {"action_variability", "sigma_target", "sigma_cursor",
                      "action_cost"}
    for v in s.values():
        assert np.isfinite(np.asarray(v)).all()
        assert (np.asarray(v) > 0).all()


@pytest.mark.parametrize("guide", ["iaf", "mvn"])
def test_neutra_smoke(guide):
    """NeuTra-preconditioned NUTS (flow and affine guides) runs and yields
    positive finite samples."""
    x = BoundedActor(T=100).simulate(random.PRNGKey(0), n=3)
    mcmc = infer(x, num_samples=10, num_warmup=10, model=BoundedActor,
                 method="neutra", neutra_guide=guide, neutra_steps=300,
                 max_depth=5, seed=0)
    for v in mcmc.get_samples().values():
        assert np.isfinite(np.asarray(v)).all()
        assert (np.asarray(v) > 0).all()


def _perturbed_iaf(key_build, key_noise, dim, num_layers, scale=0.4):
    from lqg_tpu.infer.flows import AutoIAF, make_auto_iaf

    g = make_auto_iaf(key_build, dim=dim, hidden=16, num_layers=num_layers)
    loc, ls, layers = jax.tree.map(
        lambda x: x + scale * random.normal(key_noise, x.shape),
        (g.loc, g.log_scale, g.layers))
    return AutoIAF(loc=loc, log_scale=ls, layers=layers, masks=g.masks)


def test_iaf_logdet_matches_autodiff():
    """The flow's one-pass log-determinant equals the autodiff Jacobian's."""
    g = _perturbed_iaf(random.PRNGKey(0), random.PRNGKey(1), dim=4,
                       num_layers=3)
    eps = random.normal(random.PRNGKey(2), (4,))
    _, ld = g.transform_and_logdet(eps)
    sign, ld_ref = jnp.linalg.slogdet(jax.jacfwd(g.transform)(eps))
    assert float(sign) == 1.0
    np.testing.assert_allclose(float(ld), float(ld_ref), atol=1e-4)


def test_iaf_autoregressive_jacobian():
    """A single IAF layer's Jacobian is lower-triangular in its ordering
    (the MADE masks enforce the autoregressive property)."""
    g = _perturbed_iaf(random.PRNGKey(3), random.PRNGKey(4), dim=5,
                       num_layers=1, scale=0.5)
    J = jax.jacfwd(g.transform)(random.normal(random.PRNGKey(5), (5,)))
    assert np.abs(np.triu(np.asarray(J), k=1)).max() < 1e-6


def test_iaf_fits_correlated_gaussian():
    """ELBO-fitted IAF reproduces a correlated Gaussian's moments."""
    from lqg_tpu.infer.flows import fit_auto_iaf

    mu = jnp.array([1.0, -2.0])
    cov = jnp.array([[2.0, 1.2], [1.2, 1.5]])
    P = jnp.linalg.inv(cov)

    def ll(p):
        z = jnp.stack([p["a"], p["b"]]) - mu
        return -0.5 * z @ P @ z

    model = ProbModel(init={"a": jnp.asarray(0.0), "b": jnp.asarray(0.0)},
                      transforms={"a": tfm.identity, "b": tfm.identity},
                      log_likelihood=ll, priors={})
    guide, losses = fit_auto_iaf(model, random.PRNGKey(6), steps=4000,
                                 step_size=1e-2)
    assert float(losses[-500:].mean()) < float(losses[:50].mean())
    s = guide.sample(random.PRNGKey(7), (4000,))
    np.testing.assert_allclose(np.asarray(s.mean(0)), np.asarray(mu),
                               atol=0.3)
    np.testing.assert_allclose(np.cov(np.asarray(s).T), np.asarray(cov),
                               atol=0.45)


def test_sample_from_prior():
    params = sample_from_prior(BoundedActor, seed=42)
    assert set(params) == set(get_model_params(BoundedActor))
    for v in params.values():
        assert float(v) > 0


def test_shared_params_model_potential():
    """Hierarchical model: finite potential + gradient over a batched
    multi-condition likelihood graph."""
    x1 = BoundedActor(T=100, sigma_target=5.0).simulate(random.PRNGKey(0), n=4)
    x2 = BoundedActor(T=100, sigma_target=15.0).simulate(random.PRNGKey(1), n=4)
    x = jnp.stack([x1, x2])  # (2 conditions, 4 trials, 101, 2)

    model = shared_params_lqg_model(
        x, BoundedActor,
        shared_params=["action_cost", "action_variability", "sigma_cursor"])

    # 3 shared + 2 per-condition sigma_target sites
    assert set(model.names) == {"action_cost", "action_variability",
                                "sigma_cursor", "sigma_target_0",
                                "sigma_target_1"}

    u0 = model.init_unconstrained()
    pe, grad = jax.value_and_grad(model.potential)(u0)
    assert np.isfinite(float(pe))
    assert np.isfinite(np.asarray(grad)).all()


def test_shared_params_model_delay_register():
    """The explicit-delay models are hierarchically fittable:
    no dim kwarg in their signature, action cost named 'c' (reference
    delay.py:44-51) - the builder must skip dim and find a prior for c."""
    from lqg_tpu.models import DelayedSubjectiveActor

    x = jnp.stack([
        DelayedSubjectiveActor(T=40).simulate(random.PRNGKey(c), n=2)[..., :2]
        for c in range(2)])
    model = shared_params_lqg_model(
        x, DelayedSubjectiveActor,
        shared_params=["c", "subj_noise", "subj_vel_noise", "sigma_cursor",
                       "action_variability"])
    assert set(model.names) == {"c", "subj_noise", "subj_vel_noise",
                                "sigma_cursor", "action_variability",
                                "sigma_target_0", "sigma_target_1"}
    pe, grad = jax.value_and_grad(model.potential)(
        model.init_unconstrained())
    assert np.isfinite(float(pe))
    assert np.isfinite(np.asarray(grad)).all()


def test_iaf_fit_skips_nonfinite_steps():
    """A model whose log joint NaNs on extreme draws must not poison the
    guide fit: steps with non-finite loss/grads are skipped."""
    from lqg_tpu.infer.flows import fit_auto_iaf
    from lqg_tpu.infer.models import ProbModel
    from lqg_tpu.infer import transforms as tfm

    def log_likelihood(params):
        v = params["a"]
        # NaN once the guide samples past |log a| > 2
        return jnp.where(jnp.abs(jnp.log(v)) < 2.0,
                         -0.5 * jnp.log(v) ** 2, jnp.nan)

    model = ProbModel(init={"a": jnp.asarray(1.0)},
                      transforms={"a": tfm.positive},
                      log_likelihood=log_likelihood, priors=None)
    guide, losses = fit_auto_iaf(model, random.PRNGKey(3), steps=300,
                                 chunk_steps=100, init_log_scale=0.0)
    # the trace may contain NaN losses (skipped steps) but the PARAMS
    # stay finite and the guide still samples finitely
    u = guide.sample(random.PRNGKey(4), sample_shape=(32,))
    assert np.isfinite(np.asarray(u)).all()


def test_diagnostics_sane():
    rng = np.random.default_rng(0)
    iid = rng.standard_normal((4, 1000))
    assert abs(split_rhat(iid) - 1.0) < 0.01
    assert ess(iid) > 2000

    # strongly autocorrelated chain -> small ESS
    ar = np.cumsum(rng.standard_normal((2, 1000)), axis=1)
    assert ess(ar) < 200

    table = summary({"x": iid})
    assert {"mean", "sd", "n_eff", "r_hat"} <= set(table["x"])


@pytest.mark.slow
def test_mcmc_run_checkpoint_resume(tmp_path):
    """A run interrupted mid-flight resumes to the identical result - even
    with a different launch size (transitions are keyed by global step
    index, so launch boundaries don't change the trajectory)."""
    import numpy as np
    from jax import random
    from lqg_tpu.infer.mcmc import MCMC
    from lqg_tpu.infer.models import lifted_model
    from lqg_tpu.models import BoundedActor

    m = BoundedActor(T=80)
    x = m.simulate(random.PRNGKey(0), n=5)
    prob = lifted_model(x, BoundedActor)

    kwargs = dict(num_warmup=16, num_samples=16, num_chains=2, max_depth=5)
    key = random.PRNGKey(1)

    # uninterrupted reference run
    ref = MCMC(prob, chunk_steps=8, **kwargs).run(key)

    # interrupted run: stop after two launches, leaving a checkpoint
    path = str(tmp_path / "run.npz")
    mc = MCMC(prob, chunk_steps=8, checkpoint_every=1, **kwargs)
    out = mc.run(key, checkpoint_path=path, _stop_after_launches=2)
    assert out is None  # stopped early

    # resume from the checkpoint with DIFFERENT launch sizing; must equal
    # the uninterrupted run exactly
    resumed = MCMC(prob, chunk_steps=5, **kwargs).run(
        key, checkpoint_path=path)
    np.testing.assert_allclose(np.asarray(resumed._samples_u),
                               np.asarray(ref._samples_u), atol=1e-6)

    # incompatible config is rejected
    bad = MCMC(prob, **{**kwargs, "num_samples": 32})
    with pytest.raises(ValueError):
        bad.run(key, checkpoint_path=path)

    # a stale chunk file from a different run is rejected (nonce check)
    other = str(tmp_path / "other.npz")
    MCMC(prob, chunk_steps=8, checkpoint_every=1, **kwargs).run(
        key, checkpoint_path=other, _stop_after_launches=1)
    import shutil
    shutil.copy(other + ".chunk_00000.npz", path + ".chunk_00000.npz")
    with pytest.raises(ValueError, match="nonce"):
        MCMC(prob, chunk_steps=8, **kwargs).run(key, checkpoint_path=path)


def test_mcmc_launch_budget(tmp_path):
    """The leapfrog budget bounds each launch's transitions; the run still
    completes with the same results as an unbudgeted run."""
    import numpy as np
    from jax import random
    from lqg_tpu.infer.mcmc import MCMC
    from lqg_tpu.infer.models import lifted_model
    from lqg_tpu.models import BoundedActor

    m = BoundedActor(T=40)
    x = m.simulate(random.PRNGKey(0), n=3)
    prob = lifted_model(x, BoundedActor)
    kwargs = dict(num_warmup=8, num_samples=8, num_chains=2, max_depth=4)
    key = random.PRNGKey(2)

    ref = MCMC(prob, chunk_steps=16, **kwargs).run(key)
    # a tiny budget forces one transition per launch (budget checked
    # before each step, so every launch does at least one)
    tight = MCMC(prob, chunk_steps=16, max_leapfrogs_per_launch=1,
                 **kwargs).run(key)
    np.testing.assert_allclose(np.asarray(tight._samples_u),
                               np.asarray(ref._samples_u), atol=1e-6)


def test_mcmc_chunk_default_backend_aware():
    """Launch sizing defaults are the same on every backend: 64 transitions
    per launch and no leapfrog budget unless the caller sets one."""
    from lqg_tpu.infer.mcmc import MCMC
    from lqg_tpu.infer.models import lqg_model
    from lqg_tpu.models import BoundedActor
    from jax import random

    x = BoundedActor(T=20).simulate(random.PRNGKey(0), n=2)
    prob = lqg_model(x, BoundedActor)
    assert MCMC(prob).chunk_steps == 64
    assert MCMC(prob).max_leapfrogs_per_launch == 1 << 30
    assert MCMC(prob, chunk_steps=7).chunk_steps == 7


def test_gains_vjp_method_toggle():
    """The fused gains' VJP (analytic adjoint kernel, interpreted) matches
    differentiating the sequential scan twin of the same math."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from lqg_tpu.models.basic import tracking_spec
    from lqg_tpu.ops.linalg import mT
    from lqg_tpu.ops.pallas import gains as pg

    def loss(c, kernel):
        spec = jax.tree.map(lambda a: a[None],
                            tracking_spec(1, 1.0, 0.5, 6.0, 3.0, c, 1 / 60))
        Sigma0 = spec.V @ mT(spec.V)
        if kernel:
            L, H, K = pg.gains_fused(spec, Sigma0, 25, True)
        else:
            L, H, K = pg._scan_gains(spec, Sigma0, 25)
        return jnp.sum(L**2) + jnp.sum(K**2)

    g_kernel = float(jax.grad(lambda c: loss(c, True))(0.6))
    g_scan = float(jax.grad(lambda c: loss(c, False))(0.6))
    np.testing.assert_allclose(g_kernel, g_scan, rtol=1e-5)
