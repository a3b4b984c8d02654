"""Model-zoo smoke + semantics tests (reference tests/lqg_test.py:46-66)."""

import jax.numpy as jnp
from jax import random
import pytest

from lqg_tpu.models import (
    BoundedActor,
    SubjectiveActor,
    PointMassBoundedActor,
    OptimalActor,
    RelativeObservationBoundedActor,
    DelayedSubjectiveActor,
    TemporalDelayModel,
    HandMotionModelTrackingTask,
)


@pytest.mark.parametrize("model_class", [
    BoundedActor,
    SubjectiveActor,
    PointMassBoundedActor,
    OptimalActor,
    RelativeObservationBoundedActor,
    HandMotionModelTrackingTask,
])
def test_model_simulate(model_class):
    T = 500
    lqg = model_class(T=T)
    x = lqg.simulate(random.PRNGKey(0), x0=jnp.zeros(lqg.xdim), n=10)
    assert x.shape == (10, T + 1, lqg.xdim)
    assert not jnp.isnan(x).any()


def test_delayed_subjective_actor():
    model = DelayedSubjectiveActor(T=300)
    # delay=12 with 2 base states -> 26 joint state dims
    assert model.xdim == 2 * 13
    x = model.simulate(random.PRNGKey(0), n=3)
    assert x.shape == (3, 301, model.xdim)
    assert not jnp.isnan(x).any()

    # likelihood over the 2 observed dims
    ll = model.log_likelihood(x[..., :2])
    assert jnp.isfinite(ll).all()


def test_temporal_delay_wraps_any_system():
    base = SubjectiveActor(T=200)
    delayed = TemporalDelayModel(base, delay=5)
    assert delayed.xdim == base.xdim * 6
    x = delayed.simulate(random.PRNGKey(1), n=2)
    assert not jnp.isnan(x).any()


def test_2d_models():
    """dim=2 variants (2D-Visualization workload)."""
    for cls in (BoundedActor, SubjectiveActor):
        m = cls(dim=2, T=200)
        x = m.simulate(random.PRNGKey(0), n=4)
        assert x.shape == (4, 201, m.xdim)
        assert not jnp.isnan(x).any()
        ll = m.log_likelihood(x)
        assert jnp.isfinite(ll).all()


def test_hand_model_likelihood_finite():
    """Hand model: marginalized likelihood is non-degenerate (the hand
    position carries a small noise floor; without it the observed-block
    covariance is singular at t=0)."""
    m = HandMotionModelTrackingTask(T=200)
    x = m.simulate(random.PRNGKey(0), n=5)[..., :2]
    ll = m.log_likelihood(x)
    assert jnp.isfinite(ll).all()

    import jax
    g = jax.grad(lambda c: jnp.sum(
        HandMotionModelTrackingTask(T=200,
                                    action_cost=c).log_likelihood(x)))(
        jnp.asarray(0.9))
    assert jnp.isfinite(g)


def test_signal_dependent_noise_actor():
    """Multiplicative-noise model: reduces to the plain bounded actor at
    signal_dep_noise=0, and yields more conservative gains otherwise."""
    import numpy as np
    from lqg_tpu.models import SignalDependentNoiseActor

    T = 300
    base = BoundedActor(T=T, action_cost=0.5)
    zero = SignalDependentNoiseActor(T=T, action_cost=0.5,
                                     signal_dep_noise=0.0)
    g_base, _ = base.gains()
    g_zero, _ = zero.gains()
    np.testing.assert_allclose(np.asarray(g_zero.L), np.asarray(g_base.L),
                               rtol=1e-5, atol=1e-6)

    noisy = SignalDependentNoiseActor(T=T, action_cost=0.5,
                                      signal_dep_noise=5.0)
    g_noisy, _ = noisy.gains()
    # control-dependent noise penalizes control: smaller feedback gains
    assert float(jnp.abs(g_noisy.L).max()) < float(jnp.abs(g_base.L).max())

    x = noisy.simulate(random.PRNGKey(0), n=5)
    assert not jnp.isnan(x).any()
    assert jnp.isfinite(noisy.log_likelihood(x)).all()


def test_vmapped_model_construction():
    """Constructors are pure functions of parameters: vmap batches whole
    parameter->likelihood graphs (the batch-first inference layout)."""
    import jax

    x = BoundedActor(T=100).simulate(random.PRNGKey(2), n=3)

    def ll(action_cost):
        return jnp.sum(BoundedActor(action_cost=action_cost,
                                    T=100).log_likelihood(x))

    costs = jnp.array([0.3, 0.7, 1.5])
    out = jax.vmap(ll)(costs)
    assert out.shape == (3,)
    assert jnp.isfinite(out).all()
    # matches per-value evaluation
    for i, c in enumerate(costs):
        assert jnp.allclose(out[i], ll(c), rtol=1e-4)
