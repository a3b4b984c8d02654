"""Parallel layer tests: associative-scan kernels vs sequential oracles,
sharded likelihood/chains on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax import random
import pytest

from lqg_tpu.ops import riccati, kalman, gaussian
from lqg_tpu.parallel import pscan, make_mesh, local_mesh
from lqg_tpu.parallel.sharding import sharded_log_likelihood, \
    sharded_chains_run, sequence_parallel_log_likelihood
from lqg_tpu.utils import stationary_spec
from lqg_tpu.models import BoundedActor, SubjectiveActor


def _spec(rng, n=3, m=2, p=3):
    A = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    B = 0.1 * rng.standard_normal((n, m))
    F = np.eye(p, n)
    V = np.diag(0.5 + rng.random(n))
    W = np.diag(0.5 + rng.random(p))
    Qh = rng.standard_normal((n, n)) * 0.3
    Q = Qh @ Qh.T + 0.1 * np.eye(n)
    R = np.diag(0.2 + rng.random(m))
    return stationary_spec(A=A, B=B, F=F, V=V, W=W, Q=Q, R=R)


@pytest.mark.parametrize("T", [1, 2, 7, 64, 200])
def test_kalman_assoc_matches_sequential(T, x64):
    rng = np.random.default_rng(0)
    spec = _spec(rng)
    Sigma0 = np.asarray(spec.V @ spec.V.T)

    K_seq = kalman.forward(spec, Sigma0=jnp.asarray(Sigma0), horizon=T)
    K_par = pscan.kalman_forward_assoc(spec, jnp.asarray(Sigma0), horizon=T)
    np.testing.assert_allclose(np.asarray(K_par), np.asarray(K_seq),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("T", [1, 2, 7, 64, 200])
def test_lqr_assoc_matches_sequential(T, x64):
    rng = np.random.default_rng(1)
    spec = _spec(rng)

    g_seq = riccati.backward(spec, horizon=T, regularize="none")
    g_par = pscan.lqr_backward_assoc(spec, horizon=T)
    np.testing.assert_allclose(np.asarray(g_par.L), np.asarray(g_seq.L),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(g_par.H), np.asarray(g_seq.H),
                               rtol=1e-7, atol=1e-9)


def test_assoc_on_model_specs(x64):
    """Associative kernels agree on a real model's actor spec (including a
    singular-A delay model via the Kalman path)."""
    m = SubjectiveActor(T=50)
    g_seq = riccati.backward(m.actor, horizon=50, regularize="none")
    g_par = pscan.lqr_backward_assoc(m.actor, horizon=50)
    np.testing.assert_allclose(np.asarray(g_par.L), np.asarray(g_seq.L),
                               rtol=1e-6, atol=1e-8)

    Sigma0 = m.actor.V @ m.actor.V.T
    K_seq = kalman.forward(m.actor, Sigma0=Sigma0, horizon=50)
    K_par = pscan.kalman_forward_assoc(m.actor, Sigma0, horizon=50)
    np.testing.assert_allclose(np.asarray(K_par), np.asarray(K_seq),
                               rtol=1e-6, atol=1e-8)


def test_affine_scan(x64):
    rng = np.random.default_rng(2)
    T, n = 33, 4
    M = jnp.asarray(np.eye(n) * 0.9
                    + 0.01 * rng.standard_normal((T, n, n)))
    c = jnp.asarray(0.1 * rng.standard_normal((T, n)))
    x0 = jnp.asarray(rng.standard_normal(n))

    xs_par = pscan.affine_scan(M, c, x0)

    x = x0
    xs_seq = []
    for t in range(T):
        x = M[t] @ x + c[t]
        xs_seq.append(np.asarray(x))
    np.testing.assert_allclose(np.asarray(xs_par), np.stack(xs_seq),
                               rtol=1e-8, atol=1e-10)


def test_sharded_log_likelihood_matches_local(no_compile_cache):
    mesh = local_mesh(8)
    x = BoundedActor(T=100).simulate(random.PRNGKey(0), n=16)

    def builder(params):
        return BoundedActor(T=100, **params)

    ll_fn = sharded_log_likelihood(builder, x, mesh)
    params = dict(action_cost=jnp.asarray(0.7))
    total = ll_fn(params)
    expected = jnp.sum(builder(params).log_likelihood(x))
    np.testing.assert_allclose(np.asarray(total), np.asarray(expected),
                               rtol=1e-4)

    # gradient flows through the sharded graph
    g = jax.grad(lambda c: ll_fn(dict(action_cost=c)))(jnp.asarray(0.7))
    assert np.isfinite(np.asarray(g))


@pytest.mark.slow
def test_sharded_chains_statistically_correct(no_compile_cache):
    """Chains sharded over an 8-device mesh stay on-device (one chain per
    device) and sample the correct target.

    Note: draw-for-draw equality with the vmap path is not expected - NUTS
    is chaotic, so the fp differences between partitionings diverge; the
    invariant is the stationary distribution.
    """
    from lqg_tpu.infer.models import ProbModel
    from lqg_tpu.infer import transforms as tfm
    from lqg_tpu.infer.mcmc import MCMC

    def ll(p):
        return -0.5 * (p["a"] ** 2 + p["b"] ** 2)

    model = ProbModel(
        init={"a": jnp.asarray(0.5), "b": jnp.asarray(-0.5)},
        transforms={"a": tfm.identity, "b": tfm.identity},
        log_likelihood=ll, priors={})

    mesh = local_mesh(8, name="chains")
    m = MCMC(model, num_warmup=300, num_samples=500, num_chains=8)
    sharded_chains_run(m, random.PRNGKey(3), mesh)

    # the collected draws carry the chain sharding
    shard_devices = {s.device for s in m._samples_u.addressable_shards}
    assert len(shard_devices) == 8

    a = np.asarray(m.get_samples()["a"])
    b = np.asarray(m.get_samples()["b"])
    np.testing.assert_allclose(a.mean(), 0.0, atol=0.1)
    np.testing.assert_allclose(a.var(), 1.0, rtol=0.15)
    np.testing.assert_allclose(b.var(), 1.0, rtol=0.15)

    table = m.summary()
    assert all(row["r_hat"] < 1.05 for row in table.values())


@pytest.mark.parametrize("T,n,d", [
    (1, 3, 2), (2, 3, 2), (7, 5, 2),
    pytest.param(64, 4, 2, marks=pytest.mark.slow),
    pytest.param(200, 2, 2, marks=pytest.mark.slow),
])
def test_pscan_likelihood_matches_sequential(T, n, d, x64):
    """Parallel-in-time conditioned likelihood == sequential kernel path."""
    model = BoundedActor(T=T, action_cost=0.6, sigma_cursor=2.0)
    x = model.simulate(random.PRNGKey(4), n=n)[..., :d]

    ll_seq = model.log_likelihood(x)
    ll_par = model.log_likelihood(x, method="pscan")
    np.testing.assert_allclose(np.asarray(ll_par), np.asarray(ll_seq),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.slow
def test_pscan_likelihood_subjective_and_delay(x64):
    """pscan likelihood on mismatched-actor and delay-augmented models
    (non-square joint blocks, singular delay dynamics)."""
    from lqg_tpu.models import TemporalDelayModel

    for model in (SubjectiveActor(T=60), TemporalDelayModel(SubjectiveActor(T=60), delay=4)):
        x = model.simulate(random.PRNGKey(5), n=3)
        ll_seq = model.log_likelihood(x)
        ll_par = model.log_likelihood(x, method="pscan")
        np.testing.assert_allclose(np.asarray(ll_par), np.asarray(ll_seq),
                                   rtol=1e-7, atol=1e-7)


@pytest.mark.slow
def test_pscan_likelihood_gradients_match(x64):
    """Gradients w.r.t. model parameters agree between the two paths (the
    NUTS chain rule goes parameters -> gains -> joint -> likelihood)."""
    x = BoundedActor(T=40).simulate(random.PRNGKey(6), n=4)

    def ll(c, method):
        m = BoundedActor(T=40, action_cost=c)
        return jnp.sum(m.log_likelihood(x, method=method))

    g_seq = jax.grad(lambda c: ll(c, "scan"))(jnp.asarray(0.5))
    g_par = jax.grad(lambda c: ll(c, "pscan"))(jnp.asarray(0.5))
    np.testing.assert_allclose(np.asarray(g_par), np.asarray(g_seq),
                               rtol=1e-6)


def test_pscan_likelihood_sp_sharded(x64, no_compile_cache):
    """The associative-scan likelihood runs with the data (trial axis)
    sharded over the mesh - the compiled program partitions the composes
    and reduces over collectives on real hardware."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = local_mesh(8, name="sp")
    model = BoundedActor(T=64)
    x = model.simulate(random.PRNGKey(7), n=8)

    x_sh = jax.device_put(x, NamedSharding(mesh, P("sp")))
    ll = jax.jit(lambda d: model.log_likelihood(d, method="pscan"))(x_sh)
    expected = model.log_likelihood(x)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(expected),
                               rtol=1e-8, atol=1e-8)


def test_sequence_parallel_log_likelihood(x64, no_compile_cache):
    """Horizon sharded over 8 devices: the associative-scan likelihood
    matches the single-device sequential path."""
    mesh = local_mesh(8, name="sp")
    model = BoundedActor(T=160)
    x = model.simulate(random.PRNGKey(8), n=4)

    ll_sp = sequence_parallel_log_likelihood(model, x, mesh)
    expected = model.log_likelihood(x)
    np.testing.assert_allclose(np.asarray(ll_sp), np.asarray(expected),
                               rtol=1e-8, atol=1e-8)
