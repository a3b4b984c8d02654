"""Pallas kernel parity tests, in the Pallas interpreter.

Every kernel entry point is called with ``interpret=True``, which runs the
kernel bodies (tile algebra, in-program time loops, stores at dynamic time
indices, lane padding) on the CPU; the compiled kernels on the card are
checked by ``tests/test_gpu.py`` and ``chip_smoke.py``.  Also here: the
dispatch policy (``auto`` picks the scan where no kernel compiles, forced
``fused`` raises) and the large-joint-state models, which run the scan.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lqg_tpu.models import (BoundedActor, SubjectiveActor,
                            PointMassBoundedActor)
from lqg_tpu.models.basic import tracking_spec
from lqg_tpu.ops import riccati, kalman
from lqg_tpu.ops.pallas.gains import fused_gains, fused_gains_available
from lqg_tpu.ops.linalg import mT


def _assert_parity(spec, T, atol=2e-5, **kw):
    Sigma0 = spec.V @ mT(spec.V)
    L, H, K = fused_gains(spec, Sigma0, horizon=T, interpret=True, **kw)
    g = riccati.backward(spec, horizon=T, regularize="none")
    K_ref = kalman.forward(spec, Sigma0=Sigma0, horizon=T)
    np.testing.assert_allclose(np.asarray(L), np.asarray(g.L), atol=atol)
    np.testing.assert_allclose(np.asarray(H), np.asarray(g.H), atol=atol)
    np.testing.assert_allclose(np.asarray(K), np.asarray(K_ref), atol=atol)


def test_bounded_actor_batch():
    B, T = 1100, 50  # exercises particle padding (1100 = 34*32 + 12)
    cost = jnp.linspace(0.2, 2.0, B)
    spec = jax.vmap(
        lambda c: tracking_spec(1, 1.0, 0.5, 6.0, 3.0, c, 1 / 60))(cost)
    assert fused_gains_available(jax.tree.map(lambda a: a[0], spec))
    _assert_parity(spec, T)


def test_uneven_time_chunk():
    """A prime horizon and a batch that is not a whole number of lane
    blocks (50 particles in blocks of 16: the last block edge-padded)."""
    B, T = 50, 31
    cost = jnp.linspace(0.5, 1.5, B)
    spec = jax.vmap(
        lambda c: tracking_spec(1, 1.0, 0.5, 6.0, 3.0, c, 1 / 60))(cost)
    _assert_parity(spec, T, lanes=16)


@pytest.mark.parametrize("model_cls", [SubjectiveActor,
                                       PointMassBoundedActor])
def test_model_actor_specs(model_cls):
    """Larger state dims (n=3 with p=2, n=4 with p=3)."""
    m = model_cls(T=40)
    spec = jax.tree.map(lambda a: jnp.stack([a] * 16), m.actor)
    assert fused_gains_available(m.actor)
    _assert_parity(spec, 40, atol=5e-4)


def test_availability_gate():
    m = BoundedActor(T=10)
    assert fused_gains_available(m.actor)
    from lqg_tpu.models import DelayedSubjectiveActor

    big = DelayedSubjectiveActor(T=10)
    assert not fused_gains_available(big.actor)  # n = 39 exceeds scope


@pytest.mark.slow
def test_gains_fused_custom_vjp():
    """gains_fused: Pallas primal matches the scan, and grads flow (via the
    scan-math VJP) identically to differentiating the scan directly."""
    T = 30

    def build(c):
        return tracking_spec(1, 1.0, 0.5, 6.0, 3.0, c, 1 / 60)

    from lqg_tpu.ops.pallas.gains import gains_fused, _scan_gains

    def loss_fused(c):
        spec = jax.tree.map(lambda a: a[None], build(c))
        Sigma0 = spec.V @ mT(spec.V)
        L, H, K = gains_fused(spec, Sigma0, T, True)
        return jnp.sum(L**2) + jnp.sum(K**2)

    def loss_scan(c):
        spec = jax.tree.map(lambda a: a[None], build(c))
        Sigma0 = spec.V @ mT(spec.V)
        L, H, K = _scan_gains(spec, Sigma0, T)
        return jnp.sum(L**2) + jnp.sum(K**2)

    rtol = 1e-5
    np.testing.assert_allclose(float(loss_fused(0.7)), float(loss_scan(0.7)),
                               rtol=rtol)
    gf = float(jax.grad(loss_fused)(0.7))
    gs = float(jax.grad(loss_scan)(0.7))
    np.testing.assert_allclose(gf, gs, rtol=rtol)


def test_system_gains_method_fused():
    """On the CPU, auto gains take the scan and forced ``fused`` raises
    naming the backend; the kernel itself (interpreted) matches the scan
    schedules System returns."""
    from lqg_tpu.ops.pallas.gains import gains_fused

    m = BoundedActor(T=40)
    assert not m._fused_ok()
    g_auto, K_auto = m.gains()
    g_scan, K_scan = m.gains(method="scan")
    np.testing.assert_array_equal(np.asarray(g_auto.L), np.asarray(g_scan.L))
    with pytest.raises(ValueError, match="'cpu'"):
        m.gains(method="fused")

    spec = jax.tree.map(lambda a: a[None], m.actor)
    L, H, K = gains_fused(spec, m._default_Sigma0()[None], 40, True)
    np.testing.assert_allclose(np.asarray(L[:, 0]), np.asarray(g_scan.L),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(K[:, 0]), np.asarray(K_scan),
                               atol=2e-5)


# --- fused marginalized-likelihood kernel ---

from jax import random, lax
import math

from lqg_tpu.ops import gaussian
from lqg_tpu.ops.pallas.likelihood import (conditioned_log_likelihood_fused,
                                           fused_ll_available)


def _joint_FQ(model, T):
    g, K = model.gains()
    joint = gaussian.joint_system(model.dynamics, model.actor, g.L, K, T)
    return joint.F, joint.G @ mT(joint.G)


def _fused_ll(model, x):
    """Per-trial log likelihood through the interpreted kernel, from the
    model's parameters (gains -> joint -> kernel), differentiable."""
    F, Q = _joint_FQ(model, model.horizon)
    return conditioned_log_likelihood_fused(F[None], Q[None], x[None],
                                            True)[0]


def _xla_twin_ll(F, Q, x):
    """Straight-line XLA twin of the fused recursion (oracle for grads on
    singular Q, where a cholesky-based reconstruction would NaN)."""
    T, j, _ = F.shape
    n, Tp1, d = x.shape
    X = jnp.moveaxis(x, 0, -1)
    Sigma = Q[0]
    mu = jnp.concatenate([X[0], jnp.zeros((j - d, n))], axis=0)

    def step(carry, inp):
        Sigma, mu, q, ld = carry
        F_t, Q_t, x_t, t = inp
        S = Sigma[:d, :d]
        Sinv = jnp.linalg.inv(S)
        e = x_t - mu[:d]
        mask = (t >= 1).astype(F_t.dtype)
        q = q + mask * jnp.sum(e * (Sinv @ e), axis=0)
        ld = ld + mask * jnp.log(jnp.linalg.det(S))
        FS = F_t @ Sigma
        P = FS[:, :d]
        J = P @ Sinv
        mu = F_t @ mu + J @ e
        Sigma = FS @ F_t.T + Q_t - J @ P.T
        Sigma = 0.5 * (Sigma + Sigma.T)
        return (Sigma, mu, q, ld), None

    (Sigma, mu, q, ld), _ = lax.scan(
        step, (Sigma, mu, jnp.zeros(n), jnp.zeros(())),
        (F, Q, X[:-1], jnp.arange(T)))
    S = Sigma[:d, :d]
    e = X[-1] - mu[:d]
    q = q + jnp.sum(e * (jnp.linalg.inv(S) @ e), axis=0)
    ld = ld + jnp.log(jnp.linalg.det(S))
    return -0.5 * (q + ld + T * d * math.log(2 * math.pi))


def test_fused_ll_matches_xla_path():
    """Fused likelihood == the production XLA path (BoundedActor, j=4)."""
    T, n = 16, 4
    m = BoundedActor(T=T)
    x = m.simulate(random.PRNGKey(0), n=n)
    ll_ref = m.log_likelihood(x, method="scan")
    ll = _fused_ll(m, x)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_ref),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.slow
def test_fused_ll_gradient_parity():
    """The hand-derived adjoint kernel == autodiff of the XLA twin,
    including a singular joint noise covariance (SubjectiveActor j=5)."""
    T, n = 12, 3
    x = SubjectiveActor(T=T).simulate(random.PRNGKey(1), n=n)
    F, Q = _joint_FQ(SubjectiveActor(T=T, subj_vel_noise=1.5), T)
    X = x[None]

    ll = conditioned_log_likelihood_fused(F[None], Q[None], X, True)
    ll_ref = _xla_twin_ll(F, Q, x)
    np.testing.assert_allclose(np.asarray(ll[0]), np.asarray(ll_ref),
                               rtol=2e-4, atol=2e-3)

    gF, gQ = jax.grad(
        lambda F_, Q_: conditioned_log_likelihood_fused(
            F_[None], Q_[None], X, True).sum(), argnums=(0, 1))(F, Q)
    gF2, gQ2 = jax.grad(lambda F_, Q_: _xla_twin_ll(F_, Q_, x).sum(),
                        argnums=(0, 1))(F, Q)
    sym = lambda a: 0.5 * (a + jnp.swapaxes(a, -1, -2))
    # this case deliberately stresses a SINGULAR joint covariance
    atol = 1e-3
    np.testing.assert_allclose(np.asarray(gF), np.asarray(gF2),
                               rtol=1e-2, atol=atol)
    np.testing.assert_allclose(np.asarray(sym(gQ)), np.asarray(sym(gQ2)),
                               rtol=1e-2, atol=atol)


def test_fused_ll_data_gradient():
    """The fused path's cotangent w.r.t. the DATA matches the XLA twin
    (round-2 weak spot: it used to silently return zeros)."""
    T, n = 12, 3
    m = SubjectiveActor(T=T)
    x = m.simulate(random.PRNGKey(4), n=n)
    F, Q = _joint_FQ(m, T)

    gX = jax.grad(lambda x_: conditioned_log_likelihood_fused(
        F[None], Q[None], x_[None], True).sum())(x)
    gX_ref = jax.grad(lambda x_: _xla_twin_ll(F, Q, x_).sum())(x)
    assert float(jnp.abs(gX).max()) > 0.0
    np.testing.assert_allclose(np.asarray(gX), np.asarray(gX_ref),
                               rtol=1e-2, atol=1e-4)


def test_fused_ll_theta_batch_and_vmap():
    """Explicit theta batch and vmap-over-theta agree with per-theta calls."""
    T, n, P = 10, 3, 3
    x = BoundedActor(T=T).simulate(random.PRNGKey(2), n=n)
    costs = [0.3, 0.7, 1.5]
    FQ = [_joint_FQ(BoundedActor(T=T, action_cost=c), T) for c in costs]
    F = jnp.stack([f for f, _ in FQ])
    Q = jnp.stack([q for _, q in FQ])
    X = jnp.broadcast_to(x[None], (P,) + x.shape)

    ll_batch = conditioned_log_likelihood_fused(F, Q, X, True)
    ll_ref = jnp.stack(
        [BoundedActor(T=T, action_cost=c).log_likelihood(x, method="scan")
         for c in costs])
    np.testing.assert_allclose(np.asarray(ll_batch), np.asarray(ll_ref),
                               rtol=2e-4, atol=2e-3)

    ll_vmap = jax.vmap(lambda Fi, Qi: conditioned_log_likelihood_fused(
        Fi[None], Qi[None], x[None], True)[0])(F, Q)
    np.testing.assert_allclose(np.asarray(ll_vmap), np.asarray(ll_ref),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.slow
def test_fused_ll_end_to_end_param_grad():
    """grad of the fused likelihood w.r.t. model parameters matches the
    scan path (the full NUTS chain rule: params -> gains -> joint -> ll)."""
    T, n = 12, 4
    x = BoundedActor(T=T).simulate(random.PRNGKey(3), n=n)

    def nll(c, fused):
        m = BoundedActor(T=T, action_cost=c)
        ll = _fused_ll(m, x) if fused else m.log_likelihood(x, method="scan")
        return -ll.sum()

    g1 = jax.grad(lambda c: nll(c, True))(jnp.float32(0.6))
    g2 = jax.grad(lambda c: nll(c, False))(jnp.float32(0.6))
    np.testing.assert_allclose(float(g1), float(g2), rtol=2e-3, atol=1e-3)


def test_fused_ll_availability():
    assert fused_ll_available(4, 2, jnp.float32)        # BoundedActor
    assert fused_ll_available(5, 2, jnp.float32)        # SubjectiveActor
    assert not fused_ll_available(8, 3, jnp.float32)    # j too large
    assert not fused_ll_available(10, 4, jnp.float32)   # dim=2 subjective
    assert not fused_ll_available(4, 5, jnp.float32)    # d too large
    assert not fused_ll_available(4, 2, jnp.float64)    # wrong dtype


@pytest.mark.slow
def test_fused_ll_dim2_scope():
    """dim=2 models (j=10, d=4) run the scan (outside the kernel's scope);
    the kernel's arithmetic still holds there: value + grad parity."""
    T = 32
    m = SubjectiveActor(T=T, dim=2)
    assert not fused_ll_available(m.xdim + m.bdim, m.xdim, jnp.float32)
    x = m.simulate(random.PRNGKey(0), n=2)

    ll_scan = m.log_likelihood(x, method="scan")
    ll_fused = _fused_ll(m, x)
    np.testing.assert_allclose(np.asarray(ll_fused), np.asarray(ll_scan),
                               rtol=2e-4, atol=2e-3)

    def nll(p, fused):
        mm = SubjectiveActor(T=T, dim=2, subj_noise=p)
        ll = (_fused_ll(mm, x) if fused
              else mm.log_likelihood(x, method="scan"))
        return -ll.sum()

    g_f = jax.grad(lambda p: nll(p, True))(0.8)
    g_s = jax.grad(lambda p: nll(p, False))(0.8)
    np.testing.assert_allclose(float(g_f), float(g_s), rtol=1e-3)



def test_fused_ll_prime_horizon():
    """A prime T (the T=719 recovery workload's kind of horizon) with more
    trials than one lane block (40 trials: blocks of 32, the second
    edge-padded); value and grads stay correct."""
    T, n = 13, 40
    m = BoundedActor(T=T)
    x = m.simulate(random.PRNGKey(5), n=n)
    ll_f = _fused_ll(m, x)
    ll_s = m.log_likelihood(x, method="scan")
    np.testing.assert_allclose(np.asarray(ll_f), np.asarray(ll_s),
                               rtol=2e-4, atol=2e-3)

    g_f = jax.grad(lambda c: -_fused_ll(BoundedActor(T=T, action_cost=c),
                                        x).sum())(jnp.float32(0.6))
    g_s = jax.grad(lambda c: -BoundedActor(T=T, action_cost=c)
                   .log_likelihood(x, method="scan").sum())(jnp.float32(0.6))
    np.testing.assert_allclose(float(g_f), float(g_s), rtol=2e-3)


# --- analytic gains adjoint kernel ---


def _random_spec(key, B=3, n=2, m=1, p=2):
    from lqg_tpu.utils import stationary_spec
    ks = random.split(key, 8)
    rnd = lambda k, sh: random.normal(k, sh) * 0.3
    A = jnp.eye(n)[None] + 0.1 * rnd(ks[0], (B, n, n))
    Bm = rnd(ks[1], (B, n, m)) + 0.5
    Q = jnp.eye(n)[None] + 0.05 * rnd(ks[2], (B, n, n))
    Q = 0.5 * (Q + mT(Q))
    # R symmetric PD - the kernel contract (the closed-form small inverses
    # read the upper triangle; every zoo model uses diagonal R)
    R = jnp.eye(m)[None] * 0.8 + 0.01 * jnp.abs(rnd(ks[3], (B, m, m)))
    R = 0.5 * (R + mT(R))
    F = rnd(ks[4], (B, p, n)) + jnp.eye(p, n)[None]
    V = jnp.eye(n)[None] * 0.7 + 0.05 * rnd(ks[5], (B, n, n))
    W = jnp.eye(p)[None] * 0.9 + 0.05 * rnd(ks[6], (B, p, p))
    return stationary_spec(A=A, B=Bm, F=F, V=V, W=W, Q=Q, R=R)


@pytest.mark.parametrize("n,m,p,T", [(2, 1, 2, 12), (3, 2, 3, 25),
                                     (2, 1, 2, 7)])
def test_gains_adjoint_kernel_parity(n, m, p, T):
    """The analytic adjoint kernel matches jax.vjp of the scan twin on
    random cotangents (symmetric-input cotangents compared in the
    symmetric gauge - the asymmetric part is unobservable, see
    _gains_adjoint_call)."""
    from lqg_tpu.ops.pallas.gains import _scan_gains, _gains_adjoint_call

    key = random.PRNGKey(42 + n + T)
    spec = _random_spec(key, B=3, n=n, m=m, p=p)
    S0 = spec.V @ mT(spec.V)

    out, vjp = jax.vjp(lambda s, S: _scan_gains(s, S, T), spec, S0)
    ks = random.split(random.PRNGKey(7), 3)
    cots = tuple(random.normal(k, o.shape) * 0.3 for k, o in zip(ks, out))
    sbar_ref, s0bar_ref = vjp(cots)
    sbar_k, s0bar_k = _gains_adjoint_call(spec, S0, T, *cots, interpret=True)

    sym = lambda M: 0.5 * (M + mT(M))
    # f32 accumulation-order noise between the kernel and the scan twin
    # grows with T
    tol = dict(rtol=1e-3, atol=1e-4)
    for fld in ["A", "B", "R", "F", "V", "W"]:
        np.testing.assert_allclose(
            np.asarray(getattr(sbar_k, fld)),
            np.asarray(getattr(sbar_ref, fld)), err_msg=fld, **tol)
    for fld in ["Q", "Qf"]:
        np.testing.assert_allclose(
            np.asarray(sym(getattr(sbar_k, fld))),
            np.asarray(sym(jnp.asarray(getattr(sbar_ref, fld)))),
            err_msg=fld, **tol)
    np.testing.assert_allclose(np.asarray(sym(s0bar_k)),
                               np.asarray(sym(s0bar_ref)), **tol)


def test_gains_kernel_vjp_end_to_end():
    """jax.grad through a likelihood using the fused gains primal + the
    analytic adjoint kernel matches differentiating the scan gains, single
    and vmapped (the custom_vmap fold on the backward path)."""
    from lqg_tpu.ops.pallas.gains import gains_fused, _scan_gains

    m0 = BoundedActor(T=60)
    x = m0.simulate(random.PRNGKey(0), n=4)

    def loss(u, kernel):
        ac, av = u
        m = BoundedActor(T=60, action_cost=ac, action_variability=av)
        spec = jax.tree.map(lambda a: a[None], m.actor)
        S0 = m._default_Sigma0()[None]
        if kernel:
            L, _, K = gains_fused(spec, S0, 60, True)
        else:
            L, _, K = _scan_gains(spec, S0, 60)
        joint = gaussian.joint_system(m.dynamics, m.actor, L[:, 0], K[:, 0],
                                      60)
        return jnp.sum(gaussian.trial_log_likelihood(
            gaussian.conditional_kernel(joint, 2), x))

    u = jnp.array([1.0, 0.5], jnp.float32)
    v_k, g_k = jax.value_and_grad(lambda u: loss(u, True))(u)
    v_s, g_s = jax.value_and_grad(lambda u: loss(u, False))(u)
    np.testing.assert_allclose(float(v_k), float(v_s), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_s), rtol=5e-4)

    us = jnp.stack([u, jnp.array([0.8, 0.6])]).astype(jnp.float32)
    _, gb_k = jax.vmap(jax.value_and_grad(lambda u: loss(u, True)))(us)
    _, gb_s = jax.vmap(jax.value_and_grad(lambda u: loss(u, False)))(us)
    np.testing.assert_allclose(np.asarray(gb_k), np.asarray(gb_s), rtol=5e-4)


def test_fused_ok_inside_trace():
    """Structural-zero cost terms are recognized INSIDE jit/vmap traces, so
    traced models (every NUTS leapfrog) take the fused gains path - round
    3 silently fell back to the scan because jnp.zeros became tracers."""
    from lqg_tpu.ops.pallas.gains import fused_gains_available

    hits = []

    def probe(ac):
        m = BoundedActor(T=20, action_cost=ac)
        hits.append(m._fused_ok() or not fused_gains_available(m.actor))
        return m.actor.R.sum()

    jax.make_jaxpr(probe)(jnp.float32(1.0))
    # on CPU backends _fused_ok is False for the backend check alone; the
    # structural-zero check must not be the blocker
    def probe2(ac):
        m = BoundedActor(T=20, action_cost=ac)
        a = m.actor
        import numpy as _np
        hits.append(all(isinstance(z, _np.ndarray) and not z.any()
                        for z in (a.q, a.r, a.P, a.qf)))
        return a.R.sum()

    jax.make_jaxpr(jax.vmap(probe2))(jnp.ones(2, jnp.float32))
    assert hits[-1], "cost terms lost their concrete-zero encoding in-trace"


def test_fused_ll_requires_kernel_route():
    """On the CPU, auto likelihood takes the scan and forced ``fused``
    raises naming the backend; an unknown method raises too."""
    m = BoundedActor(T=10)
    x = m.simulate(random.PRNGKey(6), n=2)
    np.testing.assert_array_equal(
        np.asarray(m.log_likelihood(x)),
        np.asarray(m.log_likelihood(x, method="scan")))
    with pytest.raises(ValueError, match="'cpu'"):
        m.log_likelihood(x, method="fused")
    with pytest.raises(ValueError, match="method must be"):
        m.log_likelihood(x, method="bogus")


@pytest.mark.parametrize("backend,expected", [("gpu", True), ("cpu", False),
                                              ("rocm", None)])
def test_kernel_route_policy(monkeypatch, backend, expected):
    """One policy: kernels compile on the GPU, the CPU runs the scans, any
    other backend is an error rather than a silent fallback."""
    from lqg_tpu import backend as be

    monkeypatch.setattr(be.jax, "default_backend", lambda: backend)
    if expected is None:
        with pytest.raises(RuntimeError, match="rocm"):
            be.kernel_route()
    else:
        assert be.kernel_route() is expected


# --- large joint states (delay registers): the scan, against the oracle ---


@pytest.mark.parametrize("delay,dim", [
    (4, 1),        # TemporalDelayModel(SubjectiveActor), j = 25
    (4, 2),        # dim = 2: j = 50, observed d = 4
    (None, 1),     # DelayedSubjectiveActor (delay 12): j = 65
])
def test_delay_model_ll_vs_oracle(delay, dim, x64):
    """Delay-register models (beyond the kernel's joint-dim scope) run the
    scan likelihood, which matches the NumPy float64 oracle."""
    import oracle
    from lqg_tpu.models.delay import (DelayedSubjectiveActor,
                                      TemporalDelayModel)

    T, n = 15, 2
    if delay is None:
        m = DelayedSubjectiveActor(T=T)
    else:
        m = TemporalDelayModel(SubjectiveActor(T=T, dim=dim), delay=delay)
    joint = m._joint()
    j = joint.F.shape[-1]
    assert j == {(4, 1): 25, (4, 2): 50, (None, 1): 65}[(delay, dim)]
    assert not fused_ll_available(j, 2 * dim, jnp.float32)
    x = m.simulate(random.PRNGKey(0), n=n)[..., :2 * dim]

    ll = m.log_likelihood(x)
    ll_ref = np.array([oracle.log_likelihood(np.asarray(joint.F),
                                             np.asarray(joint.G),
                                             np.asarray(x[i]))
                       for i in range(n)])
    np.testing.assert_allclose(np.asarray(ll), ll_ref, rtol=1e-7)


def test_blocked_method_removed():
    """The large-j blocked kernel is gone; asking for it raises."""
    from lqg_tpu.models.delay import TemporalDelayModel

    m = TemporalDelayModel(SubjectiveActor(T=20), delay=6)
    x = m.simulate(random.PRNGKey(1), n=2)[..., :2]
    with pytest.raises(ValueError, match="method must be"):
        m.log_likelihood(x, method="blocked")
