"""On-card kernel lane: the compiled Triton-route kernels against the scan.

Run on a machine with a GPU::

    JAX_PLATFORMS=cuda python -m pytest -o addopts= -m gpu tests/test_gpu.py

Every test here is ``gpu``-marked and takes the ``gpu`` fixture, so it
skips, with a reason, wherever JAX's backend is not a GPU.  The checks
mirror ``chip_smoke.py`` at smaller shapes: ``auto`` dispatch engages the
kernels, and their values and gradients match the XLA scan.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import random

from lqg_tpu.models import BoundedActor, SubjectiveActor

pytestmark = pytest.mark.gpu


def test_auto_dispatch_uses_fused_paths(gpu):
    """On the GPU, auto gains/likelihood take the fused kernel paths."""
    m = BoundedActor(T=100)
    assert m._fused_ok()
    from lqg_tpu.ops.pallas.likelihood import fused_ll_available

    j = m.xdim + m.bdim
    assert fused_ll_available(j, m.xdim, jnp.float32)


def test_gains_on_chip_parity(gpu):
    """Fused gains compiled for the card == XLA scan gains."""
    m = BoundedActor(T=200)
    g_f, K_f = m.gains(method="fused")
    g_s, K_s = m.gains(method="scan")
    np.testing.assert_allclose(np.asarray(g_f.L), np.asarray(g_s.L),
                               atol=3e-5)
    np.testing.assert_allclose(np.asarray(K_f), np.asarray(K_s), atol=3e-5)


def test_likelihood_on_chip_parity_and_grads(gpu):
    """Fused likelihood (value, param-grad, data-grad) compiled for the
    card == the scan path."""
    T = 200
    m = SubjectiveActor(T=T)
    x = m.simulate(random.PRNGKey(0), n=8)

    ll_f = m.log_likelihood(x, method="fused")
    ll_s = m.log_likelihood(x, method="scan")
    np.testing.assert_allclose(np.asarray(ll_f), np.asarray(ll_s),
                               rtol=2e-4, atol=5e-3)

    def nll(p, method):
        return -SubjectiveActor(T=T, subj_noise=p).log_likelihood(
            x, method=method).sum()

    g_f = jax.grad(lambda p: nll(p, "fused"))(jnp.float32(0.8))
    g_s = jax.grad(lambda p: nll(p, "scan"))(jnp.float32(0.8))
    np.testing.assert_allclose(float(g_f), float(g_s), rtol=5e-3)

    gx_f = jax.grad(
        lambda x_: m.log_likelihood(x_, method="fused").sum())(x)
    gx_s = jax.grad(
        lambda x_: m.log_likelihood(x_, method="scan").sum())(x)
    np.testing.assert_allclose(np.asarray(gx_f), np.asarray(gx_s),
                               rtol=5e-3, atol=5e-3)


def test_delay_model_pscan_on_chip_parity(gpu):
    """Large-j delay model (outside the kernel's scope): the associative
    path on the card matches the sequential scan."""
    from lqg_tpu.models import DelayedSubjectiveActor

    m = DelayedSubjectiveActor(T=100)
    x = m.simulate(random.PRNGKey(1), n=2)[..., :2]
    ll_pscan = m.log_likelihood(x, method="pscan")
    ll_scan = m.log_likelihood(x, method="scan")
    np.testing.assert_allclose(np.asarray(ll_pscan), np.asarray(ll_scan),
                               rtol=2e-3, atol=5e-2)
