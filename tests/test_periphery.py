"""Periphery tests: optim bridge, results persistence, common model, CLI
argument parsing, LaTeX repr."""

import os

import numpy as np
import jax.numpy as jnp
from jax import random
import pytest

from lqg_tpu.optim import minimize
from lqg_tpu.results import (save_netcdf, load_netcdf, save_summary_csv,
                             save_mcmc_checkpoint, load_mcmc_checkpoint)
from lqg_tpu.models import BoundedActor
from lqg_tpu.infer.models import common_lqg_model, get_model_params


def test_minimize_pytree():
    """Rosenbrock over a pytree, gradient from JAX autodiff."""
    def fun(p):
        x, y = p["x"], p["y"]
        return (1.0 - x) ** 2 + 100.0 * (y - x ** 2) ** 2

    res = minimize(fun, {"x": jnp.asarray(-1.0), "y": jnp.asarray(2.0)},
                   method="BFGS")
    assert res.success
    np.testing.assert_allclose(float(res.x["x"]), 1.0, rtol=1e-4)
    np.testing.assert_allclose(float(res.x["y"]), 1.0, rtol=1e-4)


def test_netcdf_roundtrip(tmp_path):
    samples = {"a": np.random.default_rng(0).standard_normal((2, 50)),
               "b": np.random.default_rng(1).standard_normal((2, 50))}
    path = str(tmp_path / "post.nc")
    save_netcdf(path, samples, attrs={"model": "BoundedActor"})
    loaded = load_netcdf(path)
    np.testing.assert_allclose(loaded["a"], samples["a"])
    np.testing.assert_allclose(loaded["b"], samples["b"])


def test_summary_csv(tmp_path):
    import csv

    table = {"a": {"mean": 1.0, "sd": 0.1}, "b": {"mean": 2.0, "sd": 0.2}}
    path = str(tmp_path / "out" / "summary.csv")
    out = save_summary_csv(path, table, true_params={"a": 0.9}, seed=3)
    assert os.path.exists(path)
    assert out["a"]["true"] == 0.9

    with open(path, newline="") as f:
        back = list(csv.reader(f))
    assert back[0] == ["", "mean", "sd", "true", "seed"]
    assert back[1][0] == "a" and float(back[1][3]) == 0.9
    assert back[2][3] == "" and back[2][4] == "3"


def test_mcmc_checkpoint_roundtrip(tmp_path):
    from lqg_tpu.infer.models import ProbModel
    from lqg_tpu.infer import transforms as tfm
    from lqg_tpu.infer.mcmc import MCMC

    def build():
        return ProbModel(init={"a": jnp.asarray(0.0)},
                         transforms={"a": tfm.identity},
                         log_likelihood=lambda p: -0.5 * p["a"] ** 2,
                         priors={})

    m = MCMC(build(), num_warmup=50, num_samples=50, num_chains=2)
    m.run(random.PRNGKey(0))
    path = str(tmp_path / "ckpt.npz")
    save_mcmc_checkpoint(path, m)

    m2 = MCMC(build(), num_warmup=50, num_samples=50, num_chains=2)
    load_mcmc_checkpoint(path, m2)
    np.testing.assert_allclose(np.asarray(m2._samples_u),
                               np.asarray(m._samples_u))
    assert m2.divergences == m.divergences
    # summary works off the restored state
    assert "a" in m2.summary()


def test_common_lqg_model_sites():
    x1 = BoundedActor(T=60, sigma_target=5.0).simulate(random.PRNGKey(0), n=2)
    x2 = BoundedActor(T=60, sigma_target=15.0).simulate(random.PRNGKey(1), n=2)
    x = jnp.stack([x1, x2])

    model = common_lqg_model(x, BoundedActor)
    shared = set(get_model_params(BoundedActor)) - {"sigma_target"}
    assert shared <= set(model.names)
    assert {"sigma_target_0", "sigma_target_1"} <= set(model.names)
    assert "sigma_target" not in model.names

    import jax
    pe = model.potential(model.init_unconstrained())
    assert np.isfinite(float(pe))


def test_latex_repr():
    m = BoundedActor(T=10)
    s = m._repr_latex_()
    assert "bmatrix" in s and "Dynamics" in s and "Actor" in s


def test_cli_arg_parsing():
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import fit_data

    args = fit_data.parse_args(["--model", "SubjectiveActor", "--nsamp",
                                "10"])
    assert args.model == "SubjectiveActor"
    assert args.nsamp == 10
    assert "action_cost" in args.shared_params


def test_profiling_timeit():
    import jax.numpy as jnp
    from lqg_tpu.utils.profiling import timeit

    t = timeit(lambda a: a * 2, jnp.arange(8.0), iters=3, warmup=1,
               name="mul")
    assert t.mean_s > 0 and t.min_s <= t.mean_s and t.per_s > 0
    assert "mul" in str(t)
