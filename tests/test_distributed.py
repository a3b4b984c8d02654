"""Multi-process (multi-host) bring-up: 2 local ``jax.distributed`` CPU
processes computing the trial-sharded likelihood over a global mesh.

The reference has no distributed backend at all (SURVEY.md section 2.6);
this validates the greenfield ``jax.distributed`` path end to end: runtime
init via ``distributed_init``, a global ``dp`` mesh spanning processes, and
the ``psum`` log-likelihood reduction agreeing with single-process
evaluation.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(__file__)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_sharded_likelihood(tmp_path):
    port = _free_port()
    outfile = str(tmp_path / "total")
    nproc = 2

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
        env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_dist_worker.py"),
             str(i), str(nproc), str(port), outfile],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    totals = []
    for i in range(nproc):
        with open(f"{outfile}.{i}") as f:
            totals.append(float(f.read()))
    # psum result is replicated: every process sees the same total
    assert totals[0] == pytest.approx(totals[1], rel=1e-6)

    # single-process oracle (this process: CPU, virtual devices)
    import jax.numpy as jnp
    from jax import random
    from lqg_tpu.models import BoundedActor

    T, n = 60, 4
    x = BoundedActor(T=T).simulate(random.PRNGKey(0), n=n)
    expected = float(
        BoundedActor(T=T, action_cost=0.7).log_likelihood(x).sum())
    np.testing.assert_allclose(totals[0], expected, rtol=2e-5)

    # phase 2 (chain-sharded NUTS + cross-process checkpoint resume): both
    # processes finish and agree on the resumed draws
    mcmc_sums = []
    for i in range(nproc):
        with open(f"{outfile}.mcmc.{i}") as f:
            mcmc_sums.append(float(f.read()))
    assert mcmc_sums[0] == pytest.approx(mcmc_sums[1], rel=1e-6)


@pytest.mark.slow
def test_two_process_2d_mesh(tmp_path):
    """(chains x dp) 2D mesh across 2 processes: each
    worker forces 2 local CPU devices, so the 4-device global mesh has the
    chains axis spanning the process boundary and dp within-process; the
    sharded training step and chain-sharded NUTS must run and agree."""
    port = _free_port()
    outfile = str(tmp_path / "total")
    nproc = 2

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + \
        env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_dist_worker.py"),
             str(i), str(nproc), str(port), outfile, "2d"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"2d worker failed:\n{out}"

    sums = []
    for i in range(nproc):
        with open(f"{outfile}.2d.{i}") as f:
            sums.append(float(f.read()))
    # the replicated (loss + draws) total is identical on every process
    assert sums[0] == pytest.approx(sums[1], rel=1e-6)
