"""Worker for the 2-process ``jax.distributed`` bring-up test.

Launched by ``tests/test_distributed.py`` as
``python tests/_dist_worker.py <process_id> <num_processes> <port> <outfile>``.

Each process owns one CPU device; together they form a global ``dp=2`` mesh
over DCN (the gRPC coordination service), and the trial-sharded likelihood's
``psum`` total must equal the single-process value (SURVEY.md section 5.8:
the ``jax.distributed`` runtime is a first-class capability).
"""

import os
import sys


def main():
    proc_id, nproc, port, outfile = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "1d"
    # drop any inherited multi-device flags
    os.environ.pop("XLA_FLAGS", None)
    if mode == "2d":
        # two local CPU devices per process -> a 4-device global mesh whose
        # axes BOTH live on a process-spanning mesh (chains axis crosses the
        # process boundary, dp is within-process)
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from lqg_tpu.parallel.mesh import distributed_init, make_mesh
    from lqg_tpu.parallel.sharding import sharded_log_likelihood

    distributed_init(coordinator=f"localhost:{port}", num_processes=nproc,
                     process_id=proc_id)
    assert jax.process_count() == nproc, jax.process_count()
    if mode == "2d":
        assert len(jax.devices()) == 2 * nproc, jax.devices()
        return main_2d(proc_id, nproc, outfile)
    assert len(jax.devices()) == nproc, jax.devices()

    import jax.numpy as jnp
    from jax import random
    from lqg_tpu.models import BoundedActor

    T, n = 60, 4
    # same seed on every process -> identical full data array per host
    x = BoundedActor(T=T).simulate(random.PRNGKey(0), n=n)

    mesh = make_mesh([("dp", nproc)], jax.devices())

    def builder(params):
        return BoundedActor(T=T, action_cost=params["action_cost"])

    total_ll = sharded_log_likelihood(builder, x, mesh)
    total = total_ll({"action_cost": jnp.float32(0.7)})

    with open(f"{outfile}.{proc_id}", "w") as f:
        f.write(repr(float(total)))

    # --- phase 2: SPMD chain-sharded NUTS across the 2 processes, with a
    # mid-run checkpoint written by process 0 and resumed by both ---
    import numpy as np

    from lqg_tpu.infer.mcmc import MCMC
    from lqg_tpu.infer.models import lifted_model
    from lqg_tpu.parallel.sharding import sharded_chains_run

    chains_mesh = make_mesh([("chains", nproc)], jax.devices())
    x_mc = BoundedActor(T=30).simulate(random.PRNGKey(3), n=3)
    prob = lifted_model(x_mc, BoundedActor)
    kwargs = dict(num_warmup=8, num_samples=8, num_chains=nproc,
                  max_depth=4, chunk_steps=4, checkpoint_every=1)
    key = random.PRNGKey(5)

    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(chains_mesh, P())
    host = lambda a: np.asarray(jax.device_put(a, rep))

    # uninterrupted reference (no checkpoint)
    ref = MCMC(prob, **kwargs)
    sharded_chains_run(ref, key, chains_mesh)
    ref_u = host(ref._samples_u)

    # interrupted + resumed run must reproduce it exactly
    ck = f"{outfile}.mcmc.npz"
    part = MCMC(prob, **kwargs)
    out = sharded_chains_run(part, key, chains_mesh, checkpoint_path=ck,
                             _stop_after_launches=1)
    assert out is None
    res = MCMC(prob, **kwargs)
    sharded_chains_run(res, key, chains_mesh, checkpoint_path=ck)
    res_u = host(res._samples_u)
    assert np.allclose(res_u, ref_u, atol=1e-6), "resume mismatch"
    assert np.isfinite(res_u).all()

    with open(f"{outfile}.mcmc.{proc_id}", "w") as f:
        f.write(repr(float(res_u.sum())))


def main_2d(proc_id, nproc, outfile):
    """(chains x dp) 2D mesh spanning 2 processes.

    The single-process dryrun (``__graft_entry__.dryrun_multichip``) runs
    this layout on virtual devices; here the same program executes with the
    chains axis crossing a real ``jax.distributed`` process boundary: the
    hierarchical shared-parameter gradient step with trials sharded over
    ``dp`` and optimization replicas over ``chains``, then chain-sharded
    NUTS with ``P("chains")`` placement on the SAME 2D mesh.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax import random
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lqg_tpu.models import BoundedActor
    from lqg_tpu.infer.mcmc import MCMC
    from lqg_tpu.infer.models import lifted_model, shared_params_lqg_model
    from lqg_tpu.parallel.mesh import make_mesh
    from lqg_tpu.parallel.sharding import sharded_chains_run

    n_chains, n_dp = nproc, 2
    mesh = make_mesh([("chains", n_chains), ("dp", n_dp)], jax.devices())

    T, trials, conds = 16, 2 * n_dp, 2
    x = jnp.stack([
        BoundedActor(T=T).simulate(random.PRNGKey(c), n=trials)
        for c in range(conds)])
    shared = ["action_cost", "action_variability", "sigma_cursor"]

    x_sharded = jax.device_put(x, NamedSharding(mesh, P(None, "dp")))
    model0 = shared_params_lqg_model(x, BoundedActor, shared_params=shared)
    u0 = model0.init_unconstrained()
    us = jnp.stack([u0 + 0.01 * i for i in range(n_chains)])
    us = jax.device_put(us, NamedSharding(mesh, P("chains")))

    opt = optax.adam(1e-2)

    def potential_with_data(u, xdata):
        m = shared_params_lqg_model(xdata, BoundedActor,
                                    shared_params=shared)
        return m.potential(u)

    @jax.jit
    def train_step(us, xdata):
        def one(u):
            loss, g = jax.value_and_grad(potential_with_data)(u, xdata)
            updates, _ = opt.update(g, opt.init(u))
            return optax.apply_updates(u, updates), loss
        return jax.vmap(one)(us)

    new_us, losses = train_step(us, x_sharded)
    rep = NamedSharding(mesh, P())
    host = lambda a: np.asarray(jax.device_put(a, rep))
    losses_h = host(losses)
    assert np.isfinite(losses_h).all(), losses_h

    # NUTS chains sharded over the 2D mesh's chains axis (dp idle but
    # present: the chain program partitions on the full process-spanning
    # mesh)
    x_mc = BoundedActor(T=24).simulate(random.PRNGKey(3), n=3)
    prob = lifted_model(x_mc, BoundedActor)
    mc = MCMC(prob, num_warmup=8, num_samples=8, num_chains=n_chains,
              max_depth=4, chunk_steps=4)
    sharded_chains_run(mc, random.PRNGKey(5), mesh)
    draws = host(mc._samples_u)
    assert np.isfinite(draws).all()

    with open(f"{outfile}.2d.{proc_id}", "w") as f:
        f.write(repr(float(losses_h.sum()) + float(draws.sum())))


if __name__ == "__main__":
    main()
