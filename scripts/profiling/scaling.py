"""Mesh-scaling sweep for the sharded trial-parallel likelihood.

Measures value+grad throughput of the psum-reduced, trial-sharded
log-likelihood (`lqg_tpu.parallel.sharding.sharded_log_likelihood`) over a
sweep of data-parallel mesh sizes.

IMPORTANT: on virtual CPU devices (`--cpu N`) the mesh shares one physical
host, so the timings validate *correctness and compilation* of the sharded
program, not hardware scaling - run on real GPUs for scaling numbers.
On one card the dp=1 row is the per-card baseline a multi-card run is
compared against.

Usage:
    python scripts/profiling/scaling.py --cpu 8      # virtual 8-device mesh
    python scripts/profiling/scaling.py              # real devices (GPUs)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="force a virtual CPU mesh of this many devices")
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--time", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={args.cpu}")
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax import random
    from jax.sharding import Mesh

    from lqg_tpu.models import BoundedActor
    from lqg_tpu.parallel.sharding import sharded_log_likelihood

    n_dev = len(jax.devices())
    model = BoundedActor(T=args.time)
    x = model.simulate(random.PRNGKey(0), n=args.trials)
    params = dict(action_cost=jnp.float32(0.5),
                  action_variability=jnp.float32(0.5),
                  sigma_target=jnp.float32(6.0),
                  sigma_cursor=jnp.float32(2.0))

    def builder(p):
        return BoundedActor(T=args.time, **p)

    print(f"backend={jax.default_backend()} devices={n_dev} "
          f"trials={args.trials} T={args.time}")
    dp = 1
    while dp <= n_dev:
        mesh = Mesh(jax.devices()[:dp], ("dp",))
        ll_fn = sharded_log_likelihood(builder, x, mesh)
        vg = jax.jit(jax.value_and_grad(
            lambda p: ll_fn(p)))
        v, g = vg(params)
        jax.block_until_ready(v)  # compile
        t0 = time.perf_counter()
        for _ in range(args.reps):
            v, g = vg(params)
        jax.block_until_ready(v)
        dt = (time.perf_counter() - t0) / args.reps
        print(f"  dp={dp:2d}: value+grad {dt * 1e3:8.2f} ms "
              f"({args.trials / dt:9.1f} trials/s)  ll={float(v):.2f}")
        dp *= 2


if __name__ == "__main__":
    main()
