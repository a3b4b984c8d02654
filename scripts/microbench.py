"""Structured timing of every hot solve, across kernel variants.

Prints a table of steady-state timings (device execution included,
dispatch pipelining excluded) for:

* gains (Riccati backward + Kalman forward): sequential scan, associative
  scan, fused Pallas kernel (where the backend compiles it: the GPU);
* marginalized likelihood: sequential kernel path vs parallel-in-time
  associative path, and its gradient;
* closed-loop simulation.

Run on the GPU (plain ``python scripts/microbench.py``) or CPU
(``--cpu``; CPU times say nothing about the card).  Use ``--trace DIR`` to
also capture a profiler trace of the headline solves.  See ``bench.py``
for the gains throughput JSON metric.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--batch", type=int, default=1024,
                    help="parameter particles for the batched-gains rows")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace", type=str, default=None,
                    help="also capture a jax.profiler trace to this dir")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from lqg_tpu.backend import kernel_route
    from lqg_tpu.config import use_compile_cache

    use_compile_cache()

    import jax.numpy as jnp
    from jax import random

    from lqg_tpu.models import BoundedActor
    from lqg_tpu.models.basic import tracking_spec
    from lqg_tpu.ops import riccati, kalman
    from lqg_tpu.ops.linalg import mT
    from lqg_tpu.parallel import pscan
    from lqg_tpu.utils.profiling import timeit, trace

    T, n, B, iters = args.T, args.trials, args.batch, args.iters
    print(f"backend={jax.default_backend()} T={T} trials={n} "
          f"particles={B}\n")

    model = BoundedActor(T=T)
    spec = model.actor
    Sigma0 = spec.V @ mT(spec.V)
    x = model.simulate(random.PRNGKey(0), n=n)
    rows = []

    # --- gains, one parameter set ---
    g_scan = jax.jit(lambda s: (riccati.backward(s, horizon=T).L,
                                kalman.forward(s, Sigma0=Sigma0, horizon=T)))
    rows.append(timeit(g_scan, spec, iters=iters, name="gains scan (1 set)"))

    g_assoc = jax.jit(lambda s: (pscan.lqr_backward_assoc(s, horizon=T).L,
                                 pscan.kalman_forward_assoc(s, Sigma0,
                                                            horizon=T)))
    rows.append(timeit(g_assoc, spec, iters=iters,
                       name="gains assoc-scan (1 set)"))

    # --- gains, batched particles ---
    ac = jnp.logspace(-2, 1, B)
    bspec = jax.vmap(lambda c: tracking_spec(
        dim=1, process_noise=1.0, action_variability=0.5, sigma_target=6.0,
        sigma_cursor=4.0, action_cost=c, dt=1.0 / 60.0))(ac)
    bSigma0 = bspec.V @ mT(bspec.V)

    gb_scan = jax.jit(lambda s: (riccati.backward(s, horizon=T).L,
                                 kalman.forward(s, Sigma0=bSigma0,
                                                horizon=T)))
    rows.append(timeit(gb_scan, bspec, iters=iters,
                       name=f"gains scan ({B} particles)"))

    if kernel_route():
        from lqg_tpu.ops.pallas.gains import fused_gains

        gb_fused = jax.jit(lambda s: fused_gains(s, bSigma0, horizon=T))
        rows.append(timeit(gb_fused, bspec, iters=iters,
                           name=f"gains fused Pallas ({B} particles)"))

    # --- likelihood ---
    ll_seq = jax.jit(lambda d: model.log_likelihood(d))
    rows.append(timeit(ll_seq, x, iters=iters,
                       name=f"log_likelihood scan ({n} trials)"))

    ll_par = jax.jit(lambda d: model.log_likelihood(d, method="pscan"))
    rows.append(timeit(ll_par, x, iters=iters,
                       name=f"log_likelihood pscan ({n} trials)"))

    grad_seq = jax.jit(jax.grad(lambda c: jnp.sum(
        BoundedActor(T=T, action_cost=c).log_likelihood(x))))
    rows.append(timeit(grad_seq, jnp.asarray(0.5), iters=iters,
                       name="grad log_likelihood scan"))

    # --- simulation ---
    sim = jax.jit(lambda k: model.simulate(k, n=n))
    rows.append(timeit(sim, random.PRNGKey(1), iters=iters,
                       name=f"simulate ({n} trials)"))

    print("\n".join(str(r) for r in rows))

    if args.trace:
        with trace(args.trace):
            g_scan(spec)[0].block_until_ready()
            ll_seq(x).block_until_ready()
        print(f"\nprofiler trace written to {args.trace}")


if __name__ == "__main__":
    main()
