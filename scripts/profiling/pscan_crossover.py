"""Where (if anywhere) does the associative scan beat the sequential scan?

The claimed regime for ``method="pscan"`` (O(log T) depth, time axis
shardable over a mesh) is long horizons, T ~ 1e4..1e6.  Every previously
recorded workload (T=500/1000) had pscan losing by 3-4x; this harness
measures the single-chip crossover directly so docs/parallelism.md can
cite a number instead of a claim.

Measures value and value+grad of the summed negative log likelihood for
  * a small-joint-dim model (BoundedActor, j=6) at T in {1e4, 1e5}
  * the large-joint-dim delay model (DelayedSubjectiveActor, j=65) at T=1e4
against the sequential scan (and the fused kernel where it compiles,
for the small-j model).  Reference workflow context: lqg/system.py:214-233 is the
reference's sequential likelihood loop; it has no parallel-in-time path
at all, so any crossover here is capability beyond the reference.

Usage: python scripts/profiling/pscan_crossover.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import jax

from lqg_tpu.backend import kernel_route  # noqa: E402
from lqg_tpu.config import use_compile_cache  # noqa: E402

use_compile_cache()
import jax.numpy as jnp
from jax import lax, random

from lqg_tpu.models import BoundedActor, DelayedSubjectiveActor


def timed(fn, name, *args, reps=3):
    @jax.jit
    def run(*a):
        def body(c, _):
            return c + fn(a[0] + 0.0 * c, *a[1:]), None

        acc, _ = lax.scan(body, jnp.float32(0.0), None, length=reps)
        return acc

    run(*args).block_until_ready()
    t0 = time.perf_counter()
    n_outer = 3
    for _ in range(n_outer):
        run(*args).block_until_ready()
    ms = (time.perf_counter() - t0) / (n_outer * reps) * 1e3
    print(f"  {name}: {ms:.2f} ms/iter", flush=True)
    return ms


def bench(make_model, T, n_trials, methods, reps=3):
    model = make_model(T)
    x = model.simulate(random.PRNGKey(0), n=n_trials)[..., :2]

    def nll(c, method):
        return -make_model(T, c).log_likelihood(x, method=method).sum()

    def guarded(fn, name):
        # a single OOM (e.g. pscan's backward at T=1e5 on one chip) is a
        # RESULT to record, not a reason to lose the other cells
        try:
            return fn()
        except Exception as e:
            print(f"  {name}: FAILED ({type(e).__name__}: "
                  f"{str(e)[:120]})", flush=True)
            return None

    vals = {m: guarded(lambda m=m: float(nll(jnp.float32(0.5), m)),
                       f"value [{m:7s}]") for m in methods}
    rels = {m: abs((vals[m] - vals["scan"]) / vals["scan"])
            for m in methods
            if m != "scan" and vals[m] is not None
            and vals["scan"] is not None}
    print(f"  parity rel-to-scan: "
          + " ".join(f"{m}={r:.2e}" for m, r in rels.items()), flush=True)

    g = jax.grad(nll)
    out = {}
    for m in methods:
        if vals[m] is None:
            out[f"value_{m}"] = None
            continue
        out[f"value_{m}"] = guarded(
            lambda m=m: timed(lambda c: nll(c, m), f"value [{m:7s}]",
                              jnp.float32(0.5), reps=reps),
            f"value [{m:7s}]")
    for m in methods:
        if vals[m] is None:
            out[f"grad_{m}"] = None
            continue
        out[f"grad_{m}"] = guarded(
            lambda m=m: timed(lambda c: g(c, m), f"grad  [{m:7s}]",
                              jnp.float32(0.5), reps=reps),
            f"grad  [{m:7s}]")
    return out


def main():
    print("backend:", jax.default_backend(), flush=True)
    only = set(sys.argv[1:])  # optional: case names to run
    results = {}

    for T in (10_000, 100_000):
        name = f"bounded_T{T}"
        if only and name not in only:
            continue
        print(f"BoundedActor (j small), T={T}, trials=4:", flush=True)
        results[name] = bench(
            lambda T, c=6.0: BoundedActor(T=T, sigma_target=c), T, 4,
            ["scan", "pscan"] + (["fused"] if kernel_route() else []),
            reps=3)

    for T in (10_000,):
        name = f"delay_T{T}"
        if only and name not in only:
            continue
        print(f"DelayedSubjectiveActor (j=65), T={T}, trials=2:", flush=True)
        results[name] = bench(
            lambda T, c=1.0: DelayedSubjectiveActor(T=T, c=c), T, 2,
            ["scan", "pscan"], reps=2)

    import json
    print(json.dumps(results))


if __name__ == "__main__":
    main()
