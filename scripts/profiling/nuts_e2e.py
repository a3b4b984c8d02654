"""End-to-end NUTS parameter-recovery timing on the current backend.

The reference's recovery workload (``main.py:17-28``): BoundedActor,
20 trials x 720 steps, 4 chains.  Here with the native NUTS engine, all
chains vmapped into one compiled program.

Prints wall-clock (excluding compile), draws/s, and the recovered posterior
means vs truth.

Usage: python scripts/profiling/nuts_e2e.py [--samples 500] [--warmup 500]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import jax

from lqg_tpu.config import use_compile_cache  # noqa: E402

use_compile_cache()
from jax import random

from lqg_tpu.infer.mcmc import MCMC
from lqg_tpu.infer.models import lifted_model
from lqg_tpu.models import BoundedActor


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--time", type=int, default=720)
    ap.add_argument("--chunk", type=int, default=32,
                    help="NUTS steps per device launch")
    ap.add_argument("--max-depth", type=int, default=10)
    args = ap.parse_args()

    true = dict(action_cost=0.5, action_variability=0.5,
                sigma_target=6.0, sigma_cursor=2.0)
    model = BoundedActor(T=args.time - 1, **true)
    x = model.simulate(random.PRNGKey(0), n=args.trials)

    prob = lifted_model(x, BoundedActor)  # T is derived from x
    mcmc = MCMC(prob, num_warmup=args.warmup, num_samples=args.samples,
                num_chains=args.chains, progress=True,
                chunk_steps=args.chunk, max_depth=args.max_depth)

    # compile (1 warmup + 1 sample; same graph shape as the full run would
    # re-specialize on lengths, so time the full run cold vs warm instead)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(1))
    jax.block_until_ready(mcmc._samples_u)
    cold = time.perf_counter() - t0

    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(2))
    jax.block_until_ready(mcmc._samples_u)
    warm = time.perf_counter() - t0

    total_draws = args.chains * (args.warmup + args.samples)
    print(f"backend={jax.default_backend()} chains={args.chains} "
          f"warmup={args.warmup} samples={args.samples} "
          f"trials={args.trials} T={args.time}")
    print(f"cold (incl. compile): {cold:.1f}s; warm: {warm:.1f}s "
          f"-> {total_draws / warm:.1f} draws/s")
    print(f"divergences: {mcmc.divergences}")
    means = {k: float(v.mean()) for k, v in mcmc.get_samples().items()}
    print("posterior means vs truth:")
    for k, v in means.items():
        print(f"  {k}: {v:.4f}  (true {true.get(k, float('nan')):.4f})")


if __name__ == "__main__":
    main()
