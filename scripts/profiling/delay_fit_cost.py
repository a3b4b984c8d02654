"""Measure the NUTS leapfrog cost of the DelayedSubjectiveActor data fit.

Before committing chip-hours to fitting the explicit-delay model to
data.mat, measure the actual per-leapfrog quantity: value+grad of the
hierarchical shared-params potential (6 conditions x 20 trials x T=1008,
j=65, the XLA scan) vmapped over the chain batch - then size the
chain/transition budget from it.

Usage: python scripts/profiling/delay_fit_cost.py [nchain ...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import jax

from lqg_tpu.config import use_compile_cache  # noqa: E402

use_compile_cache()
import jax.numpy as jnp
from jax import random

from lqg_tpu.io import load_tracking_data
from lqg_tpu.models import DelayedSubjectiveActor
from lqg_tpu.infer.models import get_model_params, shared_params_lqg_model


def main():
    chains_list = [int(a) for a in sys.argv[1:]] or [4, 8]
    print("backend:", jax.default_backend(), flush=True)

    # the model carries the 12-step register explicitly, so the loader's
    # shift is disabled (reference delay.py applies the same convention)
    data, bws = load_tracking_data(delay=0, clip=180, subtract_mean=False)
    print("data:", data.shape, flush=True)

    shared = [p for p in ["action_variability", "action_cost",
                          "sigma_cursor", "subj_noise", "subj_vel_noise"]
              if p in get_model_params(DelayedSubjectiveActor)]
    prob = shared_params_lqg_model(data, DelayedSubjectiveActor,
                                   shared_params=shared)

    u0 = prob.init_unconstrained()
    vg = jax.jit(jax.vmap(jax.value_and_grad(prob.potential)))

    for nchain in chains_list:
        us = u0[None, :] + 0.01 * jnp.arange(nchain)[:, None]
        t0 = time.perf_counter()
        v, g = vg(us)
        v.block_until_ready()
        compile_s = time.perf_counter() - t0
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            v, g = vg(us)
            v.block_until_ready()
        ms = (time.perf_counter() - t0) / reps * 1e3
        print(f"chains={nchain}: value+grad {ms:.1f} ms/leapfrog "
              f"(compile {compile_s:.1f}s), potential {float(v[0]):.1f}; "
              f"-> {3600 / (ms / 1e3 * 64):.0f} transitions/h at depth 6",
              flush=True)


if __name__ == "__main__":
    main()
