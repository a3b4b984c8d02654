"""Probe: does Laplace (exact MAP-Hessian) whitening fix flagship mixing?

Measures, at full data scale (6 conditions x 20 trials x T=1008):
1. the Hessian spectrum at the MAP (the true local metric - compare with
   the pooled-draw covariance that empirical preconditioning used),
2. 1D potential slices along the extreme-curvature eigendirections in
   whitened units (quadratic <=> locally Gaussian <=> NUTS should mix),
3. a short NUTS run in the whitened space: tree depths + lag-1 autocorr.

Findings recorded in docs/data.md.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import random

from lqg_tpu.infer.mcmc import MCMC
from lqg_tpu.infer.models import shared_params_lqg_model
from lqg_tpu.infer.svi import laplace_guide, optimize
from lqg_tpu.infer.utils import neutra_reparam
from lqg_tpu.io import load_tracking_data
from lqg_tpu.models.basic import BoundedActor

SHARED = ["action_variability", "action_cost", "sigma_cursor"]


def main():
    data, bws = load_tracking_data(delay=12, clip=180, subtract_mean=False)
    model = shared_params_lqg_model(data, BoundedActor, shared_params=SHARED)

    t0 = time.perf_counter()
    map_params, losses = optimize(model, steps=1500, step_size=0.05)
    model.init = {k: jnp.asarray(v) for k, v in map_params.items()}
    print(f"[map] potential {float(losses[-1]):.1f} "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    guide, eigs = laplace_guide(model)
    sds = np.sqrt(np.diag(np.asarray(
        guide.scale_tril @ guide.scale_tril.T, dtype=np.float64)))
    print(f"[hessian] {time.perf_counter() - t0:.1f}s; eigenvalues "
          + np.array2string(np.asarray(eigs), precision=3), flush=True)
    print("[hessian] implied posterior sds (unconstrained): "
          + np.array2string(sds, precision=4))
    print("[hessian] names:", model.names)

    # 1D slices along the flattest and stiffest eigendirections, in
    # whitened units: quadratic => 0.5 t^2 + const
    warped = neutra_reparam(model, guide)
    pot = jax.jit(lambda e: -warped.log_joint_unconstrained(e))
    e0 = np.zeros(len(model.names), dtype=np.float32)
    p0 = float(pot(jnp.asarray(e0)))
    from lqg_tpu.system import force_scan_dispatch
    with force_scan_dispatch():
        hess = np.asarray(jax.jacfwd(jax.grad(
            lambda u: -model.log_joint_unconstrained(u)))(
            model.init_unconstrained()), dtype=np.float64)
    w, v = np.linalg.eigh(0.5 * (hess + hess.T))
    Lnp = np.asarray(guide.scale_tril, dtype=np.float64)
    for label, direction in [("flattest", v[:, 0]), ("stiffest", v[:, -1])]:
        d_eps = np.linalg.solve(Lnp, direction / np.sqrt(
            np.abs(direction @ hess @ direction)))
        vals = []
        for t in (-4.0, -2.0, -1.0, 1.0, 2.0, 4.0):
            vals.append(float(pot(jnp.asarray(e0 + t * d_eps,
                                              jnp.float32))) - p0)
        print(f"[slice {label}] dU at t=+-(1,2,4): {vals}  "
              f"(quadratic => {[8.0, 2.0, 0.5, 0.5, 2.0, 8.0]})",
              flush=True)

    # short NUTS probe in the whitened space
    mcmc = MCMC(warped, num_warmup=80, num_samples=120, num_chains=4,
                max_depth=8, init_jitter=1.0, progress=True,
                max_leapfrogs_per_launch=1024)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(7))
    print(f"[probe] 4 chains x (80+120) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    extra = mcmc.get_extra_fields()
    depth = np.asarray(extra.get("tree_depth"))
    print(f"[probe] tree depth mean {depth.mean():.2f} "
          f"max {depth.max()}  (r4 runs: saturated at max_depth)")
    samples = mcmc.get_samples(group_by_chain=True)
    for name in model.names[:4]:
        x = np.asarray(samples[name], dtype=np.float64)  # (chains, draws)
        xc = x - x.mean(axis=1, keepdims=True)
        ac1 = float(np.mean(np.sum(xc[:, 1:] * xc[:, :-1], axis=1)
                            / np.sum(xc * xc, axis=1)))
        print(f"[probe] {name}: lag-1 autocorr {ac1:+.3f} "
              f"(r4 flagship: ~+0.97)")
    mcmc.print_summary()


if __name__ == "__main__":
    main()
