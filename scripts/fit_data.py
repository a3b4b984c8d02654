"""Real-data fit CLI: continuous psychophysics (Bonnen et al. 2015 data).

Workflow parity with reference ``cpp_data_fit.py``: load the tracking
dataset, run NUTS on the hierarchical shared-parameters model across the 6
blob-width conditions, and persist the posterior as netcdf.

Example:
    python scripts/fit_data.py --model BoundedActor --nsamp 500 \
        --nburnin 300 --nchain 2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(args=None):
    parser = argparse.ArgumentParser(description="Continuous Psychophysics")
    parser.add_argument("--delay", type=int, default=12,
                        help="Temporal shift between target and response")
    parser.add_argument("--clip", type=int, default=180,
                        help="Clip the initial n time steps of the data")
    parser.add_argument("--nsamp", type=int, default=5_000,
                        help="Number of samples drawn by NUTS")
    parser.add_argument("--nburnin", type=int, default=1_500,
                        help="Number of burn-in samples.")
    parser.add_argument("--nchain", type=int, default=4)
    parser.add_argument("--max-depth", type=int, default=10,
                        help="NUTS maximum tree depth (2^depth leapfrogs "
                             "worst case)")
    parser.add_argument("--model", type=str, default="BoundedActor",
                        help="Model type")
    parser.add_argument("--seed", type=int, default=1,
                        help="Random seed (for NUTS)")
    parser.add_argument("--data", type=str, default=None,
                        help="Directory containing data.mat")
    parser.add_argument("--out", type=str, default="data/processed",
                        help="Output directory for the netcdf posterior")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Checkpoint the in-flight run here (and resume "
                             "from it if present)")
    parser.add_argument("--platform", type=str, default=None,
                        help="Force a JAX platform (cpu/cuda)")
    parser.add_argument("--neutra", type=str, default="none",
                        choices=["none", "mvn", "iaf", "laplace"],
                        help="NeuTra preconditioning: fit a variational "
                             "guide (full-rank Gaussian or IAF flow) and "
                             "run NUTS in the whitened space, or (laplace) "
                             "whiten by the exact inverse Hessian at the "
                             "MAP - no SVI, deterministic, and unlike "
                             "sample-based preconditioning it measures "
                             "directions the chains never explored.  The "
                             "hierarchical posterior's correlations "
                             "otherwise drive every tree to max depth "
                             "(~2^10 leapfrogs/step) under the diagonal "
                             "mass matrix")
    parser.add_argument("--neutra-steps", type=int, default=3000,
                        help="SVI steps for the NeuTra guide fit")
    parser.add_argument("--max-leapfrogs", type=int, default=None,
                        help="Leapfrog budget per device launch (bounds "
                             "per-launch device time; default unbounded)")
    parser.add_argument("--init", type=str, default="median",
                        choices=["median", "map"],
                        help="Chain initialization: prior median (reference "
                             "init_to_median parity) or a MAP point fit. "
                             "The data.mat posterior is MULTIMODAL (target "
                             "vs cursor observation noise trade off); "
                             "median-initialized chains land in different "
                             "basins and r-hat diverges across them - "
                             "init=map starts all chains in the MAP's "
                             "basin, which carries the published "
                             "sigma_target-vs-blob-width trend")
    parser.add_argument("--map-steps", type=int, default=1500,
                        help="Adam steps for the MAP fit (--init map)")
    parser.add_argument("--init-jitter", type=float, default=0.2,
                        help="Uniform jitter around the init point in "
                             "unconstrained space (use ~0.02 with "
                             "--init map to stay in-basin)")
    parser.add_argument("--precondition", type=str, default=None,
                        help="Empirical preconditioning: netcdf posterior "
                             "from a previous run; its pooled draw "
                             "covariance (unconstrained space) becomes a "
                             "FIXED dense inverse mass (warmup adapts the "
                             "step size only)")
    parser.add_argument(
        "--shared_params", type=str, nargs="*",
        default=["action_variability", "action_cost", "c", "sigma_cursor",
                 "subj_noise", "subj_vel_noise"],
        help="Parameters shared across conditions ('c' is the delay "
             "models' action-cost name; entries absent from a model's "
             "signature are dropped)")
    return parser.parse_args(args=args)


if __name__ == "__main__":
    args = parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp
    from jax import random

    from lqg_tpu import tracking
    from lqg_tpu.io import load_tracking_data
    from lqg_tpu.infer.mcmc import MCMC
    from lqg_tpu.infer.models import (get_model_params,
                                      shared_params_lqg_model)
    from lqg_tpu.results import save_netcdf

    Model = getattr(tracking, args.model)
    model_params = get_model_params(Model).keys()
    shared = [p for p in args.shared_params if p in list(model_params)]

    data, bws = load_tracking_data(delay=args.delay, clip=args.clip,
                                   subtract_mean=False, data_path=args.data)
    print("data:", data.shape, "blob widths:", bws)

    prob_model = shared_params_lqg_model(data, Model, shared_params=shared)

    if args.init == "map":
        # base-model MAP FIRST: with --neutra this anchors the guide's
        # starting location (fit_auto_* seed their loc at
        # init_unconstrained()) - and hence the whole warped geometry -
        # in the MAP's basin of this multimodal posterior (docs/data.md)
        import time as _time

        from lqg_tpu.infer.svi import optimize

        t0 = _time.perf_counter()
        map_params, losses = optimize(prob_model, steps=args.map_steps,
                                      step_size=0.05)
        prob_model.init = {k: jnp.asarray(v)
                           for k, v in map_params.items()}
        print(f"[map] {args.map_steps} Adam steps in "
              f"{_time.perf_counter() - t0:.1f}s, potential "
              f"{float(losses[-1]):.1f}; init at MAP:", flush=True)
        print("      " + ", ".join(f"{k}={float(v):.4g}"
                                   for k, v in map_params.items()),
              flush=True)

    if args.neutra != "none":
        import time as _time

        from lqg_tpu.infer.utils import neutra_reparam

        t0 = _time.perf_counter()
        if args.neutra == "laplace":
            from lqg_tpu.infer.svi import laplace_guide

            guide, eigs = laplace_guide(prob_model)
            import numpy as np

            print(f"[neutra] laplace guide (exact MAP Hessian) in "
                  f"{_time.perf_counter() - t0:.1f}s; eigenvalue range "
                  f"[{float(eigs[0]):.3g}, {float(eigs[-1]):.3g}] "
                  f"(condition {float(eigs[-1] / eigs[0]):.1f}); "
                  "posterior sds "
                  + np.array2string(np.sqrt(np.diag(np.asarray(
                      guide.scale_tril @ guide.scale_tril.T))),
                      precision=4), flush=True)
        else:
            if args.neutra == "mvn":
                from lqg_tpu.infer.svi import fit_auto_mvn as fit_guide
            else:
                from lqg_tpu.infer.flows import fit_auto_iaf as fit_guide
            guide, losses = fit_guide(prob_model,
                                      random.PRNGKey(args.seed + 1),
                                      steps=args.neutra_steps)
            print(f"[neutra] {args.neutra} guide fit: {args.neutra_steps} "
                  f"SVI steps in {_time.perf_counter() - t0:.1f}s, final "
                  f"ELBO {-float(losses[-1]):.1f}", flush=True)
        prob_model = neutra_reparam(prob_model, guide)

        if args.init == "map":
            # short polish in the WARPED space: the guide's mean need not
            # sit exactly on the mode, so re-center the chains' eps init
            from lqg_tpu.infer.svi import optimize

            t0 = _time.perf_counter()
            _, losses, eps_map = optimize(
                prob_model, steps=max(200, args.map_steps // 3),
                step_size=0.02, return_unconstrained=True)
            prob_model.init_eps = eps_map
            print(f"[map/neutra] warped-space polish in "
                  f"{_time.perf_counter() - t0:.1f}s, potential "
                  f"{float(losses[-1]):.1f}, |eps_map| = "
                  f"{float(jnp.linalg.norm(eps_map)):.3f}", flush=True)

    mass_kwargs = {}
    if args.precondition:
        import numpy as np

        from lqg_tpu.results import load_netcdf

        prev = load_netcdf(args.precondition)
        for name in prob_model.names:
            # the stack below folds (chains, draws) into one draw axis per
            # SCALAR site; a vector-valued site would silently fold its
            # parameter dims into the draw axis and corrupt the dense mass
            if np.asarray(prev[name]).ndim > 2:
                raise ValueError(
                    f"--precondition supports scalar sites only; "
                    f"{name!r} has shape {np.asarray(prev[name]).shape} "
                    f"(chains, draws, *param_dims)")
        U = np.stack([
            np.asarray(prob_model.transforms[name].inverse(jnp.asarray(
                np.asarray(prev[name], dtype=np.float64).reshape(-1))))
            for name in prob_model.names])            # (zdim, draws)
        cov = np.cov(U)
        cov = cov + 1e-8 * np.eye(cov.shape[0])
        L = np.linalg.cholesky(0.5 * (cov + cov.T))
        mass_kwargs = dict(init_inv_mass=jnp.asarray(L, jnp.float32),
                           adapt_mass=False)
        print(f"[precondition] fixed dense mass from {args.precondition} "
              f"({U.shape[1]} draws); sqrt diag cov: "
              + np.array2string(np.sqrt(np.diag(cov)), precision=4),
              flush=True)

    mcmc = MCMC(prob_model, num_warmup=args.nburnin,
                num_samples=args.nsamp, num_chains=args.nchain,
                max_depth=args.max_depth, progress=True,
                init_jitter=args.init_jitter,
                max_leapfrogs_per_launch=args.max_leapfrogs,
                **mass_kwargs)
    mcmc.run(random.PRNGKey(args.seed), checkpoint_path=args.checkpoint)
    mcmc.print_summary()

    out_path = os.path.join(args.out, f"{args.model}-{args.seed}.nc")
    save_netcdf(out_path, mcmc.get_samples(group_by_chain=True),
                attrs=dict(model=args.model, seed=args.seed,
                           shared_params=",".join(shared)))
    print(f"saved {out_path}")
