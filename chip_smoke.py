"""Smoke run of the inverse-optimal-control path on the GPU.

Drives simulate -> marginalized likelihood and gradient -> MLE -> NUTS
through the public entry points, at the shape of the reference's
hierarchical data fit (``cpp_data_fit.py``): BoundedActor, 6 conditions x
20 trials x T = 1008 steps (1009 samples) x d = 2, shared parameters
``action_variability``, ``action_cost``, ``sigma_cursor`` and one
``sigma_target`` per condition, 4 chains.  ``data.mat`` is not in the
repository, so the experiment is simulated at data scale from ``--seed``
(as ``scripts/recover_at_scale.py`` does).  Every kernel on the path runs
compiled for the card and is compared with the XLA scan; the scan is
compared with the NumPy float64 oracle (``tests/oracle.py``) on one
condition.

    python chip_smoke.py              # one GPU: every phase
    python chip_smoke.py --chips 4    # four GPUs: sharded chains and the
                                      # dp = 4 likelihood, against one card

Any failed check raises, so the process exits non-zero; so does a run
where JAX finds no GPU.  The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

T = 1008                     # steps per trial (1009 samples)
N_TRIALS = 20
SIGMA_TARGETS = [8.6, 10.5, 12.6, 21.4, 29.1, 49.9]   # one per condition
TRUTH = dict(action_cost=0.0012, action_variability=0.42, sigma_cursor=30.0)
SHARED = ["action_variability", "action_cost", "sigma_cursor"]
N_CHAINS = 4

# tolerances: kernel against the XLA scan (both float32 on the card)
VALUE_RTOL, VALUE_ATOL = 2e-4, 5e-3
GRAD_RTOL = 5e-3             # max |g - g_scan| / max |g_scan|
# float32 scan on the card against the float64 oracle, per trial.  The
# per-trial log likelihood is a compensated sum of ~1e3 terms of O(1)
# nats; the float32 recursion itself carries ~1e-6 relative rounding per
# step, so 1e-4 relative leaves one order of magnitude above what the CPU
# float32 scan shows at this shape (about 1e-5).
ORACLE_RTOL = 1e-4
GAINS_RTOL = 1e-4            # max |gain - scan| / max |scan gain|


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def card_names():
    """The cards' name and power limit, read by nvidia-smi (a child process
    that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def simulate_data(seed):
    """(6, 20, 1009, 2) trajectories of the data-fit experiment."""
    import jax.numpy as jnp
    from jax import random
    from lqg_tpu.models import BoundedActor

    key = random.PRNGKey(seed)
    conds = [BoundedActor(T=T, sigma_target=st, **TRUTH).simulate(
                 random.fold_in(key, c), n=N_TRIALS)[..., :2]
             for c, st in enumerate(SIGMA_TARGETS)]
    return jnp.stack(conds)


def data_fit_model(data):
    from lqg_tpu.models import BoundedActor
    from lqg_tpu.infer.models import shared_params_lqg_model

    return shared_params_lqg_model(data, BoundedActor, shared_params=SHARED)


def chain_points(model, n_chains=N_CHAINS):
    """Distinct unconstrained points around the prior median, one per
    chain."""
    import jax.numpy as jnp

    u0 = model.init_unconstrained()
    offs = jnp.linspace(-0.1, 0.1, n_chains)[:, None]
    return u0[None] + offs * jnp.cos(jnp.arange(u0.shape[0]))[None]


def potential_value_and_grad(model, scan):
    """Jitted value+grad of the potential vmapped over chains; ``scan``
    traces it with every kernel replaced by the XLA scan."""
    import jax
    from lqg_tpu.system import force_scan_dispatch

    fn = jax.jit(jax.vmap(jax.value_and_grad(model.potential)))
    if not scan:
        return fn

    def traced_on_scan(z):
        with force_scan_dispatch():
            return fn(z)

    return traced_on_scan


def oracle_log_likelihood(x, sigma_target):
    """Per-trial float64 log likelihoods of one condition (tests/oracle.py)."""
    import numpy as np
    from lqg_tpu.models import BoundedActor

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    spec = BoundedActor(T=T, sigma_target=sigma_target, **TRUTH).actor
    st = lambda M: np.broadcast_to(np.asarray(M, np.float64),
                                   (T,) + np.shape(M))
    A, B, F, V, W = (st(spec.A), st(spec.B), st(spec.F), st(spec.V),
                     st(spec.W))
    Q, R = st(spec.Q), st(spec.R)
    zeros = lambda *s: np.zeros((T,) + s)
    n, m = A.shape[-1], B.shape[-1]
    L, _ = oracle.lqr_backward(Q, zeros(n), np.asarray(spec.Qf, np.float64),
                               np.zeros(n), zeros(m, n), R, zeros(m), A, B)
    K = oracle.kf_forward(A, F, V, W, V[0] @ V[0].T)
    Fj, Gj = oracle.joint_system(A, B, F, V, W, A, B, F, L, K)
    return np.array([oracle.log_likelihood(Fj, Gj, np.asarray(xi, np.float64))
                     for xi in x])


def phase_likelihood(data):
    import jax
    import numpy as np
    from lqg_tpu.models import BoundedActor
    from lqg_tpu.system import force_scan_dispatch

    model = data_fit_model(data)
    u = chain_points(model, 1)[0]
    sts = jax.numpy.asarray(SIGMA_TARGETS)

    def per_trial(st, x):
        return BoundedActor(T=T, sigma_target=st, **TRUTH).log_likelihood(x)

    ll_auto = jax.jit(jax.vmap(per_trial))(sts, data)
    with force_scan_dispatch():
        ll_scan = jax.jit(jax.vmap(lambda s, x: per_trial(s, x)))(sts, data)
    require(ll_auto.shape == (len(SIGMA_TARGETS), N_TRIALS),
            f"per-trial shape {ll_auto.shape}")
    require(np.isfinite(np.asarray(ll_auto)).all(), "per-trial ll finite")
    err = np.abs(np.asarray(ll_auto, np.float64) - np.asarray(ll_scan))
    bound = VALUE_ATOL + VALUE_RTOL * np.abs(np.asarray(ll_scan))
    log("likelihood", f"per-trial auto vs scan: max abs err "
        f"{err.max():.3e}, max rel err "
        f"{(err / np.abs(np.asarray(ll_scan))).max():.3e} "
        f"(tol rtol {VALUE_RTOL} + atol {VALUE_ATOL})")
    require((err <= bound).all(), "per-trial auto vs scan")

    v_a, g_a = jax.jit(jax.value_and_grad(model.potential))(u)
    with force_scan_dispatch():
        v_s, g_s = jax.jit(jax.value_and_grad(
            lambda z: model.potential(z)))(u)
    g_err = rel_err(g_a, g_s)
    v_err = abs(float(v_a) - float(v_s))
    log("likelihood", f"potential auto vs scan: value abs err {v_err:.3e} "
        f"(of {float(v_s):.6e}; tol rtol {VALUE_RTOL} + atol "
        f"{VALUE_ATOL}), grad max rel err {g_err:.3e} (tol {GRAD_RTOL})")
    require(v_err <= VALUE_ATOL + VALUE_RTOL * abs(float(v_s)),
            "potential value auto vs scan")
    require(g_err <= GRAD_RTOL, "potential gradient auto vs scan")

    ll_o = oracle_log_likelihood(np.asarray(data[0]), SIGMA_TARGETS[0])
    o_err = np.abs(np.asarray(ll_scan[0], np.float64) - ll_o)
    o_rel = float((o_err / np.abs(ll_o)).max())
    log("likelihood", f"scan (card, f32) vs f64 oracle, condition 0: max "
        f"abs err {o_err.max():.3e}, max rel err {o_rel:.3e} "
        f"(tol rtol {ORACLE_RTOL})")
    require(o_rel <= ORACLE_RTOL, "scan vs f64 oracle")
    return model


def phase_kernels(model):
    import jax
    import numpy as np
    from lqg_tpu.backend import kernel_route
    from lqg_tpu.ops.linalg import mT
    from lqg_tpu.ops.pallas.gains import fused_gains, _scan_gains
    from bench import build_batched_spec

    require(kernel_route(), "the backend compiles the Pallas kernels")
    z = chain_points(model)
    leapfrog = potential_value_and_grad(model, scan=False)
    t0 = time.perf_counter()
    compiled = leapfrog.lower(z).compile()
    log("kernels", f"leapfrog value+grad ({N_CHAINS} chains) compiled in "
        f"{time.perf_counter() - t0:.1f} s; memory_analysis: "
        f"{compiled.memory_analysis()}")
    v_k, g_k = compiled(z)
    v_s, g_s = potential_value_and_grad(model, scan=True)(z)
    v_err = np.abs(np.asarray(v_k, np.float64) - np.asarray(v_s))
    g_err = rel_err(g_k, g_s)
    log("kernels", f"leapfrog kernels vs scan: value max abs err "
        f"{v_err.max():.3e}, grad max rel err {g_err:.3e}")
    require(np.isfinite(np.asarray(g_k)).all(), "leapfrog grads finite")
    require((v_err <= VALUE_ATOL + VALUE_RTOL * np.abs(np.asarray(v_s)))
            .all(), "leapfrog value vs scan")
    require(g_err <= GRAD_RTOL, "leapfrog gradient vs scan")

    B, Tg = 16384, 1000
    spec = build_batched_spec(B)
    S0 = spec.V @ mT(spec.V)
    L, H, K = fused_gains(spec, S0, Tg)
    L_s, H_s, K_s = jax.jit(_scan_gains, static_argnums=2)(spec, S0, Tg)
    errs = [rel_err(a, b) for a, b in ((L, L_s), (H, H_s), (K, K_s))]
    log("kernels", f"gains B={B} T={Tg} kernel vs scan: max rel err "
        f"L {errs[0]:.3e}, H {errs[1]:.3e}, K {errs[2]:.3e} "
        f"(tol {GAINS_RTOL})")
    require(all(np.isfinite(np.asarray(a)).all() for a in (L, H, K)),
            "gains finite")
    require(max(errs) <= GAINS_RTOL, "gains kernel vs scan")


def phase_mle(model):
    import numpy as np
    from lqg_tpu.infer.svi import optimize

    _, losses = optimize(model, steps=30, step_size=0.05)
    losses = np.asarray(losses)
    log("mle", f"30 Adam steps: loss {losses[0]:.6e} -> {losses[-1]:.6e}")
    require(np.isfinite(losses).all(), "MLE losses finite")
    require(losses[-1] < losses[0], "MLE loss decreases")


def phase_nuts(model, seed):
    import numpy as np
    from jax import random
    from lqg_tpu.infer.mcmc import MCMC

    mcmc = MCMC(model, num_warmup=10, num_samples=10, num_chains=N_CHAINS,
                max_depth=6)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(seed + 1))
    draws = mcmc.get_samples(group_by_chain=True)
    log("nuts", f"{N_CHAINS} chains x (10 warmup + 10 draws), max_depth 6, "
        f"in {time.perf_counter() - t0:.1f} s (compile included)")
    mcmc.print_summary()
    require(all(np.isfinite(np.asarray(v)).all() for v in draws.values()),
            "NUTS draws finite")
    require(all(np.asarray(v).shape == (N_CHAINS, 10)
                for v in draws.values()), "NUTS draw shapes")


def phase_four_cards(data, seed):
    """Sharded chains and the dp = 4 likelihood against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import random
    from lqg_tpu.infer.mcmc import MCMC
    from lqg_tpu.models import BoundedActor
    from lqg_tpu.parallel import make_mesh
    from lqg_tpu.parallel.sharding import (sharded_chains_run,
                                           sharded_log_likelihood)

    model = data_fit_model(data)
    kw = dict(num_warmup=3, num_samples=3, num_chains=4, max_depth=3)
    one = MCMC(model, **kw).run(random.PRNGKey(seed + 1))
    mesh = make_mesh([("chains", 4)])
    four = MCMC(model, **kw)
    sharded_chains_run(four, random.PRNGKey(seed + 1), mesh)
    devices = {s.device for s in four._samples_u.addressable_shards}
    d1 = np.asarray(one._samples_u)
    d4 = np.asarray(four._samples_u)
    err = float(np.abs(d1 - d4).max())
    # each card computes its chain with the same per-chain arithmetic as
    # the one-card run, but XLA may pick other library kernels for a batch
    # of 1 than of 4, so bits can differ; NUTS amplifies such differences
    # only through its discrete tree decisions, which a 6-transition run at
    # depth 3 rarely flips
    log("chips4", f"sharded chains on {len(devices)} cards vs one card: "
        f"max abs draw diff {err:.3e} (tol 1e-3)")
    require(len(devices) == 4, "chains spread over 4 cards")
    require(err <= 1e-3, "sharded chains match one card")

    x = data[0]
    ll_fn = sharded_log_likelihood(
        lambda p: BoundedActor(T=T, **TRUTH, **p), x,
        make_mesh([("dp", 4)]))
    params = dict(sigma_target=jnp.asarray(SIGMA_TARGETS[0]))
    total4 = float(ll_fn(params))
    total1 = float(jnp.sum(jax.jit(
        lambda xx: BoundedActor(T=T, sigma_target=SIGMA_TARGETS[0],
                                **TRUTH).log_likelihood(xx))(x)))
    rel = abs(total4 - total1) / abs(total1)
    # same per-trial arithmetic; only the order of the cross-trial sum
    # differs (5 + psum against 20 on one card)
    log("chips4", f"dp=4 likelihood {total4:.6e} vs one card "
        f"{total1:.6e}: rel err {rel:.3e} (tol 1e-5)")
    require(rel <= 1e-5, "dp=4 likelihood matches one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    import jax
    from lqg_tpu.config import use_compile_cache

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX backend is {dev.platform!r})")
    if len(devices) < args.chips:
        sys.exit(f"chip_smoke: --chips {args.chips} needs {args.chips} "
                 f"GPUs, JAX sees {len(devices)}")
    cache = use_compile_cache()
    log("device", f"{devices}; device_kind {dev.device_kind!r}; "
        f"compile cache {cache}")
    log("device", f"nvidia-smi name, power.limit: {card_names()}")

    t0 = time.perf_counter()
    data = simulate_data(args.seed)
    import numpy as np
    require(data.shape == (len(SIGMA_TARGETS), N_TRIALS, T + 1, 2),
            f"data shape {data.shape}")
    require(np.isfinite(np.asarray(data)).all(), "simulated data finite")
    log("simulate", f"data {data.shape} finite, "
        f"{time.perf_counter() - t0:.1f} s")

    if args.chips == 4:
        phase_four_cards(data, args.seed)
    else:
        model = phase_likelihood(data)
        phase_kernels(model)
        phase_mle(model)
        phase_nuts(model, args.seed)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
