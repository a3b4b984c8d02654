"""Each hand-written kernel against what XLA makes of the plain scan, on the GPU.

Times, at the shapes that decide whether a kernel stays:

* the 4-chain leapfrog value+grad of the reference's hierarchical data fit
  (BoundedActor, 6 conditions x 20 trials x T=1008, the shape of
  ``chip_smoke.py``), with each kernel family switched on and off:
  ``scan`` (no kernel), ``kernels`` (gains + likelihood kernels with
  their analytic adjoints), ``ll_kernel`` (likelihood kernel, scan gains),
  ``gains_kernel`` (gains kernel, scan likelihood), and
  ``gains_scan_vjp`` (both kernels, but the gains gradient from
  differentiating the scan twin instead of the adjoint kernel);
* the likelihood value+grad alone at joint dims j = 5, 8, 10 (the dim=1
  and dim=2 models), with the kernel's compile time: it unrolls ~j^3
  operations per step;
* the gains alone at B=16384, T=1000 (``bench.py``'s shape): the kernel at
  several lane blocks and warp counts against the batched scan;
* the gains value+grad at the zoo's larger in-scope actor sizes (n=3, 4);
* the likelihood value+grad alone at the data-fit shape for several
  trials-per-program blocks.

    python scripts/profiling/kernels_vs_scan.py [--check] [--reps 10] \
        [--cell gains gains_dims joint_dim ll_block w2]

``--check`` compiles every variant once, compares it with the scan and
stops.  Exits non-zero without a GPU.  Prints one line per measurement
and a JSON summary as the last line.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def timed(fn, *args, reps):
    """Median and spread of ``reps`` calls (after one warm call), in ms."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": float(np.median(ts)), "min_ms": float(min(ts)),
            "max_ms": float(max(ts))}


def leapfrog_variants(model, z, names):
    """{name: compiled value+grad over chains} with dispatch set per name."""
    import jax
    import lqg_tpu.ops.pallas.gains as pg
    import lqg_tpu.ops.pallas.likelihood as pll
    import lqg_tpu.system as sysm

    def gains_scan_vjp():
        @functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
        def g(spec, S0, horizon, interpret=False):
            return pg._gains_fwd_cv(horizon, interpret)(spec, S0)

        def fwd(spec, S0, horizon, interpret):
            return g(spec, S0, horizon, interpret), (spec, S0)

        def bwd(horizon, interpret, res, ct):
            _, vjp = jax.vjp(lambda s, S: pg._scan_gains(s, S, horizon),
                             *res)
            return vjp(ct)

        g.defvjp(fwd, bwd)
        return g

    patches = {
        "scan": [(sysm, "_FORCE_SCAN", True)],
        "kernels": [],
        "ll_kernel": [(sysm.System, "_fused_ok", lambda self: False)],
        "gains_kernel": [(pll, "fused_ll_available", lambda *a: False)],
        "gains_scan_vjp": [(pg, "gains_fused", gains_scan_vjp())],
    }
    out = {}
    for name in names:
        plist = patches[name]
        fn = jax.jit(jax.vmap(jax.value_and_grad(model.potential)))
        saved = [(o, a, getattr(o, a)) for o, a, _ in plist]
        try:
            for o, a, v in plist:
                setattr(o, a, v)
            t0 = time.perf_counter()
            compiled = fn.lower(z).compile()
            compile_s = time.perf_counter() - t0
        finally:
            for o, a, v in saved:
                setattr(o, a, v)
        out[name] = (compiled, compile_s)
        print(f"compiled {name} in {compile_s:.1f} s", flush=True)
    return out


def compare(vg, ref):
    import numpy as np

    (v, g), (v0, g0) = vg, ref
    v, g, v0, g0 = (np.asarray(a, np.float64) for a in (v, g, v0, g0))
    return (float(np.max(np.abs(v - v0))),
            float(np.max(np.abs(g - g0)) / np.max(np.abs(g0))))


def leapfrog_cell(name, model, z, reps, check, results,
                  variants=("scan", "kernels", "ll_kernel", "gains_kernel",
                            "gains_scan_vjp")):
    variants = leapfrog_variants(model, z, variants)
    ref = variants["scan"][0](z)
    for vname, (fn, compile_s) in variants.items():
        v_err, g_err = compare(fn(z), ref)
        row = {"compile_s": compile_s, "value_abs_err": v_err,
               "grad_rel_err": g_err}
        if vname == "kernels":
            row["memory_analysis"] = str(fn.memory_analysis())
        results[f"{name}/{vname}"] = row
    if not check:
        for _ in range(3):                    # interleaved rounds
            for vname, (fn, _) in variants.items():
                r = timed(fn, z, reps=reps)
                row = results[f"{name}/{vname}"]
                row.setdefault("rounds_ms", []).append(r["median_ms"])
    for vname in variants:
        print(f"{name}/{vname}: {json.dumps(results[f'{name}/{vname}'])}",
              flush=True)


def gains_cell(reps, check, results):
    import jax
    from bench import build_batched_spec
    from lqg_tpu.ops.linalg import mT
    from lqg_tpu.ops.pallas.gains import fused_gains, _scan_gains

    B, T = 16384, 1000
    spec = build_batched_spec(B)
    S0 = spec.V @ mT(spec.V)
    scan = jax.jit(_scan_gains, static_argnums=2)
    ref = scan(spec, S0, T)
    configs = [(32, 1)] if check else [(32, 1), (64, 1), (64, 2), (128, 1),
                                       (128, 2), (128, 4)]
    for lanes, warps in configs:
        fn = jax.jit(functools.partial(fused_gains, horizon=T, lanes=lanes,
                                       num_warps=warps))
        out = fn(spec, S0)
        err = max(float(abs(a - b).max() / abs(b).max())
                  for a, b in zip(out, ref))
        row = {"rel_err": err}
        if not check:
            row.update(timed(fn, spec, S0, reps=reps))
        results[f"gains_B{B}/lanes{lanes}_warps{warps}"] = row
        print(f"gains_B{B}/lanes{lanes}_warps{warps}: {json.dumps(row)}",
              flush=True)
    if not check:
        row = timed(lambda s, S: scan(s, S, T), spec, S0, reps=reps)
        results[f"gains_B{B}/scan"] = row
        print(f"gains_B{B}/scan: {json.dumps(row)}", flush=True)


def likelihood_block_cell(data, reps, results):
    """Likelihood value+grad alone at the data-fit shape (24 parameter sets
    = 4 chains x 6 conditions, 20 trials), per trials-per-program block."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu.ops import gaussian
    from lqg_tpu.ops.linalg import mT
    from lqg_tpu.ops.pallas.likelihood import _ll_fwd_call, _ll_bwd_call
    from lqg_tpu.models import BoundedActor
    import chip_smoke as cs

    m = BoundedActor(T=cs.T, **cs.TRUTH)
    g, K = m.gains(method="scan")
    joint = gaussian.joint_system(m.dynamics, m.actor, g.L, K, cs.T)
    P = 4 * len(cs.SIGMA_TARGETS)
    F = jnp.broadcast_to(joint.F, (P,) + joint.F.shape)
    Q = jnp.broadcast_to(joint.G @ mT(joint.G), F.shape)
    X = jnp.broadcast_to(data[0], (P,) + data[0].shape)
    for trials in (16, 32):
        @jax.jit
        def vg(F, Q, X, trials=trials):
            ll, stores = _ll_fwd_call(F, Q, X, trials=trials)
            return ll, _ll_bwd_call(F, stores, jnp.ones_like(ll),
                                    trials=trials)

        row = timed(vg, F, Q, X, reps=reps)
        results[f"ll_alone/trials{trials}"] = row
        print(f"ll_alone/trials{trials}: {json.dumps(row)}", flush=True)


def joint_dim_cell(reps, check, results):
    """The likelihood alone (value + grad w.r.t. F, Q, as NUTS consumes it)
    at joint dims j = 5 (SubjectiveActor), 8 (BoundedActor dim=2) and 10
    (SubjectiveActor dim=2), kernel against scan, at the data-fit batch
    (24 parameter sets x 20 trials x T=1008).  The kernel unrolls ~j^3
    operations per step, so its compile time is reported too."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import chip_smoke as cs
    from lqg_tpu.ops import gaussian
    from lqg_tpu.ops.pallas.likelihood import conditioned_log_likelihood_fused

    P, n, T = 4 * len(cs.SIGMA_TARGETS), cs.N_TRIALS, cs.T
    rng = np.random.default_rng(0)
    for j, d in ((5, 2), (8, 4), (10, 4)):
        F = jnp.asarray(np.broadcast_to(
            0.95 * np.eye(j) + 0.01 * rng.standard_normal((j, j)),
            (P, T, j, j)), jnp.float32)
        G = jnp.broadcast_to(0.3 * jnp.eye(j), (P, T, j, j))
        Q = G @ jnp.swapaxes(G, -1, -2)
        X = jnp.asarray(rng.standard_normal((P, n, T + 1, d)), jnp.float32)

        def kernel_loss(F, Q):
            return conditioned_log_likelihood_fused(F, Q, X).sum()

        def scan_loss(F, G):
            def one(F, G, x):
                k = gaussian.conditional_kernel(gaussian.JointSystem(F, G), d)
                return gaussian.trial_log_likelihood(k, x).sum()
            return jax.vmap(one)(F, G, X).sum()

        row = {}
        for name, fn, args in (("kernel", kernel_loss, (F, Q)),
                               ("scan", scan_loss, (F, G))):
            t0 = time.perf_counter()
            c = jax.jit(jax.value_and_grad(fn)).lower(*args).compile()
            row[f"{name}_compile_s"] = time.perf_counter() - t0
            row[f"{name}_value"] = float(c(*args)[0])
            if not check:
                row[f"{name}_ms"] = timed(c, *args, reps=reps)["median_ms"]
            print(f"j{j}/{name}: {json.dumps(row)}", flush=True)
        results[f"ll_value_grad_j{j}"] = row


def gains_dims_cell(reps, check, results):
    """Gains value+grad (kernel and adjoint kernel against the scan) for the
    zoo's in-scope actor sizes at the NUTS batch (24 = 4 chains x 6
    conditions, T=1008): n=3 (SubjectiveActor) and n=4
    (PointMassBoundedActor), with compile times."""
    import jax
    import jax.numpy as jnp
    import chip_smoke as cs
    from lqg_tpu.models import SubjectiveActor, PointMassBoundedActor
    from lqg_tpu.ops.linalg import mT
    from lqg_tpu.ops.pallas.gains import gains_fused, _scan_gains

    for model in (SubjectiveActor(T=cs.T), PointMassBoundedActor(T=cs.T)):
        n = model.actor.A.shape[-1]
        spec = jax.tree.map(lambda a: jnp.stack([a] * 24), model.actor)
        S0 = spec.V @ mT(spec.V)

        def loss(spec, fn):
            L, H, K = fn(spec, S0, cs.T)
            return jnp.sum(L ** 2) + jnp.sum(K ** 2)

        row = {}
        for name, fn in (("kernel", gains_fused), ("scan", _scan_gains)):
            t0 = time.perf_counter()
            c = jax.jit(jax.value_and_grad(lambda s: loss(s, fn))) \
                .lower(spec).compile()
            row[f"{name}_compile_s"] = time.perf_counter() - t0
            row[f"{name}_value"] = float(c(spec)[0])
            if not check:
                row[f"{name}_ms"] = timed(c, spec, reps=reps)["median_ms"]
            print(f"gains_n{n}/{name}: {json.dumps(row)}", flush=True)
        results[f"gains_value_grad_n{n}"] = row


CELLS = ("gains", "gains_dims", "joint_dim", "ll_block", "w2")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cell", choices=CELLS, nargs="*", default=list(CELLS))
    args = ap.parse_args()

    import jax
    from lqg_tpu.config import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kernels_vs_scan: no GPU (JAX backend is {dev.platform!r})")
    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {dev.device_kind}; nvidia-smi: {card}", flush=True)

    import chip_smoke as cs

    results = {"device": dev.device_kind, "card": card}
    data = cs.simulate_data(0)
    if "w2" in args.cell:
        model = cs.data_fit_model(data)
        leapfrog_cell("w2_bounded", model, cs.chain_points(model), args.reps,
                      args.check, results)
    if "gains" in args.cell:
        gains_cell(args.reps, args.check, results)
    if "ll_block" in args.cell:
        likelihood_block_cell(data, args.reps, results)
    if "gains_dims" in args.cell:
        gains_dims_cell(args.reps, args.check, results)
    if "joint_dim" in args.cell:
        joint_dim_cell(args.reps, args.check, results)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
