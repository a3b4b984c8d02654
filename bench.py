"""Gains throughput on one GPU: Riccati backward + Kalman forward solves/s.

One "solve" is the Riccati backward pass (control gains L) plus the Kalman
covariance forward pass (gains K) for one bounded-actor tracking model at
horizon T=1000 (reference ``lqg/control/lqr.py`` + ``lqg/belief/kf.py``);
each call solves a batch of 16384 parameter sets.  The solve runs the fused
gains kernel (``lqg_tpu.ops.pallas.gains``, Pallas' Triton route), repeated
REPS times inside one jitted scan whose carry perturbs the inputs, so host
dispatch is excluded and every repetition executes.

    python bench.py

Prints the device and the card's power limit, then one JSON line.  Exits
non-zero when JAX finds no GPU: this measures the card, never the CPU.
"""

import json
import subprocess
import sys
import time

T = 1000
BATCH = 16384
REPS = 20
N_TIMED = 7


def build_batched_spec(batch):
    """Batch of bounded-actor specs with varying parameters."""
    import jax
    import jax.numpy as jnp
    from lqg_tpu.models.basic import tracking_spec

    action_cost = jnp.logspace(-2, 1, batch)
    action_var = jnp.linspace(0.1, 1.0, batch)
    sigma_target = jnp.linspace(2.0, 40.0, batch)
    sigma_cursor = jnp.linspace(0.5, 10.0, batch)

    def one(c, av, st, sc):
        return tracking_spec(dim=1, process_noise=1.0, action_variability=av,
                             sigma_target=st, sigma_cursor=sc,
                             action_cost=c, dt=1.0 / 60.0)

    spec = jax.vmap(one)(action_cost, action_var, sigma_target, sigma_cursor)
    return jax.tree.map(lambda a: a.astype(jnp.float32), spec)


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from lqg_tpu.config import use_compile_cache
    from lqg_tpu.ops.linalg import mT
    from lqg_tpu.ops.pallas.gains import fused_gains

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX backend is {dev.platform!r})")
    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"device: {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {card.strip()}", flush=True)

    spec = build_batched_spec(BATCH)
    Sigma0 = spec.V @ mT(spec.V)

    @jax.jit
    def solve_many(spec, Sigma0):
        def body(carry, _):
            s = spec._replace(R=spec.R + carry * 1e-20)
            L, H, K = fused_gains(s, Sigma0, horizon=T)
            return jnp.sum(L[-1]) + jnp.sum(H[-1]) + jnp.sum(K[-1]), None

        acc, _ = lax.scan(body, jnp.float32(0.0), None, length=REPS)
        return acc

    float(solve_many(spec, Sigma0))   # compile + warm
    rates = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        float(solve_many(spec, Sigma0))
        rates.append(BATCH * REPS / (time.perf_counter() - t0))
    rates.sort()
    median = rates[N_TIMED // 2]
    print(json.dumps({
        "metric": "lqg_gains_solves_per_s_T1000",
        "value": median,
        "unit": "solves/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "power_limit": card.strip(),
        "n_reps": N_TIMED,
        "min": rates[0],
        "max": rates[-1],
    }))


if __name__ == "__main__":
    main()
