"""Compensated (Kahan/Neumaier) summation for f32 likelihood reductions.

Why this exists: the marginalized likelihood sums ~1.2e5 per-observation
terms to a total of O(3e5) nats.  In float32 the ULP at that magnitude is
~0.03 nats and the accumulated reduction error is ~0.1-0.3 nats - measured
directly at the data.mat flagship fit (scripts/profiling/laplace_probe.py).
That noise floor, not posterior geometry, is what pinned NUTS step sizes and
saturated tree depths in every parametrization tried (dense mass, empirical
preconditioning, IAF NeuTra, exact-Hessian Laplace): HMC's accept test
compares potential differences to O(0.1) precision, so step-size adaptation
drives steps down to the noise floor and trajectories random-walk.

The fix here keeps every FLOP in f32 and compensates at the reduction
boundaries instead: chunked pairwise partial sums followed by a Neumaier
scan keep the effective accumulation precision near float64.  Combined with
a constant baseline shift of the returned value (HMC only uses
differences), the potential's noise floor drops from ~0.3 to ~1e-3 nats.
Whether a float64 potential is cheaper on the GPU, which runs f64
natively, has not been measured.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def kahan_sum(x: jnp.ndarray, axis: int = 0, chunk: int = 16) -> jnp.ndarray:
    """Sum ``x`` along ``axis`` with Neumaier-compensated accumulation.

    Elements are first reduced in chunks of ``chunk`` (pairwise, at small
    magnitude where f32 rounding is negligible), then the chunk partials are
    folded sequentially with a running compensation term that recovers the
    low-order bits each add discards.  Error is ~per-element rounding instead
    of growing with the partial-sum magnitude; for the flagship likelihood
    that is a >100x noise reduction at <1% of the reduction's cost.
    """
    x = jnp.moveaxis(jnp.asarray(x), axis, 0)
    n = x.shape[0]
    pad = (-n) % chunk
    if pad:
        x = jnp.concatenate(
            [x, jnp.zeros((pad,) + x.shape[1:], dtype=x.dtype)], axis=0)
    parts = x.reshape((-1, chunk) + x.shape[1:]).sum(axis=1)

    def step(carry, p):
        s, c = carry
        t = s + p
        # Neumaier: recover the bits lost by whichever operand was smaller
        c = c + jnp.where(jnp.abs(s) >= jnp.abs(p),
                          (s - t) + p, (p - t) + s)
        return (t, c), None

    # zeros_like keeps the summands' varying mesh axes (under shard_map the
    # carry must vary like the partials it accumulates)
    zero = jnp.zeros_like(parts[0])
    (s, c), _ = lax.scan(step, (zero, zero), parts)
    return s + c
