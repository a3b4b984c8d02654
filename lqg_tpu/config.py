"""Precision policy, compile cache and numerical debugging utilities.

SURVEY.md section 5.6: the reference leaves precision implicit (f32
everywhere except a stale global x64 switch in ``lqg/optim.py:9-11``).  Here
precision is an explicit policy:

* matmul precision on the likelihood/potential path is pinned to
  ``"highest"`` (full-f32 products): a GPU may otherwise run f32 matmuls
  in TF32 (~3 decimal digits), which compounds to percent-level gain error
  over T=1000 Riccati steps;
* ``enable_x64`` is an opt-in context, not an import side effect;
* NaN debugging and conditioning checks are first-class helpers.
"""

from __future__ import annotations

import contextlib
import os

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def enable_x64(enable: bool = True):
    """Temporarily toggle float64 (for tight oracle comparisons)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enable)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def use_compile_cache() -> str:
    """Keep JAX's persistent compile cache where runs can find it again.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that directory
    and nothing else is set; otherwise the cache goes to ``.jax_cache/`` at
    the root of the checkout (a fixed path: the path is part of the cache
    key).  Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise on the first NaN produced inside the context."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_finite(tree, name: str = "value"):
    """Host-side finiteness check over a pytree (for tests/debug)."""
    import numpy as np

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)}: {bad} non-finite "
                f"entries (shape {arr.shape})")


def condition_number(M: jnp.ndarray) -> jnp.ndarray:
    """Spectral condition number of (batched) symmetric matrices."""
    evals = jnp.linalg.eigvalsh(M)
    return jnp.abs(evals[..., -1]) / jnp.maximum(jnp.abs(evals[..., 0]),
                                                 jnp.finfo(M.dtype).tiny)


def check_spec_conditioning(spec, warn_threshold: float = 1e6):
    """Diagnose an LQGSpec's noise/cost conditioning (host-side).

    Returns a dict of condition numbers; prints warnings above threshold.
    The reference hand-rolls two such guards (``lqr.py:27-28`` eigenvalue
    clamp, ``point_mass.py:130-144`` make_psd); this surfaces the issue
    instead of silently clamping.
    """
    import numpy as np

    out = {}
    mT = lambda x: jnp.swapaxes(x, -1, -2)
    for name, mat in (("VV^T", spec.V @ mT(spec.V)),
                      ("WW^T", spec.W @ mT(spec.W)),
                      ("R", spec.R)):
        if mat.shape[-1] == 0:
            continue
        c = float(np.asarray(condition_number(mat)).max())
        out[name] = c
        if c > warn_threshold:
            print(f"lqg_tpu: warning: {name} condition number {c:.2e} "
                  f"exceeds {warn_threshold:.0e}; expect unstable "
                  f"recursions in float32")
    return out
