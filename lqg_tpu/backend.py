"""Backend dispatch policy: where the hand-written kernels run.

One question, answered in one place: does the current JAX backend have a
compiled route for the Pallas kernels in :mod:`lqg_tpu.ops.pallas`?

* ``gpu``: yes - the kernels compile through Pallas' Triton route.
* ``cpu``: no - every path runs the XLA scans.  (Tests still reach the
  kernels there, in the Pallas interpreter, by passing ``interpret=True``
  to the kernel entry points; the library never chooses that itself.)
* anything else: an error, not a silent fallback.
"""

from __future__ import annotations

import jax


def kernel_route() -> bool:
    """True when the default backend compiles the Pallas kernels."""
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise RuntimeError(
        f"no dispatch policy for JAX backend {backend!r}: lqg_tpu runs on "
        f"'gpu' (compiled kernels) or 'cpu' (XLA scans)")


def require_kernel_route(what: str) -> None:
    """Raise unless the default backend compiles the Pallas kernels."""
    if not kernel_route():
        raise ValueError(
            f"{what} needs a compiled kernel route, and the "
            f"{jax.default_backend()!r} backend has none; use method='scan' "
            f"or 'auto' (the kernel entry points take interpret=True for "
            f"tests)")
