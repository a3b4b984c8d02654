"""Profiling and structured timing of solves.

SURVEY.md sections 5.1/5.5: the reference has no tracing/metrics subsystem
(only ``%timeit`` pedagogy cells in its tutorial notebook); here profiler
traces and wall-clock timing of the hot solves are first-class.  Use
:func:`trace` to capture an XLA/device profile viewable in TensorBoard or
Perfetto, and :func:`timeit` for dispatch-excluded steady-state timing of
jitted callables.  ``scripts/microbench.py`` drives these across every
kernel variant.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable

import jax


@contextlib.contextmanager
def trace(log_dir: str = "lqg_trace"):
    """Capture a ``jax.profiler`` trace of the enclosed block.

    View with TensorBoard (``tensorboard --logdir <dir>``) or upload the
    ``.trace.json.gz`` to Perfetto.  On the GPU this includes per-kernel
    device timing - the ground truth for where the time goes.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def _block(out):
    return jax.tree_util.tree_map(
        lambda a: a.block_until_ready() if hasattr(a, "block_until_ready")
        else a, out)


@dataclass
class Timing:
    """Steady-state timing of one callable."""

    name: str
    mean_s: float
    min_s: float
    iters: int

    @property
    def per_s(self) -> float:
        return 1.0 / self.mean_s if self.mean_s > 0 else float("inf")

    def __str__(self) -> str:
        return (f"{self.name:<40s} {self.mean_s * 1e3:10.3f} ms/call "
                f"(min {self.min_s * 1e3:.3f} ms, {self.iters} iters)")


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2,
           name: str | None = None, **kwargs) -> Timing:
    """Time a jitted callable: warm up (compile), then ``iters`` timed calls
    with ``block_until_ready`` so device execution is included and host
    dispatch pipelining is not misread as speed."""
    for _ in range(warmup):
        _block(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return Timing(name=name or getattr(fn, "__name__", "fn"),
                  mean_s=sum(times) / len(times), min_s=min(times),
                  iters=iters)
