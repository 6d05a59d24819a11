"""Tracing and timing utilities (aux subsystem; reference analogue:
the bench harness's wall-time logger and cargo's profiling profile —
SURVEY.md §5. The device-side story here is jax.profiler).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator, Optional

log = logging.getLogger("pollen_tpu")


@contextlib.contextmanager
def stopwatch(label: str) -> Iterator[None]:
    """Log wall time for a host-side block."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info("%s: %.3f s", label, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


def time_jitted(fn, *args, reps: int = 3, warmup: int = 1) -> float:
    """Best wall time of a jitted call, synchronized on the result with
    ``jax.block_until_ready`` (dispatch is asynchronous)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
