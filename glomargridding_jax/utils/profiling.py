"""Tracing / profiling helpers.

The reference's observability is ad-hoc wall-clock prints and byte
pretty-printing (``ellipse/covariance.py:110-145``, ``utils.py:738``).
Here: a stage timer that blocks on device work (so timings cover the
work under async dispatch), a ``jax.profiler`` trace context for
TensorBoard traces, and device-memory budget estimation before
materialising large matrices.
"""

import logging
import time
from contextlib import contextmanager

import jax
import numpy as np

from .arrays import sizeof_fmt

logger = logging.getLogger(__name__)


@contextmanager
def stage_timer(name: str, result_holder: dict | None = None):
    """Time a pipeline stage, blocking on any jax arrays registered via
    ``holder['out'] = arrays`` before stopping the clock.

    >>> with stage_timer("solve") as h:
    ...     h["out"] = kriging_step(...)
    """
    holder: dict = {}
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        if "out" in holder:
            jax.block_until_ready(holder["out"])
        dt = time.perf_counter() - t0
        logger.info("[%s] %.3fs", name, dt)
        if result_holder is not None:
            result_holder[name] = dt


@contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def hbm_estimate(*shapes_dtypes) -> int:
    """Total bytes for a set of (shape, dtype) pairs.

    Use before materialising covariance matrices:
    ``hbm_estimate(((65000, 65000), jnp.float32))`` -> ~16.9 GB.
    """
    total = 0
    for shape, dtype in shapes_dtypes:
        total += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return total


def hbm_budget_check(
    *shapes_dtypes, limit_bytes: int | None = None, label: str = ""
) -> bool:
    """Log (and return) whether the given allocations fit the HBM budget.

    Without an explicit limit, uses the addressable device's memory stats
    when available, else a 16 GB default.
    """
    need = hbm_estimate(*shapes_dtypes)
    if limit_bytes is None:
        limit_bytes = 16 * 1024**3
        try:
            stats = jax.devices()[0].memory_stats()
            if stats and "bytes_limit" in stats:
                limit_bytes = int(stats["bytes_limit"])
        except Exception:  # pragma: no cover - backend-specific
            pass
    fits = need <= limit_bytes
    logger.log(
        logging.INFO if fits else logging.WARNING,
        "%s needs %s of %s HBM (%s)",
        label or "allocation",
        sizeof_fmt(need),
        sizeof_fmt(limit_bytes),
        "ok" if fits else "DOES NOT FIT",
    )
    return fits
