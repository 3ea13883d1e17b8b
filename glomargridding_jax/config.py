"""Global numeric configuration.

float32 compute everywhere by default, with an opt-in to float64 for CPU
parity testing of ill-conditioned solves. The reference mixes f64
(kriging) and f32 (ellipse covariance); here every kernel is
dtype-polymorphic and follows the input dtype, with this module
providing the default for newly created arrays.
"""

import os
from contextlib import contextmanager

import jax.numpy as jnp

_DEFAULT_DTYPE = jnp.float32


def default_dtype():
    """Default floating dtype for newly created device arrays."""
    return _DEFAULT_DTYPE


def set_default_dtype(dtype) -> None:
    """Set the default floating dtype (e.g. jnp.float32 or jnp.float64)."""
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = jnp.dtype(dtype)


@contextmanager
def default_dtype_ctx(dtype):
    """Temporarily override the default floating dtype."""
    global _DEFAULT_DTYPE
    prev = _DEFAULT_DTYPE
    _DEFAULT_DTYPE = jnp.dtype(dtype)
    try:
        yield
    finally:
        _DEFAULT_DTYPE = prev


# fixed in-checkout location: the path is part of the cache key, so a
# directory that moves between runs never hits
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache for this process.

    Production gridding is a monthly-rerun workload whose big programs
    (spherical-harmonic synthesis, 65k covariance assembly, the MLE
    chunk pipeline) are byte-identical run to run, so the persistent
    cache turns every rerun's compile into a disk read. Call once,
    before the first jit dispatch. When ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX's own setting is left alone; otherwise the cache goes
    to ``.jax_cache`` in the checkout. Returns the directory in use.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, even sub-second ones
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
