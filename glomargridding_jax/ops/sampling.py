r"""Matrix-free Gaussian sampling: Chebyshev square-root matvecs.

``models.stochastic`` draws simulated states as :math:`L z` with a dense
Cholesky factor — the right tool to ~30k states on one chip. At the
1-degree production scale (M ~ 65k) a dense f32 factor alone is ~17 GB.
This module samples :math:`y \sim N(0, C)` WITHOUT any
factorisation, using a Chebyshev polynomial approximation of
:math:`C^{1/2}`:

.. math::
    y = p_d(C)\, z \approx C^{1/2} z, \qquad z \sim N(0, I),

where :math:`p_d` is the degree-d Chebyshev expansion of sqrt on the
spectral interval [lam_min, lam_max]. Each term costs one matvec
:math:`C v` — a bandwidth-bound matmul batched over all ensemble
members at once. The operator can be:

- a dense device matrix (bf16 storage halves the memory: 65k^2 = 8.4 GB;
  accumulation stays f32), or
- a *kernel-streamed* matvec (``kernel_matvec``) that rebuilds covariance
  tiles from the kernel per block — zero covariance storage, best when
  the kernel is cheap or memory is the binding constraint.

Spectral-interval guidance (IMPORTANT): lam_max must bound the MATRIX
spectrum, which for a densely-sampled smooth kernel scales with the
number of correlated neighbours (hundreds of times the sill for a
1-degree global grid), NOT with the sill — always measure it with
``estimate_spectral_range``. A nugget term C = C_smooth + nugget*I gives
the exact floor lam_min = nugget. The sqrt expansion converges like
:math:`\exp(-2 d \sqrt{a/b})`: pick degree ~ 4 sqrt(lam_max/lam_min)
for ~3e-4 relative accuracy. Values of x OUTSIDE [lam_min, lam_max]
make the polynomial diverge (NaN members) — bounds must be honest.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.cache import BoundedCache


class Matvec:
    """A matvec as (static fn, array operands) instead of a closure.

    Calling it is ``fn(*operands, v)``. The split matters under jit: a
    plain closure traced inside a jitted function turns its captured
    device arrays into program CONSTANTS — each one costs a device->host
    pull at lowering, and a 65k bf16 store embedded as an 8.4 GB literal
    exhausts device memory. Consumers
    (``chebyshev_apply``, ``estimate_spectral_range``) detect this type
    and pass ``operands`` through as ordinary jit arguments.
    """

    def __init__(self, fn, *operands):
        self.fn = fn
        self.operands = operands

    def __call__(self, v):
        return self.fn(*self.operands, v)


def _split_matvec(matvec):
    """(static_fn, operands) for a Matvec; passthrough for closures."""
    if isinstance(matvec, Matvec):
        return matvec.fn, matvec.operands
    return matvec, ()


def chebyshev_sqrt_coeffs(
    lam_min: float, lam_max: float, degree: int
) -> np.ndarray:
    """Chebyshev expansion coefficients of sqrt on [lam_min, lam_max]."""
    if lam_min <= 0:
        raise ValueError("lam_min must be > 0 (add a nugget/jitter floor)")
    n = degree + 1
    k = np.arange(n)
    nodes = np.cos(np.pi * (k + 0.5) / n)  # Chebyshev nodes in [-1, 1]
    x = 0.5 * (lam_max - lam_min) * nodes + 0.5 * (lam_max + lam_min)
    fvals = np.sqrt(x)
    j = k[:, None]
    coeffs = (2.0 / n) * np.cos(j * np.pi * (k[None, :] + 0.5) / n) @ fvals
    coeffs[0] *= 0.5
    return coeffs


def chebyshev_apply(matvec, z, coeffs, lam_min, lam_max):
    """p(C) z via the Chebyshev recurrence; one matvec per degree.

    `matvec` is a ``Matvec`` (preferred — its operands become jit
    arguments) or a plain traceable closure v -> C v operating on (M, k)
    matrices; `coeffs` from ``chebyshev_sqrt_coeffs`` (or any
    function's expansion).
    """
    fn, operands = _split_matvec(matvec)
    return _chebyshev_apply(fn, operands, z, coeffs, lam_min, lam_max)


@partial(jax.jit, static_argnames=("fn",))
def _chebyshev_apply(fn, operands, z, coeffs, lam_min, lam_max):
    alpha = 2.0 / (lam_max - lam_min)
    beta = -(lam_max + lam_min) / (lam_max - lam_min)

    def a_tilde(v):
        return alpha * fn(*operands, v) + beta * v

    t0 = z
    t1 = a_tilde(z)
    y0 = coeffs[0] * t0 + coeffs[1] * t1

    def body(carry, c):
        t_prev, t_cur, y = carry
        t_next = 2.0 * a_tilde(t_cur) - t_prev
        return (t_cur, t_next, y + c * t_next), None

    (_, _, y), _ = jax.lax.scan(body, (t0, t1, y0), coeffs[2:])
    return y


@partial(jax.jit, static_argnames=("compute_dtype",), inline=True)
def _dense_mv(cov, v, *, compute_dtype=jnp.float32):
    return jnp.matmul(
        cov, v.astype(cov.dtype), preferred_element_type=compute_dtype
    ).astype(v.dtype)


def dense_matvec(cov, compute_dtype=jnp.float32):
    """Matvec over a dense (possibly bf16-stored) covariance.

    Returns a ``Matvec`` so the matrix travels as a jit ARGUMENT when
    consumers trace it (never a captured constant). The matmul
    accumulates in `compute_dtype` regardless of storage
    (``preferred_element_type``), so bf16 storage costs ~3 decimal
    digits on the matrix entries but not on the accumulation.
    """
    fn = _DENSE_MV_BY_DTYPE.setdefault(
        jnp.dtype(compute_dtype).name,
        partial(_dense_mv, compute_dtype=compute_dtype),
    )
    return Matvec(fn, cov)


_DENSE_MV_BY_DTYPE: dict = {}


def _kernel_mv(kernel_fn, m, la_b, lo_b, lats_rad, lons_rad, v):
    def per_block(_, inputs):
        la_blk, lo_blk = inputs
        tile = kernel_fn(la_blk, lo_blk, lats_rad, lons_rad)
        return None, tile @ v

    _, out = jax.lax.scan(per_block, None, (la_b, lo_b))
    return out.reshape(out.shape[0] * out.shape[1], *out.shape[2:])[:m]


def kernel_matvec(kernel_fn, lats_rad, lons_rad, n_blocks: int = 16):
    """Streamed matvec: covariance tiles rebuilt from the kernel per block.

    y_block = kernel(block, :) @ v — no covariance storage at all. Cost
    is one full kernel evaluation per matvec; prefer ``dense_matvec``
    with bf16 storage when the matrix fits. `kernel_fn` should be a
    stable (value-hashable or module-level) function: it becomes part
    of the consumers' jit cache key.
    """
    m = lats_rad.shape[0]
    # block size rounded to a multiple of 256: unaligned scan-stacked
    # outputs once triggered a pathological compile path (re-measuring
    # the rule on the GPU is open)
    block = -(-m // n_blocks)
    block = -(-block // 256) * 256
    n_blocks = -(-m // block)
    pad = n_blocks * block - m
    la = jnp.concatenate([lats_rad, jnp.zeros((pad,), lats_rad.dtype)])
    lo = jnp.concatenate([lons_rad, jnp.zeros((pad,), lons_rad.dtype)])
    la_b = la.reshape(n_blocks, block)
    lo_b = lo.reshape(n_blocks, block)
    # Memoised per (kernel_fn, m): ``partial`` hashes by identity, so a
    # fresh wrapper per call would retrace every consumer that jits
    # with the fn static (chebyshev_apply, estimate_spectral_range) on
    # each operator re-creation — the same reason _DENSE_MV_BY_DTYPE
    # exists for the dense path.
    fn = _KERNEL_MV_BY_KEY.setdefault(
        (kernel_fn, m), partial(_kernel_mv, kernel_fn, m)
    )
    return Matvec(fn, la_b, lo_b, lats_rad, lons_rad)


# bounded: kernel_fn is often a per-call closure, so unbounded
# growth would pin every closure's captured operands for the
# process lifetime (the memo still de-dupes the hot recent keys)
_KERNEL_MV_BY_KEY = BoundedCache(32)


def estimate_spectral_range(
    matvec, n: int, key, iters: int = 30, dtype=jnp.float32
):
    """(lam_min_floor, lam_max_bound) of an SPD operator by power iteration.

    lam_max is a tight upper estimate (power iteration * 1.05 margin);
    lam_min is NOT resolved by power iteration — a floor of
    1e-3 * lam_max is returned, which callers should max() with their
    known nugget.
    """

    fn, operands = _split_matvec(matvec)

    @partial(jax.jit, static_argnames=("fn", "iters"))
    def power(fn, operands, key, iters):
        v = jax.random.normal(key, (n, 1), dtype)
        v = v / jnp.linalg.norm(v)

        def body(v, _):
            w = fn(*operands, v)
            lam = jnp.linalg.norm(w)
            return w / lam, lam

        _, lams = jax.lax.scan(body, v, None, length=iters)
        return lams[-1]

    lam_max = float(power(fn, operands, key, iters)) * 1.05
    return 1e-3 * lam_max, lam_max


def sample_mvn_chebyshev(
    key,
    matvec,
    n: int,
    n_members: int,
    lam_min: float,
    lam_max: float,
    degree: int = 100,
    dtype=jnp.float32,
):
    """n_members draws of N(0, C) through the Chebyshev sqrt of a matvec.

    Returns (n_members, n). All members share every matvec (one batched
    matmul per polynomial degree) — the factor-free analog of the
    factor-once/draw-many Cholesky idiom.
    """
    coeffs = jnp.asarray(
        chebyshev_sqrt_coeffs(lam_min, lam_max, degree), dtype
    )
    z = jax.random.normal(key, (n, n_members), dtype)
    y = chebyshev_apply(
        matvec,
        z,
        coeffs,
        jnp.asarray(lam_min, dtype),
        jnp.asarray(lam_max, dtype),
    )
    return y.T
