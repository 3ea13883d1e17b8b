"""Fused banded narrow matvec of the ellipse stream operator (Pallas, Triton).

``y = C_ns @ x`` for an ``x`` of at most ``X_COLS`` columns, without
ever writing a covariance tile to device memory. One program owns one
``BLOCK``-row slice of ``y``: it loads its row parameters once, walks
its band of column blocks ``[first[i], last[i]]`` in a loop, builds
each (BLOCK x BLOCK) tile of pair values in registers
(``covariance.pair_values``, the same algebra as the XLA tile) and
contracts it with the matching rows of ``x``; the accumulator is
written once. Programs share nothing, so the grid runs in any order.

The band comes from the stream operator's latitude-gap certificates at
``BLOCK`` granularity; tiles inside the band but past the cutoff are
zeroed by the pair algebra itself, so the result equals the dense
masked product.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 64
X_COLS = 16  # pl.dot needs every dimension of its right operand >= 16


def _kernel(
    first_ref, last_ref, la_ref, lo_ref, s00_ref, s01_ref, s11_ref,
    sd_ref, sg_ref, x_ref, y_ref, *, kparams,
):
    from .covariance import pair_values  # covariance imports this module

    v, delta_x_method, max_dist, use_max_dist = kparams
    params = (la_ref, lo_ref, s00_ref, s01_ref, s11_ref, sd_ref, sg_ref)
    i = pl.program_id(0)
    zero = jnp.zeros((), i.dtype)  # one index dtype for every slice
    row_sl = pl.ds(i * BLOCK, BLOCK)
    row = tuple(plgpu.load(r.at[row_sl])[:, None] for r in params)

    def body(j, acc):
        col_sl = pl.ds(j * BLOCK, BLOCK)
        col = tuple(plgpu.load(r.at[col_sl])[None, :] for r in params)
        tile = pair_values(
            row, col, v, delta_x_method, max_dist, use_max_dist
        )
        xb = plgpu.load(x_ref.at[col_sl, pl.ds(zero, X_COLS)])
        # f32 FMA contraction: TF32 would cost ~1e-3 relative against
        # the f32-exact XLA stream
        return acc + pl.dot(tile, xb, precision=jax.lax.Precision.HIGHEST)

    acc = jax.lax.fori_loop(
        plgpu.load(first_ref.at[i]),
        plgpu.load(last_ref.at[i]) + 1,
        body,
        jnp.zeros((BLOCK, X_COLS), jnp.float32),
    )
    plgpu.store(y_ref.at[row_sl, pl.ds(zero, X_COLS)], acc)


@partial(jax.jit, static_argnames=("kparams", "interpret"))
def ellipse_matvec(cols, x, first, last, *, kparams, interpret=False):
    """``C_ns @ x`` without the diagonal, through the Triton kernel.

    ``cols`` are the seven per-point parameter vectors (lat, lon, s00,
    s01, s11, sqrt det, stdev), padded to a ``BLOCK`` multiple;
    ``x`` is (n_pad, w <= X_COLS) with zero padding rows; ``first`` /
    ``last`` are the int32 per-row-block column-block band limits.
    ``kparams`` = (v, delta_x_method, max_dist, use_max_dist), static.
    Compiles for the GPU only; ``interpret=True`` runs the Pallas
    interpreter (tests on the CPU).
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Triton matvec kernel compiles for the GPU only; pass "
            f"interpret=True on {jax.default_backend()!r}"
        )
    n_pad, w = x.shape
    if n_pad % BLOCK or w > X_COLS:
        raise ValueError(
            f"x must be (multiple of {BLOCK}, <= {X_COLS}), got {x.shape}"
        )
    n_blocks = n_pad // BLOCK
    if first.shape != (n_blocks,) or last.shape != (n_blocks,):
        # the kernel reads first[i], last[i] for every row block i;
        # on the GPU an index past the end reads garbage bounds
        raise ValueError(
            f"first/last must have shape ({n_blocks},), got "
            f"{first.shape} and {last.shape}"
        )
    xp = jnp.pad(x.astype(jnp.float32), ((0, 0), (0, X_COLS - w)))
    y = pl.pallas_call(
        partial(_kernel, kparams=kparams),
        out_shape=jax.ShapeDtypeStruct((n_pad, X_COLS), jnp.float32),
        grid=(n_pad // BLOCK,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="ellipse_stream_matvec",
    )(
        jnp.asarray(first, jnp.int32), jnp.asarray(last, jnp.int32),
        *(c.astype(jnp.float32) for c in cols), xp,
    )
    return y[:, :w]
