r"""Multi-chip kernel-functional kriging via shard_map.

The streamed column-block solver (``models.kernel_kriging``) is
embarrassingly parallel over grid columns: the observation system
K = C_obs + E is tiny and replicated; each device builds C_cross tiles
for ITS slice of the output grid straight from the kernel, solves them
against its own copy of the Cholesky factor, and reduces its slice of
the diagonals. There is no cross-device communication after the initial
broadcast, so scaling over devices is linear in the grid axis.
"""

import jax
from jax import shard_map
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax.sharding import NamedSharding, PartitionSpec as P


def sharded_kriging_from_kernel(
    mesh,
    kernel_fn,
    grid_lats,
    grid_lons,
    idx,
    obs,
    error_cov,
    variance: float = 1.0,
    axis: str = "grid",
):
    """Ordinary kriging with grid columns sharded over a mesh axis.

    `grid_lats`/`grid_lons` (degrees, length M divisible by the axis
    size) are split across devices; every device receives the replicated
    obs system and computes its local field / uncertainty^2 /
    constraint-mask slice. Returns arrays sharded over `axis`.
    """
    la = jnp.radians(jnp.asarray(grid_lats))
    lo = jnp.radians(jnp.asarray(grid_lons))
    idx = jnp.asarray(idx)
    y = jnp.asarray(obs, la.dtype)
    E = jnp.asarray(error_cov, la.dtype)
    var = jnp.asarray(variance, la.dtype)

    la_o = la[idx]
    lo_o = lo[idx]

    def local(la_blk, lo_blk, la_o, lo_o, y, E, var):
        # One triangular solve with B RHS per device (replicated factor,
        # replicated n-vector solves): same restructure as the
        # single-chip streamed path (models.kernel_kriging).
        K = kernel_fn(la_o, lo_o, la_o, lo_o) + E
        L = jnp.linalg.cholesky(K)
        factor = (L, True)
        ones = jnp.ones((idx.shape[0],), la_blk.dtype)
        u = jsl.cho_solve(factor, ones)
        w = jsl.cho_solve(factor, y)
        s = jnp.sum(u)
        uy = u @ y
        Cc = kernel_fn(la_o, lo_o, la_blk, lo_blk)
        # Linv matmul instead of the tall triangular solve — same
        # restructure + precision argument as the single-chip path
        Linv = jsl.solve_triangular(
            L, jnp.eye(L.shape[0], dtype=L.dtype), lower=True
        )
        U = jnp.matmul(Linv, Cc, precision=jax.lax.Precision.HIGHEST)
        sv = jnp.einsum("nb,nb->b", U, U)
        hi = jax.lax.Precision.HIGHEST
        t = jnp.matmul(u, Cc, precision=hi)
        lam = (t - 1.0) / s
        field = jnp.matmul(w, Cc, precision=hi) - lam * uy
        wc = sv - lam * t
        uncert2 = var - (wc + lam) - lam
        cmask = sv / var
        return field, uncert2, cmask

    mapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis)),
    )

    sharded = NamedSharding(mesh, P(axis))
    la_s = jax.device_put(la, sharded)
    lo_s = jax.device_put(lo, sharded)
    return jax.jit(mapped)(la_s, lo_s, la_o, lo_o, y, E, var)
