r"""Distributed dense linear algebra over a device mesh.

XLA has no sharded Cholesky: factorising a sharded SPD matrix all-gathers
it onto every device, so a dense factor is limited by ONE device's
memory. This module implements a right-looking
blocked Cholesky inside ``shard_map``: the matrix lives as row-blocks
sharded over the mesh axis and never exists whole on any device.

Per block-column j (a ``lax.fori_loop`` iteration — the program is traced
ONCE, so compile time is flat in the number of blocks):

1. the current row-block j is broadcast (a one-hot ``psum`` — only the
   owner contributes);
2. every device factorises the tiny diagonal tile (replicated compute)
   and triangular-solves ITS OWN row tiles of the panel column;
3. the panel column is broadcast the same way and every device applies
   the trailing rank-nb update to its rows (one local matmul).

Total communication is 2 n^2 elements spread over B steps — the same
volume as one all-gather of the matrix, but the peak per-device memory
is n^2 / n_devices + O(n * nb). The rolled loop applies the trailing
update at full row width under a column mask (static shapes), which
costs 2x the triangular-loop FLOPs; the factorisation is
bandwidth/latency-bound at these block sizes, and the 2x buys O(1)
compile time (the unrolled version compiled linearly in n_blocks).
With stationary kernels prefer ``ops.sphere`` (no factor at all); this
is the path for NON-stationary covariances too big for one chip.

A forward triangular solve with the same layout
(``sharded_triangular_solve``) applies the factor without gathering it,
completing the factor-once / solve-and-draw-many pipeline at pod scale.
"""

import jax
from jax import shard_map
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax.sharding import NamedSharding, PartitionSpec as P


def _resolve_blocks(n: int, n_dev: int, n_blocks: int | None) -> int:
    if n_blocks is None:
        n_blocks = max(n_dev, min(32, n // 128 if n >= 128 else n_dev))
        n_blocks = max(n_dev, (n_blocks // n_dev) * n_dev)
    if n % n_blocks != 0 or n_blocks % n_dev != 0:
        raise ValueError(
            f"n={n} must divide into n_blocks={n_blocks} divisible by the "
            f"axis size {n_dev}"
        )
    return n_blocks


def resolve_blocks_padded(
    n: int, n_dev: int, n_blocks: int | None
) -> tuple[int, int]:
    """(n_blocks, n_padded) for an ARBITRARY n: the single source of the
    block-count heuristic for callers that can pad (e.g. the ensemble
    step pads the covariance with an identity tail). n_padded is the
    smallest multiple of the chosen block count >= n."""
    if n_blocks is None:
        n_blocks = max(n_dev, min(32, n // 128 if n >= 128 else n_dev))
        n_blocks = max(n_dev, (n_blocks // n_dev) * n_dev)
    n_pad = -(-n // n_blocks) * n_blocks
    return _resolve_blocks(n_pad, n_dev, n_blocks), n_pad


def make_sharded_cholesky(mesh, n: int, n_blocks: int, axis: str = "grid"):
    """shard_map-wrapped blocked Cholesky, composable inside a jit.

    Returns ``chol(A_blocks)`` mapping row-blocks (n_blocks, nb, n)
    sharded P(axis) to L row-blocks with the same sharding (strict upper
    triangle zeroed).
    """
    n_dev = mesh.shape[axis]
    nb = n // n_blocks
    blocks_per_dev = n_blocks // n_dev

    def local_chol(a_local):
        # a_local: (blocks_per_dev, nb, n) — this device's row blocks
        me = jax.lax.axis_index(axis)
        my_block_ids = me * blocks_per_dev + jnp.arange(blocks_per_dev)
        col_ids = jnp.arange(n)

        def body(j, a):
            own_j = (j // blocks_per_dev) == me
            j_local = j % blocks_per_dev
            # broadcast current row-block j (one-hot psum)
            mine = jax.lax.dynamic_index_in_dim(
                a, j_local, axis=0, keepdims=False
            )
            contrib = jnp.where(own_j, mine, jnp.zeros_like(mine))
            row_j = jax.lax.psum(contrib, axis)  # (nb, n)

            d = jax.lax.dynamic_slice(row_j, (0, j * nb), (nb, nb))
            L_jj = jnp.linalg.cholesky(d)

            # finalise row j on its owner: columns < j*nb keep previous
            # L, diagonal tile becomes L_jj, right of diagonal zeroed.
            diag_embed = jax.lax.dynamic_update_slice(
                jnp.zeros((nb, n), a.dtype), L_jj, (0, j * nb)
            )
            row_final = (
                jnp.where((col_ids < j * nb)[None, :], row_j, 0.0)
                + diag_embed
            )
            a = jax.lax.dynamic_update_index_in_dim(
                a, jnp.where(own_j, row_final, mine), j_local, axis=0
            )

            # each device solves its own panel tiles L_ij (i > j):
            # L_ij = A_ij L_jj^{-T}
            tiles = jax.lax.dynamic_slice(
                a, (0, 0, j * nb), (blocks_per_dev, nb, nb)
            )
            solved = jax.vmap(
                lambda t: jsl.solve_triangular(L_jj, t.T, lower=True).T
            )(tiles)
            is_below = (my_block_ids > j)[:, None, None]
            new_tiles = jnp.where(is_below, solved, tiles)
            a = jax.lax.dynamic_update_slice(a, new_tiles, (0, 0, j * nb))

            # broadcast the full panel column (n, nb): each device
            # contributes its below-j tiles at its global row offset
            panel_contrib = jnp.where(
                is_below, new_tiles, jnp.zeros_like(new_tiles)
            ).reshape(blocks_per_dev * nb, nb)
            start = me * blocks_per_dev * nb
            panel_full = jax.lax.dynamic_update_slice(
                jnp.zeros((n, nb), a.dtype),
                panel_contrib,
                (start, jnp.zeros((), start.dtype)),
            )
            panel_full = jax.lax.psum(panel_full, axis)  # (n, nb)

            # trailing update on my rows i > j over columns >= (j+1)*nb
            # (full width under a mask — static shapes for the rolled
            # loop; masked entries contribute zero)
            trail = jnp.where(
                (col_ids >= (j + 1) * nb)[:, None], panel_full, 0.0
            )  # (n, nb); rows here index output columns
            update = jnp.einsum(
                "bik,mk->bim",
                jnp.where(is_below, new_tiles, 0.0),
                trail,
            )
            return a - update

        return jax.lax.fori_loop(0, n_blocks, body, a_local)

    return shard_map(
        local_chol, mesh=mesh, in_specs=P(axis), out_specs=P(axis)
    )


def sharded_cholesky(mesh, A, n_blocks: int | None = None, axis: str = "grid"):
    """Lower Cholesky factor of a row-sharded SPD matrix.

    `A` is (n, n) with rows shardable over the mesh `axis` (n divisible
    by n_blocks, n_blocks divisible by the axis size). Returns L (lower
    triangular, same sharding). The strict upper triangle of the result
    is zeroed.
    """
    n = A.shape[0]
    n_blocks = _resolve_blocks(n, mesh.shape[axis], n_blocks)
    nb = n // n_blocks

    A_blocks = jax.device_put(
        jnp.asarray(A).reshape(n_blocks, nb, n), NamedSharding(mesh, P(axis))
    )
    mapped = make_sharded_cholesky(mesh, n, n_blocks, axis)
    L_blocks = jax.jit(mapped)(A_blocks)
    L = L_blocks.reshape(n, n)
    # strict upper triangle already zeroed per-row at finalisation
    return jax.device_put(L, NamedSharding(mesh, P(axis, None)))


def make_sharded_triangular_solve(
    mesh, n: int, n_rhs: int, n_blocks: int, axis: str = "grid"
):
    """shard_map-wrapped forward substitution, composable inside a jit.

    Returns ``solve(L_blocks, B)`` with L row-blocks (n_blocks, nb, n)
    sharded P(axis) and B (n, n_rhs) replicated, solving L X = B without
    ever gathering L. X is returned replicated (every device needs the
    full solution as it builds). The block recurrence is sequential;
    each step is one (nb, n) x (n, n_rhs) local matmul plus a one-hot
    psum of the nb solved rows.
    """
    n_dev = mesh.shape[axis]
    nb = n // n_blocks
    blocks_per_dev = n_blocks // n_dev

    def local_solve(L_local, B):
        me = jax.lax.axis_index(axis)
        col_ids = jnp.arange(n)

        def body(j, X):
            own_j = (j // blocks_per_dev) == me
            j_local = j % blocks_per_dev
            row = jax.lax.dynamic_index_in_dim(
                L_local, j_local, axis=0, keepdims=False
            )  # (nb, n) — garbage on non-owners, masked out below
            # b_j - L[j, :j*nb] @ X[:j*nb]  (full width under a mask)
            partial = row @ jnp.where((col_ids < j * nb)[:, None], X, 0.0)
            b_j = jax.lax.dynamic_slice(B, (j * nb, 0), (nb, n_rhs))
            L_jj = jax.lax.dynamic_slice(row, (0, j * nb), (nb, nb))
            x_j = jsl.solve_triangular(L_jj, b_j - partial, lower=True)
            x_j = jax.lax.psum(
                jnp.where(own_j, x_j, jnp.zeros_like(x_j)), axis
            )
            return jax.lax.dynamic_update_slice(X, x_j, (j * nb, 0))

        X0 = jnp.zeros((n, n_rhs), B.dtype)
        return jax.lax.fori_loop(0, n_blocks, body, X0)

    return shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=P(),
    )


def sharded_triangular_solve(
    mesh, L, B, n_blocks: int | None = None, axis: str = "grid"
):
    """Solve L X = B (L lower-triangular, row-sharded; B replicated).

    The distributed companion to :func:`sharded_cholesky`: applies the
    factor (whitening, kriging-system solves) while L stays sharded as
    P(axis, None). Returns X (n, n_rhs) replicated.
    """
    n = L.shape[0]
    B = jnp.asarray(B)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    n_blocks = _resolve_blocks(n, mesh.shape[axis], n_blocks)
    nb = n // n_blocks

    L_blocks = jax.device_put(
        jnp.asarray(L).reshape(n_blocks, nb, n), NamedSharding(mesh, P(axis))
    )
    B = jax.device_put(B, NamedSharding(mesh, P()))
    mapped = make_sharded_triangular_solve(
        mesh, n, int(B.shape[1]), n_blocks, axis
    )
    X = jax.jit(mapped)(L_blocks, B)
    return X[:, 0] if squeeze else X


_LOG_2PI = 1.8378770664093453


def sharded_whiten(mesh, L, X, n_blocks: int | None = None,
                   axis: str = "grid"):
    """Whiten fields against a sharded factor: z = L^{-1} X.

    THE production consumer of :func:`sharded_triangular_solve`: with a
    non-stationary covariance C = L L' too big for one chip (factored
    once by :func:`sharded_cholesky`), whitening turns correlated
    fields/residuals into iid N(0, 1) coordinates — standardised
    residual QC, de-correlation before per-cell statistics, and the
    quadratic form of every Gaussian score. X may be (n,) or (n, b);
    the factor never leaves its row-sharded layout.
    """
    return sharded_triangular_solve(mesh, L, X, n_blocks, axis)


def sharded_mvn_logpdf(mesh, L, x, mean=None, n_blocks: int | None = None,
                       axis: str = "grid"):
    r"""log N(x; mean, L L') from the sharded factor, never gathering it.

    .. math::
        \log p = -\tfrac12 \|L^{-1}(x-\mu)\|^2 - \sum_i \log L_{ii}
                 - \tfrac{n}{2}\log 2\pi

    The model-selection / cross-validation score for fitted covariances
    at pod scale (e.g. scoring a month of observed anomalies under
    competing ellipse parameter fields): one sharded forward solve plus
    the factor's log-diagonal. `x` may be (n,) for one field or (n, b)
    for a batch of fields scored under the same factor (the
    factor-once / solve-many idiom); returns a scalar or (b,) scores.
    (Capability beyond the reference, which computes dense Gaussian
    scores only through scipy on one host.)
    """
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if mean is not None:
        x = x - jnp.asarray(mean).reshape(-1, 1)
    n = x.shape[0]
    z = sharded_triangular_solve(mesh, L, x, n_blocks, axis)
    quad = jnp.sum(z * z, axis=0)
    logdet = jnp.sum(jnp.log(jnp.diagonal(jnp.asarray(L))))
    out = -0.5 * quad - logdet - 0.5 * n * _LOG_2PI
    return out[0] if squeeze else out
