r"""Sharded non-stationary (ellipse) covariance assembly.

A 1-degree non-stationary covariance is ~17 GB in f32.
Row-blocks of the Paciorek-Schervish matrix are embarrassingly parallel:
every device holds the full (small) parameter vectors and assembles ONLY
its slice of rows, so the matrix exists only as a row-sharded array.
Composed with ``parallel.linalg.sharded_cholesky`` and row-sharded
``L @ z`` draws this gives the full non-stationary ensemble pipeline at
pod scale (stationary kernels should prefer the exact spectral sampler
in ``ops.sphere``, which needs no matrix at all).
"""

import jax
from jax import shard_map
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.ellipse.covariance import ellipse_covariance_block
from ..ops.distances import sigma_rot_flat
from ..types import DeltaXMethod


def sharded_ellipse_covariance(
    mesh,
    Lx,
    Ly,
    theta,
    stdev,
    lats_deg,
    lons_deg,
    v: float,
    delta_x_method: DeltaXMethod = "Modified_Met_Office",
    max_dist: float | None = None,
    axis: str = "grid",
):
    """Row-sharded N x N Paciorek-Schervish covariance over the mesh.

    Inputs are the per-point (already compressed/unmasked) parameter and
    coordinate vectors, N divisible by the mesh axis size. Returns the
    covariance (diag(stdev^2) included) sharded as P(axis, None).
    """
    n = len(lats_deg)
    n_dev = mesh.shape[axis]
    if n % n_dev != 0:
        raise ValueError(f"N={n} must be divisible by axis size {n_dev}")

    la = jnp.radians(jnp.asarray(lats_deg))
    lo = jnp.radians(jnp.asarray(lons_deg))
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)
    )
    sig_flat = jnp.stack([s00, s01, s11], axis=-1)
    sqrt_dets = jnp.sqrt(s00 * s11 - s01 * s01)
    sg = jnp.asarray(stdev, sig_flat.dtype)

    def local(la_rows, lo_rows, sig_rows, sd_rows, sg_rows,
              la_all, lo_all, sig_all, sd_all, sg_all):
        block = ellipse_covariance_block(
            la_rows, lo_rows, sig_rows, sd_rows, sg_rows,
            la_all, lo_all, sig_all, sd_all, sg_all,
            v=v,
            delta_x_method=delta_x_method,
            max_dist=0.0 if max_dist is None else float(max_dist),
            use_max_dist=max_dist is not None,
        )
        # local diagonal slice: global row index = local offset + shard
        me = jax.lax.axis_index(axis)
        rows_per_dev = la_rows.shape[0]
        row_ids = me * rows_per_dev + jnp.arange(rows_per_dev)
        block = block + (
            (jnp.arange(la_all.shape[0])[None, :] == row_ids[:, None])
            * (sg_rows**2)[:, None]
        )
        return block

    mapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis), P(axis), P(axis), P(axis),
            P(), P(), P(), P(), P(),
        ),
        out_specs=P(axis, None),
    )
    shard_rows = NamedSharding(mesh, P(axis))
    args_rows = [
        jax.device_put(a, shard_rows)
        for a in (la, lo, sig_flat, sqrt_dets, sg)
    ]
    return jax.jit(mapped)(*args_rows, la, lo, sig_flat, sqrt_dets, sg)


def sharded_state_draws(mesh, key, L, n_members: int, axis: str = "grid"):
    """(n_members, N) draws of N(0, L L') with L row-sharded.

    z is replicated; each device computes its row slice of L @ z — one
    local matmul, no collectives. Output is sharded P(None, axis).
    """
    n = L.shape[0]

    def local(L_rows, z):
        return (L_rows @ z).T  # (members, rows)

    mapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=P(None, axis),
    )
    z = jax.random.normal(key, (n, n_members), L.dtype)
    return jax.jit(mapped)(L, z)


# -- pod-scale ZERO-STORAGE stream operator ------------------------------------
#
# The single-chip stream operator (models.ellipse.covariance,
# store="stream") caps out where its (n, width) eigensolver blocks stop
# fitting one chip's HBM (~16 GB bounds n * width to ~4e9 f32). At a
# 0.1-degree grid (n = 6.48M) even rank-1024 factor blocks are ~27 GB —
# pod territory. This operator shards EVERYTHING by grid rows and
# applies cov @ X as a ring-SUMMA: each device assembles only
# (rows_local x col-block) Paciorek-Schervish tiles against the x-shard
# it currently holds, then rotates the column shard (params + x) one
# step around the ring with lax.ppermute. Per-device memory is
# O(n/n_dev * (width + block)); the collective is a neighbour permute
# between devices. Nothing n x n (or even n x n/n_dev) ever exists.
_SHARDED_STREAM_FNS: dict = {}


def _varying(x, axis: str):
    """Mark a freshly-created array as device-varying over `axis`.

    shard_map's varying-manual-axes tracking (newer JAX) requires loop
    carries initialised inside the mapped function to carry the same
    varying annotation as the per-device values accumulated into them;
    older JAX has no pcast and needs nothing."""
    pcast = getattr(jax.lax, "pcast", None)
    if pcast is None:
        return x
    try:
        return pcast(x, (axis,), to="varying")
    except Exception:
        return x


def _sharded_stream_fn(mesh, axis: str, kparams, n: int):
    key = (mesh, axis, kparams, n)
    cached = _SHARDED_STREAM_FNS.get(key)
    if cached is not None:
        return cached

    n_dev = mesh.shape[axis]
    shard_len = n // n_dev
    v, delta_x_method, md, use_md = kparams
    # ~256 MB f32 tile per inner scan step, like the single-chip path
    block = max(256, (1 << 26) // max(shard_len, 1))
    block = -(-block // 256) * 256
    block = min(block, -(-shard_len // 256) * 256)
    n_blocks = -(-shard_len // block)
    pad = n_blocks * block - shard_len

    def _tiles_matmul(rows, cols, x_c):
        """sum_j tile(rows, col_block_j) @ x_c[block_j] for one shard."""

        def _pad_edge(a):
            if pad == 0:
                return a
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, widths, mode="edge")

        blk = tuple(
            _pad_edge(a).reshape((n_blocks, block) + a.shape[1:])
            for a in cols
        )
        # zero-pad x so edge-padded phantom columns contribute nothing
        x_blk = jnp.pad(x_c, ((0, pad), (0, 0))).reshape(
            n_blocks, block, x_c.shape[1]
        )

        def body(acc, inputs):
            la_b, lo_b, sig_b, sd_b, sg_b, xb = inputs
            tile = ellipse_covariance_block(
                rows[0], rows[1], rows[2], rows[3], rows[4],
                la_b, lo_b, sig_b, sd_b, sg_b,
                v=v,
                delta_x_method=delta_x_method,
                max_dist=md,
                use_max_dist=use_md,
            )
            return acc + jnp.matmul(
                tile, xb, precision=jax.lax.Precision.HIGHEST
            ), None

        acc0 = _varying(
            jnp.zeros((rows[0].shape[0], x_c.shape[1]), x_c.dtype),
            axis,
        )
        acc, _ = jax.lax.scan(body, acc0, (*blk, x_blk))
        return acc

    def local_mv(la_s, lo_s, sig_s, sd_s, sg_s, diag_s, x_s):
        rows = (la_s, lo_s, sig_s, sd_s, sg_s)
        perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]

        def ring_step(_, carry):
            cols_and_x, acc = carry
            *cols, x_c = cols_and_x
            acc = acc + _tiles_matmul(rows, tuple(cols), x_c)
            rotated = jax.tree.map(
                lambda a: jax.lax.ppermute(a, axis, perm), cols_and_x
            )
            return rotated, acc

        acc0 = _varying(
            jnp.zeros((la_s.shape[0], x_s.shape[1]), x_s.dtype), axis
        )
        (_, acc) = jax.lax.fori_loop(
            0, n_dev, ring_step, ((*rows, x_s), acc0)
        )
        return acc + diag_s[:, None] * x_s

    mapped = shard_map(
        local_mv,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(axis, None),
        ),
        out_specs=P(axis, None),
    )

    def fn(la, lo, sig, sd, sg, diag, x):
        x2 = x if x.ndim == 2 else x[:, None]
        out = mapped(la, lo, sig, sd, sg, diag, x2)
        return out if x.ndim == 2 else out[:, 0]

    _SHARDED_STREAM_FNS[key] = fn
    return fn


def sharded_ellipse_stream_operator(
    mesh,
    Lx,
    Ly,
    theta,
    stdev,
    lats_deg,
    lons_deg,
    v: float,
    delta_x_method: DeltaXMethod = "Modified_Met_Office",
    max_dist: float | None = None,
    axis: str = "grid",
):
    """Row-sharded zero-storage ``cov @ X`` over the mesh.

    Returns ``(matvec, n, trace)`` exactly like the single-chip
    ``ellipse_covariance_operator(store="stream")`` — ``matvec`` is an
    ``ops.sampling.Matvec`` whose fn slot is memoised per
    (mesh, axis, kernel config, n), so the adaptive eigensolver's
    fused-stage dispatch and the device-scale clips
    (``explained_variance_clip_lowrank`` / ``laloux_clip_lowrank``)
    work unchanged: the whole PSD repair runs with every (n, width)
    block row-sharded across the mesh, per-device memory ~1/n_dev of
    the single-chip path. N must divide the mesh axis.

    (Pod-scale capability beyond reference ``ellipse/covariance.py``,
    which requires the dense matrix and a single process; composes the
    SURVEY §2.3 tiled-kernel and mesh-sharding equivalents.)
    """
    from ..ops.sampling import Matvec

    n = len(lats_deg)
    n_dev = mesh.shape[axis]
    if n % n_dev != 0:
        raise ValueError(f"N={n} must be divisible by axis size {n_dev}")

    la = jnp.radians(jnp.asarray(lats_deg, jnp.float32))
    lo = jnp.radians(jnp.asarray(lons_deg, jnp.float32))
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)
    )
    sig_flat = jnp.stack([s00, s01, s11], axis=-1)
    sqrt_dets = jnp.sqrt(s00 * s11 - s01 * s01)
    sg = jnp.asarray(stdev, sig_flat.dtype)
    diag = sg.astype(jnp.float32) ** 2
    trace = float(jnp.sum(diag))

    kparams = (
        float(v),
        delta_x_method,
        0.0 if max_dist is None else float(max_dist),
        max_dist is not None,
    )
    fn = _sharded_stream_fn(mesh, axis, kparams, n)

    shard_rows = NamedSharding(mesh, P(axis))
    operands = [
        jax.device_put(a, shard_rows)
        for a in (la, lo, sig_flat, sqrt_dets, sg, diag)
    ]
    return Matvec(fn, *operands), n, trace
