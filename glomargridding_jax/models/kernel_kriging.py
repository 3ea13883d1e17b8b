r"""Kernel-functional kriging: the large-N path (covariance never
materialised).

The class API (``models.kriging``) mirrors the reference and takes a
dense M x M covariance — fine to ~10k grid points. At production scale
(1-degree global, M ~ 65k) a dense covariance is ~17 GB in f32 and the
reference cannot run at all. This module provides the device design:
the covariance is a *kernel function* of coordinates; the solver streams
column blocks of :math:`C_{cross}` under ``lax.scan``, building each tile
directly from the kernel, triangular-solving it against the one
replicated Cholesky factor of :math:`K = C_{obs} + E`, and reducing its
slice of the field / uncertainty / constraint-mask diagonals. Peak memory
is O(n^2 + n * block) regardless of M.

This is the engine behind ``bench.py`` (64.8k grid / 5k obs against the
10 s baseline target).
"""

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..constants import RADIUS_OF_EARTH_KM
from ..ops.distances import asin_poly


class KrigingResult(NamedTuple):
    """Kriged field + diagnostics (uncertainty = sqrt of clamped var)."""

    field: jax.Array
    uncertainty: jax.Array
    constraint_mask: jax.Array


class _VariogramKernel:
    """Covariance-kernel callable that hashes by VALUE.

    The streamed solvers take `kernel_fn` as a STATIC jit argument; a
    per-call closure would give the compile cache a fresh key every
    time a kernel is (re)constructed. Hashing on the variogram's field
    values instead means `variogram_kernel(MaternVariogram(...))` built
    twice with the same parameters reuses the compiled program.
    """

    def __init__(self, variogram, distance, variance, radius):
        self.variogram = variogram
        self.distance = distance
        self.var = (
            variogram.psill + variogram.nugget
            if variance is None
            else variance
        )
        self.radius = radius

    def _cache_key(self):
        import dataclasses

        return (
            type(self.variogram).__name__,
            tuple(sorted(dataclasses.asdict(self.variogram).items())),
            self.distance,
            float(self.var),
            float(self.radius),
        )

    def __eq__(self, other):
        return (
            isinstance(other, _VariogramKernel)
            and self._cache_key() == other._cache_key()
        )

    def __hash__(self):
        return hash(self._cache_key())

    def __call__(self, la1, lo1, la2, lo2):
        distance, radius = self.distance, self.radius
        if distance == "cartesian":
            dy = jnp.degrees(la1[:, None] - la2[None, :])
            dx = jnp.degrees(lo1[:, None] - lo2[None, :])
            d = jnp.sqrt(dy * dy + dx * dx)
        else:
            # haversine-a is well-conditioned for near pairs (no 1-cos
            # cancellation); kept per-pair sins for that reason
            a = (
                jnp.sin((la1[:, None] - la2[None, :]) / 2.0) ** 2
                + jnp.cos(la1)[:, None]
                * jnp.cos(la2)[None, :]
                * jnp.sin((lo1[:, None] - lo2[None, :]) / 2.0) ** 2
            )
            a = jnp.clip(a, 0.0, 1.0)
            if distance == "chordal":
                # chord = 2 R sin(c/2) and c = 2 asin(sqrt(a)), so the
                # chord is EXACTLY 2 R sqrt(a) — no inverse trig at all
                d = 2.0 * radius * jnp.sqrt(a)
            elif distance == "haversine":
                # asin via the A&S polynomial (err 2e-8 < f32 eps):
                # a few multiply-adds instead of a library arcsin
                d = 2.0 * radius * asin_poly(jnp.sqrt(a))
            else:
                raise ValueError(f"Unknown distance: {distance}")
        return self.var - self.variogram._kernel(d)


def variogram_kernel(
    variogram,
    distance: str = "haversine",
    variance: float | None = None,
    radius: float = RADIUS_OF_EARTH_KM,
) -> Callable:
    """Covariance kernel (lat1, lon1, lat2, lon2 in RADIANS) from a
    variogram model.

    `distance` is "haversine" (great-circle km), "chordal" (tunnel km) or
    "cartesian" (planar degrees on raw coordinates). The kernel evaluates
    ``variance - variogram(d)`` elementwise — fused by XLA into whatever
    tile consumes it. The returned callable hashes by the variogram's
    field values, so rebuilding the same kernel does not recompile the
    streamed solvers.
    """
    return _VariogramKernel(variogram, distance, variance, radius)


def _hmm(a, b):
    """a @ b in full f32. The field and the Lagrange multiplier are
    differences of large terms, and a default-precision f32 product
    may run as TF32 on the GPU."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _pad_blocks(arr, n_blocks):
    m = arr.shape[0]
    # block size rounded to a multiple of 256: unaligned block dims on
    # scan-carried shapes once sent a compiler into a pathological
    # layout path (re-measuring the rule on the GPU is open)
    block = -(-m // n_blocks)
    block = -(-block // 256) * 256
    n_blocks = -(-m // block)
    pad = n_blocks * block - m
    if pad:
        arr = jnp.concatenate([arr, jnp.broadcast_to(arr[-1:], (pad,))])
    return arr.reshape(n_blocks, block), pad


@partial(
    jax.jit,
    static_argnames=("kernel_fn", "method", "n_blocks", "fields_only"),
)
def _kernel_kriging_jit(
    kernel_fn,
    la,
    lo,
    idx,
    y,
    error_cov,
    variance,
    mean,
    method: str,
    n_blocks: int,
    fields_only: bool = False,
):
    la_o = la[idx]
    lo_o = lo[idx]
    K = kernel_fn(la_o, lo_o, la_o, lo_o)
    if error_cov is not None:
        K = K + error_cov
    # One n x n Cholesky; per block only ONE triangular application with
    # B RHS: the field and the colsum diagnostics contract precomputed
    # n-vectors (w = K^{-1}y, u = K^{-1}1) against the tile, and
    # diag(Cc' K^{-1} Cc) = column norms of L^{-1} Cc. The application
    # runs as Linv @ Cc, ONE f32-exact (HIGHEST) matmul against the
    # precomputed small inverse, not a tall triangular solve.
    # Numerically safe HERE because the inverse's roundoff lands in
    # sv = ||U||^2 columnwise — a positive quadratic form of the
    # solution, measured 9e-7 relative vs the f64 oracle — while the
    # FIELD solves stay cho_solve (their results feed differences of
    # large terms, see ARCHITECTURE.md "Explored and rejected").
    L = jnp.linalg.cholesky(K)
    factor = (L, True)
    n = idx.shape[0]
    ones = jnp.ones((n,), la.dtype)
    u = jsl.cho_solve(factor, ones)
    w = jsl.cho_solve(factor, y)
    s = jnp.sum(u)
    uy = u @ y

    la_b0, _ = _pad_blocks(la, n_blocks)
    lo_b0, _ = _pad_blocks(lo, n_blocks)

    if fields_only:
        # Fields-only (the months-scan diagnostics=False path): no
        # Linv GEMM exists to hide a duplicated producer under, so
        # u and w are stacked into ONE (2, n) left operand — a single
        # fused assembly per tile — and the n x n triangular inverse is
        # skipped entirely.
        M2 = jnp.stack([u, w], axis=0)

        def per_block_f(_, inputs):
            la_blk, lo_blk = inputs
            Cc = kernel_fn(la_o, lo_o, la_blk, lo_blk)
            R = _hmm(M2, Cc)  # rows: u@Cc, w@Cc
            if method == "ordinary":
                lam = (R[0] - 1.0) / s
                field = R[1] - lam * uy
            else:
                field = R[1] + mean
            return None, field

        _, field = jax.lax.scan(per_block_f, None, (la_b0, lo_b0))
        return field.reshape(-1), None, None

    Linv = jsl.solve_triangular(
        L, jnp.eye(n, dtype=L.dtype), lower=True
    )
    # NOTE on producer fusion: here the small `u @ Cc` / `w @ Cc` dots
    # KEEP their own fused copies of the transcendental assembly — the
    # recompute hid under the HIGHEST-precision GEMM that dominates
    # this path on the previous accelerator, and stacking them into
    # the big GEMM (one producer instance) measured slower there. The
    # ensemble path below, with no big GEMM to hide under, stacks
    # them. Both choices are still to be re-measured on the GPU.

    def per_block(_, inputs):
        la_blk, lo_blk = inputs
        Cc = kernel_fn(la_o, lo_o, la_blk, lo_blk)  # (n, B)
        U = jnp.matmul(Linv, Cc, precision=jax.lax.Precision.HIGHEST)
        sv = jnp.einsum("nb,nb->b", U, U)
        if method == "ordinary":
            t = _hmm(u, Cc)
            lam = (t - 1.0) / s
            field = _hmm(w, Cc) - lam * uy
            wc = sv - lam * t
            uncert2 = variance - (wc + lam) - lam
        else:
            field = _hmm(w, Cc) + mean
            uncert2 = variance - sv
        cmask = sv / variance
        return None, (field, uncert2, cmask)

    _, (field, uncert2, cmask) = jax.lax.scan(
        per_block, None, (la_b0, lo_b0)
    )
    return field.reshape(-1), uncert2.reshape(-1), cmask.reshape(-1)


def kriging_from_kernel(
    kernel_fn: Callable,
    grid_lats,
    grid_lons,
    idx,
    obs,
    error_cov=None,
    variance: float = 1.0,
    method: str = "ordinary",
    mean: float = 0.0,
    n_blocks: int = 16,
) -> KrigingResult:
    """Simple/ordinary kriging against a covariance *kernel*.

    `kernel_fn(la1, lo1, la2, lo2)` (radians) produces covariance tiles;
    `grid_lats`/`grid_lons` are the output grid positions in degrees;
    `variance` is the kernel's value at zero distance (diag(C)).
    Memory never exceeds O(n^2 + n * M/n_blocks).
    """
    if method not in ("ordinary", "simple"):
        raise ValueError(f"Unknown kriging method: {method}")
    la = jnp.radians(jnp.asarray(grid_lats))
    lo = jnp.radians(jnp.asarray(grid_lons))
    m = la.shape[0]
    idx = jnp.asarray(idx)
    y = jnp.asarray(obs, la.dtype)
    E = None if error_cov is None else jnp.asarray(error_cov, la.dtype)

    field, uncert2, cmask = _kernel_kriging_jit(
        kernel_fn,
        la,
        lo,
        idx,
        y,
        E,
        jnp.asarray(variance, la.dtype),
        jnp.asarray(mean, la.dtype),
        method,
        n_blocks,
    )
    field = field[:m]
    uncert2 = uncert2[:m]
    cmask = cmask[:m]
    uncert = jnp.sqrt(jnp.clip(uncert2, 0.0))
    return KrigingResult(field, uncert, cmask)


@partial(
    jax.jit, static_argnames=("kernel_fn", "n_members", "n_blocks")
)
def _kernel_ensemble_jit(
    kernel_fn, la, lo, idx, y, error_cov, key, n_members, n_blocks
):
    la_o = la[idx]
    lo_o = lo[idx]
    K = kernel_fn(la_o, lo_o, la_o, lo_o) + error_cov
    L_obs = jnp.linalg.cholesky(K)
    factor = (L_obs, True)
    n = idx.shape[0]
    ones = jnp.ones((n,), la.dtype)
    u = jsl.cho_solve(factor, ones)
    w = jsl.cho_solve(factor, y)
    s = jnp.sum(u)
    uy = u @ y
    z = jax.random.normal(key, (n_members, n), la.dtype)
    sim_obs = z @ L_obs.T
    # Solve once against the (n, members) RHS; every block is then pure
    # matmuls — no M-RHS triangular solves at all.
    S = jsl.cho_solve(factor, sim_obs.T).T  # (members, n)
    # Stack u, w and the member weights into ONE left operand: with
    # separate `u @ Cc` / `w @ Cc` / `S @ Cc` dots, XLA fuses the
    # transcendental Cc ASSEMBLY into each consumer separately and
    # recomputes it per dot. One (members+2, n) GEMM pins a single
    # producer instance per block. This trade reversed in
    # _kernel_kriging_jit above, where a dominant GEMM hid the
    # recompute — see the note there.
    M = jnp.concatenate([u[None, :], w[None, :], S], axis=0)

    la_b, _ = _pad_blocks(la, n_blocks)
    lo_b, _ = _pad_blocks(lo, n_blocks)

    def per_block(_, inputs):
        la_blk, lo_blk = inputs
        Cc = kernel_fn(la_o, lo_o, la_blk, lo_blk)
        R = _hmm(M, Cc)  # rows: u@Cc, w@Cc, then S@Cc
        lam = (R[0] - 1.0) / s
        field = R[1] - lam * uy
        perturbed = field[None, :] + R[2:]
        return None, (field, perturbed)

    _, (field, members) = jax.lax.scan(per_block, None, (la_b, lo_b))
    field = field.reshape(-1)
    members = jnp.transpose(members, (1, 0, 2)).reshape(n_members, -1)
    return field, members


def ensemble_from_kernel(
    kernel_fn: Callable,
    grid_lats,
    grid_lons,
    idx,
    obs,
    error_cov,
    key,
    n_members: int = 100,
    n_blocks: int = 16,
):
    """Observation-perturbation ensemble around the kernel-kriged field.

    One factorisation of K = C_obs + E; `n_members` draws of simulated
    observation noise are simple-kriged through the streamed column
    blocks. Returns (field (M,), members (n_members, M)). For the full
    Morice-2021 two-stage scheme with simulated STATES, use
    ``models.stochastic`` (dense covariance) or the sharded
    ``parallel.ensemble_kriging_step``.
    """
    la = jnp.radians(jnp.asarray(grid_lats))
    lo = jnp.radians(jnp.asarray(grid_lons))
    m = la.shape[0]
    field, members = _kernel_ensemble_jit(
        kernel_fn,
        la,
        lo,
        jnp.asarray(idx),
        jnp.asarray(obs, la.dtype),
        jnp.asarray(error_cov, la.dtype),
        key,
        n_members,
        n_blocks,
    )
    return field[:m], members[:, :m]


def pad_month_observations(
    idx_months,
    obs_months,
    err_months,
    bucket: int | None = None,
    pad_error: float = 1e8,
):
    """Pad variable-length monthly observation sets to one bucket size.

    Monthly obs counts differ at runtime but jit needs static shapes
    (SURVEY.md §7.4.2). Padding adds dummy observations at grid index 0
    with value 0 and a huge uncorrelated error variance (`pad_error`), so
    their kriging weight is ~variance/pad_error — negligible. Returns
    stacked (T, bucket) idx/obs and (T, bucket, bucket) error covariance
    ready for ``months_scan_kriging``.
    """
    import numpy as _np

    if bucket is None:
        bucket = max(len(i) for i in idx_months)
    T = len(idx_months)
    idx_out = _np.zeros((T, bucket), dtype=_np.asarray(idx_months[0]).dtype)
    obs_out = _np.zeros((T, bucket), dtype=float)
    err_out = _np.zeros((T, bucket, bucket), dtype=float)
    for t in range(T):
        n = len(idx_months[t])
        if n > bucket:
            raise ValueError(
                f"month {t} has {n} obs > bucket size {bucket}"
            )
        idx_out[t, :n] = _np.asarray(idx_months[t])
        obs_out[t, :n] = _np.asarray(obs_months[t])
        err_out[t, :n, :n] = _np.asarray(err_months[t])
        # dummy slots: enormous independent error -> ~zero weight
        pad_sl = _np.arange(n, bucket)
        err_out[t, pad_sl, pad_sl] = pad_error
    return idx_out, obs_out, err_out


@partial(
    jax.jit, static_argnames=("kernel_fn", "n_blocks", "diagnostics")
)
def _months_scan_jit(
    kernel_fn,
    la,
    lo,
    idx_m,
    obs_m,
    err_m,
    variance,
    n_blocks: int,
    diagnostics: bool,
):
    m = la.shape[0]

    def one_month(carry, inputs):
        idx, y, E = inputs
        field, uncert2, cmask = _kernel_kriging_jit(
            kernel_fn,
            la,
            lo,
            idx,
            y,
            E,
            variance,
            jnp.asarray(0.0, la.dtype),
            "ordinary",
            n_blocks,
            fields_only=not diagnostics,
        )
        if diagnostics:
            return carry, (field[:m], uncert2[:m], cmask[:m])
        return carry, field[:m]

    _, out = jax.lax.scan(one_month, None, (idx_m, obs_m, err_m))
    return out


def months_scan_kriging(
    kernel_fn: Callable,
    grid_lats,
    grid_lons,
    idx_months,
    obs_months,
    error_cov_months,
    variance: float = 1.0,
    n_blocks: int = 8,
    diagnostics: bool = True,
):
    """Batch kriging over a stack of months with identical obs layouts.

    `idx_months` (T, n), `obs_months` (T, n), `error_cov_months`
    (T, n, n): one compiled program scans over months (the ESA-CCI
    41-Marches configuration; months with differing obs counts should be
    padded/bucketed with ``pad_month_observations``). Returns
    (fields, uncertainties, constraint_masks), each (T, M) — the
    uncertainty is sqrt of the clamped variance. With
    ``diagnostics=False`` only the (T, M) fields are computed and
    returned (XLA drops the diagonal reductions entirely — a few times
    faster when only fields are wanted).
    """
    la = jnp.radians(jnp.asarray(grid_lats))
    lo = jnp.radians(jnp.asarray(grid_lons))
    out = _months_scan_jit(
        kernel_fn,
        la,
        lo,
        jnp.asarray(idx_months),
        jnp.asarray(obs_months),
        jnp.asarray(error_cov_months),
        jnp.asarray(variance, la.dtype),
        n_blocks,
        diagnostics,
    )
    if not diagnostics:
        return out
    fields, uncert2, cmask = out
    return fields, jnp.sqrt(jnp.clip(uncert2, 0.0)), cmask


class CrossValResult(NamedTuple):
    """Leave-one-out kriging cross-validation diagnostics."""

    residuals: jax.Array       # (n,) y_i - LOO prediction at obs i
    std_residuals: jax.Array   # (n,) residual / LOO predictive stdev
    loo_variance: jax.Array    # (n,) LOO predictive variance
    rmse: jax.Array            # scalar sqrt(mean residual^2)
    mssr: jax.Array            # scalar mean squared std residual (~1)


def _loo_from_K(K, y, mean, method: str):
    """Dubrule LOO identity off the dense (m, m) observation system.

    Traceable core shared by the kernel path and the factored
    (``models.lowrank``) path.
    """
    n = K.shape[0]
    if method == "ordinary":
        ones = jnp.ones((n, 1), K.dtype)
        Kx = jnp.block(
            [[K, ones], [ones.T, jnp.zeros((1, 1), K.dtype)]]
        )
        rhs = jnp.concatenate([y, jnp.zeros((1,), y.dtype)])
        # the bordered system is symmetric INDEFINITE: lu, not cholesky
        Kinv = jnp.linalg.inv(Kx)
        alpha = Kinv @ rhs
        d = jnp.diagonal(Kinv)[:n]
        alpha = alpha[:n]
    else:
        factor = jsl.cho_factor(K)
        alpha = jsl.cho_solve(factor, y - mean)
        Kinv = jsl.cho_solve(factor, jnp.eye(n, dtype=K.dtype))
        d = jnp.diagonal(Kinv)
    loo_var = 1.0 / d
    resid = alpha * loo_var
    stdres = alpha * jnp.sqrt(loo_var)
    rmse = jnp.sqrt(jnp.mean(resid**2))
    mssr = jnp.mean(stdres**2)
    return resid, stdres, loo_var, rmse, mssr


@partial(jax.jit, static_argnames=("kernel_fn", "method"))
def _loo_crossval_jit(kernel_fn, la, lo, idx, y, E, mean, method):
    la_o = la[idx]
    lo_o = lo[idx]
    K = kernel_fn(la_o, lo_o, la_o, lo_o)
    if E is not None:
        K = K + (jnp.diag(E) if E.ndim == 1 else E)
    return _loo_from_K(K, y, mean, method)


def kriging_crossval(
    kernel_fn: Callable,
    grid_lats,
    grid_lons,
    idx,
    obs,
    error_cov=None,
    mean: float = 0.0,
    method: str = "ordinary",
) -> CrossValResult:
    r"""Leave-one-out cross-validation of a kriging model — ONE solve.

    The classic kriging CV identity (Dubrule 1983): with
    :math:`K = C_{obs} + E` and :math:`\alpha = K^{-1}(y - \mu)`, the
    leave-one-out residual at observation i is
    :math:`e_i = \alpha_i / (K^{-1})_{ii}` and the LOO predictive
    variance is :math:`1 / (K^{-1})_{ii}` — every left-out refit falls
    out of the SINGLE factorisation, so scoring a variogram model
    costs one n^3 factor instead of n refits. For ``method="ordinary"``
    the identity is applied to the Lagrange-bordered system (universal
    kriging CV), so the unknown-mean constraint is respected in every
    leave-one-out prediction.

    Returns residuals, standardized residuals, LOO variances, and two
    summary scores: ``rmse`` (prediction accuracy — compare models) and
    ``mssr`` (mean squared standardized residual — calibration; ~1 when
    the covariance amplitude matches the data, >1 when uncertainty is
    underestimated).

    Production use: score candidate variogram/ellipse models on the
    month's observations BEFORE committing the expensive grid solve;
    the reference library has no model-selection tooling (capability
    beyond ``glomar_gridding``; the statistical identity is standard).
    `error_cov` accepts the (n,) diagonal or the (n, n) matrix.
    """
    if method not in ("ordinary", "simple"):
        raise ValueError(f"Unknown kriging method: {method}")
    la = jnp.radians(jnp.asarray(grid_lats))
    lo = jnp.radians(jnp.asarray(grid_lons))
    idx = jnp.asarray(idx)
    y = jnp.asarray(obs, la.dtype)
    E = None if error_cov is None else jnp.asarray(error_cov, la.dtype)
    out = _loo_crossval_jit(
        kernel_fn, la, lo, idx, y, E,
        jnp.asarray(mean, la.dtype), method,
    )
    return CrossValResult(*out)


@partial(jax.jit, static_argnames=("method",))
def _loo_from_cov_jit(cov, idx, y, E, mean, method):
    K = cov[idx[:, None], idx[None, :]]
    if E is not None:
        K = K + (jnp.diag(E) if E.ndim == 1 else E)
    return _loo_from_K(K, y, mean, method)


def crossval_from_covariance(
    covariance,
    idx,
    obs,
    error_cov=None,
    mean: float = 0.0,
    method: str = "ordinary",
) -> CrossValResult:
    """:func:`kriging_crossval` for a precomputed dense covariance.

    Same Dubrule LOO identity, gathering the observation system from
    the (n, n) matrix instead of a kernel — the variant for the dense
    class workflow (``OrdinaryKriging``-style precomputed covariances,
    e.g. a clipped non-stationary assembly): score candidate
    covariance models on the month's observations before the grid
    solve. `error_cov` may be obs-sized (m or m x m) or full-grid
    (n or n x n — subset to `idx` like the ``Kriging`` classes do).
    """
    if method not in ("ordinary", "simple"):
        raise ValueError(f"Unknown kriging method: {method}")
    cov = jnp.asarray(covariance)
    idx = jnp.asarray(idx)
    y = jnp.asarray(obs, cov.dtype)
    E = None if error_cov is None else jnp.asarray(error_cov, cov.dtype)
    m = int(idx.shape[0])
    if E is not None and E.shape[0] != m:
        if E.shape[0] != cov.shape[0]:
            raise ValueError(
                f"error_cov dimension {E.shape[0]} matches neither the "
                f"observation count {m} nor the grid size {cov.shape[0]}"
            )
        E = E[idx] if E.ndim == 1 else E[idx[:, None], idx[None, :]]
    out = _loo_from_cov_jit(
        cov, idx, y, E, jnp.asarray(mean, cov.dtype), method
    )
    return CrossValResult(*out)
