r"""Ellipse parameter estimation from a (time, lat, lon) training cube.

Capability parity with reference ``ellipse/estimate.py`` (EllipseBuilder:
empirical covariance/correlation, per-gridpoint training-set selection,
MLE ellipse fits with QC codes, whole-grid parameter fields), re-designed
for an accelerator:

- the empirical covariance X'X/(T-1) is one matmul;
- per-gridpoint training-set selection is a *mask*, not a gather: every
  point keeps a fixed-length (N,) row of displacements/correlations with
  0/1 weights, so all fits share one compiled program;
- ``compute_params`` fits ALL unmasked grid points with the batched
  Nelder-Mead — the reference's sequential scipy loop
  (``estimate.py:691-713``, its 58 s hotspot) becomes a handful of
  device launches (row-chunked to bound memory).
"""

import json
import logging
import math
import os
from functools import partial
from typing import Any
from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec

from ...constants import RADIUS_OF_EARTH_KM
from ...core.labeled import Coordinates, DataArray, Dataset
from ...ops.distances import displacements, haversine_matrix
from ...ops.optim import (
    batched_lbfgs,
    batched_levenberg_marquardt,
    batched_nelder_mead,
)
from ...types import DeltaXMethod
from ...utils.arrays import cov_2_cor, uncompress_masked
from ...utils.cache import BoundedCache
from .model import ARCTANH_THRESHOLD, EllipseModel

logger = logging.getLogger(__name__)


@jax.jit
def _normalised_samples(x):
    """Variance-normalise centred (T, n) samples so xn'xn is the
    empirical correlation."""
    var = jnp.einsum("tn,tn->n", x, x)
    inv_s = jnp.where(var > 0, 1.0 / jnp.sqrt(var), 0.0)
    return x * inv_s[None, :]


@jax.jit
def _cor_matmul(x):
    xn = _normalised_samples(x)
    return xn.T @ xn


@partial(jax.jit, donate_argnums=0)
def _set_unit_diag(cor):
    ii = jnp.arange(cor.shape[0])
    return cor.at[ii, ii].set(1.0)


def _correlation_from_centred(x):
    """(n, n) correlation from centred (T, n) samples.

    Normalising the samples FIRST means the correlation needs a single
    n x n buffer (no dense covariance is ever formed). The exact unit
    diagonal is written by a separate jit with the input DONATED: left
    inside one program, XLA did not alias the scatter and transiently
    held 2 x n^2 (~15.8 GB at 1-degree scale = OOM); donation
    guarantees the in-place update.
    """
    return _set_unit_diag(_cor_matmul(x))


def _train_geometry_arrays(
    lats_all,
    lons_all,
    centre_sel,
    *,
    min_distance: float,
    max_distance: float,
    anisotropic: bool,
    delta_x_method,
    physical_distance: bool,
    physical_distance_selection: bool,
):
    """Displacements/selection geometry for a batch of centre points.

    Traceable module-level core of ``EllipseBuilder._train_geometry``
    (pure function of the coordinate arrays, so the whole per-chunk
    training-data build can run as ONE jitted program,
    :func:`_chunk_train_data`). Returns (X, weights): X is (B, N, 2)
    for anisotropic models or (B, N) distances for isotropic ones;
    weights the (B, N) 0/1 selection mask — replicating the three
    selection regimes of reference ``estimate.py:424-513``.
    """
    if physical_distance and (delta_x_method is None):
        raise ValueError(
            "Cannot have physical_distance with unset delta_x_method"
        )
    lat_c = lats_all[centre_sel]
    lon_c = lons_all[centre_sel]

    # displacement from every point to each centre: (N, B) -> (B, N)
    dy, dx = displacements(
        lats_all, lons_all, lat_c, lon_c, delta_x_method=delta_x_method
    )
    dy = dy.T
    dx = dx.T

    if delta_x_method is None or not physical_distance_selection:
        if delta_x_method is not None:
            dyd, dxd = displacements(
                lats_all, lons_all, lat_c, lon_c, delta_x_method=None
            )
            deg_distance = jnp.sqrt(dxd.T**2 + dyd.T**2)
        else:
            deg_distance = jnp.sqrt(dx**2 + dy**2)
        weights = (
            (deg_distance <= max_distance)
            & (deg_distance >= min_distance)
            & (deg_distance != 0.0)
        ).astype(dy.dtype)
        if anisotropic:
            X = jnp.stack([dx, dy], axis=-1)
            if physical_distance:
                X = X * RADIUS_OF_EARTH_KM
            return X, weights
        if physical_distance:
            dist = haversine_matrix(lat_c, lon_c, lats_all, lons_all)
            return dist, weights
        return deg_distance, weights

    dist = haversine_matrix(lat_c, lon_c, lats_all, lons_all)  # (B, N)
    weights = (
        (dist <= max_distance)
        & (dist >= min_distance)
        & (dist != 0.0)
    ).astype(dy.dtype)
    if anisotropic:
        X = RADIUS_OF_EARTH_KM * jnp.stack([dx, dy], axis=-1)
        return X, weights
    return dist, weights


@partial(
    jax.jit,
    static_argnames=(
        "min_distance",
        "max_distance",
        "anisotropic",
        "delta_x_method",
        "physical_distance",
        "physical_distance_selection",
        "max_train_cols",
        "fisher_z",
        "lazy_cor",
    ),
)
def _chunk_train_data(
    lats_all,
    lons_all,
    cor,
    centre_sel,
    *,
    min_distance: float,
    max_distance: float,
    anisotropic: bool,
    delta_x_method,
    physical_distance: bool,
    physical_distance_selection: bool,
    max_train_cols,
    fisher_z: bool = False,
    lazy_cor: bool = False,
):
    """One chunk's full training data (X, y, w) as ONE compiled program.

    Fusing geometry + correlation row-gather + nearest-column selection
    keeps the (B, N) intermediates (≈360 MB at the 1-degree shape)
    inside XLA instead of materialising half a dozen of them eagerly —
    measured ~2x on the warm per-chunk wall of the whole-grid MLE fit.

    With ``fisher_z=True`` the returned observations are
    ``arctanh(clip(y))`` (masked lanes zeroed first, matching ``nll``'s
    masking order) for the ``_nll_fit_z`` / ``_residuals_fit_z``
    objectives: the transform is constant across optimizer iterations,
    so computing it here removes one log per element per candidate
    evaluation from the transcendental-bound fit loop.

    With ``lazy_cor=True``, `cor` is NOT the (n, n) correlation but the
    (T, n) variance-normalised centred samples, and the chunk's
    correlation rows are rebuilt inside this same program as one
    (B, T) x (T, n) matmul — the (n, n) matrix never exists, which is
    what makes whole-grid fits possible past ~10^5 points (259k
    dense correlation = 269 GB). Exact unit self-correlation is
    re-imposed at [b, centre_sel[b]] for parity with the dense path.
    """
    X, w = _train_geometry_arrays(
        lats_all,
        lons_all,
        centre_sel,
        min_distance=min_distance,
        max_distance=max_distance,
        anisotropic=anisotropic,
        delta_x_method=delta_x_method,
        physical_distance=physical_distance,
        physical_distance_selection=physical_distance_selection,
    )
    if lazy_cor:
        xn = cor  # (T, n) normalised samples
        y = xn[:, centre_sel].T @ xn  # (B, n) correlation rows
        y = y.at[jnp.arange(centre_sel.shape[0]), centre_sel].set(1.0)
    else:
        y = cor[centre_sel, :]
    if max_train_cols is not None and max_train_cols < y.shape[1]:
        X, y, w = _nearest_train_cols(X, y, w, max_train_cols, anisotropic)
    if fisher_z:
        y = jnp.arctanh(
            jnp.clip(
                jnp.where(w > 0, y, 0.0),
                -ARCTANH_THRESHOLD,
                ARCTANH_THRESHOLD,
            )
        )
    return X, y, w


# Grouped-dispatch whole-grid fitting: one jitted lax.scan runs
# `dispatch_chunks` consecutive fit chunks per device dispatch, so the
# per-chunk dispatch overhead is paid once per GROUP. The body
# is identical to the single-chunk path (same _chunk_train_data + same
# batched optimiser); results agree to float tolerance — XLA's scan
# scheduling reassociates a few reductions, which can shift an NM
# termination by one iteration (pinned by test). (B, N) training
# temps live once (scan reuses iteration buffers). Cached per
# (objective fn, optimiser lane, tolerance, geometry config): the
# objective is a bound method of the model instance, which hashes
# stably, so repeated monthly runs reuse one compiled program.
# bounded: keys pin EllipseModel instances + compiled programs
_GROUP_FIT_CACHE = BoundedCache(16)


def _group_fit_fn(fun, residuals_fun, lane, tol, geo_cfg, mesh_info=None):
    key = (fun, residuals_fun, lane, tol, geo_cfg, mesh_info)
    cached = _GROUP_FIT_CACHE.get(key)
    if cached is not None:
        return cached
    (
        min_distance,
        max_distance,
        anisotropic,
        delta_x_method,
        physical_distance,
        physical_distance_selection,
        max_train_cols,
        lazy_cor,
    ) = geo_cfg

    def run(lats_all, lons_all, cor, sel_mat, x0_single, lo, hi):
        def body(_, sel_row):
            X, y, w = _chunk_train_data(
                lats_all,
                lons_all,
                cor,
                sel_row,
                min_distance=min_distance,
                max_distance=max_distance,
                anisotropic=anisotropic,
                delta_x_method=delta_x_method,
                physical_distance=physical_distance,
                physical_distance_selection=physical_distance_selection,
                max_train_cols=max_train_cols,
                fisher_z=True,
                lazy_cor=lazy_cor,
            )
            x0 = jnp.broadcast_to(
                x0_single, (sel_row.shape[0], x0_single.shape[0])
            )
            if lane == "lm":
                res = batched_levenberg_marquardt(
                    residuals_fun, x0, (X, y, w), (lo, hi), xtol=tol
                )
            elif lane == "lbfgs":
                res = batched_lbfgs(
                    fun, x0, (X, y, w), (lo, hi), tol=tol
                )
            else:
                res = batched_nelder_mead(
                    fun, x0, (X, y, w), (lo, hi), xatol=tol, fatol=tol
                )
            return None, (
                res.x,
                res.nit,
                res.success,
                jnp.sum(w, axis=1) > 0,
            )

        _, outs = jax.lax.scan(body, None, sel_mat)
        return outs

    if mesh_info is None:
        compiled = jax.jit(run)
    else:
        # Multi-chip whole-grid fit: every lane (grid point) is
        # independent, so sharding the (G, B) centre-index matrix along
        # its LANE axis splits each chunk's fits across the mesh with
        # ZERO collectives — each device rebuilds only its own lanes'
        # (B/n_dev, N) training rows against the replicated training
        # cube and runs the batched optimiser on them. Linear scaling
        # in device count; per-device fit temps shrink by n_dev.
        mesh, axis = mesh_info
        lane_spec = PartitionSpec(None, axis)
        rep = PartitionSpec()
        compiled = jax.jit(
            shard_map(
                run,
                mesh=mesh,
                in_specs=(rep, rep, rep, lane_spec, rep, rep, rep),
                out_specs=(lane_spec, lane_spec, lane_spec, lane_spec),
                # the optimiser while_loop carries start replicated
                # (broadcast x0) and become device-varying once the
                # sharded lanes' training data enters — that is the
                # point; there are no collectives for the checker to
                # protect
                check_vma=False,
            )
        )
    _GROUP_FIT_CACHE[key] = compiled
    return compiled


# Per-chunk Fisher-information standard errors, as a SEPARATE jitted
# program from the fit: fusing the vmapped Hessian into the fit scan
# made the production-shape compile take minutes AND recompiled the
# whole fit whenever SE was toggled;
# standalone, the fit program stays byte-identical (compile-cache hit)
# and the SE program — chunk-data rebuild + d^2-gradient pass, no
# optimiser while_loop — compiles on its own. Cached per (objective,
# geometry config) like the fit.
_CHUNK_SE_CACHE = BoundedCache(16)


def _chunk_se_fn(fun, geo_cfg, mesh_info=None):
    key = (fun, geo_cfg, mesh_info)
    cached = _CHUNK_SE_CACHE.get(key)
    if cached is not None:
        return cached
    (
        min_distance,
        max_distance,
        anisotropic,
        delta_x_method,
        physical_distance,
        physical_distance_selection,
        max_train_cols,
        lazy_cor,
    ) = geo_cfg

    def _lane_se(x, X_i, y_i, w_i):
        """sqrt(diag(H^{-1})) at one lane's optimum.

        H is the autodiff Hessian of the SAME weighted Fisher-z
        objective the fit minimised — available because K_nu is
        differentiable JAX (the reference raises NotImplementedError
        for Hessian SEs, ``model.py:539-544``). Non-positive-curvature
        directions (bound-pinned or failed lanes) yield NaN.
        """
        H = jax.hessian(lambda p: fun(p, X_i, y_i, w_i))(x)
        cov = jnp.linalg.inv(H)
        dg = jnp.diagonal(cov)
        return jnp.sqrt(jnp.where(dg > 0, dg, jnp.nan))

    def run(lats_all, lons_all, cor, sel_row, xs):
        X, y, w = _chunk_train_data(
            lats_all,
            lons_all,
            cor,
            sel_row,
            min_distance=min_distance,
            max_distance=max_distance,
            anisotropic=anisotropic,
            delta_x_method=delta_x_method,
            physical_distance=physical_distance,
            physical_distance_selection=physical_distance_selection,
            max_train_cols=max_train_cols,
            fisher_z=True,
            lazy_cor=lazy_cor,
        )
        return jax.vmap(_lane_se)(xs, X, y, w)

    if mesh_info is None:
        compiled = jax.jit(run)
    else:
        # same lane-axis split as the sharded fit: each device runs the
        # Hessian pass only for its own lanes
        mesh, axis = mesh_info
        lane_spec = PartitionSpec(axis)
        rep = PartitionSpec()
        compiled = jax.jit(
            shard_map(
                run,
                mesh=mesh,
                in_specs=(rep, rep, rep, lane_spec, lane_spec),
                out_specs=lane_spec,
                check_vma=False,
            )
        )
    _CHUNK_SE_CACHE[key] = compiled
    return compiled


@jax.jit
def _lazy_cor_row(xn, i):
    """One correlation row from the normalised samples, exact unit
    self-correlation."""
    return (xn[:, i] @ xn).at[i].set(1.0)


class _LazyCorrelation:
    """Row-on-demand empirical correlation: cor[i, j] = xn[:, i]·xn[:, j].

    Holds only the (T, n) variance-normalised centred samples; a row is
    one (T,) x (T, n) matvec on device. Supports the row-access patterns
    the estimation pipeline uses (``cor[i, :]``, ``cor[i, j]``); whole-
    matrix reads raise rather than silently materialising n² floats
    (269 GB at the 259k half-degree grid — the size this class
    exists to avoid).
    """

    def __init__(self, xn) -> None:
        self._xn = xn
        n = int(xn.shape[1])
        self.shape = (n, n)
        self.dtype = xn.dtype

    @property
    def normalised_samples(self):
        """The (T, n) variance-normalised centred samples."""
        return self._xn

    def row(self, i: int):
        """Correlation row i as a device (n,) array."""
        return _lazy_cor_row(self._xn, int(i))

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            i, j = key
            if isinstance(i, (int, np.integer)):
                r = self.row(int(i))
                if isinstance(j, slice) and j == slice(None):
                    return r
                return r[j]
        raise TypeError(
            "lazy correlation supports cor[i, :] / cor[i, j] row access "
            "only; use .normalised_samples for bulk computation or "
            "cor_mode='dense' to materialise the full matrix"
        )

    def __array__(self, dtype=None, copy=None):
        raise MemoryError(
            f"refusing to materialise the {self.shape} lazy correlation "
            "(use cor_mode='dense' if it fits in memory)"
        )


class EllipseBuilder:
    """Build spatial covariance/correlation and fit ellipse parameters.

    `data_array` is a (time, lat, lon) cube (numpy or numpy.ma masked;
    NaNs also count as masked). `coords` must contain "time", "latitude",
    "longitude" with time as dimension 0. Points masked at ANY time are
    dropped (parity: reference ``estimate.py:119-149``).

    A `jax.Array` cube stays ON DEVICE end-to-end: the mask is detected
    by a device reduction (NaN = masked; only the small (lat, lon) bool
    map is fetched), the kept columns are a device gather, and
    ``self.data`` remains the device array, with no device->host->device
    round-trip of the training cube for mask bookkeeping.

    `cor_mode` controls the empirical correlation representation:
    ``"dense"`` materialises the (n, n) matrix on device (reference
    semantics; ~8 GB at the 1-degree 44k-point scale), ``"lazy"`` keeps
    only the (T, n) normalised samples and rebuilds correlation rows
    on demand inside the fit programs (exact same values; the only
    path that scales past ~10^5 points), ``"auto"`` (default) picks
    lazy above 100,000 unmasked points.
    """

    def __init__(
        self, data_array: np.ndarray, coords, cor_mode: str = "auto"
    ) -> None:
        if cor_mode not in ("auto", "dense", "lazy"):
            raise ValueError("cor_mode must be 'auto', 'dense' or 'lazy'")
        self.cor_mode = cor_mode
        if isinstance(data_array, jax.Array):
            self.data = data_array  # device-resident path
        elif isinstance(data_array, np.ma.MaskedArray):
            self.data = data_array
        else:
            self.data = np.ma.MaskedArray(data_array)
        self.coords = coords
        self.xy_shape = tuple(self.data.shape[1:])
        if len(self.xy_shape) != 2:
            raise ValueError(
                "Time slice maps should be 2D; check extra dims (ensemble?)"
            )
        self.big_covar_size = int(np.prod(self.xy_shape))

        self._parse_coords()
        self._detect_mask()
        self.calc_cov()

    # -- setup ---------------------------------------------------------------
    def _parse_coords(self) -> None:
        names = list(self.coords.keys())
        if "time" not in names:
            raise ValueError("Input cube needs a time dimension")
        if names.index("time") != 0:
            raise ValueError("Input cube time dimension not at 0")
        missing = [
            c for c in ("latitude", "longitude") if c not in names
        ]
        if missing:
            raise ValueError(
                "Input cube need two spatial dimensions "
                "('latitude' and 'longitude')"
            )
        lons = np.asarray(self.coords["longitude"])
        lats = np.asarray(self.coords["latitude"])
        self.xx, self.yy = np.meshgrid(lons, lats)
        self.xi, self.yi = np.meshgrid(
            np.arange(len(lons)), np.arange(len(lats))
        )
        self.time_n = len(np.asarray(self.coords["time"]))

    def _detect_mask(self) -> None:
        if isinstance(self.data, jax.Array):
            # device cube: NaN = masked; fetch only the (lat, lon) map
            self.mask = np.asarray(
                jnp.any(jnp.isnan(self.data), axis=0)
            )
            self.data_has_mask = bool(self.mask.any())
            self.mask_1D = self.mask.flatten()
            self.small_covar_size = int(np.sum(~self.mask))
        else:
            nan_mask = np.isnan(np.ma.getdata(self.data))
            base_mask = np.ma.getmaskarray(self.data) | nan_mask
            self.data = np.ma.masked_where(base_mask, self.data)
            self.data_has_mask = bool(base_mask.any())
            if self.data_has_mask:
                # time-varying masks (sea ice): any-time-masked dropped
                self.mask = np.any(base_mask, axis=0)
                self.mask_1D = self.mask.flatten()
                self._self_mask()
                self.small_covar_size = int(np.sum(~self.mask))
            else:
                self.mask = np.zeros(self.xy_shape, dtype=bool)
                self.mask_1D = self.mask.flatten()
                self.small_covar_size = self.big_covar_size
        self.x_masked = np.ma.masked_where(self.mask, self.xx)
        self.y_masked = np.ma.masked_where(self.mask, self.yy)
        self.xi_masked = np.ma.masked_where(self.mask, self.xi).compressed()
        self.yi_masked = np.ma.masked_where(self.mask, self.yi).compressed()
        self.xy_masked = np.column_stack(
            [self.x_masked.compressed(), self.y_masked.compressed()]
        )
        self.xy_full = np.column_stack(
            [self.x_masked.flatten(), self.y_masked.flatten()]
        )

    def _self_mask(self) -> None:
        broadcasted = np.broadcast_to(self.mask, self.data.shape)
        self.data = np.ma.masked_where(broadcasted, self.data)

    def calc_cov(self, rounding: int | None = None) -> None:
        """Empirical covariance/correlation over time — one matmul.

        cov = X'X/(T-1) with the temporal mean removed, over unmasked
        points only (parity: reference ``estimate.py:151-180``).

        Memory/transfer design: only the CORRELATION is materialised
        (directly, from variance-normalised samples — one matmul), it
        stays DEVICE-resident (at 1-degree scale it is ~8 GB, so a host
        round-trip would dominate the whole build, and holding cov AND
        cor doubles the device memory), and
        ``cov`` is a lazy property recomputed from the retained (T, n)
        centred samples on access. numpy consumers go through
        ``__array__`` transparently. Past ~10^5 points (``cor_mode
        "auto"``/"lazy") even the single correlation buffer is too big
        (269 GB at 259k): ``self.cor`` becomes a
        :class:`_LazyCorrelation` that rebuilds rows on demand, and the
        batched fit rebuilds each chunk's rows inside its compiled
        program.
        """
        if isinstance(self.data, jax.Array):
            flat = self.data.reshape((self.time_n, self.big_covar_size))
            if self.data_has_mask:
                # device gather of the kept columns (static host index)
                keep = jnp.asarray(np.where(~self.mask_1D)[0])
                x = flat[:, keep]
            else:
                x = flat
        else:
            flat = self.data.reshape(
                (self.time_n, self.big_covar_size)
            )
            kept = np.ma.getdata(flat)[:, ~self.mask_1D]
            x = jnp.asarray(kept)
        x = x - jnp.mean(x, axis=0, keepdims=True)
        self._x_centered = x
        self._rounding = rounding
        self._cov_diagonal = None  # derived cache: invalidate on recompute
        lazy = self.cor_mode == "lazy" or (
            self.cor_mode == "auto" and self.small_covar_size > 100_000
        )
        if rounding is not None:
            if lazy:
                # covers cor_mode="auto" past the size threshold too —
                # falling through would attempt the dense (n, n)
                # materialisation this mode exists to avoid
                raise ValueError(
                    "rounding requires the dense correlation "
                    "(cor_mode='dense')"
                )
            # rare parity path (reference rounds cov before normalising)
            self.cor = cov_2_cor(
                jnp.round(self._cov_matrix(), rounding), rounding=rounding
            )
            return
        if lazy:
            self.cor = _LazyCorrelation(_normalised_samples(x))
            return
        # one fused dispatch: under jit the unit-diagonal write updates
        # the matmul result IN PLACE — eager .at[].set would allocate a
        # second n x n buffer (2 x 7.9 GB transient at 1 degree = OOM)
        self.cor = _correlation_from_centred(x)

    def _cov_matrix(self):
        x = self._x_centered
        cov = (x.T @ x) / (self.time_n - 1)
        if getattr(self, "_rounding", None) is not None:
            cov = jnp.round(cov, self._rounding)
        return cov

    @property
    def cov(self):
        """Empirical covariance (lazy: rebuilt from the centred samples
        on access — one matmul — so the n x n array is not pinned in
        memory alongside ``cor``)."""
        return self._cov_matrix()

    @property
    def cov_diagonal(self):
        """diag of the empirical covariance without forming it.

        Cached as HOST data: the per-point parity path reads one entry
        per fit, and an uncached device einsum + sync per read costs a
        device round-trip each.
        """
        cached = getattr(self, "_cov_diagonal", None)
        if cached is None:
            x = self._x_centered
            cached = np.asarray(
                jnp.einsum("tn,tn->n", x, x) / (self.time_n - 1)
            )
            self._cov_diagonal = cached
        return cached

    # -- training data (parity helper; batched path builds masks inline) ----
    def _train_geometry(
        self,
        centre_sel,
        min_distance: float,
        max_distance: float,
        anisotropic: bool,
        delta_x_method: DeltaXMethod | None,
        physical_distance: bool,
        physical_distance_selection: bool,
    ):
        """Displacements/selection geometry for a batch of centre points.

        Returns (X, weights): X is (B, N, 2) for anisotropic models or
        (B, N) distances for isotropic ones; weights the (B, N) 0/1
        selection mask — replicating the three selection regimes of
        reference ``estimate.py:424-513``. Delegates to the traceable
        module-level :func:`_train_geometry_arrays`.
        """
        return _train_geometry_arrays(
            jnp.asarray(self.xy_masked[:, 1]),
            jnp.asarray(self.xy_masked[:, 0]),
            centre_sel,
            min_distance=min_distance,
            max_distance=max_distance,
            anisotropic=anisotropic,
            delta_x_method=delta_x_method,
            physical_distance=physical_distance,
            physical_distance_selection=physical_distance_selection,
        )

    def _get_train_data(
        self,
        xy_point: int,
        min_distance: float,
        max_distance: float,
        anisotropic: bool,
        delta_x_method: DeltaXMethod | None,
        physical_distance: bool = True,
        physical_distance_selection: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(X_train, y_train) for one centre point (reference-shaped)."""
        X, w = self._train_geometry(
            jnp.asarray([xy_point]),
            min_distance,
            max_distance,
            anisotropic,
            delta_x_method,
            physical_distance,
            physical_distance_selection,
        )
        sel = np.asarray(w[0]) > 0
        y = np.asarray(self.cor[xy_point, :])[sel]
        X0 = np.asarray(X[0])
        return (X0[sel, :] if anisotropic else X0[sel]), y

    # -- fitting --------------------------------------------------------------
    def fit_ellipse_model(
        self,
        xy_point: int,
        matern_ellipse: EllipseModel,
        max_distance: float = 6000,
        min_distance: float = 0.3,
        delta_x_method: DeltaXMethod | None = "Modified_Met_Office",
        guesses=None,
        bounds=None,
        opt_method: str = "Nelder-Mead",
        tol: float = 0.001,
        estimate_SE: str | None = None,
        n_jobs: int | None = None,
        n_sim: int = 500,
        physical_distance_selection: bool = True,
    ) -> dict[str, Any] | None:
        """Fit the ellipse model at one grid point.

        Returns a dict with the fitted parameters (ModelParams ordered as
        the model's supercategory fields), QC code, iteration count,
        standard deviation, and the observed correlation map — or None
        when no training data falls in the distance window (parity:
        reference ``estimate.py:187-400``).
        """
        R2 = uncompress_masked(
            np.asarray(self.cor[xy_point, :]),
            self.mask_1D,
            fill_value=np.nan,
        ).reshape(self.xy_shape)

        X_train, y_train = self._get_train_data(
            xy_point=xy_point,
            min_distance=min_distance,
            max_distance=max_distance,
            anisotropic=matern_ellipse.anisotropic,
            delta_x_method=delta_x_method,
            physical_distance=matern_ellipse.physical_distance,
            physical_distance_selection=physical_distance_selection,
        )
        if len(y_train) == 0:
            warn(f"No training data for idx {xy_point}")
            return None

        results, SE, bounds_out = matern_ellipse.fit(
            X_train,
            y_train,
            guesses=guesses,
            bounds=bounds,
            opt_method=opt_method,
            tol=tol,
            estimate_SE=estimate_SE,
            n_sim=n_sim,
        )

        model_params = np.asarray(results.x).tolist()
        self._check_params(matern_ellipse, model_params)

        stdev = None
        if not matern_ellipse.unit_sigma:
            stdev = model_params.pop()

        if bool(results.success):
            fit_success = _get_fit_score(
                model_params, bounds_out, int(results.nit)
            )
        else:
            fit_success = 9

        std_dev = float(np.sqrt(self.cov_diagonal[xy_point]))
        model_params.append(std_dev)
        model_params.append(fit_success)
        model_params.append(int(results.nit))

        return {
            "Correlation": R2,
            "Results": results,
            "ModelParams": model_params,
            "Success": fit_success,
            "StandardDeviation": std_dev,
            "StandardError": SE,
            "RMSE": stdev,
        }

    def _check_params(self, ellipse: EllipseModel, model_params) -> None:
        """Canonicalise: ensure Lx >= Ly and theta in (-pi, pi] (in place).

        Note: the reference applies the +pi/2 rotation on a Lx/Ly swap
        unconditionally for anisotropic models (``estimate.py:402-422``),
        which for the un-rotated 2-parameter form would corrupt the
        appended likelihood-sigma slot; here the rotation adjustment only
        applies to rotated models.
        """
        if ellipse.anisotropic and model_params[1] > model_params[0]:
            model_params[0], model_params[1] = (
                model_params[1],
                model_params[0],
            )
            if ellipse.rotated:
                model_params[2] += np.pi / 2
        if not ellipse.rotated:
            return
        if model_params[2] > np.pi:
            model_params[2] -= np.pi
        if model_params[2] <= -np.pi:
            model_params[2] += np.pi

    def compute_params(  # noqa: C901
        self,
        default_value: Any,
        matern_ellipse: EllipseModel,
        max_distance: float = 6000,
        min_distance: float = 0.3,
        delta_x_method: DeltaXMethod | None = "Modified_Met_Office",
        guesses=None,
        bounds=None,
        opt_method: str = "Nelder-Mead",
        tol: float = 1e-4,
        estimate_SE: str | None = None,
        n_jobs: int | None = None,
        n_sim: int = 500,
        physical_distance_selection: bool = True,
        chunk_size: int = 1024,
        max_train_cols: int | None = None,
        checkpoint: str | None = None,
        checkpoint_every: int = 8,
        dispatch_chunks: int = 1,
        mesh=None,
        mesh_axis: str = "grid",
    ) -> Dataset:
        """Fit ellipses at ALL unmasked grid points — batched on device.

        One compiled program fits `chunk_size` points at a time with the
        vmapped Nelder-Mead; the sequential per-point scipy loop of the
        reference collapses into ceil(N/chunk) device launches. Returns a
        Dataset of parameter fields (qc_code semantics: 0 ok / 1 lower
        bound / 2 upper bound / 3 multiple bounds / 9 no convergence or
        no training data).

        `estimate_SE="hessian"` adds Fisher-information standard-error
        fields (``Lx_se``/``Ly_se``/``theta_se``/``R_se``) to the
        returned Dataset: each converged lane's autodiff Hessian of the
        same weighted objective, inverted on device. The SE pass runs
        as its own jitted per-chunk program AFTER the fit (the fit
        program stays byte-identical, so its compile cache still hits;
        fusing the Hessian into the fit scan made the
        production-shape compile take minutes). The
        reference cannot produce these at all (its whole-grid loop
        discards SEs, and its single-point Hessian raises
        ``NotImplementedError``). Bound-pinned or failed lanes get NaN.
        The bootstrap values of `estimate_SE` (and `n_jobs`/`n_sim`)
        are accepted for signature parity but ignored here — use
        ``fit_ellipse_model`` for a single point's bootstrap SE.

        `opt_method` "Nelder-Mead" (default, reference parity), "lm"
        (Levenberg-Marquardt on the exact Fisher-z least-squares form
        of the likelihood — same optimum, ~20 damped Gauss-Newton
        iterations instead of hundreds of simplex steps, with per-lane
        damping so nothing lockstep-stalls), or "L-BFGS-B"
        (gradient-based; available because K_nu is differentiable JAX).
        NM stays the default (the vmapped L-BFGS linesearch
        synchronises across the batch); LM's value is fewer objective
        evaluations when the per-evaluation data is large, and gradient
        access. ``bench_reference_configs`` times all three.

        `max_train_cols` caps the training correlations per fit to the
        K nearest in-window grid points (static-shape top-k gather).
        Whole-grid cost scales as n_points x n_cols, so at 1-degree
        scale (~40k x ~40k) the unrestricted fit is ~170x the 5-degree
        one; K = 4096 keeps every fit's window out to ~3500 km while
        cutting the NLL work ~10x. When the distance window holds fewer
        than K points this equals the unrestricted fit (up to float
        reassociation from the gather's column reorder — pinned by
        test); None (default) = reference semantics, all columns.

        `checkpoint` (a file path) makes the whole-grid fit RESUMABLE:
        every `checkpoint_every` chunks the accumulated per-point
        results are flushed to an ``.npz`` (written atomically), and a
        rerun with the same configuration continues from the last saved
        chunk instead of refitting — a fully-saved checkpoint returns
        without touching the device. The stage is minutes at 0.25
        degrees and hours at 0.1, so production runs should always set
        this (the reference's precompute-and-persist idiom,
        ``glomar_gridding/io.py:34-100``, applied to the fit itself).
        A checkpoint records a fingerprint of the fit configuration
        (grid size, model, optimiser, chunking, window) and refuses to
        resume a run whose configuration differs. Flushes are batched
        so the device pipeline is not serialised on host fetches.

        `dispatch_chunks` runs that many consecutive chunks as ONE
        jitted ``lax.scan`` dispatch — the same per-chunk computation
        (results agree to float tolerance; XLA's scan scheduling can
        shift an optimiser termination by an iteration), with the
        per-dispatch overhead paid once per group. Memory is
        unchanged: the
        (B, N) training temps are
        scan-internal and reused across iterations. Use 4-16 for
        production whole-grid fits; 1 (default) keeps the single-chunk
        dispatch granularity.

        `mesh` (a ``jax.sharding.Mesh``) runs the fit MULTI-CHIP: the
        chunk's lane axis is ``shard_map``-split over ``mesh_axis``, so
        each device rebuilds training rows and runs the batched
        optimiser only for its own ``chunk_size / n_dev`` grid points —
        the fits are independent, so there are no collectives at all
        and wall-time scales linearly in device count (the training
        cube/correlation is replicated per device; per-device (B, N)
        fit temps shrink by n_dev, so `chunk_size` may be raised by
        the same factor). This is the 0.1-degree scaling path. The
        single-chip rate is MEASURED at two grid octaves
        (driver-recorded): 0.22 s per warm 1024-fit chunk at
        n=259,200 (``lazy_mle_259k``) and 0.136 s per warm 256-fit
        chunk at n=1,036,800 (``lazy_mle_1M`` — whole-1M-grid ~9.2
        min one chip; the per-fit wall grows ~2.5x per 4x grid
        because the lazy correlation rows lengthen with n, which is
        why the 259k-rate-only projection of round 4 — "~24 min at
        6.48M" — was optimistic). Scaling the measured 1M per-fit
        rate to 6.48M fits gives ~1 h single-chip as a LOWER bound
        (the row-length growth continues past 1M), / n_dev on a
        mesh; only the 8-device CPU-mesh parity and dryrun are
        hardware-verified (one real chip in this environment); a
        pod-slice wall has not been measured.
        `chunk_size` is rounded down to a multiple of the axis size.
        Sharded-vs-single-program parity is pinned on the 8-device CPU
        mesh (`tests/test_parallel.py`).
        """
        if opt_method not in (
            "Nelder-Mead",
            "L-BFGS-B",
            "L-BFGS",
            "lbfgs",
            "lm",
            "Levenberg-Marquardt",
        ):
            raise ValueError(
                "opt_method must be 'Nelder-Mead', 'L-BFGS-B' or 'lm'"
            )
        use_lbfgs = opt_method in ("L-BFGS-B", "L-BFGS", "lbfgs")
        use_lm = opt_method in ("lm", "Levenberg-Marquardt")
        coords = Coordinates(
            {
                "latitude": np.asarray(self.coords["latitude"]),
                "longitude": np.asarray(self.coords["longitude"]),
            }
        )
        param_names = matern_ellipse.supercategory_params
        params = init_parameter_set(
            coords, parameters=param_names, default_value=default_value
        )

        n_points = len(self.xi_masked)
        if n_points == 0:
            return params

        # the per-chunk build materialises (B, N)-shaped geometry and a
        # packed top-k payload — ~32 B bytes per (B, N) pair at f32.
        # Cap B so those temps stay under ~10 GB of device memory: at
        # the half-degree (259k) grid, B = 2048 peaks at 15.8 GB while
        # B = 1024 fits with headroom. Under a mesh
        # the lane axis is split n_dev ways, so the PER-DEVICE temp is
        # (B/n_dev, N) and the cap scales up by n_dev.
        n_dev = 1 if mesh is None else int(mesh.shape[mesh_axis])
        cap = max(256, int(10e9 * n_dev / (32 * n_points)))
        if chunk_size > cap:
            cap -= cap % 256
            warn(
                f"chunk_size {chunk_size} -> {cap}: (B, N) fit temps "
                f"at N={n_points} would exceed device memory"
            )
            chunk_size = cap
        if mesh is not None:
            rounded = max(n_dev, chunk_size - chunk_size % n_dev)
            if rounded != chunk_size:
                warn(
                    f"chunk_size {chunk_size} -> {rounded}: the sharded "
                    f"fit needs a multiple of the {mesh_axis!r} axis "
                    f"size {n_dev}"
                )
                chunk_size = rounded

        x0_single, (lo, hi), bounds_out = matern_ellipse._fit_setup(
            guesses, bounds
        )
        d = x0_single.shape[0]
        lazy = isinstance(self.cor, _LazyCorrelation)
        cor_dev = (
            self.cor.normalised_samples if lazy else jnp.asarray(self.cor)
        )
        lats_all_dev = jnp.asarray(self.xy_masked[:, 1])
        lons_all_dev = jnp.asarray(self.xy_masked[:, 0])

        # Bound method (NOT a local closure): hashes stably, so the
        # jitted batched optimiser compiles once per model instance.
        # The _z objectives take Fisher-transformed observations
        # precomputed once per chunk (see _chunk_train_data).
        fun = matern_ellipse._nll_fit_z

        # --- checkpoint/resume ------------------------------------------------
        # Host-side accumulators hold FETCHED results for [0, n_done);
        # `pending` holds device results not yet flushed. The fingerprint
        # pins every input that changes the per-point answer or the
        # chunk alignment — including a checksum of the TRAINING DATA
        # itself (two device reductions, one scalar fetch each, rounded
        # so reduction-order jitter can't refuse a legitimate resume):
        # without it, a checkpoint written against a different training
        # cube would silently return the old cube's fits.
        xc = self._x_centered
        data_sum = float(f"{float(jnp.sum(xc)):.6e}")
        data_sumsq = float(f"{float(jnp.sum(xc * xc)):.6e}")
        fingerprint = json.dumps(
            {
                "n_points": n_points,
                "data": [int(xc.shape[0]), data_sum, data_sumsq],
                "model": matern_ellipse.model_type,
                "opt": opt_method,
                "chunk": chunk_size,
                "d": d,
                "tol": tol,
                "win": [float(min_distance), float(max_distance)],
                "cols": max_train_cols,
                "dx": delta_x_method,
                "phys_sel": bool(physical_distance_selection),
                "x0": np.asarray(x0_single).tolist(),
                "lo": np.asarray(lo).tolist(),
                "hi": np.asarray(hi).tolist(),
            },
            sort_keys=True,
        )
        host_parts: dict[str, list[np.ndarray]] = {
            "x": [], "nit": [], "success": [], "has_data": []
        }
        n_done = 0
        if checkpoint is not None and os.path.exists(checkpoint):
            with np.load(checkpoint) as data:
                saved_fp = str(data["fingerprint"])
                if saved_fp != fingerprint:
                    # Distinguish a LIBRARY fingerprint-schema upgrade
                    # (different key set — e.g. an old checkpoint
                    # predating the training-data checksum) from a
                    # genuine configuration/data mismatch: the former
                    # refits fresh with a warning, the latter refuses —
                    # silently mixing fits is the failure mode the
                    # fingerprint exists to prevent.
                    try:
                        saved_keys = set(json.loads(saved_fp))
                    except (json.JSONDecodeError, TypeError):
                        # unparseable/corrupt fingerprint — NOT a known
                        # older format; refuse rather than scheduling
                        # the file for overwrite
                        saved_keys = None
                    if saved_keys is None or saved_keys == set(
                        json.loads(fingerprint)
                    ):
                        raise ValueError(
                            f"checkpoint {checkpoint!r} was written by "
                            "a fit with a different configuration — "
                            "delete it (or point elsewhere) to refit"
                        )
                    warn(
                        f"checkpoint {checkpoint!r} uses an older "
                        "fingerprint format; refitting from scratch "
                        "(the file will be overwritten)"
                    )
                else:
                    n_done = int(data["n_done"])
                    for name in host_parts:
                        host_parts[name].append(data[name][:n_done])
            if n_done:
                logger.info(
                    "resuming whole-grid fit from %s: %d/%d points done",
                    checkpoint, n_done, n_points,
                )

        pending: list[tuple] = []

        def _flush(save: bool) -> None:
            nonlocal n_done
            if pending:
                for (xs, nits_, succ, hd, n_keep) in pending:
                    host_parts["x"].append(np.asarray(xs)[:n_keep])
                    host_parts["nit"].append(np.asarray(nits_)[:n_keep])
                    host_parts["success"].append(
                        np.asarray(succ)[:n_keep]
                    )
                    host_parts["has_data"].append(np.asarray(hd)[:n_keep])
                    n_done += n_keep
                pending.clear()
            if save and checkpoint is not None:
                tmp = checkpoint + ".tmp.npz"
                np.savez(
                    tmp,
                    fingerprint=np.asarray(fingerprint),
                    n_done=np.asarray(n_done),
                    **{
                        name: np.concatenate(parts, axis=0)
                        if parts
                        else np.zeros((0,))
                        for name, parts in host_parts.items()
                    },
                )
                os.replace(tmp, checkpoint)

        # every dispatched row shares ONE static length: chunk_size when
        # the grid spans several chunks, else the single short chunk —
        # rounded UP to the mesh axis so the sharded fit can split a
        # sub-chunk-size grid (n_dev = 1 single-chip: unchanged)
        row_len = (
            chunk_size
            if n_points > chunk_size
            else -(-n_points // n_dev) * n_dev
        )

        def _sel_row(start):
            """(row_len,) padded centre indices + kept count."""
            stop = min(start + chunk_size, n_points)
            sel = np.arange(start, stop)
            if stop - start < row_len:
                sel = np.concatenate(
                    [sel, np.full(row_len - (stop - start), start)]
                )
            return sel, stop - start

        lane = "lm" if use_lm else ("lbfgs" if use_lbfgs else "nm")
        geo_cfg = (
            float(min_distance),
            float(max_distance),
            matern_ellipse.anisotropic,
            delta_x_method,
            matern_ellipse.physical_distance,
            bool(physical_distance_selection),
            max_train_cols,
            lazy,
        )
        mesh_info = None if mesh is None else (mesh, mesh_axis)
        group_fit = _group_fit_fn(
            fun, matern_ellipse._residuals_fit_z, lane, float(tol),
            geo_cfg, mesh_info,
        )
        group = max(1, int(dispatch_chunks))
        starts = list(range(n_done, n_points, chunk_size))
        for gstart in range(0, len(starts), group):
            gstarts = starts[gstart : gstart + group]
            rows = [_sel_row(s) for s in gstarts]
            # pad the last group with duplicate rows (n_keep=0) so every
            # group shares ONE compiled (G, B) program
            while len(rows) < group and len(starts) > group:
                rows.append((rows[-1][0], 0))
            sel_mat = jnp.asarray(np.stack([r[0] for r in rows]))
            xs, nits_d, succ_d, hd_d = group_fit(
                lats_all_dev,
                lons_all_dev,
                cor_dev,
                sel_mat,
                x0_single,
                lo,
                hi,
            )
            # keep results ON DEVICE: fetching here would block the next
            # group's dispatch behind this one's solve, serialising host
            # round-trips with device compute. The per-chunk
            # outputs are (B, d) and (B,) — holding every chunk costs
            # ~0.5 MB, while the (B, N) training temps are scan-internal
            # and freed on the device as each iteration completes.
            for g_i, (_, n_keep) in enumerate(rows):
                if n_keep == 0:
                    continue
                pending.append(
                    (xs[g_i], nits_d[g_i], succ_d[g_i], hd_d[g_i],
                     n_keep)
                )
            if checkpoint is not None and len(pending) >= checkpoint_every:
                _flush(save=True)

        _flush(save=checkpoint is not None)

        def _cat(name):
            parts = host_parts[name]
            return np.concatenate(parts, axis=0)

        fitted = _cat("x")
        nits = _cat("nit")
        successes = _cat("success")
        has_data = _cat("has_data")

        names = list(param_names.keys())
        for i in np.where(~has_data)[0]:
            warn(f"No training data for idx {i}")

        # Vectorised post-processing (identical semantics to the scalar
        # _check_params / _get_fit_score pipeline; a Python loop here
        # costs ~5 ms per 1k points x per-point overhead and would
        # dominate whole-grid fits at 1-degree scale).
        p = fitted.astype(float).copy()
        if matern_ellipse.anisotropic:
            swap = p[:, 1] > p[:, 0]
            p[swap, 0], p[swap, 1] = fitted[swap, 1], fitted[swap, 0]
            if matern_ellipse.rotated:
                p[swap, 2] += np.pi / 2
        if matern_ellipse.rotated:
            th = p[:, 2]
            th = np.where(th > np.pi, th - np.pi, th)
            th = np.where(th <= -np.pi, th + np.pi, th)
            p[:, 2] = th
        n_model = len(names) - 3  # minus stdev / qc / niter slots
        pm = p[:, :n_model]

        score = np.zeros(n_points, dtype=int)
        for j, bb in enumerate(bounds_out[:n_model]):
            a = pm[:, j]
            # math.isclose(a, b, rel_tol=0.01) semantics
            tol = 0.01 * np.maximum(np.abs(a), abs(bb[0]))
            left = np.abs(a - bb[0]) <= tol
            tol = 0.01 * np.maximum(np.abs(a), abs(bb[1]))
            right = np.abs(a - bb[1]) <= tol
            score = np.where(left, np.where(score == 0, 1, 3), score)
            score = np.where(right, np.where(score == 0, 2, 3), score)
        score = np.where(successes, score, 9)

        vals = np.column_stack(
            [
                pm,
                np.sqrt(np.asarray(self.cov_diagonal)[:n_points]),
                score.astype(float),
                nits.astype(float),
            ]
        )
        gj = np.asarray(self.yi_masked)[:n_points][has_data]
        gi = np.asarray(self.xi_masked)[:n_points][has_data]
        for k, name in enumerate(names):
            params[name].values[gj, gi] = vals[has_data, k]

        if estimate_SE == "hessian":
            # second pass: one jitted (chunk rebuild + vmapped autodiff
            # Hessian) dispatch per chunk, at the RAW optima (before the
            # Lx>=Ly canonicalisation) so the curvature matches the
            # objective actually minimised; SEs then swap with the axes
            se_fn = _chunk_se_fn(fun, geo_cfg, mesh_info)
            fitted_dev = jnp.asarray(fitted, lats_all_dev.dtype)
            se_pending = []
            for start in range(0, n_points, chunk_size):
                sel, n_keep = _sel_row(start)
                xs_chunk = fitted_dev[jnp.asarray(sel)]
                se_pending.append(
                    (
                        se_fn(
                            lats_all_dev, lons_all_dev, cor_dev,
                            jnp.asarray(sel), xs_chunk,
                        ),
                        n_keep,
                    )
                )
            ses = np.concatenate(
                [np.asarray(s)[:k] for s, k in se_pending], axis=0
            ).astype(float)
            # axis-swapped lanes swap their SEs with them
            if matern_ellipse.anisotropic:
                ses[swap, 0], ses[swap, 1] = (
                    ses[swap, 1].copy(), ses[swap, 0].copy()
                )
            ses[score == 9] = np.nan  # failed fits carry no information
            grid_shape = params[names[0]].values.shape
            for k in range(n_model):
                se_name = f"{names[k]}_se"
                field = np.full(grid_shape, np.nan, dtype=float)
                field[gj, gi] = ses[has_data, k]
                params[se_name] = DataArray(
                    field,
                    params[names[0]].coords,
                    name=se_name,
                    attrs={"units": param_names[names[k]]},
                )

        return params

    # -- lookups ---------------------------------------------------------------
    def find_nearest_xy_index_in_cov_matrix(
        self, lonlat, use_full: bool = False
    ) -> tuple[int, np.ndarray]:
        """Nearest covariance row/column index for a (lon, lat) position."""
        lon, lat, *_ = lonlat
        a = self.xy_full if use_full else self.xy_masked
        idx = int(((a[:, 0] - lon) ** 2.0 + (a[:, 1] - lat) ** 2.0).argmin())
        return idx, a[idx, :]

    def _xy_2_xy_full_index(self, xy_point: int) -> int:
        """Index within the full (uncompressed) flattened grid."""
        return int(
            np.argwhere(
                np.all(
                    (self.xy_full - self.xy_masked[xy_point, :]) == 0,
                    axis=1,
                )
            )[0]
        )

    def __str__(self) -> str:
        return str(self.__class__)


@partial(jax.jit, static_argnames=("k", "anisotropic"))
def _nearest_train_cols(X, y, w, k: int, anisotropic: bool):
    """Gather each centre's k nearest IN-WINDOW training columns.

    Out-of-window columns (w == 0) sort to the back (+inf distance); if
    a window holds fewer than k points the excess gathered columns keep
    w = 0 and never enter the weighted NLL, so whenever k covers the
    window the fit equals the unrestricted one (up to float
    reassociation from the column reorder).
    """
    if anisotropic:
        d2 = X[..., 0] ** 2 + X[..., 1] ** 2
    else:
        d2 = X * X
    d2 = jnp.where(w > 0, d2, jnp.inf)
    _, cols = jax.lax.top_k(-d2, k)  # (B, k), exact selection
    # ONE wide-slice gather instead of three: packing [X..., y, w] into
    # one payload gathers each index once instead of three times.
    payload = [X] if anisotropic else [X[..., None]]
    payload += [y[..., None], w[..., None]]
    packed = jnp.take_along_axis(
        jnp.concatenate(payload, axis=-1), cols[..., None], axis=1
    )
    y = packed[..., -2]
    w = packed[..., -1]
    X = packed[..., :-2] if anisotropic else packed[..., 0]
    return X, y, w


def _get_fit_score(model_params, bounds, niter) -> int:
    """QC code: 0 ok, 1 lower bound hit, 2 upper, 3 multiple, 9 fail."""
    fit_success = 0
    for model_param, bb in zip(model_params, bounds):
        left = math.isclose(model_param, bb[0], rel_tol=0.01)
        right = math.isclose(model_param, bb[1], rel_tol=0.01)
        if left:
            fit_success = 1 if fit_success == 0 else 3
        if right:
            fit_success = 2 if fit_success == 0 else 3
    return fit_success


def init_parameter_set(
    coords, parameters: dict[str, str], default_value: Any = np.nan
) -> Dataset:
    """Initialise the (lat, lon) parameter fields for an ellipse model.

    `parameters` maps field name -> unit; `default_value` is scalar or a
    per-field list (parity: reference ``estimate.py:779-821``).
    """
    from ...utils.arrays import is_iter

    if not is_iter(default_value):
        default_value = [default_value] * len(parameters)
    if len(default_value) != len(parameters):
        raise ValueError(
            "Cannot set 6 default values for input default values"
        )
    if not isinstance(coords, Coordinates):
        coords = Coordinates({k: np.asarray(v) for k, v in coords.items()})
    shape = coords.shape
    params = Dataset({}, coords)
    for i, (name, unit) in enumerate(parameters.items()):
        params[name] = DataArray(
            np.full(shape, default_value[i], dtype=float),
            coords,
            name=name,
            attrs={"units": unit},
        )
    return params
