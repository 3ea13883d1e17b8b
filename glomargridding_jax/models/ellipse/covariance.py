r"""Non-stationary anisotropic covariance assembly (Paciorek-Schervish).

Capability parity with reference ``ellipse/covariance.py``
(EllipseCovarianceBuilder): assemble the full N x N covariance from
per-gridpoint ellipse parameter fields via PS06 Eq. 8 / Karspeck Eq. 17:

.. math::
    c_{ij} = \sigma_i \sigma_j
        \frac{|\Sigma_i|^{1/4} |\Sigma_j|^{1/4}}{|\bar\Sigma|^{1/2}}
        \frac{(2\sqrt{\nu}\tau)^\nu K_\nu(2\sqrt{\nu}\tau)}
             {\Gamma(\nu) 2^{\nu-1}},
    \qquad \bar\Sigma = \tfrac{\Sigma_i + \Sigma_j}{2},

with :math:`\tau` the Mahalanobis distance of the Met-Office-convention
displacement under :math:`\bar\Sigma`.

The reference's three execution strategies (vectorised C(N,2) pair
list / pure loop / batched pairs, ``covariance.py:226-236``) collapse
into ONE tiled kernel over (row-block x col-block): per tile,
displacement -> sigma-bar quadratic form -> K_nu fuse into one
elementwise chain with no pair-index lists and no host round-trips.
``covariance_method`` is accepted for API parity and only tunes the
row-block size.
"""

import logging
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import RADIUS_OF_EARTH_KM
from ...ops.distances import sigma_rot_flat
from ...ops.sampling import Matvec
from ...ops.special import xv_kv
from ...types import CovarianceMethod, DeltaXMethod
from .stream_kernel import BLOCK as _KERNEL_BLOCK
from .stream_kernel import X_COLS as _KERNEL_COLS
from .stream_kernel import ellipse_matvec

logger = logging.getLogger(__name__)

TWO_PI = 2.0 * math.pi


def pair_values(
    row, col, v: float, delta_x_method: DeltaXMethod, max_dist, use_max_dist
):
    """PS06 covariance of every (row, column) pair, self-pairs zeroed.

    ``row`` and ``col`` each hold the seven per-point parameters
    (lat, lon in radians; Sigma rows s00, s01, s11; sqrt det Sigma;
    stdev) shaped to broadcast against each other, (B, 1) and (1, C).
    The XLA tile (``ellipse_covariance_block``) and the fused matvec
    kernel both evaluate exactly this algebra.
    """
    la_i, lo_i, s00_i, s01_i, s11_i, sd_i, sg_i = row
    la_j, lo_j, s00_j, s01_j, s11_j, sd_j, sg_j = col

    dy = la_i - la_j
    dx = lo_i - lo_j
    dx = jnp.where(dx > math.pi, dx - TWO_PI, dx)
    dx = jnp.where(dx < -math.pi, dx + TWO_PI, dx)
    if delta_x_method == "Modified_Met_Office":
        dx = dx * (0.5 * (jnp.cos(la_i) + jnp.cos(la_j)))
    elif delta_x_method != "Met_Office":
        raise ValueError(
            f"Unknown 'delta_x_method' value: {delta_x_method}"
        )
    dy = RADIUS_OF_EARTH_KM * dy
    dx = RADIUS_OF_EARTH_KM * dx

    s00 = 0.5 * (s00_i + s00_j)
    s01 = 0.5 * (s01_i + s01_j)
    s11 = 0.5 * (s11_i + s11_j)
    det_bar = s00 * s11 - s01 * s01

    # Per-PAIR slow ops are the cost of the sweep: one rsqrt supplies
    # both 1/sqrt(det_bar) (pref) and 1/det_bar = rsqrt^2 (quad); the
    # per-point amplitude stdev * det^(1/4) is hoisted out of the pairs.
    r_det = jax.lax.rsqrt(det_bar)
    amp_i = sg_i * jnp.sqrt(sd_i)
    amp_j = sg_j * jnp.sqrt(sd_j)
    pref = (
        (amp_i * amp_j) / (math.gamma(v) * (2.0 ** (v - 1.0)))
    ) * r_det

    quad = (
        dx * (dx * s11 - dy * s01) + dy * (dy * s00 - dx * s01)
    ) * (r_det * r_det)
    tau = jnp.sqrt(jnp.clip(quad, 0.0, None))
    inner = (2.0 * math.sqrt(v)) * tau
    # fused x^v K_v (one exp for half-integer v); inner==0 / NaN
    # sanitised just below
    corr = xv_kv(v, inner)
    out = pref * corr
    # zero displacement (diagonal) and any non-finite garbage -> 0
    out = jnp.where(inner > 0.0, out, jnp.zeros_like(out))
    out = jnp.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)

    if use_max_dist:
        # haversine cutoff with ZERO per-pair transcendentals:
        # dist > max_dist <=> a > sin^2(max_dist / 2R) (asin is
        # monotone), with a = sin^2(dlat/2) + cos cos sin^2(dlon/2)
        # and each half-angle sine expanded through per-POINT
        # HALF-angle trig: sin((x-y)/2) = sh_x ch_y - ch_x sh_y.
        # The squared-difference form is f32-stable at ANY cutoff —
        # the earlier (1 - cos(x-y))/2 expansion cancelled
        # catastrophically (abs error ~1e-7 vs a_thresh ~6e-7 at a
        # 10 km cutoff -> boundary misplaced by ~8% of the radius);
        # here the per-pair rounding lands BEFORE the square, so the
        # error in a is ~2*sqrt(a)*eps (relative, not absolute).
        if isinstance(max_dist, (int, float)):
            half = min(max_dist / (2.0 * RADIUS_OF_EARTH_KM), 0.5 * math.pi)
            a_thresh = math.sin(half) ** 2
        else:
            half = jnp.minimum(
                max_dist / (2.0 * RADIUS_OF_EARTH_KM), 0.5 * math.pi
            )
            a_thresh = jnp.sin(half) ** 2  # scalar, once per tile
        shla_i, chla_i = jnp.sin(0.5 * la_i), jnp.cos(0.5 * la_i)
        shla_j, chla_j = jnp.sin(0.5 * la_j), jnp.cos(0.5 * la_j)
        shlo_i, chlo_i = jnp.sin(0.5 * lo_i), jnp.cos(0.5 * lo_i)
        shlo_j, chlo_j = jnp.sin(0.5 * lo_j), jnp.cos(0.5 * lo_j)
        sdlat = shla_i * chla_j - chla_i * shla_j
        sdlon = shlo_i * chlo_j - chlo_i * shlo_j
        cli = 1.0 - 2.0 * shla_i * shla_i  # cos(la) from half-angle
        clj = 1.0 - 2.0 * shla_j * shla_j
        a = sdlat * sdlat + (cli * clj) * (sdlon * sdlon)
        out = jnp.where(a > a_thresh, jnp.zeros_like(out), out)
    return out


@partial(
    jax.jit,
    static_argnames=("v", "delta_x_method", "use_max_dist"),
)
def ellipse_covariance_block(
    lat_i,
    lon_i,
    sig_i,
    sqrt_det_i,
    stdev_i,
    lat_j,
    lon_j,
    sig_j,
    sqrt_det_j,
    stdev_j,
    v: float,
    delta_x_method: DeltaXMethod = "Modified_Met_Office",
    max_dist: float = 0.0,
    use_max_dist: bool = False,
):
    """One (B_i x B_j) tile of the non-stationary covariance.

    lat/lon in radians; `sig_*` holds the flattened Sigma rows
    (s00, s01, s11) as a (B, 3) array; `sqrt_det_*` = |Sigma|^(1/2);
    v static. Entries at zero displacement (the diagonal of diagonal
    tiles) and beyond `max_dist` (haversine km) are 0.
    """
    row = (lat_i, lon_i, sig_i[:, 0], sig_i[:, 1], sig_i[:, 2],
           sqrt_det_i, stdev_i)
    col = (lat_j, lon_j, sig_j[:, 0], sig_j[:, 1], sig_j[:, 2],
           sqrt_det_j, stdev_j)
    out = pair_values(
        tuple(a[:, None] for a in row),
        tuple(a[None, :] for a in col),
        v, delta_x_method, max_dist, use_max_dist,
    )
    return out.astype(sig_i.dtype)


def _is_half_integer(v: float) -> bool:
    return abs(2 * v - round(2 * v)) < 1e-12 and round(2 * v) % 2 == 1


def build_ellipse_covariance(
    lats_rad,
    lons_rad,
    sig_flat,
    sqrt_dets,
    stdevs,
    v: float,
    delta_x_method: DeltaXMethod = "Modified_Met_Office",
    max_dist: float | None = None,
    row_block: int = 2048,
):
    """Assemble the full covariance by row-blocks of the tiled kernel.

    Adds diag(stdev^2) at the end. Memory high-water is
    row_block x N per launch.
    """
    n = len(lats_rad)
    lats_rad = jnp.asarray(lats_rad)
    lons_rad = jnp.asarray(lons_rad)
    sig_flat = jnp.asarray(sig_flat)
    sqrt_dets = jnp.asarray(sqrt_dets)
    stdevs = jnp.asarray(stdevs)
    use_md = max_dist is not None

    if n <= row_block:
        cov = ellipse_covariance_block(
            lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs,
            lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs,
            v=v,
            delta_x_method=delta_x_method,
            max_dist=0.0 if max_dist is None else float(max_dist),
            use_max_dist=use_md,
        )
        cov = cov + jnp.diag(stdevs**2)
        return cov

    blocks = []
    # pad to a whole number of row blocks so every launch shares a shape
    for start in range(0, n, row_block):
        stop = min(start + row_block, n)
        sl = slice(start, stop)
        blocks.append(
            ellipse_covariance_block(
                lats_rad[sl], lons_rad[sl], sig_flat[sl],
                sqrt_dets[sl], stdevs[sl],
                lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs,
                v=v,
                delta_x_method=delta_x_method,
                max_dist=0.0 if max_dist is None else float(max_dist),
                use_max_dist=use_md,
            )
        )
    cov = jnp.concatenate(blocks, axis=0)
    return cov + jnp.diag(stdevs**2)


@partial(
    jax.jit,
    static_argnames=(
        "v", "delta_x_method", "max_dist", "row_block"
    ),
)
def _assemble_covariance(
    Lx, Ly, theta, stdevs, lats_rad, lons_rad,
    *, v, delta_x_method, max_dist, row_block,
):
    """Sigma precompute + full covariance assembly in ONE compiled call."""
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, theta)
    sig_flat = jnp.stack([s00, s01, s11], axis=-1)
    sqrt_dets = jnp.sqrt(s00 * s11 - s01 * s01)
    return build_ellipse_covariance(
        lats_rad,
        lons_rad,
        sig_flat,
        sqrt_dets,
        stdevs,
        v=v,
        delta_x_method=delta_x_method,
        max_dist=max_dist,
        row_block=row_block,
    )


class EllipseCovarianceBuilder:
    """Covariance from ellipse parameter fields and positions.

    Valid (unmasked) points only enter the matrix; `max_dist` (haversine
    km) zeroes covariance beyond the radius; `precision` defaults to
    float32 (memory-driven, like the reference). `covariance_method`
    ("array" / "batched" / "low_memory") is accepted for API parity — all
    three run the same tiled device kernel, the value only selects the
    row-block size (whole-matrix / `batch_size` rows / 512 rows).

    Sets `cov_ns`; `calculate_cor` adds `cor_ns`; `uncompress_cov`
    re-inflates to the full grid with fill values.
    (Parity: reference ``ellipse/covariance.py:40-509``.)
    """

    def __init__(
        self,
        Lx,
        Ly,
        theta,
        stdev,
        lats,
        lons,
        v: float,
        delta_x_method: DeltaXMethod | None = "Modified_Met_Office",
        max_dist: float | None = None,
        precision=np.float32,
        covariance_method: CovarianceMethod = "array",
        batch_size: int | None = None,
    ) -> None:
        if max_dist is not None and not isinstance(max_dist, (int, float)):
            raise ValueError("max_dist must be a number")
        if delta_x_method not in ("Met_Office", "Modified_Met_Office"):
            raise ValueError(
                f"Unknown 'delta_x_method' value: {delta_x_method}"
            )

        self.v = float(v)
        self.precision = precision

        def as_masked(arr):
            return np.ma.MaskedArray(
                np.asarray(np.ma.getdata(arr), dtype=precision),
                np.ma.getmaskarray(arr),
            )

        self.Lx = as_masked(Lx)
        self.Ly = as_masked(Ly)
        self.theta = as_masked(theta)
        self.stdev = as_masked(stdev)
        self.max_dist = max_dist
        self.delta_x_method = delta_x_method
        self.lats = np.asarray(lats, dtype=precision)
        self.lons = np.asarray(lons, dtype=precision)
        self.covariance_method: CovarianceMethod = covariance_method
        self.batch_size = batch_size

        self.xy_shape = self.Lx.shape
        self.n_elements = int(np.prod(self.xy_shape))

        self._get_mask()
        self._calculate_covariance()

    def _get_mask(self) -> None:
        self.data_has_mask = bool(np.ma.getmaskarray(self.Lx).any())
        self.data_mask = np.ma.getmaskarray(self.Lx)
        self.covar_size = int(np.sum(~self.data_mask))

        self.Lx_compressed = self.Lx.compressed()
        self.Ly_compressed = self.Ly.compressed()
        self.theta_compressed = self.theta.compressed()
        self.stdev_compressed = self.stdev.compressed()

        self.x_grid, self.y_grid = np.meshgrid(self.lons, self.lats)
        self.x_mask = np.ma.masked_where(self.data_mask, self.x_grid)
        self.y_mask = np.ma.masked_where(self.data_mask, self.y_grid)
        self.lat_grid_compressed = self.y_mask.compressed()
        self.lon_grid_compressed = self.x_mask.compressed()
        self.lat_grid_compressed_rad = np.deg2rad(self.lat_grid_compressed)
        self.lon_grid_compressed_rad = np.deg2rad(self.lon_grid_compressed)

        self.xy_compressed = np.column_stack(
            [self.lon_grid_compressed, self.lat_grid_compressed]
        )
        self.xy_full = np.column_stack(
            [self.x_mask.flatten(), self.y_mask.flatten()]
        )

    def _row_block(self) -> int:
        n = len(self.Lx_compressed)
        match self.covariance_method:
            case "array":
                return max(n, 1)
            case "batched":
                if self.batch_size is None:
                    raise ValueError(
                        "batch_size must be set if using 'batched' method"
                    )
                return max(1, int(self.batch_size))
            case "low_memory":
                return 512
            case _:
                raise ValueError(
                    f"Unknown covariance_method: {self.covariance_method}"
                )

    @property
    def sigmas(self):
        """Per-point flattened 2x2 Sigma rows (parity attribute).

        Computed lazily on the host: assembly never needs the host copy,
        and fetching it eagerly used to cost four blocking device->host
        round-trips per build.
        """
        if getattr(self, "_sigmas", None) is None:
            ct = np.cos(self.theta_compressed)
            st = np.sin(self.theta_compressed)
            Lx2 = self.Lx_compressed**2
            Ly2 = self.Ly_compressed**2
            s00 = ct * ct * Lx2 + st * st * Ly2
            s01 = ct * st * (Lx2 - Ly2)
            s11 = st * st * Lx2 + ct * ct * Ly2
            self._sigmas = np.column_stack([s00, s01, s01, s11]).astype(
                self.precision
            )
        return self._sigmas

    @property
    def sqrt_dets(self):
        """Per-point sqrt(det Sigma) (parity attribute, lazy)."""
        if getattr(self, "_sqrt_dets", None) is None:
            s = self.sigmas
            self._sqrt_dets = np.sqrt(s[:, 0] * s[:, 3] - s[:, 1] * s[:, 2])
        return self._sqrt_dets

    def _calculate_covariance(self) -> None:
        self.gamma_v_term = math.gamma(self.v) * (2 ** (self.v - 1))
        self.sqrt_v_term = math.sqrt(self.v) * 2
        self._sigmas = None
        self._sqrt_dets = None

        # One fused jitted dispatch: Sigma precompute + tile assembly +
        # diagonal.
        cov = _assemble_covariance(
            jnp.asarray(self.Lx_compressed, self.precision),
            jnp.asarray(self.Ly_compressed, self.precision),
            jnp.asarray(self.theta_compressed, self.precision),
            jnp.asarray(self.stdev_compressed, self.precision),
            jnp.asarray(self.lat_grid_compressed_rad, self.precision),
            jnp.asarray(self.lon_grid_compressed_rad, self.precision),
            v=self.v,
            delta_x_method=self.delta_x_method,
            max_dist=self.max_dist,
            row_block=self._row_block(),
        )
        # Left on device: downstream consumers (eigenvalue clipping,
        # kriging) are device computations; numpy access works through
        # __array__ when host data is actually needed.
        self.cov_ns = cov.astype(self.precision)
        logger.info("Covariance assembled: %s", self.cov_ns.shape)

    def calculate_cor(self) -> None:
        """Correlation matrix from the covariance matrix."""
        from ...utils.arrays import cov_2_cor

        self.cor_ns = np.asarray(cov_2_cor(self.cov_ns))

    def uncompress_cov(
        self, diag_fill_value=np.nan, fill_value=np.nan
    ) -> None:
        """Re-inflate cov_ns to full-grid size with fill values."""
        self.cov_ns = np.asarray(self.cov_ns)
        if not np.sum(~self.data_mask) == self.cov_ns.shape[0]:
            raise ValueError("Data mask and coordinates cannot be aligned")
        fmask = np.logical_or.outer(
            self.data_mask.flatten(), self.data_mask.flatten()
        )
        uncompressed = np.full(
            fmask.shape, fill_value=fill_value, dtype=self.precision
        )
        np.fill_diagonal(uncompressed, diag_fill_value)
        uncompressed[~fmask] = self.cov_ns.flatten()
        self.cov_ns = uncompressed


def ellipse_covariance_operator(
    lats_rad,
    lons_rad,
    sig_flat,
    sqrt_dets,
    stdevs,
    v: float,
    delta_x_method: DeltaXMethod = "Modified_Met_Office",
    max_dist: float | None = None,
    n_blocks: int | None = None,
    store: str = "bf16",
):
    """Matvec-form non-stationary covariance: ``cov @ X`` with no f32
    n x n matrix ever materialised.

    This is what makes the 1-degree (65k) non-stationary pipeline fit on
    one chip: a dense f32 covariance is ~17 GB, but the device-scale
    PSD repair (``explained_variance_clip_lowrank``) and the low-rank
    solvers only ever need ``cov @ X``. Returns ``(matvec, n, trace)``
    ready to feed the clip; ``matvec`` is an ``ops.sampling.Matvec`` (a
    callable that splits into a static fn + array operands), so jit
    consumers like ``chebyshev_apply`` / ``estimate_spectral_range``
    pass the store as an argument instead of lowering it as an 8.4 GB
    program constant.

    store="bf16" (default): assemble once, block-by-block, into a
    HALF-memory bf16 matrix (65k^2 = 8.4 GB) with the exactly-known
    diagonal (stdev^2) kept out of the store and re-added in f32 —
    matvecs are single bf16 matmuls with f32 accumulation
    (``preferred_element_type``). Relative matvec error ~1e-3 (bf16
    mantissa), which perturbs clip eigenvalues by O(1e-3 ||C||) — noise
    relative to the statistical estimation error the clip exists to
    regularise.

    store="stream": nothing n x n at all — every application recomputes
    covariance tiles from the kernel under ``lax.scan`` (O(n * B)
    memory). Exact to f32, but each application pays the full n^2
    pair assembly; use when even the bf16 store is too big.

    With ``max_dist`` set, the stream is BANDED: a per-row-block
    contiguous column window is derived from latitude-interval bounds
    (central angle >= |dlat|, so any tile whose lat gap exceeds
    max_dist/R is provably all-zero) and tiles outside the window are
    never assembled. For lat-sorted point orders (the grid compression
    order) this cuts the per-application work to the band fraction.
    Results are EXACT vs the unbanded masked stream: omitted tiles
    contribute exact zeros. On a GPU, narrow applications (<= 16
    columns, half-integer v) run the fused Triton kernel
    (``stream_kernel.ellipse_matvec``), which builds each tile in
    registers and never writes it to device memory.

    (Capability beyond reference ``ellipse/covariance.py``, which
    requires the dense matrix and stops at ~10k points.)
    """
    lats_rad = jnp.asarray(lats_rad)
    lons_rad = jnp.asarray(lons_rad)
    sig_flat = jnp.asarray(sig_flat)
    sqrt_dets = jnp.asarray(sqrt_dets)
    stdevs = jnp.asarray(stdevs)
    n = int(lats_rad.shape[0])
    use_md = max_dist is not None
    md = 0.0 if max_dist is None else float(max_dist)
    diag = stdevs.astype(jnp.float32) ** 2
    trace = float(jnp.sum(diag))

    # Block size rounded UP to a multiple of 256 (an unaligned block
    # dimension once sent a compiler into a pathological layout path;
    # re-measuring it on the GPU is open). Default block: ~256 MB of
    # f32 tile per scan step regardless of n, so the build's working
    # set stays flat as grids grow past 65k.
    if n_blocks is None:
        block = max(256, (1 << 26) // max(n, 1))
        block = -(-block // 256) * 256
        block = min(block, -(-n // 256) * 256)
    else:
        block = -(-n // n_blocks)
        block = -(-block // 256) * 256
    n_blocks = -(-n // block)
    pad = n_blocks * block - n

    def _pad(a):
        return _pad_edge(a, pad)

    rows = tuple(
        _pad(a).reshape((n_blocks, block) + a.shape[1:])
        for a in (lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs)
    )
    cols = (lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs)

    # EVERY device array is an explicit jit ARGUMENT of the MODULE-LEVEL
    # jitted helpers below, never a closure capture: captured concrete
    # arrays are lowered as program constants, which (a) forces a
    # device->host copy per constant at trace time and (b) at 65k
    # embeds an 8.4 GB constant that exhausts device memory.
    # Module-level jits also mean re-creating the operator (e.g.
    # monthly) hits the compile cache instead of retracing closures.
    kparams = (v, delta_x_method, md, use_md)

    if store == "stream":
        # Column-band plan: 256-granularity contiguous windows for the
        # grouped XLA path and per-row-block [first, last] column-block
        # limits for the fused kernel. One small host fetch of the
        # latitudes; everything derived is static or a tiny int32
        # operand.
        n_cols_pad = -(-n // _COL_PAD) * _COL_PAD
        nk = n_cols_pad // _KERNEL_BLOCK
        lat_np = np.asarray(lats_rad, dtype=np.float64)
        lat_pad_np = (
            np.pad(lat_np, (0, pad), mode="edge") if pad else lat_np
        )
        if use_md:
            col_starts_np, bw, first_np, last_np = _stream_band_plan(
                lat_pad_np, lat_np, n, block, md, _STREAM_CHUNK,
                _KERNEL_BLOCK,
            )
            # the kernel's grid covers the padded columns too: give each
            # all-padding row block its own diagonal tile (its outputs
            # are sliced off)
            extra = np.arange(len(first_np), nk, dtype=np.int32)
            first_np = np.concatenate([first_np, extra])
            last_np = np.concatenate([last_np, extra])
        else:
            col_starts_np = np.zeros(n_blocks, np.int32)
            bw = n_cols_pad
            first_np = np.zeros(nk, np.int32)
            last_np = np.full(nk, nk - 1, np.int32)
        # the fused kernel compiles for the GPU only, and its pair
        # algebra needs the closed-form (half-integer v) Matern
        kernel = (
            "triton"
            if jax.default_backend() == "gpu" and _is_half_integer(v)
            else None
        )
        # Group row blocks for the wide path: ONE column slice per
        # group (not per row block — per-row dynamic slices break
        # XLA's assemble-into-matmul fusion and LOSE to the dense
        # stream). G (16-64, _stream_groups) keeps slices amortised
        # while each group's window is band + group latitude span; G is
        # re-derived from the rows-per-group so block-count padding
        # wastes at most rpg - 1 blocks (naive ceil wasted 25% at 65k).
        rpg = -(-n_blocks // min(n_blocks, _stream_groups(n_blocks)))
        G = -(-n_blocks // rpg)
        nb_pad = G * rpg
        gs, bwg = _group_windows(
            col_starts_np, bw, n_blocks, nb_pad, G, rpg,
            n_cols_pad, _STREAM_CHUNK,
        )
        rows_g = tuple(
            _pad_blocks_to(a, nb_pad).reshape(
                (G, rpg) + a.shape[1:]
            )
            for a in rows
        )
        banded = bwg < n_cols_pad
        cpad = n_cols_pad - n
        cols_p = tuple(_pad_edge(a, cpad) for a in cols)
        matvec = Matvec(
            _stream_fn(kparams, n, bwg, n_cols_pad, kernel, banded),
            *rows_g, *cols_p, diag,
            jnp.asarray(gs),
            jnp.asarray(first_np),
            jnp.asarray(last_np),
        )
        # work accounting for benches/rooflines: the pair counts each
        # path assembles per application
        matvec.band_stats = {
            "banded": banded,
            "bw": int(bw),
            "bwg": int(bwg),
            "n_cols_pad": int(n_cols_pad),
            # wide grouped scan: every (padded) row against its
            # group's bwg-wide window
            "wide_pairs": int(nb_pad) * int(block) * int(bwg),
            # fused kernel: every row block against its band
            "kernel_pairs": int((last_np - first_np + 1).sum())
            * _KERNEL_BLOCK * _KERNEL_BLOCK,
            "kernel": kernel,
        }
        return matvec, n, trace

    if store != "bf16":
        raise ValueError(f"Unknown store: {store!r}")
    A = _operator_build(rows, cols, kparams)
    fn = _BF16_MV_BY_N.setdefault(n, partial(_bf16_apply_nd, n))
    return Matvec(fn, A, diag), n, trace


def _hdot(tile, x):
    """tile @ x in full f32: the stream is exact to f32, and a
    default-precision f32 product may run as TF32 on the GPU (3.1e-4
    relative on the 8-column stream, measured on the H100)."""
    return jnp.matmul(tile, x, precision=jax.lax.Precision.HIGHEST)


def _op_tile(row_inputs, cols, kparams):
    la_b, lo_b, sig_b, sd_b, st_b = row_inputs
    la, lo, sg, sd, st = cols
    v, delta_x_method, md, use_md = kparams
    return ellipse_covariance_block(
        la_b, lo_b, sig_b, sd_b, st_b,
        la, lo, sg, sd, st,
        v=v,
        delta_x_method=delta_x_method,
        max_dist=md,
        use_max_dist=use_md,
    )


@partial(jax.jit, static_argnames=("kparams",))
def _operator_build(rows, cols, kparams):
    def per_block(_, inputs):
        return None, _op_tile(inputs, cols, kparams).astype(jnp.bfloat16)

    _, A = jax.lax.scan(per_block, None, rows)
    # Deliberately kept (n_blocks, block, n): reshaping the stacked
    # 8.5 GB store to 2-D can materialise a second copy (2x peak ->
    # OOM at 65k); the matvec batches over the leading axis instead
    # and reshapes only its small output.
    return A


def _bf16_apply_nd(n, A, diag, x):
    """ndim-polymorphic bf16-store application (``Matvec`` fn slot).

    A module-level function memoised per n (``_BF16_MV_BY_N``): as a
    ``Matvec.fn`` it hashes stably across operator re-creations, and
    the 8.4 GB store travels as a jit ARGUMENT of whatever consumer
    traces it (``chebyshev_apply``, ``estimate_spectral_range``, the
    clip) — never a lowered program constant (a bare closure here
    would embed the store and exhaust device memory on trace).
    """
    x2 = x if x.ndim == 2 else x[:, None]
    out = _operator_apply_bf16(A, diag, x2.astype(jnp.float32), n)
    return out if x.ndim == 2 else out[:, 0]


_BF16_MV_BY_N: dict = {}


_STREAM_MV_BY_KEY: dict = {}


def _stream_fn(kparams, n, bwg, n_cols_pad, kernel, banded):
    key = (kparams, n, bwg, n_cols_pad, kernel, banded)
    return _STREAM_MV_BY_KEY.setdefault(
        key, partial(_stream_apply_banded_nd, *key)
    )


def with_kernel_route(matvec, kernel):
    """The stream operator ``matvec`` with its narrow-x route fixed.

    ``kernel`` is None (the plain XLA stream, the version every kernel
    result is compared with), "triton" (the fused kernel compiled for
    the GPU) or "interpret" (the same kernel in the Pallas interpreter,
    for tests on the CPU). Operands are shared, not copied.
    """
    if kernel not in (None, "triton", "interpret"):
        raise ValueError(f"Unknown kernel route: {kernel!r}")
    kparams, n, bwg, n_cols_pad, _, banded = matvec.fn.args
    out = Matvec(
        _stream_fn(kparams, n, bwg, n_cols_pad, kernel, banded),
        *matvec.operands,
    )
    out.band_stats = dict(matvec.band_stats, kernel=kernel)
    return out


@partial(jax.jit, static_argnames=("n",))
def _operator_apply_bf16(A, diag, x2, n):
    y = jax.lax.dot_general(
        A,
        x2.astype(jnp.bfloat16),
        (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (n_blocks, block, k)
    y = y.reshape(-1, x2.shape[1])[:n]
    return y + diag[:, None] * x2


@partial(jax.jit, static_argnames=("kparams", "n"))
def _operator_apply_stream(rows, cols, diag, x2, kparams, n):
    def per_block(_, inputs):
        return None, _hdot(_op_tile(inputs, cols, kparams), x2)

    _, out = jax.lax.scan(per_block, None, rows)
    out = out.reshape(-1, x2.shape[1])[:n]
    return out + diag[:, None] * x2


# ---------------------------------------------------------------------------
# Banded stream + fused narrow-x kernel path
# ---------------------------------------------------------------------------
_STREAM_CHUNK = 256
# padded column count of the stream operator: a multiple of both the
# wide path's chunk and the fused kernel's block
_COL_PAD = 512


def _pad_edge(a, pad):
    if pad == 0:
        return a
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, widths, mode="edge")


# Row-block groups for the banded wide path. Each group's column
# window is band + the group's LATITUDE SPAN, so more groups mean a
# tighter window (fewer assembled pairs) but more column slices; too
# many groups degenerates toward per-row-block slices, which break
# XLA's assemble-into-matmul fusion. rpg >= 16 keeps every slice
# amortised over at least 16 row blocks; the cap of 64 groups was
# swept at 1M / W=640 / 3000 km on the previous accelerator and is
# still to be re-swept on the GPU.
_STREAM_GROUPS_MAX = 64


def _stream_groups(n_blocks):
    return max(16, min(_STREAM_GROUPS_MAX, n_blocks // 16))


def _stream_band_plan(
    lat_pad_np, lat_np, n, block, max_dist_km, chunk, chunk_p
):
    """Column-band certificates from latitude intervals (host, numpy).

    Central angle >= |dlat|, so haversine distance >= R |dlat|: any
    (row-block, column-chunk) pair whose latitude-interval gap exceeds
    max_dist / R contains ONLY entries the kernel's cutoff zeroes —
    omitting those tiles is exact. Returns

    - ``col_starts``: (n_blocks,) int32 element offsets of each row
      block's contiguous column window (chunk-aligned),
    - ``bw``: the static uniform window width (elements),
    - ``first``, ``last``: (ceil(n / chunk_p),) int32 first and last
      active ``chunk_p``-column block of each ``chunk_p``-row block,
      for the fused kernel (rows and columns are the same points).

    For lat-sorted point orders the windows are tight; for arbitrary
    orders they are conservative supersets (still exact, just wider).
    """
    thresh = max_dist_km / RADIUS_OF_EARTH_KM
    n_blocks = len(lat_pad_np) // block
    rlat = lat_pad_np.reshape(n_blocks, block)
    rmin, rmax = rlat.min(axis=1), rlat.max(axis=1)
    n_chunks = -(-n // chunk)
    cpad = n_chunks * chunk - n
    clat = (
        np.pad(lat_np, (0, cpad), mode="edge") if cpad else lat_np
    ).reshape(n_chunks, chunk)
    cmin, cmax = clat.min(axis=1), clat.max(axis=1)

    has, first, last = _interval_windows(
        rmin, rmax, cmin, cmax, thresh
    )
    bw_chunks = int((last - first + 1).max())
    start = np.minimum(first, n_chunks - bw_chunks).astype(np.int64)
    col_starts = (start * chunk).astype(np.int32)

    # chunk_p-granularity plan for the fused kernel: rows AND cols are
    # the points in chunk_p blocks, so every block is active against
    # itself (gap 0) and first <= i <= last
    n_p = -(-n // chunk_p)
    ppad = n_p * chunk_p - n
    plat = (
        np.pad(lat_np, (0, ppad), mode="edge") if ppad else lat_np
    ).reshape(n_p, chunk_p)
    pmin, pmax = plat.min(axis=1), plat.max(axis=1)
    _, first_p, last_p = _interval_windows(pmin, pmax, pmin, pmax, thresh)
    return (
        col_starts, bw_chunks * chunk,
        first_p.astype(np.int32), last_p.astype(np.int32),
    )


def _interval_windows(amin, amax, bmin, bmax, thresh):
    """Per row interval [amin_i, amax_i]: the first/last column
    interval j whose latitude gap is <= thresh (i.e. bmax_j >= amin_i -
    thresh AND bmin_j <= amax_i + thresh).

    When the column intervals are latitude-sorted — every lat-major
    grid order — the active set is contiguous and two searchsorted
    calls give the EXACT same windows as the pairwise scan in
    O((R + C) log C) instead of O(R*C): at 6.48M the pairwise gap
    matrix was 5.1 GB of f64 and ~100 s of the 145 s operator build.
    Unsorted orders take the pairwise fallback (conservative windows,
    identical to the original code).
    """
    if np.all(np.diff(bmin) >= 0.0) and np.all(np.diff(bmax) >= 0.0):
        first = np.searchsorted(bmax, amin - thresh, side="left")
        last = np.searchsorted(bmin, amax + thresh, side="right") - 1
        has = first <= last
        return (
            has,
            np.where(has, first, 0).astype(np.int64),
            np.where(has, last, 0).astype(np.int64),
        )
    gap = np.maximum(
        0.0,
        np.maximum(
            amin[:, None] - bmax[None, :], bmin[None, :] - amax[:, None]
        ),
    )
    active = gap <= thresh
    has = active.any(axis=1)
    nc = bmin.shape[0]
    first = np.where(has, np.argmax(active, axis=1), 0)
    last = np.where(
        has, nc - 1 - np.argmax(active[:, ::-1], axis=1), 0
    )
    return has, first.astype(np.int64), last.astype(np.int64)


def _group_windows(
    col_starts, bw, n_blocks, nb_pad, G, rpg, n_cols_pad, chunk
):
    """One (start, width) column window per row-block GROUP.

    The wide path slices the columns once per group (G of 16-64) instead of
    once per row block: per-row dynamic slices break XLA's
    assemble-into-matmul fusion (measured SLOWER than the dense
    stream), while per-group slices are amortised over rpg row blocks
    and the window only grows by the group's latitude span. Returns
    ((G,) int32 starts, uniform width bwg).
    """
    cs = np.asarray(col_starts, np.int64)
    if nb_pad > n_blocks:  # padding blocks repeat the last real block
        cs = np.concatenate(
            [cs, np.full(nb_pad - n_blocks, cs[-1], np.int64)]
        )
    cs = cs.reshape(G, rpg)
    gs = cs.min(axis=1)
    gend = (cs + bw).max(axis=1)
    bwg = int((gend - gs).max())
    bwg = min(-(-bwg // chunk) * chunk, n_cols_pad)
    gs = np.minimum(gs, n_cols_pad - bwg).astype(np.int32)
    return gs, bwg


def _pad_blocks_to(a, nb_pad):
    """Pad a (n_blocks, block, ...) stack to nb_pad blocks by repeating
    the last block (its outputs land past n and are discarded)."""
    extra = nb_pad - a.shape[0]
    if extra == 0:
        return a
    return jnp.concatenate(
        [a, jnp.broadcast_to(a[-1:], (extra,) + a.shape[1:])], axis=0
    )


def _stream_apply_banded_nd(
    kparams, n, bwg, n_cols_pad, kernel, banded, *args
):
    """ndim-polymorphic banded streamed application (``Matvec`` fn).

    Narrow x (<= 16 columns) routes through the fused Triton kernel
    when it is available; wide blocks (the clip's CholQR sweeps) take
    the GROUP-banded ``lax.scan`` stream (dense stream when the band
    plan could not narrow the window). All paths honour the same
    latitude-gap band certificates, so results match the dense masked
    stream exactly (omitted tiles are exact zeros).
    """
    *arrs, x = args
    rows_g = tuple(arrs[:5])
    cols_p = tuple(arrs[5:10])
    diag = arrs[10]
    gstarts, first, last = arrs[11:14]
    x2 = x if x.ndim == 2 else x[:, None]
    block = rows_g[0].shape[2]
    if kernel is not None and x2.shape[1] <= _KERNEL_COLS:
        out = _apply_kernel(
            cols_p, diag, x2.astype(jnp.float32), first, last,
            kparams, n, n_cols_pad, kernel == "interpret",
        )
    elif banded and block * bwg * 4 > _GROUP_TILE_LIMIT_BYTES:
        # The group window is so wide that one (block, bwg) assemble —
        # and the several same-shape elementwise intermediates XLA may
        # materialise before the dot — no longer fits device memory
        # (first hit at n = 6.48M / 0.1 degree: bwg = 2.35M, 2.4 GB
        # per intermediate). Accumulate over ~`_GROUP_CC_BYTES`
        # column chunks instead: identical tile algebra, bounded
        # working set, same producer fusion per chunk.
        # chunk count first, then the width: ccw = bwg/ncc rounded up
        # to lanes, so window padding stays < one 256-lane chunk (a
        # fixed ccw independent of bwg padded up to 39% dead producer
        # work at the 1M shape — padded columns still assemble pairs)
        ncc = max(1, -(-(block * bwg * 4) // _GROUP_CC_BYTES))
        ccw = -(-(-(-bwg // ncc)) // 256) * 256
        if any(
            isinstance(a, jax.core.Tracer) for a in (x2, *rows_g)
        ):
            out = _operator_apply_stream_grouped_chunked(
                rows_g, cols_p, diag, x2.astype(jnp.float32),
                gstarts, kparams, n, bwg, n_cols_pad, ccw,
            )
        else:
            # Concrete call: one program PER GROUP, queued
            # asynchronously, so no single program runs for minutes at
            # the 0.1-degree scale. Whether the single-program form
            # above is as good on the GPU is open.
            out = _apply_grouped_chunked_multidispatch(
                rows_g, cols_p, diag, x2.astype(jnp.float32),
                gstarts, kparams, n, bwg, n_cols_pad, ccw,
            )
    elif banded:
        out = _operator_apply_stream_grouped(
            rows_g, cols_p, diag, x2.astype(jnp.float32), gstarts,
            kparams, n, bwg, n_cols_pad,
        )
    else:
        rows = tuple(
            a.reshape((-1,) + a.shape[2:]) for a in rows_g
        )
        out = _operator_apply_stream(
            rows,
            tuple(c[:n] for c in cols_p),
            diag, x2.astype(jnp.float32), kparams, n,
        )
    return out if x.ndim == 2 else out[:, 0]


@partial(
    jax.jit, static_argnames=("kparams", "n", "bwg", "n_cols_pad")
)
def _operator_apply_stream_grouped(
    rows_g, cols_p, diag, x2, gstarts, kparams, n, bwg, n_cols_pad
):
    """Group-banded stream: slice the column window ONCE per group,
    then run the same fused assemble-into-matmul scan as the dense
    stream over the group's row blocks. The slice cost is amortised
    over rpg row blocks, so XLA's producer fusion (the thing that puts
    the dense stream at its pairs/s ceiling) is preserved while
    the per-pair work drops to the band fraction."""
    xp = (
        jnp.pad(x2, ((0, n_cols_pad - n), (0, 0)))
        if n_cols_pad != n
        else x2
    )

    def per_group(_, ginputs):
        *grows, gs = ginputs
        cols_sl = tuple(
            jax.lax.dynamic_slice_in_dim(c, gs, bwg, axis=0)
            for c in cols_p
        )
        x_sl = jax.lax.dynamic_slice(
            xp, (gs, jnp.zeros((), gs.dtype)), (bwg, xp.shape[1])
        )

        def per_row(_, row_in):
            return None, _hdot(
                _op_tile(tuple(row_in), cols_sl, kparams), x_sl
            )

        _, yg = jax.lax.scan(per_row, None, tuple(grows))
        return None, yg

    _, out = jax.lax.scan(per_group, None, (*rows_g, gstarts))
    out = out.reshape(-1, x2.shape[1])[:n]
    return out + diag[:, None] * x2


# Column-chunk the grouped scan above this per-(row-block x window)
# tile size: XLA can materialise several (block, bwg) f32 elementwise
# intermediates of the pair kernel before the dot, and past ~1 GB each
# a handful of them exhausts device memory (the 0.1-degree grid's
# bwg = 2.35M window; 1M and below sit well under the limit and keep
# the single-slice path).
_GROUP_TILE_LIMIT_BYTES = 1 << 30
_GROUP_CC_BYTES = 256 << 20


@partial(
    jax.jit,
    static_argnames=("kparams", "n", "bwg", "n_cols_pad", "ccw"),
)
def _operator_apply_stream_grouped_chunked(
    rows_g, cols_p, diag, x2, gstarts, kparams, n, bwg, n_cols_pad,
    ccw,
):
    """Group-banded stream with column-chunked accumulation.

    Same band plan and tile algebra as
    ``_operator_apply_stream_grouped``, but each row block accumulates
    its output over ``ccw``-wide column chunks of the group window, so
    the largest live intermediate is (block, ccw) — the working set
    stays flat as the window grows with n (0.1-degree grids). The
    window is padded up to a whole number of chunks: column params are
    edge-padded (finite kernel values) and x zero-padded, so padded
    columns contribute exact zeros.
    """
    ncc = -(-bwg // ccw)
    bwg_p = ncc * ccw
    xp = (
        jnp.pad(x2, ((0, n_cols_pad - n), (0, 0)))
        if n_cols_pad != n
        else x2
    )

    def per_group(_, ginputs):
        *grows, gs = ginputs
        cols_sl = tuple(
            jnp.pad(
                jax.lax.dynamic_slice_in_dim(c, gs, bwg, axis=0),
                [(0, bwg_p - bwg)] + [(0, 0)] * (c.ndim - 1),
                mode="edge",
            ).reshape((ncc, ccw) + c.shape[1:])
            for c in cols_p
        )
        x_sl = jnp.pad(
            jax.lax.dynamic_slice(
                xp, (gs, jnp.zeros((), gs.dtype)), (bwg, xp.shape[1])
            ),
            ((0, bwg_p - bwg), (0, 0)),
        ).reshape(ncc, ccw, xp.shape[1])

        def per_row(_, row_in):
            def per_cc(acc, cc_in):
                *ccols, xc = cc_in
                return (
                    acc
                    + _hdot(
                        _op_tile(tuple(row_in), tuple(ccols), kparams), xc
                    ),
                    None,
                )

            y0 = jnp.zeros(
                (row_in[0].shape[0], xp.shape[1]), jnp.float32
            )
            y, _ = jax.lax.scan(per_cc, y0, (*cols_sl, x_sl))
            return None, y

        _, yg = jax.lax.scan(per_row, None, tuple(grows))
        return None, yg

    _, out = jax.lax.scan(per_group, None, (*rows_g, gstarts))
    out = out.reshape(-1, x2.shape[1])[:n]
    return out + diag[:, None] * x2


@partial(
    jax.jit,
    static_argnames=("kparams", "bwg", "n_cols_pad", "ccw"),
)
def _apply_one_group_chunked(
    grows, cols_p, xp, gs, kparams, bwg, n_cols_pad, ccw
):
    """One group of the column-chunked banded stream as its OWN
    program: (rpg, block, W) output for the group's row blocks.
    Same algebra as the per_group body of
    ``_operator_apply_stream_grouped_chunked``."""
    ncc = -(-bwg // ccw)
    bwg_p = ncc * ccw
    cols_sl = tuple(
        jnp.pad(
            jax.lax.dynamic_slice_in_dim(c, gs, bwg, axis=0),
            [(0, bwg_p - bwg)] + [(0, 0)] * (c.ndim - 1),
            mode="edge",
        ).reshape((ncc, ccw) + c.shape[1:])
        for c in cols_p
    )
    x_sl = jnp.pad(
        jax.lax.dynamic_slice(
            xp, (gs, jnp.zeros((), gs.dtype)), (bwg, xp.shape[1])
        ),
        ((0, bwg_p - bwg), (0, 0)),
    ).reshape(ncc, ccw, xp.shape[1])

    def per_row(_, row_in):
        def per_cc(acc, cc_in):
            *ccols, xc = cc_in
            return (
                acc
                + _hdot(_op_tile(tuple(row_in), tuple(ccols), kparams), xc),
                None,
            )

        y0 = jnp.zeros(
            (row_in[0].shape[0], xp.shape[1]), jnp.float32
        )
        y, _ = jax.lax.scan(per_cc, y0, (*cols_sl, x_sl))
        return None, y

    _, yg = jax.lax.scan(per_row, None, tuple(grows))
    return yg


def _apply_grouped_chunked_multidispatch(
    rows_g, cols_p, diag, x2, gstarts, kparams, n, bwg, n_cols_pad,
    ccw,
):
    """Host-level per-group dispatch of the column-chunked banded
    stream (concrete inputs only — the traced form is the single
    program above). All G programs are queued async and the results
    concatenated once; every dispatch compiles the SAME per-group
    program (one cache entry)."""
    xp = (
        jnp.pad(x2, ((0, n_cols_pad - n), (0, 0)))
        if n_cols_pad != n
        else x2
    )
    outs = [
        _apply_one_group_chunked(
            tuple(a[g] for a in rows_g), cols_p, xp, gstarts[g],
            kparams, bwg, n_cols_pad, ccw,
        )
        for g in range(rows_g[0].shape[0])
    ]
    out = jnp.concatenate(outs).reshape(-1, x2.shape[1])[:n]
    return out + diag[:, None] * x2


@partial(
    jax.jit, static_argnames=("kparams", "n", "n_cols_pad", "interpret")
)
def _apply_kernel(
    cols_p, diag, x2, first, last, kparams, n, n_cols_pad, interpret
):
    la, lo, sig, sd, sg = cols_p
    xp = jnp.pad(x2, ((0, n_cols_pad - n), (0, 0)))
    y = ellipse_matvec(
        (la, lo, sig[:, 0], sig[:, 1], sig[:, 2], sd, sg), xp,
        first, last, kparams=kparams, interpret=interpret,
    )
    return y[:n] + diag[:, None] * x2
