"""Pairwise geometry on the sphere — jitted, tiled, dtype-polymorphic.

Replaces the reference's sklearn/geopandas distance layer
(``distances.py``) with pure-JAX pairwise kernels designed for a device:
computation is expressed per (row-block x col-block) tile so consumers can
either materialise a full M x M matrix (small grids) or stream tiles into a
reduction (large grids) without ever allocating what they don't need.

All functions take latitude/longitude in **degrees** unless stated and
return distances scaled by ``radius`` (default: Earth radius in km).
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import RADIUS_OF_EARTH_KM
from ..types import DeltaXMethod

TWO_PI = 2.0 * math.pi


# --------------------------------------------------------------------------
# 2x2 helpers (parity: reference ``distances.py:41-58``)
# --------------------------------------------------------------------------
def rot_mat(angle):
    """2-d rotation matrix from an angle in radians."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array([[c, -s], [s, c]])


def inv_2d(mat):
    """Inverse of a 2 x 2 matrix."""
    det = mat[0, 0] * mat[1, 1] - mat[0, 1] * mat[1, 0]
    inv = jnp.array([[mat[1, 1], -mat[0, 1]], [-mat[1, 0], mat[0, 0]]])
    return inv / det


# --------------------------------------------------------------------------
# Core pairwise kernels
# --------------------------------------------------------------------------
def asin_poly(x):
    """arcsin(x) for x in [0, 1] via Abramowitz-Stegun 4.4.46.

    Polynomial error ~2e-8 (2.2e-8 measured in f64, pinned by test);
    evaluated in f32 the ``sqrt(1 - x)`` factor loses to cancellation
    as x -> 1,
    growing the error to ~1.4e-6 rad — that worst case is the
    ANTIPODE (18 m of great-circle distance at x = 0.9998), where
    every kernel this feeds is indistinguishable from zero. A few
    multiply-adds and one sqrt per pair: the streamed kernel solvers
    route their per-pair central angle through this, since at 6.5M-grid
    scale the C_cross assembly is the ensemble stage's wall.
    """
    x = jnp.clip(x, 0.0, 1.0)
    p = jnp.asarray(-0.0012624911, x.dtype)
    for c in (
        0.0066700901,
        -0.0170881256,
        0.0308918810,
        -0.0501743046,
        0.0889789874,
        -0.2145988016,
        1.5707963050,
    ):
        p = p * x + c
    return jnp.asarray(0.5 * math.pi, x.dtype) - jnp.sqrt(1.0 - x) * p


def _haversine_rad(lat1, lon1, lat2, lon2):
    """Central angle (radians) between broadcastable radian coordinates."""
    dlat = lat1 - lat2
    dlon = lon1 - lon2
    a = (
        jnp.sin(dlat / 2.0) ** 2
        + jnp.cos(lat1) * jnp.cos(lat2) * jnp.sin(dlon / 2.0) ** 2
    )
    # clip guards f32 rounding at antipodes (a slightly > 1)
    return 2.0 * jnp.arcsin(jnp.sqrt(jnp.clip(a, 0.0, 1.0)))


@partial(jax.jit, static_argnames=("radius",))
def haversine_matrix(
    lats1,
    lons1,
    lats2=None,
    lons2=None,
    radius: float = RADIUS_OF_EARTH_KM,
):
    """Pairwise great-circle distance matrix (degrees in, `radius` units out).

    With one coordinate set: the symmetric M x M matrix. With two sets:
    the rectangular |set1| x |set2| cross matrix — this is the primitive
    used to build C_cross tiles without materialising the grid covariance.
    (Capability parity: reference ``distances.py:191-218``.)
    """
    lats2 = lats1 if lats2 is None else lats2
    lons2 = lons1 if lons2 is None else lons2
    la1 = jnp.radians(lats1)[:, None]
    lo1 = jnp.radians(lons1)[:, None]
    la2 = jnp.radians(lats2)[None, :]
    lo2 = jnp.radians(lons2)[None, :]
    return radius * _haversine_rad(la1, lo1, la2, lo2)


@partial(jax.jit, static_argnames=("radius",))
def euclidean_matrix(
    lats1,
    lons1,
    lats2=None,
    lons2=None,
    radius: float = RADIUS_OF_EARTH_KM,
):
    """Pairwise chordal ("tunnel") distance through the sphere.

    (Capability parity: reference ``distances.py:139-188``.)
    """
    lats2 = lats1 if lats2 is None else lats2
    lons2 = lons1 if lons2 is None else lons2
    la1 = jnp.radians(lats1)[:, None]
    lo1 = jnp.radians(lons1)[:, None]
    la2 = jnp.radians(lats2)[None, :]
    lo2 = jnp.radians(lons2)[None, :]
    # Chord length via the central angle: 2R sin(c/2). The haversine form of
    # c is stable at small separations, unlike the 2 - 2*dot Gram form.
    c = _haversine_rad(la1, lo1, la2, lo2)
    return 2.0 * radius * jnp.sin(c / 2.0)


def cartesian_euclidean_matrix(lats1, lons1, lats2=None, lons2=None):
    """Plain planar Euclidean distance on (lat, lon) treated as x/y.

    Used by the GeoStats.jl golden configuration where coordinates are
    abstract planar positions, matching
    ``sklearn.metrics.pairwise.euclidean_distances``.
    """
    lats2 = lats1 if lats2 is None else lats2
    lons2 = lons1 if lons2 is None else lons2
    dy = jnp.asarray(lats1)[:, None] - jnp.asarray(lats2)[None, :]
    dx = jnp.asarray(lons1)[:, None] - jnp.asarray(lons2)[None, :]
    return jnp.sqrt(dy * dy + dx * dx)


def radial_dist(lat1, lon1, lat2, lon2, radius: float = RADIUS_OF_EARTH_KM):
    """Single-pair great-circle distance (degrees in)."""
    return radius * _haversine_rad(
        jnp.radians(lat1),
        jnp.radians(lon1),
        jnp.radians(lat2),
        jnp.radians(lon2),
    )


# --------------------------------------------------------------------------
# Displacements (parity: reference ``distances.py:477-549``)
# --------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("delta_x_method",))
def displacements(
    lats,
    lons,
    lats2=None,
    lons2=None,
    delta_x_method: DeltaXMethod | None = None,
):
    """E-W / N-S displacement matrices for all pairs of positions.

    Longitude differences are wrapped into (-180, 180]. With
    ``delta_x_method=None`` results are in degrees; "Met_Office" converts to
    radians on a cylindrical ("tin-can") Earth; "Modified_Met_Office"
    additionally scales the zonal displacement by the mean cos-latitude of
    the pair (sinusoidal squish). Results are NOT multiplied by a radius.

    Returns (disp_y, disp_x) with shape (len(first set), len(second set)).
    """
    if delta_x_method is not None and delta_x_method not in (
        "Met_Office",
        "Modified_Met_Office",
    ):
        raise ValueError(
            f"Unknown 'delta_x_method' value, got '{delta_x_method}'"
        )
    lats = jnp.atleast_1d(jnp.asarray(lats))
    lons = jnp.atleast_1d(jnp.asarray(lons))
    lats2v = lats if lats2 is None else jnp.atleast_1d(jnp.asarray(lats2))
    lons2v = lons if lons2 is None else jnp.atleast_1d(jnp.asarray(lons2))

    disp_y = lats[:, None] - lats2v[None, :]
    disp_x = lons[:, None] - lons2v[None, :]
    disp_x = jnp.where(disp_x > 180.0, disp_x - 360.0, disp_x)
    disp_x = jnp.where(disp_x < -180.0, disp_x + 360.0, disp_x)

    if delta_x_method is None:
        return disp_y, disp_x

    disp_y = jnp.deg2rad(disp_y)
    disp_x = jnp.deg2rad(disp_x)

    if delta_x_method == "Modified_Met_Office":
        cos1 = jnp.cos(jnp.radians(lats))
        cos2 = jnp.cos(jnp.radians(lats2v))
        y_cos_mean = 0.5 * (cos1[:, None] + cos2[None, :])
        disp_x = disp_x * y_cos_mean

    return disp_y, disp_x


# --------------------------------------------------------------------------
# Anisotropic (Mahalanobis / tau) distances
# (parity: reference ``distances.py:328-474``)
# --------------------------------------------------------------------------
def sigma_rot_func(Lx, Ly, theta=None):
    """Sigma(Lx, Ly, theta) = R diag(Lx^2, Ly^2) R^T (2 x 2).

    Karspeck et al. 2011 Eq. 15 / Paciorek-Schervish 2006 Eq. 6.
    """
    L = jnp.diag(jnp.array([Lx**2.0, Ly**2.0]))
    if theta is None:
        return L
    R = rot_mat(theta)
    return R @ L @ R.T


def sigma_rot_flat(Lx, Ly, theta):
    """Flattened (s00, s01, s10, s11) Sigma entries for vector parameters.

    Vectorised over arbitrary leading dimensions; this is the layout the
    tiled ellipse-covariance kernel consumes.
    """
    ct = jnp.cos(theta)
    st = jnp.sin(theta)
    c2 = ct * ct
    s2 = st * st
    cs = ct * st
    Lx2 = Lx * Lx
    Ly2 = Ly * Ly
    s00 = c2 * Lx2 + s2 * Ly2
    s01 = cs * (Lx2 - Ly2)
    s11 = s2 * Lx2 + c2 * Ly2
    return s00, s01, s01, s11


def tau_dist(dE, dN, sigma):
    """Mahalanobis distance sqrt(dx' Sigma^{-1} dx) for one 2x2 Sigma."""
    dx_vec = jnp.array([dE, dN])
    return jnp.sqrt(dx_vec.T @ inv_2d(sigma) @ dx_vec)


def mahal_dist_func(delta_x, delta_y, Lx, Ly, theta=None):
    """Mahalanobis tau for displacement arrays and scalar ellipse params.

    tau = sqrt(dx (dx*si00 + dy*si01) + dy (dx*si10 + dy*si11)) with
    si = Sigma(Lx,Ly,theta)^{-1}; fully elementwise.
    """
    if theta is None:
        s00, s01, s10, s11 = Lx * Lx, 0.0, 0.0, Ly * Ly
    else:
        s00, s01, s10, s11 = sigma_rot_flat(Lx, Ly, theta)
    det = s00 * s11 - s01 * s10
    i00 = s11 / det
    i01 = -s01 / det
    i10 = -s10 / det
    i11 = s00 / det
    q = delta_x * (delta_x * i00 + delta_y * i01) + delta_y * (
        delta_x * i10 + delta_y * i11
    )
    return jnp.sqrt(jnp.clip(q, 0.0, None))


def tau_dist_matrix(
    lats,
    lons,
    Lx,
    Ly,
    theta,
    delta_x_method: DeltaXMethod = "Modified_Met_Office",
    radius: float = RADIUS_OF_EARTH_KM,
):
    """Pairwise Mahalanobis tau for one set of points and shared ellipse.

    Displacements use the chosen Met-Office convention, scaled to km.
    """
    dy, dx = displacements(lats, lons, delta_x_method=delta_x_method)
    return mahal_dist_func(radius * dx, radius * dy, Lx, Ly, theta)


# --------------------------------------------------------------------------
# Frame-level wrappers (host API parity; pandas-first)
# --------------------------------------------------------------------------
def haversine_distance_from_frame(df, radius: float = RADIUS_OF_EARTH_KM):
    """Pairwise haversine matrix from a frame with 'lat'/'lon' columns."""
    if list(df.columns) != ["lat", "lon"]:
        raise ValueError("Input must only contain 'lat' and 'lon' columns")
    lat = np.asarray(df["lat"], dtype=float)
    lon = np.asarray(df["lon"], dtype=float)
    return np.asarray(haversine_matrix(lat, lon, radius=radius))


def euclidean_distance(df, radius: float = RADIUS_OF_EARTH_KM):
    """Pairwise chordal (tunnel) matrix from a frame with 'lat'/'lon'."""
    if list(df.columns) != ["lat", "lon"]:
        raise ValueError("Input must only contain 'lat' and 'lon' columns")
    lat = np.asarray(df["lat"], dtype=float)
    lon = np.asarray(df["lon"], dtype=float)
    return np.asarray(euclidean_matrix(lat, lon, radius=radius))


def cartesian_euclidean_from_frame(df, **_ignored):
    """Planar Euclidean pairwise matrix from a lat/lon frame.

    Matches sklearn's ``euclidean_distances`` on raw coordinates; used by
    abstract-planar configurations (e.g. the GeoStats.jl golden test).
    """
    if list(df.columns) != ["lat", "lon"]:
        raise ValueError("Input must only contain 'lat' and 'lon' columns")
    lat = np.asarray(df["lat"], dtype=float)
    lon = np.asarray(df["lon"], dtype=float)
    return np.asarray(cartesian_euclidean_matrix(lat, lon))


def calculate_distance_matrix(
    df,
    dist_func=haversine_distance_from_frame,
    lat_col: str = "lat",
    lon_col: str = "lon",
    **dist_kwargs,
):
    """Distance matrix from a positional frame using a distance function.

    (Parity: reference ``distances.py:221-264``.) `dist_func` receives a
    two-column frame named lat/lon.
    """
    import pandas as pd

    frame = pd.DataFrame(
        {"lat": np.asarray(df[lat_col]), "lon": np.asarray(df[lon_col])}
    )
    return dist_func(frame, **dist_kwargs)


def haversine_gaussian(
    df,
    R: float = RADIUS_OF_EARTH_KM,
    r: float = 40.0,
    s: float = 0.6,
) -> np.ndarray:
    """Gaussian-model-weighted haversine matrix (variogram-flavoured).

    Usable as a `dist_fn` for within-gridbox error-covariance distance
    weighting (parity: reference ``distances.py:62-94``).
    """
    from ..utils.frames import check_cols

    check_cols(df, ["lat", "lon"])
    lat = np.asarray(df["lat"], dtype=float)
    lon = np.asarray(df["lon"], dtype=float)
    C = np.asarray(haversine_matrix(lat, lon, radius=R))
    C = np.exp(-(C**2) / r**2)
    return s / 2.0 * C


# WGS84 ellipsoid (the datum behind the reference's EPSG:4326 -> tmerc
# reprojection).
WGS84_A_KM = 6378.137
WGS84_F = 1.0 / 298.257223563


def tmerc_forward(
    lats_deg,
    lons_deg,
    lat0_deg: float,
    lon0_deg: float,
    k0: float = 0.9996,
    a: float = WGS84_A_KM,
    f: float = WGS84_F,
) -> tuple[np.ndarray, np.ndarray]:
    """Ellipsoidal Transverse Mercator forward projection (km).

    Exact (nanometre-class) Gauss-Krueger projection via the 6th-order
    Krueger alpha series in the third flattening n (Karney 2011,
    "Transverse Mercator with an accuracy of a few nanometers" — standard
    published coefficients), written in plain numpy so the reference's
    ``+proj=tmerc +lat_0=.. +lon_0=.. +k=0.9996 +units=km`` CRS
    (``distances.py:267-312``) is reproduced without pyproj/geopandas.
    Returns (easting, northing) in km with the false origin at
    (lat0, lon0): northing is measured from the lat0 parallel.
    """
    lats = np.radians(np.asarray(lats_deg, dtype=np.float64))
    lons = np.asarray(lons_deg, dtype=np.float64)
    dlam = np.radians(((lons - lon0_deg) + 180.0) % 360.0 - 180.0)

    n = f / (2.0 - f)
    n2, n3 = n * n, n**3
    n4, n5, n6 = n**4, n**5, n**6
    # rectifying radius
    A = a / (1.0 + n) * (1.0 + n2 / 4.0 + n4 / 64.0 + n6 / 256.0)
    alpha = np.array(
        [
            n / 2.0 - 2.0 * n2 / 3.0 + 5.0 * n3 / 16.0 + 41.0 * n4 / 180.0
            - 127.0 * n5 / 288.0 + 7891.0 * n6 / 37800.0,
            13.0 * n2 / 48.0 - 3.0 * n3 / 5.0 + 557.0 * n4 / 1440.0
            + 281.0 * n5 / 630.0 - 1983433.0 * n6 / 1935360.0,
            61.0 * n3 / 240.0 - 103.0 * n4 / 140.0 + 15061.0 * n5 / 26880.0
            + 167603.0 * n6 / 181440.0,
            49561.0 * n4 / 161280.0 - 179.0 * n5 / 168.0
            + 6601661.0 * n6 / 7257600.0,
            34729.0 * n5 / 80640.0 - 3418889.0 * n6 / 1995840.0,
            212378941.0 * n6 / 149968080.0,
        ]
    )
    e = math.sqrt(f * (2.0 - f))

    def _xi_eta(phi, lam):
        s = np.clip(np.sin(phi), -1.0, 1.0)
        # conformal latitude chi: tan(chi) = sinh(asinh-style combination)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
        t = np.where(np.abs(s) >= 1.0, np.copysign(np.inf, s), t)
        xi_p = np.arctan2(t, np.cos(lam))
        eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))
        j = np.arange(1, 7, dtype=np.float64)
        two_j_xi = 2.0 * j[:, None] * np.ravel(xi_p)[None, :]
        two_j_eta = 2.0 * j[:, None] * np.ravel(eta_p)[None, :]
        xi = np.ravel(xi_p) + alpha @ (np.sin(two_j_xi) * np.cosh(two_j_eta))
        eta = np.ravel(eta_p) + alpha @ (
            np.cos(two_j_xi) * np.sinh(two_j_eta)
        )
        return xi.reshape(np.shape(phi)), eta.reshape(np.shape(phi))

    xi, eta = _xi_eta(lats, dlam)
    xi0, _ = _xi_eta(np.asarray(math.radians(lat0_deg)), np.asarray(0.0))
    easting = k0 * A * eta
    northing = k0 * A * (xi - float(xi0))
    return easting, northing


def tau_dist_from_frame(df, displacement: str = "tmerc") -> np.ndarray:
    """exp(-tau) matrix for all records within one gridbox.

    Requires columns lat/lon plus gridbox ellipse parameters
    grid_lat/grid_lon/grid_lx/grid_ly/grid_theta (first row used — all
    records share the gridbox). ``displacement`` selects how observation
    coordinates become local northing/easting:

    - ``"tmerc"`` (default): exact Transverse Mercator about the gridbox
      centre with the reference's scale factor k=0.9996 on WGS84 — the
      same reprojection the reference performs through geopandas/pyproj
      (``distances.py:384-433``), so the result is reference-exact.
    - ``"tangent"``: spherical local-tangent approximation (cheaper;
      agrees with tmerc to ~0.5% at gridbox scales, dominated by the
      spherical-vs-ellipsoidal meridian curvature — pinned by
      ``tests/test_distances.py``).
    """
    from ..utils.frames import check_cols

    required = [
        "grid_lon",
        "grid_lat",
        "grid_lx",
        "grid_ly",
        "grid_theta",
        "lat",
        "lon",
    ]
    check_cols(df, required)
    lat0 = float(np.asarray(df["grid_lat"])[0])
    lon0 = float(np.asarray(df["grid_lon"])[0])
    Lx = float(np.asarray(df["grid_lx"])[0])
    Ly = float(np.asarray(df["grid_ly"])[0])
    theta = float(np.asarray(df["grid_theta"])[0])

    lats = np.asarray(df["lat"], dtype=float)
    lons = np.asarray(df["lon"], dtype=float)
    if displacement == "tmerc":
        easting, northing = tmerc_forward(lats, lons, lat0, lon0)
    elif displacement == "tangent":
        km_per_deg = RADIUS_OF_EARTH_KM * math.pi / 180.0
        northing = lats * km_per_deg
        easting = lons * km_per_deg * math.cos(math.radians(lat0))
    else:
        raise ValueError(f"unknown displacement method {displacement!r}")
    dN = northing[:, None] - northing[None, :]
    dE = easting[:, None] - easting[None, :]
    tau = np.asarray(
        mahal_dist_func(jnp.asarray(dE), jnp.asarray(dN), Lx, Ly, theta)
    )
    return np.exp(-tau)
