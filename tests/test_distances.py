"""Geometry tests: haversine/chordal/displacements/Mahalanobis oracles."""

import numpy as np
import pandas as pd
import pytest
from scipy.spatial.distance import mahalanobis as scipy_mahalanobis
from scipy.spatial.transform import Rotation
from sklearn.metrics.pairwise import euclidean_distances, haversine_distances

import jax.numpy as jnp
from glomargridding_jax.ops.distances import (
    cartesian_euclidean_matrix,
    displacements,
    euclidean_matrix,
    haversine_gaussian,
    haversine_matrix,
    inv_2d,
    mahal_dist_func,
    radial_dist,
    rot_mat,
    sigma_rot_func,
    tau_dist,
    tau_dist_from_frame,
)

LONDON = (51.5072, -0.1276)
PARIS = (48.8566, 2.3522)


def test_known_city_distance():
    d = float(radial_dist(LONDON[0], LONDON[1], PARIS[0], PARIS[1]))
    assert abs(d - 344.0) < 1.0  # London-Paris great-circle ~343.5 km


def test_haversine_vs_sklearn(rng):
    lats = rng.uniform(-85, 85, 40)
    lons = rng.uniform(-180, 180, 40)
    ours = np.asarray(haversine_matrix(lats, lons))
    pos = np.radians(np.column_stack([lats, lons]))
    ref = haversine_distances(pos) * 6371.0
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-8)


def test_haversine_cross_matrix(rng):
    lats1, lons1 = rng.uniform(-80, 80, 7), rng.uniform(-180, 180, 7)
    lats2, lons2 = rng.uniform(-80, 80, 5), rng.uniform(-180, 180, 5)
    ours = np.asarray(haversine_matrix(lats1, lons1, lats2, lons2))
    full = np.asarray(
        haversine_matrix(
            np.concatenate([lats1, lats2]), np.concatenate([lons1, lons2])
        )
    )
    np.testing.assert_allclose(ours, full[:7, 7:], rtol=1e-12)


def test_euclidean_chordal(rng):
    lats = rng.uniform(-85, 85, 20)
    lons = rng.uniform(-180, 180, 20)
    ours = np.asarray(euclidean_matrix(lats, lons))
    la, lo = np.radians(lats), np.radians(lons)
    xyz = np.column_stack(
        [np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)]
    )
    ref = euclidean_distances(xyz) * 6371.0
    np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=1e-6)


def test_cartesian_euclidean(rng):
    y = rng.uniform(0, 20, 15)
    x = rng.uniform(0, 20, 15)
    ours = np.asarray(cartesian_euclidean_matrix(y, x))
    ref = euclidean_distances(np.column_stack([y, x]))
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-10)


def test_rot_mat_vs_scipy():
    for ang in [0.0, 0.3, -1.2, np.pi / 2]:
        ours = np.asarray(rot_mat(ang))
        ref = Rotation.from_euler("z", ang).as_matrix()[:2, :2]
        np.testing.assert_allclose(ours, ref, atol=1e-12)


def test_inv_2d(rng):
    m = rng.random((2, 2)) + np.eye(2)
    np.testing.assert_allclose(
        np.asarray(inv_2d(jnp.asarray(m))), np.linalg.inv(m), rtol=1e-10
    )


def test_mahalanobis_vs_scipy(rng):
    Lx, Ly, theta = 3.0, 1.5, 0.4
    sigma = np.asarray(sigma_rot_func(Lx, Ly, theta))
    VI = np.linalg.inv(sigma)
    for _ in range(10):
        dx, dy = rng.normal(size=2)
        ours = float(mahal_dist_func(dx, dy, Lx, Ly, theta))
        ref = scipy_mahalanobis([dx, dy], [0.0, 0.0], VI)
        assert np.isclose(ours, ref, rtol=1e-8)
        # tau_dist single-pair form agrees
        ours2 = float(tau_dist(dx, dy, jnp.asarray(sigma)))
        assert np.isclose(ours2, ref, rtol=1e-8)


def test_displacements_wrapping():
    lats = np.array([0.0, 10.0])
    lons = np.array([-179.0, 179.0])
    dy, dx = displacements(lats, lons)
    # wrap: -179 - 179 = -358 -> +2
    assert np.isclose(np.asarray(dx)[0, 1], 2.0)
    assert np.isclose(np.asarray(dx)[1, 0], -2.0)
    np.testing.assert_allclose(np.asarray(dy)[0, 1], -10.0)


def test_displacements_met_office_scalings():
    lats = np.array([0.0, 60.0])
    lons = np.array([0.0, 10.0])
    dy_mo, dx_mo = displacements(lats, lons, delta_x_method="Met_Office")
    np.testing.assert_allclose(
        np.asarray(dx_mo)[0, 1], np.deg2rad(-10.0), rtol=1e-12
    )
    dy_m, dx_m = displacements(
        lats, lons, delta_x_method="Modified_Met_Office"
    )
    scale = 0.5 * (np.cos(0.0) + np.cos(np.radians(60.0)))
    np.testing.assert_allclose(
        np.asarray(dx_m)[0, 1], np.deg2rad(-10.0) * scale, rtol=1e-12
    )
    # invalid method raises
    with pytest.raises(ValueError):
        displacements(lats, lons, delta_x_method="bogus")


def test_haversine_gaussian_bounds(rng):
    df = pd.DataFrame(
        {"lat": rng.uniform(-10, 10, 8), "lon": rng.uniform(-10, 10, 8)}
    )
    C = haversine_gaussian(df, r=40.0, s=0.6)
    assert C.shape == (8, 8)
    np.testing.assert_allclose(np.diag(C), 0.3)
    assert (C >= 0).all() and (C <= 0.3 + 1e-12).all()


def test_tau_dist_from_frame():
    df = pd.DataFrame(
        {
            "lat": [0.0, 0.1, -0.1],
            "lon": [10.0, 10.1, 9.9],
            "grid_lat": [0.0] * 3,
            "grid_lon": [10.0] * 3,
            "grid_lx": [50.0] * 3,
            "grid_ly": [30.0] * 3,
            "grid_theta": [0.2] * 3,
        }
    )
    out = tau_dist_from_frame(df)
    assert out.shape == (3, 3)
    np.testing.assert_allclose(np.diag(out), 1.0)  # exp(-0)
    assert (out <= 1.0).all() and (out > 0).all()
    assert np.allclose(out, out.T)


def test_tmerc_forward_meridian_arc():
    """Northing along the central meridian must equal the true meridian
    arc length integral(M(phi) dphi) — an oracle independent of the
    Krueger series (reference CRS: tmerc on WGS84, distances.py:303-305).
    """
    from scipy.integrate import quad

    from glomargridding_jax.ops.distances import (
        WGS84_A_KM,
        WGS84_F,
        tmerc_forward,
    )

    a, f = WGS84_A_KM, WGS84_F
    e2 = f * (2.0 - f)

    def meridian_M(phi):
        return a * (1.0 - e2) / (1.0 - e2 * np.sin(phi) ** 2) ** 1.5

    for lat in (1.0, 45.0, 70.0, 89.0):
        arc, _err = quad(meridian_M, 0.0, np.radians(lat), epsabs=1e-12)
        _, northing = tmerc_forward([lat], [0.0], 0.0, 0.0, k0=1.0)
        np.testing.assert_allclose(northing[0], arc, rtol=1e-10)

    # quarter meridian, WGS84: 10001.965729 km (and the pole is finite)
    _, quarter = tmerc_forward([90.0], [0.0], 0.0, 0.0, k0=1.0)
    np.testing.assert_allclose(quarter[0], 10001.965729, rtol=1e-8)

    # k0 scales the projection uniformly
    _, n_k = tmerc_forward([45.0], [0.0], 0.0, 0.0, k0=0.9996)
    _, n_1 = tmerc_forward([45.0], [0.0], 0.0, 0.0, k0=1.0)
    np.testing.assert_allclose(n_k[0], 0.9996 * n_1[0], rtol=1e-14)


def test_tmerc_forward_small_easting_limit():
    """For small dlon, easting -> k0 * N(phi) * cos(phi) * dlam where
    N is the prime-vertical curvature radius (first-order TM property)."""
    from glomargridding_jax.ops.distances import (
        WGS84_A_KM,
        WGS84_F,
        tmerc_forward,
    )

    a, f = WGS84_A_KM, WGS84_F
    e2 = f * (2.0 - f)
    dlon = 1e-4  # degrees
    for lat in (0.0, 35.0, 60.0):
        easting, _ = tmerc_forward([lat], [dlon], lat, 0.0)
        phi = np.radians(lat)
        N = a / np.sqrt(1.0 - e2 * np.sin(phi) ** 2)
        expected = 0.9996 * N * np.cos(phi) * np.radians(dlon)
        np.testing.assert_allclose(easting[0], expected, rtol=1e-7)


def test_tau_tangent_vs_tmerc_bound():
    """Pin the documented tangent-plane-vs-TM agreement: for gridbox-scale
    clouds at mid and high latitude the exp(-tau) matrices agree to ~0.5%
    absolute (the gap is spherical-vs-ellipsoidal curvature, not TM
    series truncation)."""
    rng = np.random.default_rng(7)
    for lat0, lon0 in ((45.0, -30.0), (70.0, 10.0)):
        n = 12
        df = pd.DataFrame(
            {
                "lat": lat0 + rng.uniform(-0.5, 0.5, n),
                "lon": lon0 + rng.uniform(-0.5, 0.5, n),
                "grid_lat": [lat0] * n,
                "grid_lon": [lon0] * n,
                "grid_lx": [80.0] * n,
                "grid_ly": [40.0] * n,
                "grid_theta": [0.4] * n,
            }
        )
        exact = tau_dist_from_frame(df, displacement="tmerc")
        approx = tau_dist_from_frame(df, displacement="tangent")
        assert np.max(np.abs(exact - approx)) < 5e-3
        np.testing.assert_allclose(np.diag(exact), 1.0)

    with pytest.raises(ValueError, match="unknown displacement"):
        tau_dist_from_frame(df, displacement="nope")


def test_asin_poly_accuracy():
    """A&S 4.4.46 polynomial: |err| ~2e-8 over [0, 1] in f64; f32
    evaluation degrades to ~1.4e-6 rad ONLY near x -> 1 (sqrt(1 - x)
    cancellation — the antipode, ~18 m of distance) and stays inside
    ~5e-7 on the sub-antipodal range the kernels live on."""
    import jax
    import jax.numpy as jnp

    from glomargridding_jax.ops.distances import asin_poly

    x64 = np.linspace(0.0, 1.0, 20001)
    if jax.config.jax_enable_x64:
        got = np.asarray(asin_poly(jnp.asarray(x64, jnp.float64)))
        assert np.abs(got - np.arcsin(x64)).max() < 3e-8
    x32 = x64.astype(np.float32)
    got32 = np.asarray(asin_poly(jnp.asarray(x32)))
    err = np.abs(got32 - np.arcsin(x64))
    assert err.max() < 2e-6  # antipodal worst case
    assert err[x64 < 0.99].max() < 5e-7
    # endpoints exact-ish
    assert abs(float(asin_poly(jnp.float32(1.0))) - np.pi / 2) < 1e-6
    assert abs(float(asin_poly(jnp.float32(0.0)))) < 2e-7  # 1 ulp of pi/2
