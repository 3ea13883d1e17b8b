"""Ellipse package tests: oracle vs stored independent result plus
statistical round-trip self-consistency (reference test_ellipse idioms)."""

import os

import numpy as np
import pytest

from glomargridding_jax.core.labeled import Coordinates
from glomargridding_jax.io import open_dataset
from glomargridding_jax.models.ellipse import (
    EllipseBuilder,
    EllipseCovarianceBuilder,
    EllipseModel,
)
from glomargridding_jax.ops.covariance_tools import eigenvalue_clip
from glomargridding_jax.utils.arrays import cov_2_cor, uncompress_masked

from conftest import reference_data_path, requires_reference_data


def frob(mat):
    return float(np.linalg.norm(mat, ord="fro"))


def correlation_distance(cov1, cov2):
    cor1 = cov_2_cor(cov1)
    cor2 = cov_2_cor(cov2)
    num = np.trace(cor1 @ cor2)
    return 1 - num / (frob(cor1) * frob(cor2))


def _atlantic_subset():
    ds = open_dataset(reference_data_path("Atlantic_Ocean_07.nc"))
    sl = (slice(50, 70), slice(50, 70))
    Lxs = ds["lx"].values[sl]
    Lys = ds["ly"].values[sl]
    thetas = ds["theta"].values[sl]
    stdevs = ds["standard_deviation"].values[sl]
    lats = np.asarray(ds.coords["latitude"])[sl[0]]
    lons = np.asarray(ds.coords["longitude"])[sl[1]]
    mask = Lxs > 1e5
    return Lxs, Lys, thetas, stdevs, lats, lons, mask


@requires_reference_data
def test_ellipse_covariance_oracle():
    """Covariance matches the stored result of an independent
    implementation (reference test data cov_no_hfix.nc)."""
    Lxs, Lys, thetas, stdevs, lats, lons, mask = _atlantic_subset()
    expected = open_dataset(reference_data_path("cov_no_hfix.nc"))[
        "covariance"
    ].values

    builder = EllipseCovarianceBuilder(
        np.ma.masked_where(mask, Lxs),
        np.ma.masked_where(mask, Lys),
        np.ma.masked_where(mask, thetas),
        np.ma.masked_where(mask, stdevs),
        lats,
        lons,
        v=0.5,
    )
    assert builder.cov_ns.shape == expected.shape
    cmd = correlation_distance(builder.cov_ns, expected)
    assert cmd < 1e-4
    np.testing.assert_allclose(builder.cov_ns, expected, rtol=1e-5, atol=1e-7)

    builder.calculate_cor()
    assert hasattr(builder, "cor_ns")
    assert np.isclose(1, np.max(np.diag(builder.cor_ns)))


@requires_reference_data
def test_ellipse_covariance_methods_agree():
    """array / batched / low_memory strategies produce one result (they
    share the tiled kernel; this pins the row-blocking logic)."""
    Lxs, Lys, thetas, stdevs, lats, lons, mask = _atlantic_subset()

    def build(**kw):
        return EllipseCovarianceBuilder(
            np.ma.masked_where(mask, Lxs),
            np.ma.masked_where(mask, Lys),
            np.ma.masked_where(mask, thetas),
            np.ma.masked_where(mask, stdevs),
            lats,
            lons,
            v=0.5,
            **kw,
        ).cov_ns

    cov_array = build()
    cov_batched = build(covariance_method="batched", batch_size=100)
    cov_loop = build(covariance_method="low_memory")
    np.testing.assert_allclose(cov_array, cov_batched, rtol=1e-5)
    np.testing.assert_allclose(cov_array, cov_loop, rtol=1e-5)


@requires_reference_data
def test_ellipse_covariance_max_dist():
    Lxs, Lys, thetas, stdevs, lats, lons, mask = _atlantic_subset()
    builder = EllipseCovarianceBuilder(
        np.ma.masked_where(mask, Lxs),
        np.ma.masked_where(mask, Lys),
        np.ma.masked_where(mask, thetas),
        np.ma.masked_where(mask, stdevs),
        lats,
        lons,
        v=0.5,
        max_dist=500.0,
    )
    # entries beyond the radius are exactly zero; diagonal survives
    assert (np.diag(builder.cov_ns) > 0).all()
    n_zero = np.sum(builder.cov_ns == 0.0)
    assert n_zero > 0.5 * builder.cov_ns.size


@requires_reference_data
def test_uncompress_cov():
    Lxs, Lys, thetas, stdevs, lats, lons, mask = _atlantic_subset()
    builder = EllipseCovarianceBuilder(
        np.ma.masked_where(mask, Lxs),
        np.ma.masked_where(mask, Lys),
        np.ma.masked_where(mask, thetas),
        np.ma.masked_where(mask, stdevs),
        lats,
        lons,
        v=0.5,
    )
    builder.uncompress_cov()
    assert builder.cov_ns.shape[0] == builder.cov_ns.shape[1]
    assert builder.cov_ns.shape[0] == Lxs.size


def _initialise_covariance(Lx, Ly, theta, stdev, v, size):
    Lx_arr = np.full(size, Lx)
    Ly_arr = np.full(size, Ly)
    theta_arr = np.full(size, theta)
    stdev_arr = np.full(size, stdev)
    lons = np.arange(size[1], dtype=np.float32)
    lats = np.arange(size[0], dtype=np.float32)
    out = EllipseCovarianceBuilder(
        Lx_arr, Ly_arr, theta_arr, stdev_arr, v=v, lons=lons, lats=lats
    ).cov_ns
    return eigenvalue_clip(
        out, method="explained_variance", target_variance_fraction=0.99
    )


@pytest.mark.parametrize(
    "v, params, size",
    [
        (
            1.5,
            {"Lx": 1500, "Ly": 800, "theta": np.pi / 3, "stdev": 0.6},
            (10, 6),
        ),
        (1.5, {"Lx": 3600, "Ly": 1700, "theta": 0.2, "stdev": 1.2}, (8, 8)),
    ],
)
def test_ellipse_round_trip(v, params, size):
    """Draw samples from a known-parameter covariance, re-estimate the
    parameters, rebuild — must recover the input covariance."""
    rng = np.random.default_rng(40814)
    n = 5_000
    true_cov = _initialise_covariance(**params, v=v, size=size)
    test_data = rng.multivariate_normal(
        np.zeros(true_cov.shape[0]), true_cov, size=n
    )
    in_cov = np.cov(test_data.T)
    test_data = test_data.reshape((n, *size))
    coords = Coordinates(
        {
            "time": np.arange(n),
            "longitude": np.arange(size[1], dtype=np.float32),
            "latitude": np.arange(size[0], dtype=np.float32),
        }
    )

    ellipse = EllipseModel(
        anisotropic=True,
        rotated=True,
        physical_distance=True,
        v=v,
        unit_sigma=True,
    )
    builder = EllipseBuilder(test_data, coords)

    ellipse_params = builder.compute_params(
        default_value=[0.0] * ellipse.supercategory_n_params,
        matern_ellipse=ellipse,
        bounds=[
            (300.0, 30000.0),
            (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi),
        ],
        guesses=[300.0, 300.0, 0.0],
        max_distance=10_000.0,
        delta_x_method="Modified_Met_Office",
    )

    ellipse_cov = EllipseCovarianceBuilder(
        ellipse_params["Lx"].values,
        ellipse_params["Ly"].values,
        ellipse_params["theta"].values,
        ellipse_params["standard_deviation"].values,
        lons=np.asarray(coords["longitude"]),
        lats=np.asarray(coords["latitude"]),
        v=v,
    ).cov_ns
    ellipse_cov = eigenvalue_clip(
        ellipse_cov, method="explained_variance",
        target_variance_fraction=0.99,
    )

    np.testing.assert_allclose(ellipse_cov, in_cov, rtol=5e-2, atol=5e-3)
    assert correlation_distance(in_cov, ellipse_cov) < 1e-4


@requires_reference_data
def test_ellipse_atlantic_self_consistency():
    """Round trip through the real Atlantic parameter file at n=1000."""
    ds = open_dataset(reference_data_path("Atlantic_Ocean_07.nc"))
    sl = (slice(50, 70), slice(50, 70))
    Lxs = ds["lx"].values[sl]
    lats = np.asarray(ds.coords["latitude"])[sl[0]]
    lons = np.asarray(ds.coords["longitude"])[sl[1]]
    mask = Lxs > 1e5
    known_cov = open_dataset(reference_data_path("cov_no_hfix.nc"))[
        "covariance"
    ].values

    rng = np.random.default_rng(7)
    n = 1_000
    draws = rng.multivariate_normal(
        np.zeros(known_cov.shape[0]), known_cov, size=n
    )
    test_data = np.array(
        [
            uncompress_masked(draws[i, :], mask.flatten(), fill_value=np.nan)
            for i in range(n)
        ]
    ).reshape((n, *Lxs.shape))
    test_data = np.ma.masked_where(np.isnan(test_data), test_data)

    ellipse = EllipseModel(
        anisotropic=True,
        rotated=True,
        physical_distance=True,
        v=0.5,
        unit_sigma=True,
    )
    builder = EllipseBuilder(
        test_data,
        Coordinates(
            {"time": np.arange(n), "longitude": lons, "latitude": lats}
        ),
    )
    ellipse_params = builder.compute_params(
        default_value=[-999.0] * ellipse.supercategory_n_params,
        matern_ellipse=ellipse,
        bounds=[
            (300.0, 30000.0),
            (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi),
        ],
        guesses=[300.0, 300.0, 0.0],
        max_distance=10_000.0,
        delta_x_method="Modified_Met_Office",
    )
    rebuilt = EllipseCovarianceBuilder(
        np.ma.masked_less(ellipse_params["Lx"].values, -900.0),
        np.ma.masked_less(ellipse_params["Ly"].values, -900.0),
        np.ma.masked_less(ellipse_params["theta"].values, -900.0),
        np.ma.masked_less(
            ellipse_params["standard_deviation"].values, -900.0
        ),
        lats,
        lons,
        v=0.5,
    ).cov_ns
    assert correlation_distance(rebuilt, builder.cov) < 1e-3


def test_ellipse_model_taxonomy():
    m = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True, v=0.5
    )
    assert m.fform == "anisotropic_rotated_pd"
    assert m.model_type == "ps2006_kks2011_ani_r_pd"
    assert m.supercategory == "3_param_matern_pd"
    assert m.n_params == 3
    m2 = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=False, v=1.5
    )
    assert m2.fform == "isotropic"
    assert m2.n_params == 1
    with pytest.raises(ValueError, match="isotropic rotated"):
        EllipseModel(
            anisotropic=False, rotated=True, physical_distance=False, v=0.5
        )
    with pytest.raises(ValueError, match="'v' must be > 0"):
        EllipseModel(
            anisotropic=True, rotated=True, physical_distance=True, v=0.0
        )


def test_ellipse_nll_against_reference_formula(rng):
    """NLL equals a direct scipy/numpy transliteration of the reference."""
    from scipy.special import gamma as sgamma
    from scipy.special import kv as skv
    from scipy.stats import norm

    m = EllipseModel(
        anisotropic=True,
        rotated=True,
        physical_distance=True,
        v=1.5,
        unit_sigma=True,
    )
    X = rng.uniform(-2000, 2000, size=(50, 2))
    params = [1500.0, 800.0, 0.3]

    # reference-style expected correlation
    Lx, Ly, theta = params
    R = np.array(
        [
            [np.cos(theta), -np.sin(theta)],
            [np.sin(theta), np.cos(theta)],
        ]
    )
    sigma = R @ np.diag([Lx**2, Ly**2]) @ R.T
    si = np.linalg.inv(sigma)
    dx, dy = X[:, 0], X[:, 1]
    tau = np.sqrt(
        dx * (dx * si[0, 0] + dy * si[0, 1])
        + dy * (dx * si[1, 0] + dy * si[1, 1])
    )
    inner = 2.0 * tau * np.sqrt(1.5)
    y_ll = inner**1.5 * skv(1.5, inner) / (sgamma(1.5) * 2.0**0.5)
    y = np.clip(y_ll + rng.normal(0, 0.05, size=50), -0.99, 0.99)

    expected = -np.sum(
        norm.logpdf(np.arctanh(y), loc=np.arctanh(y_ll), scale=1.0)
    )
    ours = m.negative_log_likelihood(X, y, params)
    np.testing.assert_allclose(ours, expected, rtol=1e-8)


def test_ellipse_fit_bootstrap_se(rng):
    """Bootstrap SE returns one value per fitted parameter and the fit
    recovers a synthetic isotropic radius."""
    m = EllipseModel(
        anisotropic=False,
        rotated=False,
        physical_distance=False,
        v=0.5,
        unit_sigma=False,
    )
    R_true = 9.0
    d = rng.uniform(0.5, 25.0, 300)
    from scipy.special import kv as skv

    inner = 2.0 * (d / R_true) * np.sqrt(0.5)
    y = inner**0.5 * skv(0.5, inner) / (np.sqrt(np.pi / 2))  # gamma(.5)2^-.5
    # gamma(0.5) * 2^{-0.5} = sqrt(pi/2); add noise
    y = np.clip(y + rng.normal(0, 0.02, 300), -0.999, 0.999)
    res, SE, bounds = m.fit(d, y, estimate_SE="bootstrap_parallel", n_sim=32)
    assert abs(float(res.x[0]) - R_true) < 1.0
    assert SE is not None and SE.shape == (2,)  # R + likelihood sigma
    res2, SE2, _ = m.fit(d, y, estimate_SE=None)
    assert SE2 is None


def _synthetic_builder(rng, size=(8, 10), n=3000, range_km=1500.0):
    """Training cube drawn from a known isotropic covariance."""
    lats = np.linspace(-21.0, 21.0, size[0]).astype(np.float32)
    lons = np.linspace(0.0, 27.0, size[1]).astype(np.float32)
    builder_cov = _initialise_covariance(
        Lx=range_km, Ly=range_km, theta=0.0, stdev=1.0, v=0.5,
        size=size,
    )
    data = rng.multivariate_normal(
        np.zeros(builder_cov.shape[0]), builder_cov, size=n
    ).reshape((n, *size))
    coords = Coordinates(
        {"time": np.arange(n), "latitude": lats, "longitude": lons}
    )
    return EllipseBuilder(data, coords), lats, lons


def test_ellipse_isotropic_compute_params(rng):
    """Isotropic (1-parameter) fits through the batched path."""
    builder, lats, lons = _synthetic_builder(rng)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    params = builder.compute_params(
        default_value=[-999.0] * iso.supercategory_n_params,
        matern_ellipse=iso,
        bounds=[(100.0, 20000.0)],
        guesses=[500.0],
        max_distance=8000.0,
        delta_x_method="Modified_Met_Office",
    )
    R = params["R"].values
    fitted = R[R > 0]
    assert len(fitted) == builder.small_covar_size
    # radii should be broadly near the generating scale
    assert 200.0 < np.median(fitted) < 20000.0
    assert "qc_code" in params


def test_ellipse_degrees_mode_fit(rng):
    """Non-physical-distance (degrees) fform exercises the degree-norm
    selection branch."""
    builder, lats, lons = _synthetic_builder(rng)
    deg_model = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=False,
        v=0.5, unit_sigma=True,
    )
    params = builder.compute_params(
        default_value=[-999.0] * deg_model.supercategory_n_params,
        matern_ellipse=deg_model,
        max_distance=60.0,  # degrees
        min_distance=0.1,
        delta_x_method=None,
        guesses=[5.0, 5.0, 0.0],
        bounds=[(0.5, 50.0), (0.5, 30.0), (-2 * np.pi, 2 * np.pi)],
        physical_distance_selection=False,
    )
    Lx = params["Lx"].values
    fitted = Lx[Lx > 0]
    assert len(fitted) == builder.small_covar_size
    assert (fitted <= 50.0 + 1e-6).all()


def test_ellipse_single_point_parity(rng):
    """fit_ellipse_model (single point) agrees with the batched fit."""
    builder, lats, lons = _synthetic_builder(rng, n=2000)
    model = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    kwargs = dict(
        matern_ellipse=model,
        max_distance=8000.0,
        guesses=[500.0, 500.0, 0.0],
        bounds=[(100.0, 20000.0), (100.0, 20000.0),
                (-2 * np.pi, 2 * np.pi)],
        delta_x_method="Modified_Met_Office",
    )
    single = builder.fit_ellipse_model(xy_point=12, tol=1e-4, **kwargs)
    assert single is not None
    batched = builder.compute_params(
        default_value=[-999.0] * model.supercategory_n_params,
        tol=1e-4,
        **kwargs,
    )
    gi, gj = builder.xi_masked[12], builder.yi_masked[12]
    lx_b = batched["Lx"].values[gj, gi]
    ly_b = batched["Ly"].values[gj, gi]
    # same optimum within NM tolerance scales
    np.testing.assert_allclose(single["ModelParams"][0], lx_b, rtol=0.05)
    np.testing.assert_allclose(single["ModelParams"][1], ly_b, rtol=0.05)


def test_ellipse_lbfgs_and_hessian_se(rng):
    """Gradient-based fit reaches the same optimum as Nelder-Mead, and
    Fisher-information SEs (autodiff Hessian) are finite and comparable
    to bootstrap SEs. The reference cannot do either (scipy Bessel is
    not differentiable; estimate_SE='hessian' raises)."""
    from scipy.special import kv as skv

    m = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=False,
        v=0.5, unit_sigma=False,
    )
    R_true = 9.0
    d = rng.uniform(0.5, 25.0, 400)
    inner = 2.0 * (d / R_true) * np.sqrt(0.5)
    y = inner**0.5 * skv(0.5, inner) / np.sqrt(np.pi / 2)
    y = np.clip(y + rng.normal(0, 0.02, 400), -0.999, 0.999)

    res_nm, se_boot, _ = m.fit(
        d, y, estimate_SE="bootstrap_parallel", n_sim=64
    )
    res_lb, se_hess, _ = m.fit(
        d, y, opt_method="L-BFGS-B", estimate_SE="hessian", tol=1e-8
    )
    assert bool(res_lb.success)
    np.testing.assert_allclose(
        float(res_lb.x[0]), float(res_nm.x[0]), rtol=0.02
    )
    assert np.isfinite(se_hess).all()
    # same order of magnitude as the bootstrap estimate for R
    ratio = se_hess[0] / se_boot[0]
    assert 0.2 < ratio < 5.0

    with pytest.raises(ValueError, match="opt_method"):
        m.fit(d, y, opt_method="Powell", estimate_SE=None)


def test_compute_params_lbfgs_matches_nm(rng):
    """Whole-grid gradient fits land on the same optima as Nelder-Mead."""
    builder, lats, lons = _synthetic_builder(rng, size=(6, 8), n=2000)
    model = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    kwargs = dict(
        default_value=[-999.0] * model.supercategory_n_params,
        matern_ellipse=model,
        max_distance=8000.0,
        guesses=[500.0, 500.0, 0.0],
        bounds=[(100.0, 20000.0), (100.0, 20000.0),
                (-2 * np.pi, 2 * np.pi)],
        delta_x_method="Modified_Met_Office",
    )
    p_nm = builder.compute_params(tol=1e-5, **kwargs)
    p_lb = builder.compute_params(
        tol=1e-5, opt_method="L-BFGS-B", **kwargs
    )
    sel = p_nm["Lx"].values > 0
    np.testing.assert_allclose(
        p_lb["Lx"].values[sel], p_nm["Lx"].values[sel], rtol=0.05
    )
    np.testing.assert_allclose(
        p_lb["Ly"].values[sel], p_nm["Ly"].values[sel], rtol=0.05
    )


def test_cov_builder_lazy_parity_attrs(rng):
    """sigmas / sqrt_dets are computed lazily and match Sigma = R L R'."""
    from glomargridding_jax.models.ellipse.covariance import (
        EllipseCovarianceBuilder,
    )

    nlat, nlon = 4, 5
    Lx = 800 + 200 * rng.random((nlat, nlon))
    Ly = 500 + 100 * rng.random((nlat, nlon))
    th = rng.uniform(-1, 1, (nlat, nlon))
    sd = 0.5 + rng.random((nlat, nlon))
    b = EllipseCovarianceBuilder(
        Lx, Ly, th, sd,
        np.linspace(-30, 30, nlat), np.linspace(0, 40, nlon), v=1.5,
    )
    assert b._sigmas is None  # not materialised by the build
    ct, st = np.cos(th.ravel()), np.sin(th.ravel())
    s00 = ct**2 * Lx.ravel() ** 2 + st**2 * Ly.ravel() ** 2
    s11 = st**2 * Lx.ravel() ** 2 + ct**2 * Ly.ravel() ** 2
    s01 = ct * st * (Lx.ravel() ** 2 - Ly.ravel() ** 2)
    np.testing.assert_allclose(b.sigmas[:, 0], s00, rtol=1e-5)
    np.testing.assert_allclose(b.sigmas[:, 1], s01, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(b.sigmas[:, 3], s11, rtol=1e-5)
    np.testing.assert_allclose(
        b.sqrt_dets,
        np.sqrt(s00 * s11 - s01 * s01),
        rtol=1e-5,
    )


def test_vectorised_postprocess_matches_scalar_semantics(rng):
    """The vectorised compute_params post-processing must agree with the
    scalar _check_params + _get_fit_score pipeline point by point."""
    from glomargridding_jax.models.ellipse.estimate import _get_fit_score

    builder, lats, lons = _synthetic_builder(rng, size=(6, 8), n=2000)
    model = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    bounds = [(100.0, 20000.0), (100.0, 20000.0), (-2 * np.pi, 2 * np.pi)]
    params = builder.compute_params(
        default_value=[-999.0] * model.supercategory_n_params,
        matern_ellipse=model,
        max_distance=8000.0,
        guesses=[500.0, 500.0, 0.0],
        bounds=bounds,
        delta_x_method="Modified_Met_Office",
        tol=1e-5,
    )
    Lx = params["Lx"].values
    Ly = params["Ly"].values
    th = params["theta"].values
    qc = params["qc_code"].values
    nit = params["number_of_iterations"].values
    fitted = Lx > 0
    assert fitted.any()
    # canonical form: Lx >= Ly, theta in (-pi, pi]
    assert (Lx[fitted] >= Ly[fitted]).all()
    assert (th[fitted] > -np.pi).all() and (th[fitted] <= np.pi).all()
    # QC codes recomputed through the scalar scorer must match
    for gj, gi in zip(*np.where(fitted)):
        expected = _get_fit_score(
            [Lx[gj, gi], Ly[gj, gi], th[gj, gi]], bounds, int(nit[gj, gi])
        )
        if qc[gj, gi] != 9:
            assert qc[gj, gi] == expected, (gj, gi)


def test_compute_params_max_train_cols_exact_when_window_covered():
    """K >= in-window column count => bit-identical to unrestricted fit."""
    rng = np.random.default_rng(1234)
    size = (6, 9)
    n_pts = size[0] * size[1]
    n_t = 400
    true_cov = _initialise_covariance(
        Lx=900.0, Ly=600.0, theta=0.4, stdev=1.0, v=0.5, size=size
    )
    data = rng.multivariate_normal(
        np.zeros(n_pts), true_cov, size=n_t
    ).reshape((n_t, *size))
    coords = Coordinates(
        {
            "time": np.arange(n_t),
            "longitude": np.arange(size[1], dtype=np.float32),
            "latitude": np.arange(size[0], dtype=np.float32),
        }
    )
    ellipse = EllipseModel(
        anisotropic=True,
        rotated=True,
        physical_distance=True,
        v=0.5,
        unit_sigma=True,
    )
    kwargs = dict(
        default_value=[0.0] * ellipse.supercategory_n_params,
        matern_ellipse=ellipse,
        bounds=[
            (300.0, 30000.0),
            (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi),
        ],
        guesses=[500.0, 500.0, 0.0],
        max_distance=10_000.0,
        delta_x_method="Modified_Met_Office",
    )
    full = EllipseBuilder(data, coords).compute_params(**kwargs)
    # window = everything but self => n_pts - 1 in-window columns;
    # K = n_pts - 1 < n_pts triggers the top-k gather yet must cover
    # every window exactly
    capped = EllipseBuilder(data, coords).compute_params(
        **kwargs, max_train_cols=n_pts - 1
    )
    # the gather reorders columns, so weighted-NLL summation order
    # changes: equality up to float reassociation, not bitwise
    np.testing.assert_array_equal(
        full["qc_code"].values, capped["qc_code"].values
    )
    for name in ("Lx", "Ly", "theta"):
        np.testing.assert_allclose(
            full[name].values,
            capped[name].values,
            rtol=1e-5,
            atol=1e-6,
            err_msg=name,
        )

    # a genuinely restrictive K still produces valid, converged fits
    small = EllipseBuilder(data, coords).compute_params(
        **kwargs, max_train_cols=30
    )
    qc = small["qc_code"].values
    assert set(np.unique(qc)).issubset({0.0, 1.0, 2.0, 3.0, 9.0})
    assert (small["Lx"].values > 0).mean() > 0.9


def test_ellipse_covariance_operator_matches_dense(rng):
    """Streamed and bf16 matvec forms vs the dense assembly."""
    from glomargridding_jax.models.ellipse.covariance import (
        build_ellipse_covariance,
        ellipse_covariance_operator,
    )
    from glomargridding_jax.ops.distances import sigma_rot_flat
    import jax.numpy as jnp

    n = 300
    lats = jnp.radians(jnp.asarray(rng.uniform(-60, 60, n), jnp.float32))
    lons = jnp.radians(jnp.asarray(rng.uniform(-180, 180, n), jnp.float32))
    Lx = jnp.asarray(rng.uniform(800, 1600, n), jnp.float32)
    Ly = jnp.asarray(rng.uniform(400, 900, n), jnp.float32)
    th = jnp.asarray(rng.uniform(-0.6, 0.6, n), jnp.float32)
    sd = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, th)
    sig = jnp.stack([s00, s01, s11], axis=-1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)

    dense = np.asarray(
        build_ellipse_covariance(
            lats, lons, sig, sqd, sd, v=1.5
        ),
        dtype=np.float64,
    )
    X = rng.normal(size=(n, 7)).astype(np.float32)

    mv, n_out, trace = ellipse_covariance_operator(
        lats, lons, sig, sqd, sd, v=1.5, store="stream", n_blocks=7
    )
    assert n_out == n
    assert trace == pytest.approx(float(np.trace(dense)), rel=1e-5)
    got = np.asarray(mv(jnp.asarray(X)))
    np.testing.assert_allclose(got, dense @ X, rtol=2e-4, atol=2e-4)
    # 1-d input path
    got1 = np.asarray(mv(jnp.asarray(X[:, 0])))
    np.testing.assert_allclose(got1, dense @ X[:, 0], rtol=2e-4, atol=2e-4)

    mv16, _, trace16 = ellipse_covariance_operator(
        lats, lons, sig, sqd, sd, v=1.5, store="bf16", n_blocks=7
    )
    assert trace16 == pytest.approx(trace, rel=1e-6)
    got16 = np.asarray(mv16(jnp.asarray(X)))
    scale = np.abs(dense @ X).max()
    assert np.abs(got16 - dense @ X).max() / scale < 2e-2
    got16_1 = np.asarray(mv16(jnp.asarray(X[:, 0])))
    np.testing.assert_allclose(
        got16_1, got16[:, 0], rtol=1e-6, atol=1e-6
    )
    with pytest.raises(ValueError, match="Unknown store"):
        ellipse_covariance_operator(
            lats, lons, sig, sqd, sd, v=1.5, store="dense"
        )


def test_operator_clip_to_lowrank_ensemble(rng):
    """65k-style flow at toy size: operator -> clip -> kriging, vs the
    same clip run on the dense matrix."""
    import jax
    import jax.numpy as jnp

    from glomargridding_jax.models.ellipse.covariance import (
        build_ellipse_covariance,
        ellipse_covariance_operator,
    )
    from glomargridding_jax.models.lowrank import lowrank_kriging
    from glomargridding_jax.ops.covariance_tools import (
        explained_variance_clip_lowrank,
    )
    from glomargridding_jax.ops.distances import sigma_rot_flat

    n = 400
    lats = jnp.radians(
        jnp.asarray(np.linspace(-60, 60, n), jnp.float32)
    )
    lons = jnp.radians(
        jnp.asarray(np.linspace(-170, 170, n), jnp.float32)
    )
    Lx = jnp.full((n,), 3000.0, jnp.float32)
    Ly = jnp.full((n,), 2000.0, jnp.float32)
    th = jnp.zeros((n,), jnp.float32)
    sd = jnp.ones((n,), jnp.float32)
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, th)
    sig = jnp.stack([s00, s01, s11], axis=-1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)

    mv, n_out, trace = ellipse_covariance_operator(
        lats, lons, sig, sqd, sd, v=1.5, store="stream", n_blocks=8
    )
    psd_op = explained_variance_clip_lowrank(
        mv, n=n_out, trace=trace,
        target_variance_fraction=0.9, key=jax.random.key(0),
        k0=64, max_rank=256,
    )
    dense = build_ellipse_covariance(
        lats, lons, sig, sqd, sd, v=1.5
    )
    psd_dense = explained_variance_clip_lowrank(
        dense, target_variance_fraction=0.9, key=jax.random.key(0),
        k0=64, max_rank=256,
    )
    assert psd_op.rank == psd_dense.rank
    np.testing.assert_allclose(
        np.sort(np.asarray(psd_op.gains)),
        np.sort(np.asarray(psd_dense.gains)),
        rtol=1e-3, atol=1e-5,
    )

    idx = np.sort(rng.choice(n, 60, replace=False))
    y = rng.normal(size=60)
    E = 0.05 * np.eye(60)
    r_op = lowrank_kriging(psd_op, idx, y, E)
    r_dense = lowrank_kriging(psd_dense, idx, y, E)
    np.testing.assert_allclose(
        r_op.field, r_dense.field, rtol=1e-4, atol=1e-5
    )


def test_operator_recreation_hits_jit_cache(rng):
    """Re-creating the covariance operator (monthly production) must
    reuse the module-level compiled programs, not retrace fresh
    closures."""
    import jax.numpy as jnp

    from glomargridding_jax.models.ellipse.covariance import (
        _operator_build,
        ellipse_covariance_operator,
    )
    from glomargridding_jax.ops.distances import sigma_rot_flat

    n = 96
    lats = jnp.asarray(np.radians(rng.uniform(-60, 60, n)), jnp.float32)
    lons = jnp.asarray(np.radians(rng.uniform(-180, 180, n)), jnp.float32)
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.full((n,), 1200.0), jnp.full((n,), 700.0), jnp.zeros((n,))
    )
    sig = jnp.stack([s00, s01, s11], axis=-1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)
    sd = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)

    before = _operator_build._cache_size()
    mv1, _, _ = ellipse_covariance_operator(
        lats, lons, sig, sqd, sd, v=1.5, store="bf16"
    )
    mv1(jnp.ones((n,), jnp.float32))
    after_first = _operator_build._cache_size()
    mv2, _, _ = ellipse_covariance_operator(
        lats, lons, sig, sqd, sd, v=1.5, store="bf16"
    )
    mv2(jnp.ones((n,), jnp.float32))
    after_second = _operator_build._cache_size()
    assert after_first == before + 1
    assert after_second == after_first  # warm re-creation: no retrace


def test_compute_params_lm_matches_nm(rng):
    """Levenberg-Marquardt on the Fisher-z least-squares form lands on
    the same optima as Nelder-Mead (round-3 throughput lane)."""
    builder, lats, lons = _synthetic_builder(rng, size=(6, 8), n=2000)
    model = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    kwargs = dict(
        default_value=[-999.0] * model.supercategory_n_params,
        matern_ellipse=model,
        max_distance=8000.0,
        guesses=[500.0, 500.0, 0.0],
        bounds=[(100.0, 20000.0), (100.0, 20000.0),
                (-2 * np.pi, 2 * np.pi)],
        delta_x_method="Modified_Met_Office",
    )
    p_nm = builder.compute_params(tol=1e-5, **kwargs)
    p_lm = builder.compute_params(tol=1e-8, opt_method="lm", **kwargs)
    sel = p_nm["Lx"].values > 0
    np.testing.assert_allclose(
        p_lm["Lx"].values[sel], p_nm["Lx"].values[sel], rtol=0.05
    )
    np.testing.assert_allclose(
        p_lm["Ly"].values[sel], p_nm["Ly"].values[sel], rtol=0.05
    )
    # LM must actually converge (QC != 9) wherever NM did
    qc_nm = p_nm["qc_code"].values[sel]
    qc_lm = p_lm["qc_code"].values[sel]
    assert (qc_lm[qc_nm != 9] != 9).all()


def test_lazy_cor_matches_dense_compute_params(rng):
    """cor_mode='lazy' == 'dense' for whole-grid fits and row access.

    The lazy path never forms the (n, n) correlation: chunk rows are
    rebuilt inside the fit program from the (T, n) normalised samples.
    Same contraction per element, so parameters agree to float
    tolerance and QC codes exactly.
    """
    size = (6, 9)
    n_pts = size[0] * size[1]
    n_t = 300
    true_cov = _initialise_covariance(
        Lx=900.0, Ly=700.0, theta=0.2, stdev=1.0, v=0.5, size=size
    )
    data = rng.multivariate_normal(
        np.zeros(n_pts), true_cov, size=n_t
    ).reshape((n_t, *size))
    coords = Coordinates(
        {
            "time": np.arange(n_t),
            "longitude": np.arange(size[1], dtype=np.float32),
            "latitude": np.arange(size[0], dtype=np.float32),
        }
    )
    ellipse = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    kwargs = dict(
        default_value=[0.0] * ellipse.supercategory_n_params,
        matern_ellipse=ellipse,
        bounds=[
            (300.0, 30000.0),
            (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi),
        ],
        guesses=[500.0, 500.0, 0.0],
        max_distance=10_000.0,
        delta_x_method="Modified_Met_Office",
        max_train_cols=n_pts - 1,  # exercise top-k on the lazy rows
    )
    dense_b = EllipseBuilder(data, coords, cor_mode="dense")
    lazy_b = EllipseBuilder(data, coords, cor_mode="lazy")

    from glomargridding_jax.models.ellipse.estimate import _LazyCorrelation

    assert isinstance(lazy_b.cor, _LazyCorrelation)
    assert not isinstance(dense_b.cor, _LazyCorrelation)

    # row access parity (the fit_ellipse_model / _get_train_data path)
    np.testing.assert_allclose(
        np.asarray(lazy_b.cor[3, :]),
        np.asarray(dense_b.cor[3, :]),
        rtol=1e-5, atol=1e-6,
    )
    assert float(lazy_b.cor[3, 3]) == 1.0

    dense_p = dense_b.compute_params(**kwargs)
    lazy_p = lazy_b.compute_params(**kwargs)
    np.testing.assert_array_equal(
        dense_p["qc_code"].values, lazy_p["qc_code"].values
    )
    for name in ("Lx", "Ly", "theta"):
        np.testing.assert_allclose(
            dense_p[name].values, lazy_p[name].values,
            rtol=1e-4, atol=1e-5, err_msg=name,
        )

    # bulk reads refuse to materialise n^2
    import pytest as _pytest

    with _pytest.raises((MemoryError, TypeError)):
        np.asarray(lazy_b.cor)
    with _pytest.raises(TypeError):
        lazy_b.cor[:, 0]


def test_device_cube_builder_matches_host(rng):
    """EllipseBuilder(jax.Array) == EllipseBuilder(numpy) end-to-end.

    The device path detects the mask by a NaN reduction, gathers kept
    columns on device, and never fetches the cube; fits must agree
    with the host/np.ma path exactly (identical kept samples).
    """
    import jax.numpy as _jnp

    size = (6, 9)
    n_pts = size[0] * size[1]
    n_t = 200
    true_cov = _initialise_covariance(
        Lx=900.0, Ly=700.0, theta=0.2, stdev=1.0, v=0.5, size=size
    )
    data = rng.multivariate_normal(
        np.zeros(n_pts), true_cov, size=n_t
    ).reshape((n_t, *size)).astype(np.float32)
    # mask two cells: NaN on the device cube, np.ma on the host cube
    data_dev = data.copy()
    data_dev[:, 0, 0] = np.nan
    data_dev[:, 3, 4] = np.nan
    mask = np.zeros(size, bool)
    mask[0, 0] = mask[3, 4] = True
    data_host = np.ma.masked_where(
        np.broadcast_to(mask, data.shape), data
    )
    coords = Coordinates(
        {
            "time": np.arange(n_t),
            "longitude": np.arange(size[1], dtype=np.float32),
            "latitude": np.arange(size[0], dtype=np.float32),
        }
    )
    b_dev = EllipseBuilder(_jnp.asarray(data_dev), coords)
    b_host = EllipseBuilder(data_host, coords)
    assert b_dev.small_covar_size == b_host.small_covar_size == n_pts - 2
    np.testing.assert_array_equal(b_dev.mask, b_host.mask)
    np.testing.assert_allclose(
        np.asarray(b_dev.cor), np.asarray(b_host.cor),
        rtol=1e-5, atol=1e-6,
    )

    ellipse = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    kwargs = dict(
        default_value=[0.0] * ellipse.supercategory_n_params,
        matern_ellipse=ellipse,
        bounds=[
            (300.0, 30000.0),
            (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi),
        ],
        guesses=[500.0, 500.0, 0.0],
        max_distance=10_000.0,
        delta_x_method="Modified_Met_Office",
    )
    p_dev = b_dev.compute_params(**kwargs)
    p_host = b_host.compute_params(**kwargs)
    np.testing.assert_array_equal(
        p_dev["qc_code"].values, p_host["qc_code"].values
    )
    for name in ("Lx", "Ly", "theta"):
        np.testing.assert_allclose(
            p_dev[name].values, p_host[name].values,
            rtol=1e-4, atol=1e-5, err_msg=name,
        )


def test_compute_params_checkpoint_resume(rng, tmp_path):
    """Chunk-level checkpoint/resume: a partial checkpoint is continued
    (already-fitted chunks are NOT refit), a complete checkpoint returns
    without fitting, and a config change is refused."""
    builder, lats, lons = _synthetic_builder(rng, size=(6, 8), n=1500)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    ckpt = str(tmp_path / "fit_ckpt.npz")
    kwargs = dict(
        default_value=[-999.0] * iso.supercategory_n_params,
        matern_ellipse=iso,
        bounds=[(100.0, 20000.0)],
        guesses=[500.0],
        max_distance=8000.0,
        delta_x_method="Modified_Met_Office",
        chunk_size=16,
    )

    import glomargridding_jax.models.ellipse.estimate as est

    # Count GROUP DISPATCHES (with dispatch_chunks=1, one per chunk) by
    # wrapping the cached group-fit program; the per-chunk work itself
    # is inside one jitted scan, so optimiser-level counters never fire.
    calls = {"n": 0, "fail_after": None}
    real_group_fit_fn = est._group_fit_fn

    def counting_group_fit_fn(*args, **kw):
        run = real_group_fit_fn(*args, **kw)

        def counting_run(*a, **k):
            if (
                calls["fail_after"] is not None
                and calls["n"] >= calls["fail_after"]
            ):
                raise KeyboardInterrupt("simulated preemption")
            calls["n"] += 1
            return run(*a, **k)

        return counting_run

    est._group_fit_fn = counting_group_fit_fn
    try:
        # reference run without checkpointing
        p_ref = builder.compute_params(**kwargs)
        full_chunks = calls["n"]
        assert full_chunks == 3  # 48 points / 16

        # run 1: checkpoint every chunk, cut short after 2 chunks
        calls["n"] = 0
        calls["fail_after"] = 2
        with pytest.raises(KeyboardInterrupt):
            builder.compute_params(
                checkpoint=ckpt, checkpoint_every=1, **kwargs
            )
        assert os.path.exists(ckpt)

        # run 2: resume — only the remaining chunk is fitted
        calls["n"] = 0
        calls["fail_after"] = None
        p_res = builder.compute_params(
            checkpoint=ckpt, checkpoint_every=1, **kwargs
        )
        assert calls["n"] == full_chunks - 2
        np.testing.assert_array_equal(
            p_res["R"].values, p_ref["R"].values
        )
        np.testing.assert_array_equal(
            p_res["qc_code"].values, p_ref["qc_code"].values
        )

        # run 3: complete checkpoint — nothing is refit
        calls["n"] = 0
        p_done = builder.compute_params(checkpoint=ckpt, **kwargs)
        assert calls["n"] == 0
        np.testing.assert_array_equal(
            p_done["R"].values, p_ref["R"].values
        )

        # config change is refused
        with pytest.raises(ValueError, match="different configuration"):
            builder.compute_params(
                checkpoint=ckpt,
                **{**kwargs, "max_distance": 5000.0},
            )

        # a DIFFERENT TRAINING CUBE is refused too (same shape/config):
        # the fingerprint checksums the centred samples, so a completed
        # checkpoint cannot silently return another cube's fits
        builder2, _, _ = _synthetic_builder(
            np.random.default_rng(999), size=(6, 8), n=1500
        )
        with pytest.raises(ValueError, match="different configuration"):
            builder2.compute_params(checkpoint=ckpt, **kwargs)
    finally:
        est._group_fit_fn = real_group_fit_fn


def test_compute_params_dispatch_chunks_match(rng):
    """dispatch_chunks>1 (one lax.scan per group) must reproduce the
    single-dispatch path to float tolerance — same per-chunk
    computation, one RPC per group. Covers the padded final group
    (5 chunks, groups of 2)."""
    builder, lats, lons = _synthetic_builder(rng, size=(8, 10), n=1500)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    kwargs = dict(
        default_value=[-999.0] * iso.supercategory_n_params,
        matern_ellipse=iso,
        bounds=[(100.0, 20000.0)],
        guesses=[500.0],
        max_distance=8000.0,
        delta_x_method="Modified_Met_Office",
        chunk_size=16,  # 80 points -> 5 chunks
    )
    p1 = builder.compute_params(**kwargs)
    p2 = builder.compute_params(dispatch_chunks=2, **kwargs)
    np.testing.assert_array_equal(
        p1["qc_code"].values, p2["qc_code"].values
    )
    np.testing.assert_allclose(
        p2["R"].values, p1["R"].values, rtol=1e-6, atol=1e-6
    )
    # XLA schedules the scan body slightly differently from the lone
    # dispatch, so a few lanes' NM termination shifts by one iteration
    # (the optima above still agree to 1e-6)
    assert (
        np.abs(
            p1["number_of_iterations"].values
            - p2["number_of_iterations"].values
        )
        <= 2
    ).all()


def test_compute_params_hessian_se(rng):
    """estimate_SE='hessian' adds whole-grid Fisher-information SE
    fields, matching the single-point autodiff Hessian SE (the
    reference raises NotImplementedError for Hessian SEs and its
    whole-grid loop discards SEs entirely)."""
    builder, lats, lons = _synthetic_builder(rng, size=(6, 8), n=2000)
    model = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    kwargs = dict(
        default_value=[-999.0] * model.supercategory_n_params,
        matern_ellipse=model,
        max_distance=8000.0,
        guesses=[500.0, 500.0, 0.0],
        bounds=[(100.0, 20000.0), (100.0, 20000.0),
                (-2 * np.pi, 2 * np.pi)],
        delta_x_method="Modified_Met_Office",
        tol=1e-5,
    )
    p0 = builder.compute_params(**kwargs)
    assert "Lx_se" not in p0.data_vars  # opt-in only

    p = builder.compute_params(estimate_SE="hessian", **kwargs)
    for name in ("Lx_se", "Ly_se", "theta_se"):
        assert name in p.data_vars

    qc = p["qc_code"].values
    fitted = p["Lx"].values > 0
    interior = fitted & (qc == 0)
    assert interior.sum() > 10
    lx_se = p["Lx_se"].values
    assert np.isfinite(lx_se[interior]).all()
    assert (lx_se[interior] > 0).all()
    # informative data: SEs are the same order as the estimates, not
    # degenerate (tiny fixture grid -> wide but finite intervals)
    rel = lx_se[interior] / p["Lx"].values[interior]
    assert np.median(rel) < 1.0

    # parity with the single-point Hessian SE at one interior point
    interior_pts = interior[
        np.asarray(builder.yi_masked), np.asarray(builder.xi_masked)
    ]
    pt = int(np.flatnonzero(interior_pts)[0])
    single = builder.fit_ellipse_model(
        pt, model,
        max_distance=8000.0,
        guesses=[500.0, 500.0, 0.0],
        bounds=[(100.0, 20000.0), (100.0, 20000.0),
                (-2 * np.pi, 2 * np.pi)],
        delta_x_method="Modified_Met_Office",
        tol=1e-5,
        estimate_SE="hessian",
    )
    se_single = np.asarray(single["StandardError"]).copy()
    raw_x = np.asarray(single["Results"].x)
    if raw_x[1] > raw_x[0]:
        # the single-point API canonicalises Lx >= Ly in ModelParams but
        # reports SE at the raw optimum; the whole-grid fields swap SEs
        # together with the axes
        se_single[[0, 1]] = se_single[[1, 0]]
    gj = np.asarray(builder.yi_masked)[pt]
    gi = np.asarray(builder.xi_masked)[pt]
    se_grid = np.array(
        [p["Lx_se"].values[gj, gi], p["Ly_se"].values[gj, gi],
         p["theta_se"].values[gj, gi]]
    )
    np.testing.assert_allclose(se_grid, se_single, rtol=0.1)


def test_checkpoint_schema_upgrade_refits(rng, tmp_path):
    """A checkpoint whose fingerprint has a DIFFERENT KEY SET (an older
    library format) warns and refits; only a same-schema value mismatch
    refuses."""
    import json as _json

    builder, _, _ = _synthetic_builder(rng, size=(4, 6), n=800)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    ckpt = str(tmp_path / "old_format.npz")
    # fabricate an old-format checkpoint: valid npz, fingerprint JSON
    # missing the round-3 "data" key
    old_fp = _json.dumps({"n_points": 24, "model": "old"})
    np.savez(
        ckpt,
        fingerprint=np.asarray(old_fp),
        n_done=np.asarray(24),
        x=np.zeros((24, 1)),
        nit=np.zeros(24),
        success=np.ones(24, bool),
        has_data=np.ones(24, bool),
    )
    with pytest.warns(UserWarning, match="older"):
        params = builder.compute_params(
            default_value=[-999.0] * iso.supercategory_n_params,
            matern_ellipse=iso,
            bounds=[(100.0, 20000.0)],
            guesses=[500.0],
            max_distance=8000.0,
            delta_x_method="Modified_Met_Office",
            chunk_size=16,
            checkpoint=ckpt,
        )
    # refit actually happened (fabricated zeros would all be qc 9/bounds)
    assert np.isfinite(params["R"].values).any()


def test_checkpoint_corrupt_fingerprint_refuses(rng, tmp_path):
    """An UNPARSEABLE fingerprint (corrupt file, or checkpoint= pointed
    at an unrelated npz) refuses instead of scheduling the file for
    overwrite — only a parseable dict with a different key set proves a
    library-format upgrade."""
    builder, _, _ = _synthetic_builder(rng, size=(4, 6), n=800)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    ckpt = str(tmp_path / "corrupt.npz")
    np.savez(ckpt, fingerprint=np.asarray("{not json"),
             n_done=np.asarray(0))
    with pytest.raises(ValueError, match="different configuration"):
        builder.compute_params(
            default_value=[-999.0] * iso.supercategory_n_params,
            matern_ellipse=iso,
            bounds=[(100.0, 20000.0)],
            guesses=[500.0],
            max_distance=8000.0,
            delta_x_method="Modified_Met_Office",
            chunk_size=16,
            checkpoint=ckpt,
        )
    assert os.path.exists(ckpt)  # file untouched


def test_banded_stream_operator_exact_vs_dense(rng):
    """With max_dist set, the stream operator skips provably-zero tiles
    via latitude-gap certificates; results must be EXACT vs the dense
    masked covariance (omitted tiles are exact zeros)."""
    import jax.numpy as jnp

    from glomargridding_jax.models.ellipse.covariance import (
        build_ellipse_covariance,
        ellipse_covariance_operator,
    )
    from glomargridding_jax.ops.distances import sigma_rot_flat

    n = 700
    # lat-SORTED points (the grid compression order) so banding bites
    lats_deg = np.sort(rng.uniform(-75, 75, n)).astype(np.float32)
    lons_deg = rng.uniform(-180, 180, n).astype(np.float32)
    lats = jnp.radians(jnp.asarray(lats_deg))
    lons = jnp.radians(jnp.asarray(lons_deg))
    Lx = jnp.asarray(rng.uniform(800, 1600, n), jnp.float32)
    Ly = jnp.asarray(rng.uniform(400, 900, n), jnp.float32)
    th = jnp.asarray(rng.uniform(-0.6, 0.6, n), jnp.float32)
    sd = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, th)
    sig = jnp.stack([s00, s01, s11], axis=-1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)

    max_dist = 2500.0
    dense = np.asarray(
        build_ellipse_covariance(
            lats, lons, sig, sqd, sd, v=1.5,
            max_dist=max_dist,
        ),
        dtype=np.float64,
    )
    X = rng.normal(size=(n, 5)).astype(np.float32)

    mv, n_out, trace = ellipse_covariance_operator(
        lats, lons, sig, sqd, sd, v=1.5,
        store="stream", max_dist=max_dist, n_blocks=6,
    )
    got = np.asarray(mv(jnp.asarray(X)))
    np.testing.assert_allclose(got, dense @ X, rtol=2e-4, atol=2e-4)
    got1 = np.asarray(mv(jnp.asarray(X[:, 0])))
    np.testing.assert_allclose(
        got1, dense @ X[:, 0], rtol=2e-4, atol=2e-4
    )
    # (window NARROWING at production sizes is asserted in
    # test_band_plan_certificates — at n=700 a 256-element chunk spans
    # ~55 degrees of latitude, so the plan legitimately keeps all
    # chunks active here)


def test_grouped_chunked_stream_exact(rng, monkeypatch):
    """The column-chunked grouped stream (the 0.1-degree working-set
    path, forced here by shrinking the tile limit) matches the
    single-slice grouped path and the dense masked covariance exactly:
    padded columns are edge-padded params x zero-padded x, so they
    contribute exact zeros."""
    import jax.numpy as jnp

    from glomargridding_jax.models.ellipse import covariance as cov
    from glomargridding_jax.ops.distances import sigma_rot_flat

    n = 1500
    lats_deg = np.sort(rng.uniform(-75, 75, n)).astype(np.float32)
    lons_deg = rng.uniform(-180, 180, n).astype(np.float32)
    lats = jnp.radians(jnp.asarray(lats_deg))
    lons = jnp.radians(jnp.asarray(lons_deg))
    Lx = jnp.asarray(rng.uniform(800, 1600, n), jnp.float32)
    Ly = jnp.asarray(rng.uniform(400, 900, n), jnp.float32)
    th = jnp.asarray(rng.uniform(-0.6, 0.6, n), jnp.float32)
    sd = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, th)
    sig = jnp.stack([s00, s01, s11], axis=-1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)
    X = jnp.asarray(rng.normal(size=(n, 5)).astype(np.float32))

    def build(max_dist):
        mv, _, _ = cov.ellipse_covariance_operator(
            lats, lons, sig, sqd, sd, v=1.5,
            store="stream", max_dist=max_dist, n_blocks=6,
        )
        return mv

    mv = build(1500.0)
    assert mv.band_stats["banded"], "test needs a narrowed window"
    want = np.asarray(mv(X))

    # force the chunked path (tile limit 0) with a few chunks per
    # window (ccw -> 256 => >= 2 chunks at any banded bwg here)
    monkeypatch.setattr(cov, "_GROUP_TILE_LIMIT_BYTES", 0)
    monkeypatch.setattr(cov, "_GROUP_CC_BYTES", 1)
    # same tile algebra; only the dot's K-summation order differs.
    # Concrete x routes the PER-GROUP multidispatch form; traced x
    # the single-program form — both must match the single-slice path.
    got = np.asarray(mv(X))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    got1 = np.asarray(mv(X[:, 0]))
    np.testing.assert_allclose(
        got1, want[:, 0], rtol=2e-6, atol=2e-6
    )
    import jax

    got_tr = np.asarray(jax.jit(mv)(X))
    np.testing.assert_allclose(got_tr, want, rtol=2e-6, atol=2e-6)

    # and vs the dense masked covariance (correctness, not just parity)
    dense = np.asarray(
        cov.build_ellipse_covariance(
            lats, lons, sig, sqd, sd, v=1.5,
            max_dist=1500.0,
        ),
        dtype=np.float64,
    )
    np.testing.assert_allclose(
        got, dense @ np.asarray(X), rtol=2e-4, atol=2e-4
    )


def test_interval_windows_sorted_matches_pairwise(rng):
    """The O(n log n) searchsorted window path (lat-sorted column
    intervals — every lat-major grid) must return exactly the windows
    of the O(n^2) pairwise scan; unsorted input takes the fallback."""
    from glomargridding_jax.models.ellipse.covariance import (
        _interval_windows,
    )

    for trial in range(5):
        c = np.sort(rng.uniform(-80, 80, 37))
        bmin, bmax = c - rng.uniform(0, 2, 37), c + rng.uniform(0, 2, 37)
        # bmin sorted by construction; force bmax monotone too
        bmax = np.maximum.accumulate(bmax)
        amin = rng.uniform(-85, 85, 23)
        amax = amin + rng.uniform(0, 3, 23)
        thresh = rng.uniform(0.5, 10.0)

        has_s, first_s, last_s = _interval_windows(
            amin, amax, bmin, bmax, thresh
        )
        # pairwise oracle (the fallback formula, computed directly)
        gap = np.maximum(
            0.0,
            np.maximum(
                amin[:, None] - bmax[None, :],
                bmin[None, :] - amax[:, None],
            ),
        )
        active = gap <= thresh
        has = active.any(axis=1)
        first = np.where(has, np.argmax(active, axis=1), 0)
        last = np.where(
            has, 36 - np.argmax(active[:, ::-1], axis=1), 0
        )
        np.testing.assert_array_equal(has_s, has)
        np.testing.assert_array_equal(first_s, first)
        np.testing.assert_array_equal(last_s, last)

    # unsorted columns: the fallback must be taken and agree with the
    # oracle by construction
    perm = rng.permutation(37)
    has_u, first_u, last_u = _interval_windows(
        amin, amax, bmin[perm], bmax[perm], thresh
    )
    gap = np.maximum(
        0.0,
        np.maximum(
            amin[:, None] - bmax[perm][None, :],
            bmin[perm][None, :] - amax[:, None],
        ),
    )
    active = gap <= thresh
    has = active.any(axis=1)
    np.testing.assert_array_equal(has_u, has)


def test_band_plan_certificates(rng):  # noqa: C901
    """The latitude-gap band plan: windows cover every pair within the
    cutoff, and each row block's [first, last] kernel band holds the
    diagonal and every column block within the cutoff."""
    from glomargridding_jax.constants import RADIUS_OF_EARTH_KM
    from glomargridding_jax.models.ellipse.covariance import (
        _stream_band_plan,
    )

    n, block, chunk, chunk_p = 6000, 512, 256, 512
    lat = np.sort(rng.uniform(-1.2, 1.2, n))  # radians
    pad = (-n) % block
    lat_pad = np.pad(lat, (0, pad), mode="edge")
    md = 800.0
    col_starts, bw, first, last = _stream_band_plan(
        lat_pad, lat, n, block, md, chunk, chunk_p
    )
    n_blocks = len(lat_pad) // block
    assert col_starts.shape == (n_blocks,)
    n_p = -(-n // chunk_p)
    assert first.shape == last.shape == (n_p,)
    assert (first <= np.arange(n_p)).all()
    assert (last >= np.arange(n_p)).all()
    assert (first >= 0).all() and (last <= n_p - 1).all()
    # at this density the window must actually narrow (that is the
    # whole point of the plan)
    assert bw < n // 2, bw
    assert (last - first).max() + 1 < n_p

    thresh = md / RADIUS_OF_EARTH_KM
    # brute-force: every (row point, col point) pair within the cutoff
    # must fall inside its row block's column window
    for b in range(n_blocks):
        rows = lat_pad[b * block : (b + 1) * block]
        close = np.abs(rows[:, None] - lat[None, :]) <= thresh
        cols_needed = np.where(close.any(axis=0))[0]
        if len(cols_needed):
            assert cols_needed.min() >= 0
            assert cols_needed.min() >= col_starts[b] or (
                col_starts[b] == 0
            )
            assert cols_needed.max() < col_starts[b] + bw
    # kernel band certificate at chunk_p granularity
    ppad = n_p * chunk_p - n
    latp = np.pad(lat, (0, ppad), mode="edge").reshape(n_p, chunk_p)
    for i in range(n_p):
        for j in range(n_p):
            gap = max(
                0.0,
                latp[j].min() - latp[i].max(),
                latp[i].min() - latp[j].max(),
            )
            if gap <= thresh:
                assert first[i] <= j <= last[i], (i, j)


def test_ellipse_matvec_pallas_interpret(rng):
    """The fused Triton matvec kernel (Pallas interpreter off the GPU),
    driven with the operator's own band plan == dense covariance
    product, banded and unbanded."""
    import jax.numpy as jnp

    from glomargridding_jax.models.ellipse.covariance import (
        _stream_band_plan,
        build_ellipse_covariance,
    )
    from glomargridding_jax.models.ellipse.stream_kernel import (
        BLOCK,
        ellipse_matvec,
    )
    from glomargridding_jax.ops.distances import sigma_rot_flat

    n = 1300
    lats_deg = np.sort(rng.uniform(-70, 70, n)).astype(np.float32)
    lons_deg = rng.uniform(-180, 180, n).astype(np.float32)
    lats = jnp.radians(jnp.asarray(lats_deg))
    lons = jnp.radians(jnp.asarray(lons_deg))
    Lx = jnp.asarray(rng.uniform(900, 1800, n), jnp.float32)
    Ly = jnp.asarray(rng.uniform(500, 900, n), jnp.float32)
    th = jnp.asarray(rng.uniform(-0.5, 0.5, n), jnp.float32)
    sd = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
    s00, s01, _, s11 = sigma_rot_flat(Lx, Ly, th)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)
    sig = jnp.stack([s00, s01, s11], axis=-1)

    n_p = -(-n // BLOCK)
    cpad = n_p * BLOCK - n

    def padded(a):
        return jnp.pad(a, (0, cpad), mode="edge")

    cols = tuple(padded(a) for a in (lats, lons, s00, s01, s11, sqd, sd))
    X = rng.normal(size=(n, 3)).astype(np.float32)
    Xp = jnp.pad(jnp.asarray(X), ((0, cpad), (0, 0)))

    for max_dist in (None, 2500.0):
        dense = np.asarray(
            build_ellipse_covariance(
                lats, lons, sig, sqd, sd, v=1.5, max_dist=max_dist,
            ),
            dtype=np.float64,
        )
        md = 0.0 if max_dist is None else max_dist
        if max_dist is None:
            first = np.zeros(n_p, np.int32)
            last = np.full(n_p, n_p - 1, np.int32)
        else:
            lat_np = np.asarray(lats, np.float64)
            _, _, first, last = _stream_band_plan(
                np.pad(lat_np, (0, cpad), mode="edge"),
                lat_np, n, BLOCK, md, 256, BLOCK,
            )
            assert (last - first + 1).sum() < n_p * n_p
        y = ellipse_matvec(
            cols, Xp, first, last,
            kparams=(1.5, "Modified_Met_Office", md, max_dist is not None),
            interpret=True,
        )
        assert y.shape == (n_p * BLOCK, 3)
        got = np.asarray(y[:n]) + np.asarray(sd)[:, None] ** 2 * X
        want = dense @ X
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-4, max_dist


def test_group_windows_cover_and_clamp():
    """Group windows cover every member row block's window and stay
    inside the padded column range."""
    from glomargridding_jax.models.ellipse.covariance import (
        _group_windows,
    )

    col_starts = np.asarray(
        [0, 256, 256, 512, 1024, 1536, 1792, 1792], np.int32
    )
    bw, n_cols_pad, chunk = 512, 2560, 256
    n_blocks = len(col_starts)
    G, rpg = 3, 3
    nb_pad = G * rpg  # one padding block repeating the last start
    gs, bwg = _group_windows(
        col_starts, bw, n_blocks, nb_pad, G, rpg, n_cols_pad, chunk
    )
    assert gs.shape == (G,)
    assert bwg % chunk == 0
    assert (gs >= 0).all() and (gs + bwg <= n_cols_pad).all()
    # every row block's [start, start+bw) window sits inside its group
    cs = np.concatenate([col_starts, [col_starts[-1]]]).reshape(G, rpg)
    for g in range(G):
        assert (cs[g] >= gs[g]).all()
        assert (cs[g] + bw <= gs[g] + bwg).all()
