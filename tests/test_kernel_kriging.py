"""Kernel-functional (large-N streamed) kriging vs the dense class path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glomargridding_jax.models.kernel_kriging import (
    ensemble_from_kernel,
    kriging_from_kernel,
    months_scan_kriging,
    variogram_kernel,
)
from glomargridding_jax.models.kriging import OrdinaryKriging, SimpleKriging
from glomargridding_jax.ops.distances import haversine_matrix
from glomargridding_jax.ops.variogram import MaternVariogram


def _grid_problem(rng, n_lat=12, n_lon=24, n_obs=20):
    lat = np.arange(-82.5, 90, 180.0 / n_lat)
    lon = np.arange(-172.5, 180, 360.0 / n_lon)
    glat = np.repeat(lat, n_lon)
    glon = np.tile(lon, n_lat)
    m = len(glat)
    idx = np.sort(rng.choice(m, n_obs, replace=False))
    obs = rng.normal(size=n_obs)
    err = np.diag(0.1 + 0.05 * rng.random(n_obs))
    return glat, glon, idx, obs, err


@pytest.mark.parametrize("method", ["ordinary", "simple"])
def test_kernel_matches_dense_class(rng, method):
    glat, glon, idx, obs, err = _grid_problem(rng)
    vario = MaternVariogram(psill=1.2, nugget=0.0, range=2000.0, nu=1.5)
    kernel = variogram_kernel(vario)

    res = kriging_from_kernel(
        kernel,
        glat,
        glon,
        idx,
        obs,
        error_cov=err,
        variance=1.2,
        method=method,
        n_blocks=6,
    )

    # dense covariance reference through the class API
    d = np.asarray(haversine_matrix(glat, glon))
    cov = np.asarray(vario.covariance(d, variance=1.2))
    cls = OrdinaryKriging if method == "ordinary" else SimpleKriging
    K = cls(cov, idx=idx, obs=obs, error_cov=err)
    k_ref = K.solve()
    u_ref = K.get_uncertainty()
    a_ref = K.constraint_mask()

    # the streamed kernel evaluates the central angle via the A&S
    # asin polynomial (|err| 2e-8 — inside f32 rounding of the true
    # asin the dense reference uses); near-zero field values amplify
    # that sub-ulp kernel delta past rtol 1e-6, hence the atol
    np.testing.assert_allclose(
        np.asarray(res.field), k_ref, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.uncertainty), u_ref, rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res.constraint_mask), a_ref, rtol=1e-4, atol=1e-6
    )


def test_kernel_kriging_block_invariance(rng):
    """Result independent of block count (incl. non-divisible padding)."""
    glat, glon, idx, obs, err = _grid_problem(rng)
    vario = MaternVariogram(psill=1.0, nugget=0.0, range=1500.0, nu=0.5)
    kernel = variogram_kernel(vario)
    base = kriging_from_kernel(
        kernel, glat, glon, idx, obs, err, variance=1.0, n_blocks=1
    )
    for n_blocks in (3, 7, 16):
        other = kriging_from_kernel(
            kernel, glat, glon, idx, obs, err, variance=1.0,
            n_blocks=n_blocks,
        )
        np.testing.assert_allclose(
            np.asarray(base.field), np.asarray(other.field), rtol=1e-6
        )


def test_ensemble_from_kernel(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    vario = MaternVariogram(psill=1.0, nugget=0.0, range=1500.0, nu=0.5)
    kernel = variogram_kernel(vario)
    field, members = ensemble_from_kernel(
        kernel, glat, glon, idx, obs, err, jax.random.key(0),
        n_members=256, n_blocks=4,
    )
    assert members.shape == (256, len(glat))
    # members scatter around the kriged field with sane spread
    mean_dev = np.abs(np.asarray(members).mean(0) - np.asarray(field))
    assert mean_dev.mean() < 0.1
    assert np.isfinite(np.asarray(members)).all()


def test_months_scan(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    vario = MaternVariogram(psill=1.0, nugget=0.0, range=1500.0, nu=0.5)
    kernel = variogram_kernel(vario)
    T = 5
    idx_m = np.stack([idx] * T)
    obs_m = np.stack([rng.normal(size=len(idx)) for _ in range(T)])
    err_m = np.stack([err] * T)
    fields, uncerts, cmasks = months_scan_kriging(
        kernel, glat, glon, idx_m, obs_m, err_m, variance=1.0
    )
    assert fields.shape == (T, len(glat))
    # month 0 equals the single-month call (field + diagnostics)
    single = kriging_from_kernel(
        kernel, glat, glon, idx, obs_m[0], err, variance=1.0, n_blocks=8
    )
    np.testing.assert_allclose(
        np.asarray(fields[0]), np.asarray(single.field), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(uncerts[0]), np.asarray(single.uncertainty),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(cmasks[0]), np.asarray(single.constraint_mask),
        rtol=1e-6,
    )
    # fields-only path (dedicated stacked 2-row GEMM, no Linv at all)
    # returns the same fields
    fields_only = months_scan_kriging(
        kernel, glat, glon, idx_m, obs_m, err_m, variance=1.0,
        diagnostics=False,
    )
    assert fields_only.shape == (T, len(glat))
    np.testing.assert_allclose(
        np.asarray(fields_only), np.asarray(fields), rtol=1e-5,
        atol=1e-6,
    )


def test_kernel_distance_variants(rng):
    glat, glon, idx, obs, err = _grid_problem(rng)
    vario = MaternVariogram(psill=1.0, nugget=0.0, range=1500.0, nu=0.5)
    for distance in ("haversine", "chordal", "cartesian"):
        kernel = variogram_kernel(vario, distance=distance)
        res = kriging_from_kernel(
            kernel, glat, glon, idx, obs, err, variance=1.0
        )
        assert np.isfinite(np.asarray(res.field)).all()
    with pytest.raises(ValueError):
        kriging_from_kernel(
            variogram_kernel(vario), glat, glon, idx, obs, err,
            method="bogus",
        )


def test_pad_month_observations(rng):
    from glomargridding_jax.models.kernel_kriging import (
        pad_month_observations,
    )

    glat, glon, idx, obs, err = _grid_problem(rng)
    vario = MaternVariogram(psill=1.0, nugget=0.0, range=1500.0, nu=0.5)
    kernel = variogram_kernel(vario)

    # two months with different obs counts
    idx2, obs2 = idx[:12], obs[:12]
    err2 = err[:12, :12]
    idx_m, obs_m, err_m = pad_month_observations(
        [idx, idx2], [obs, obs2], [err, err2]
    )
    assert idx_m.shape == (2, len(idx))
    fields, _, _ = months_scan_kriging(
        kernel, glat, glon, idx_m, obs_m, err_m, variance=1.0
    )

    # padded month ~= its standalone solve (dummy obs has ~zero weight)
    single = kriging_from_kernel(
        kernel, glat, glon, idx2, obs2, err2, variance=1.0, n_blocks=8
    )
    np.testing.assert_allclose(
        np.asarray(fields[1]), np.asarray(single.field), atol=2e-4
    )
    with pytest.raises(ValueError, match="bucket"):
        pad_month_observations([idx], [obs], [err], bucket=3)


def test_variogram_kernel_hashes_by_value():
    """Rebuilding an identical kernel must reuse the jit cache (the
    solvers take kernel_fn as a STATIC argument)."""
    v1 = MaternVariogram(psill=1.0, range=800.0, nu=1.5)
    v2 = MaternVariogram(psill=1.0, range=800.0, nu=1.5)
    k1 = variogram_kernel(v1)
    k2 = variogram_kernel(v2)
    assert k1 == k2
    assert hash(k1) == hash(k2)
    k3 = variogram_kernel(MaternVariogram(psill=1.0, range=900.0, nu=1.5))
    assert k1 != k3
    k4 = variogram_kernel(v1, distance="chordal")
    assert k1 != k4


@pytest.mark.parametrize("method", ["ordinary", "simple"])
def test_kriging_crossval_matches_bruteforce(rng, method):
    """The one-factorisation LOO identity must equal literally refitting
    with each observation removed."""
    from glomargridding_jax.models.kernel_kriging import kriging_crossval

    glat, glon, idx, obs, err = _grid_problem(rng, n_obs=14)
    vario = MaternVariogram(psill=1.2, nugget=0.0, range=2000.0, nu=1.5)
    kernel = variogram_kernel(vario)

    cv = kriging_crossval(
        kernel, glat, glon, idx, obs, error_cov=err, method=method
    )

    # brute force: for each i, krige AT obs point i from the others
    d = np.asarray(
        haversine_matrix(glat[idx], glon[idx], glat[idx], glon[idx])
    )
    C = 1.2 - np.asarray(vario.fit(jnp.asarray(d)))
    K = C + err
    n = len(idx)
    for i in range(n):
        keep = np.arange(n) != i
        Ki = K[np.ix_(keep, keep)]
        ci = C[keep, i]
        yi = obs[keep]
        if method == "simple":
            w = np.linalg.solve(Ki, ci)
            pred = w @ yi
            var = K[i, i] - w @ ci
        else:
            ones = np.ones(n - 1)
            Kx = np.block(
                [[Ki, ones[:, None]], [ones[None, :], np.zeros((1, 1))]]
            )
            w = np.linalg.solve(Kx, np.concatenate([ci, [1.0]]))
            pred = w[:-1] @ yi
            var = K[i, i] - w[:-1] @ ci - w[-1]
        np.testing.assert_allclose(
            float(cv.residuals[i]), obs[i] - pred, rtol=1e-5, atol=1e-7,
            err_msg=f"residual {i}",
        )
        np.testing.assert_allclose(
            float(cv.loo_variance[i]), var, rtol=1e-5, atol=1e-7,
            err_msg=f"variance {i}",
        )
    np.testing.assert_allclose(
        float(cv.rmse),
        float(np.sqrt(np.mean(np.asarray(cv.residuals) ** 2))),
        rtol=1e-6,
    )


def test_kriging_crossval_calibration(rng):
    """Data drawn FROM the model scores mssr ~ 1; a too-small amplitude
    model scores mssr >> 1 (underestimated uncertainty) — the model-
    selection contract."""
    from glomargridding_jax.models.kernel_kriging import kriging_crossval

    n_lat, n_lon = 10, 20
    lat = np.arange(-81.0, 90, 180.0 / n_lat)
    lon = np.arange(-171.0, 180, 360.0 / n_lon)
    glat = np.repeat(lat, n_lon)
    glon = np.tile(lon, n_lat)
    vario = MaternVariogram(psill=1.0, nugget=0.0, range=2500.0, nu=0.5)
    d = np.asarray(haversine_matrix(glat, glon))
    C = 1.0 - np.asarray(vario.fit(jnp.asarray(d)))
    m = C.shape[0]
    z = np.linalg.cholesky(C + 1e-6 * np.eye(m)) @ rng.normal(size=m)
    idx = np.sort(rng.choice(m, 60, replace=False))
    noise = 0.05
    y = z[idx] + np.sqrt(noise) * rng.normal(size=60)
    E = np.full(60, noise)

    kernel = variogram_kernel(vario)
    cv = kriging_crossval(
        kernel, glat, glon, idx, y, error_cov=E, method="ordinary"
    )
    assert 0.5 < float(cv.mssr) < 2.0, float(cv.mssr)

    # same correlation shape, 10x too small amplitude -> badly
    # calibrated (mssr inflated ~10x)
    small = variogram_kernel(
        MaternVariogram(psill=0.1, nugget=0.0, range=2500.0, nu=0.5)
    )
    cv_small = kriging_crossval(
        kernel_fn=small, grid_lats=glat, grid_lons=glon, idx=idx,
        obs=y, error_cov=E, method="ordinary",
    )
    assert float(cv_small.mssr) > 3.0 * float(cv.mssr)


def test_crossval_from_covariance_matches_kernel(rng):
    """Dense-covariance CV == kernel CV for the same model."""
    from glomargridding_jax.models.kernel_kriging import (
        crossval_from_covariance,
        kriging_crossval,
    )

    glat, glon, idx, obs, err = _grid_problem(rng, n_obs=18)
    vario = MaternVariogram(psill=1.2, nugget=0.0, range=2000.0, nu=1.5)
    kernel = variogram_kernel(vario)
    cv_k = kriging_crossval(
        kernel, glat, glon, idx, obs, error_cov=err
    )
    d = np.asarray(haversine_matrix(glat, glon))
    cov = 1.2 - np.asarray(vario.fit(jnp.asarray(d)))
    cv_d = crossval_from_covariance(cov, idx, obs, error_cov=err)
    np.testing.assert_allclose(
        np.asarray(cv_d.residuals), np.asarray(cv_k.residuals),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        float(cv_d.mssr), float(cv_k.mssr), rtol=1e-5
    )
