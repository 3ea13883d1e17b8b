"""Kriging solver tests.

Includes the GeoStats.jl golden-file oracle: ordinary kriging on a 20 x 20
planar grid with a Matern(nu=1.5) variogram must reproduce the stored
output of the independent Julia implementation (range conversion /3
between the libraries), exactly as the reference validates itself.
"""

from itertools import product

import numpy as np
import pandas as pd
import pytest

from glomargridding_jax.grid import (
    grid_from_resolution,
    grid_to_distance_matrix,
    map_to_grid,
)
from glomargridding_jax.models.kriging import (
    OrdinaryKriging,
    SimpleKriging,
    _extended_inverse,
    constraint_mask,
    kriging_ordinary,
    kriging_simple,
)
from glomargridding_jax.models.stochastic import StochasticKriging
from glomargridding_jax.ops.distances import cartesian_euclidean_from_frame
from glomargridding_jax.ops.variogram import MaternVariogram

from conftest import reference_data_path, requires_reference_data


def _load_golden():
    path = reference_data_path("geostatsjl_ord_krig_results.dat")
    with open(path) as f:
        vals = [float(line) for line in f]
    # Julia writes Fortran (column-major) order.
    return np.reshape(vals, (20, 20), "F")


def _setup():
    grid = grid_from_resolution(1, [(1, 21), (1, 21)], ["lat", "lon"])
    obs = pd.DataFrame(
        {
            "lat": [5.0, 15.0, 10.0],
            "lon": [5.0, 10.0, 15.0],
            "val": [1.0, 0.0, 1.0],
        }
    )
    obs = map_to_grid(obs, grid, grid_coords=["lat", "lon"])
    dist = grid_to_distance_matrix(grid, cartesian_euclidean_from_frame)
    variogram = MaternVariogram(range=35 / 3, psill=4.0, nugget=0.0, nu=1.5)
    covariance = np.asarray(variogram.fit(dist.values))
    grid_idx = obs["grid_idx"].to_numpy()
    obs_vals = obs["val"].to_numpy()
    return covariance, grid_idx, obs_vals


def _rand_error_cov(shape, grid_idx, rng, with_nan_at=None):
    err_cov = np.full(shape, np.nan)
    vals = rng.random((3, 3))
    vals = vals @ vals.T
    if with_nan_at is not None:
        vals[with_nan_at, with_nan_at] = np.nan
    for (i, j), v in zip(product(grid_idx, grid_idx), vals.flatten()):
        err_cov[i, j] = v
    return err_cov, vals


@requires_reference_data
def test_ordinary_kriging_golden():
    covariance, grid_idx, obs_vals = _setup()
    expected = _load_golden()
    OK = OrdinaryKriging(covariance, idx=grid_idx, obs=obs_vals)
    k = OK.solve()
    np.testing.assert_allclose(
        expected, np.reshape(k, (20, 20), "C"), rtol=1e-7, atol=1e-9
    )


@requires_reference_data
def test_ordinary_kriging_golden_function_form():
    covariance, grid_idx, obs_vals = _setup()
    expected = _load_golden()
    S = covariance[grid_idx[:, None], grid_idx[None, :]]
    SS = covariance[grid_idx, :]
    with pytest.warns(DeprecationWarning):
        k, _ = kriging_ordinary(S, SS, obs_vals, covariance)
    np.testing.assert_allclose(
        expected, np.reshape(k, (20, 20), "C"), rtol=1e-7, atol=1e-9
    )


@requires_reference_data
def test_ordinary_kriging_from_weights():
    covariance, grid_idx, obs_vals = _setup()
    expected = _load_golden()
    # Weights computed the reference way: LU solve of the extended system.
    S = covariance[grid_idx[:, None], grid_idx[None, :]]
    SS = covariance[grid_idx, :]
    N, M = SS.shape
    S_ext = np.block([[S, np.ones((N, 1))], [np.ones((1, N)), 0]])
    SS_ext = np.concatenate((SS, np.ones((1, M))), axis=0)
    weights = np.linalg.solve(S_ext, SS_ext).T

    OK = OrdinaryKriging(covariance, idx=grid_idx, obs=obs_vals)
    OK.set_kriging_weights(weights)
    k = OK.solve()
    np.testing.assert_allclose(
        expected, np.reshape(k, (20, 20), "C"), rtol=1e-7, atol=1e-12
    )


@requires_reference_data
def test_ordinary_kriging_from_inverse():
    covariance, grid_idx, obs_vals = _setup()
    expected = _load_golden()
    S = covariance[grid_idx[:, None], grid_idx[None, :]]
    S_inv = np.linalg.inv(S)
    OK = OrdinaryKriging(covariance, idx=grid_idx, obs=obs_vals)
    S_ext_inv = OK.extended_inverse(S_inv)
    OK.kriging_weights_from_inverse(S_ext_inv)
    k = OK.solve()
    np.testing.assert_allclose(
        expected, np.reshape(k, (20, 20), "C"), rtol=1e-6, atol=1e-12
    )


def test_ordinary_matches_numpy_reference(rng):
    """Bordered-Cholesky solve == dense extended-system LU solve."""
    covariance, grid_idx, obs_vals = _setup()
    err_cov, err_vals = _rand_error_cov(
        covariance.shape, grid_idx, rng
    )
    OK = OrdinaryKriging(
        covariance, idx=grid_idx, obs=obs_vals, error_cov=err_cov
    )
    k = OK.solve()
    u = OK.get_uncertainty()
    a = OK.constraint_mask()
    assert k.shape == u.shape == a.shape

    # independent numpy implementation of the reference algorithm
    S = covariance[grid_idx[:, None], grid_idx[None, :]] + err_vals
    SS = covariance[grid_idx, :]
    N, M = SS.shape
    S_ext = np.block([[S, np.ones((N, 1))], [np.ones((1, N)), 0]])
    SS_ext = np.concatenate((SS, np.ones((1, M))), axis=0)
    W = np.linalg.solve(S_ext, SS_ext).T
    k_ref = W @ np.append(obs_vals, 0)
    alpha = W[:, -1]
    u2_ref = np.diag(covariance - W @ SS_ext) - alpha
    u_ref = np.sqrt(np.maximum(u2_ref, 0))
    np.testing.assert_allclose(k, k_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(u, u_ref, rtol=1e-6, atol=1e-8)

    # constraint mask against its function form
    a_ref = constraint_mask(S, SS, covariance)
    np.testing.assert_allclose(a, a_ref, rtol=1e-8)


def test_simple_matches_numpy_reference(rng):
    covariance, grid_idx, obs_vals = _setup()
    err_cov, err_vals = _rand_error_cov(covariance.shape, grid_idx, rng)
    SK = SimpleKriging(
        covariance, idx=grid_idx, obs=obs_vals, error_cov=err_cov
    )
    k = SK.solve()
    u = SK.get_uncertainty()
    a = SK.constraint_mask()
    assert k.shape == u.shape == a.shape

    S = covariance[grid_idx[:, None], grid_idx[None, :]] + err_vals
    SS = covariance[grid_idx, :]
    W = np.linalg.solve(S, SS).T
    k_ref = W @ obs_vals
    u2_ref = np.diag(covariance - W @ SS)
    u_ref = np.sqrt(np.maximum(u2_ref, 0))
    np.testing.assert_allclose(k, k_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(u, u_ref, rtol=1e-6, atol=1e-8)

    with pytest.warns(DeprecationWarning):
        k2, u2 = kriging_simple(S, SS, obs_vals, covariance)
    np.testing.assert_allclose(k2, k, rtol=1e-10)
    np.testing.assert_allclose(u2, u, rtol=1e-8)


def test_simple_kriging_mean_shift():
    covariance, grid_idx, obs_vals = _setup()
    SK = SimpleKriging(covariance, idx=grid_idx, obs=obs_vals)
    base = SK.solve(mean=0.0)
    del SK.kriging_weights
    shifted = SimpleKriging(covariance, idx=grid_idx, obs=obs_vals).solve(
        mean=2.5
    )
    np.testing.assert_allclose(shifted, base + 2.5, rtol=1e-10)


@pytest.mark.parametrize("n", [10, 25, 100, 1000])
def test_extended_inverse_trick(n, rng):
    A = rng.random((n, n))
    S = A @ A.T + n * np.eye(n)
    Sinv = np.linalg.inv(S)
    Sinv_ext = _extended_inverse(Sinv)
    S_ext = np.block([[S, np.ones((n, 1))], [np.ones((1, n)), 0]])
    np.testing.assert_allclose(
        Sinv_ext, np.linalg.inv(S_ext), rtol=1e-5, atol=1e-8
    )


def test_stochastic_kriging(rng):
    covariance, grid_idx, obs_vals = _setup()
    err_cov, err_vals = _rand_error_cov(covariance.shape, grid_idx, rng)
    StochKrige = StochasticKriging(
        covariance, idx=grid_idx, obs=obs_vals, error_cov=err_cov
    )
    import jax

    k = StochKrige.solve(key=jax.random.key(0))
    u = StochKrige.get_uncertainty()
    a = StochKrige.constraint_mask()
    assert k.shape == u.shape == a.shape

    # First-stage field must equal plain ordinary kriging.
    S = covariance[grid_idx[:, None], grid_idx[None, :]] + err_vals
    SS = covariance[grid_idx, :]
    with pytest.warns(DeprecationWarning):
        k2, u2 = kriging_ordinary(S, SS, obs_vals, covariance)
    assert hasattr(StochKrige, "gridded_field")
    np.testing.assert_allclose(k2, StochKrige.gridded_field, rtol=1e-7)
    np.testing.assert_allclose(u2, u, rtol=1e-6, atol=1e-9)

    # epsilon = simulated_grid - simulated_state; solution = field + epsilon
    np.testing.assert_allclose(
        k, StochKrige.gridded_field + StochKrige.epsilon, rtol=1e-10
    )

    # constraint mask reproducible after weight re-injection
    sk_weights = StochKrige.simple_kriging_weights
    delattr(StochKrige, "simple_kriging_weights")
    StochKrige.set_simple_kriging_weights(sk_weights)
    a2 = StochKrige.constraint_mask()
    np.testing.assert_allclose(a, a2)


def test_stochastic_injected_state_deterministic(rng):
    """With an injected simulated state the perturbation is reproducible."""
    covariance, grid_idx, obs_vals = _setup()
    err_cov, err_vals = _rand_error_cov(covariance.shape, grid_idx, rng)
    state = rng.normal(size=covariance.shape[0])
    import jax

    K1 = StochasticKriging(covariance, grid_idx, obs_vals, err_cov)
    out1 = K1.solve(simulated_state=state, key=jax.random.key(7))
    K2 = StochasticKriging(covariance, grid_idx, obs_vals, err_cov)
    out2 = K2.solve(simulated_state=state, key=jax.random.key(7))
    np.testing.assert_allclose(out1, out2)
    # and the simulated grid is the simple-kriged simulated obs
    np.testing.assert_allclose(
        K1.simulated_grid,
        K1.simple_kriging_weights @ K1.simulated_obs,
        rtol=1e-10,
    )


def test_filter_bad_error_cov_values(rng):
    covariance, grid_idx, obs_vals = _setup()
    err_cov, _ = _rand_error_cov(
        covariance.shape, grid_idx, rng, with_nan_at=2
    )
    expected_warn = (
        "Have nans or zeros on the error covariance diagonal. "
        f"At positions {grid_idx[2]}. Filtering input accordingly"
    )
    with pytest.warns(UserWarning, match=expected_warn):
        OK = OrdinaryKriging(
            covariance, idx=grid_idx, obs=obs_vals, error_cov=err_cov
        )
    assert (OK.idx == grid_idx[:2]).all()
    assert (OK.obs == obs_vals[:2]).all()
    assert OK.error_cov.shape == (2, 2)


def test_filter_bad_error_cov_values_stochastic(rng):
    covariance, grid_idx, obs_vals = _setup()
    err_cov, _ = _rand_error_cov(
        covariance.shape, grid_idx, rng, with_nan_at=2
    )
    with pytest.warns(UserWarning, match="Filtering input accordingly"):
        SK = StochasticKriging(
            covariance, idx=grid_idx, obs=obs_vals, error_cov=err_cov
        )
    assert (SK.idx == grid_idx[:2]).all()
    assert SK.error_cov.shape == (2, 2)


def test_stochastic_requires_error_cov():
    covariance, grid_idx, obs_vals = _setup()
    with pytest.raises(ValueError, match="Error Covariance"):
        StochasticKriging(covariance, grid_idx, obs_vals, None)


def test_prep_obs_for_kriging():
    from glomargridding_jax.models.kriging import prep_obs_for_kriging

    unmask_idx = np.array([0, 3, 5, 7, 9])
    unique_obs_idx = np.array([3, 7])
    weights = np.array([[0.5, 0.5, 0.0], [0.0, 0.0, 1.0]])
    obs = np.array([1.0, 3.0, 5.0])
    obs_idx, grid_obs = prep_obs_for_kriging(
        unmask_idx, unique_obs_idx, weights, obs
    )
    np.testing.assert_array_equal(obs_idx, [1, 3])  # positions of 3 and 7
    np.testing.assert_allclose(grid_obs, [2.0, 5.0])
    # mean removal
    _, demeaned = prep_obs_for_kriging(
        unmask_idx, unique_obs_idx, weights, obs, remove_obs_mean=1
    )
    np.testing.assert_allclose(demeaned, [-1.5, 1.5])
    with pytest.raises(ValueError):
        prep_obs_for_kriging(
            unmask_idx, unique_obs_idx, weights, obs, remove_obs_mean=3
        )


def test_kriging_exact_at_obs_without_error():
    """With no error covariance the kriged field interpolates the obs."""
    covariance, grid_idx, obs_vals = _setup()
    # use a PSD covariance (variance - variogram) rather than the raw
    # variogram for this property
    cov = 4.0 - covariance
    OK = OrdinaryKriging(cov, idx=grid_idx, obs=obs_vals)
    k = OK.solve()
    np.testing.assert_allclose(k[grid_idx], obs_vals, atol=1e-6)
    u = OK.get_uncertainty()
    # reference OK-variance formula subtracts lambda twice, so at obs
    # points the clamped uncertainty is ~0 only within the multiplier
    assert (u[grid_idx] < 0.2).all()

    SK = SimpleKriging(cov, idx=grid_idx, obs=obs_vals)
    ks = SK.solve()
    np.testing.assert_allclose(ks[grid_idx], obs_vals, atol=1e-6)
    us = SK.get_uncertainty()
    np.testing.assert_allclose(us[grid_idx], 0.0, atol=1e-4)


def test_precompute_states_both_routes(rng):
    import jax

    from glomargridding_jax.models.stochastic import precompute_states
    from glomargridding_jax.ops.sphere import matern_correlation

    # dense route
    pts = rng.uniform(0, 1, size=(40, 2))
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    cov = np.exp(-d / 0.3) + 0.01 * np.eye(40)
    states = precompute_states(jax.random.key(0), 64, covariance=cov)
    assert states.shape == (64, 40)
    assert np.isfinite(states).all()

    # spectral route
    lats = np.arange(-60.0, 61.0, 30.0)
    lons = np.arange(0.0, 360.0, 60.0)
    states2 = precompute_states(
        jax.random.key(1),
        8,
        corr_fn=matern_correlation(0.5, 2000.0),
        variance=1.2,
        lats_deg=lats,
        lons_deg=lons,
    )
    assert states2.shape == (8, len(lats) * len(lons))
    assert np.isfinite(states2).all()

    with pytest.raises(ValueError, match="provide either"):
        precompute_states(jax.random.key(2), 4)


def test_cov_device_cache_shared_across_instances(rng):
    """One host covariance -> one device upload, reused by every solver.

    (Perf contract: the canonical ensemble loop builds a fresh solver
    per member from the SAME covariance array.)
    """
    n = 24
    A = rng.normal(size=(n, n))
    cov = (A @ A.T + n * np.eye(n)).astype(np.float32)
    idx = np.arange(0, n, 3)
    obs = rng.normal(size=len(idx)).astype(np.float32)
    E = np.diag(np.full(len(idx), 0.05, dtype=np.float32))
    k1 = StochasticKriging(cov, idx=idx, obs=obs, error_cov=E)
    k2 = StochasticKriging(cov, idx=idx, obs=obs, error_cov=E)
    assert k1._cov_device() is k2._cov_device()


def test_cov_device_cache_is_bounded(rng):
    """Solvers over many DISTINCT covariances must not grow the device
    cache unboundedly (round-1 leak: weakref.finalize on np.ndarray always
    raises, so nothing ever evicted)."""
    from glomargridding_jax.models.kriging import _COV_DEVICE_CACHE

    _COV_DEVICE_CACHE.clear()
    n = 16
    idx = np.arange(0, n, 3)
    obs = rng.normal(size=len(idx)).astype(np.float32)
    E = np.diag(np.full(len(idx), 0.05, dtype=np.float32))
    solvers = []
    for _ in range(7):
        A = rng.normal(size=(n, n))
        cov = (A @ A.T + n * np.eye(n)).astype(np.float32)
        k = StochasticKriging(cov, idx=idx, obs=obs, error_cov=E)
        k._cov_device()
        solvers.append(k)
    assert len(_COV_DEVICE_CACHE) <= _COV_DEVICE_CACHE.max_entries
    # the most recent entry is still a hit (LRU keeps the hot one)
    assert (
        solvers[-1]._cov_device()
        is _COV_DEVICE_CACHE.get_or_put(solvers[-1].covariance)
    )


def test_stochastic_solve_non_pd_rescue(rng):
    """A non-PD covariance must route through the eigen-repair rescue
    and still return a finite member (reference stochastic.py:395-502
    semantics)."""
    import jax

    n = 30
    A = rng.normal(size=(n, 6))
    cov = (A @ A.T).astype(np.float32)  # rank 6 -> Cholesky fails
    cov += 1e-6 * np.eye(n, dtype=np.float32)
    # push one eigenvalue slightly negative
    w, v = np.linalg.eigh(cov.astype(np.float64))
    w[0] = -1e-9
    cov = (v @ np.diag(w) @ v.T).astype(np.float32)
    idx = np.arange(0, n, 2)
    obs = rng.normal(size=len(idx)).astype(np.float32)
    E = np.diag(np.full(len(idx), 0.1, dtype=np.float32))
    sk = StochasticKriging(cov, idx=idx, obs=obs, error_cov=E)
    member = np.asarray(sk.solve(key=jax.random.key(7)))
    assert member.shape == (n,)
    assert np.isfinite(member).all()
    # structural identity regardless of path taken
    np.testing.assert_allclose(
        np.asarray(sk.simulated_grid),
        np.asarray(sk.simple_kriging_weights) @ np.asarray(sk.simulated_obs),
        rtol=2e-4,
        atol=2e-5,
    )


def test_textbook_uncertainty_convention(rng):
    """uncertainty="textbook" subtracts the Lagrange multiplier ONCE:
    sigma2_textbook == sigma2_reference + lambda, and the injected-
    weights path agrees with the solve path in both conventions."""
    covariance, grid_idx, obs_vals = _setup()
    err_cov, err_vals = _rand_error_cov(covariance.shape, grid_idx, rng)

    ref = OrdinaryKriging(
        covariance, idx=grid_idx, obs=obs_vals, error_cov=err_cov
    )
    txt = OrdinaryKriging(
        covariance,
        idx=grid_idx,
        obs=obs_vals,
        error_cov=err_cov,
        uncertainty="textbook",
    )
    # the FIELD is identical across conventions
    np.testing.assert_allclose(ref.solve(), txt.solve(), rtol=1e-10)
    u_ref = ref.get_uncertainty()
    u_txt = txt.get_uncertainty()
    lam = np.asarray(ref.kriging_weights)[:, -1]
    # compare only where neither convention was clamped to zero (this
    # golden setup feeds a variogram matrix, so some raw variances are
    # legitimately negative and _finalise_uncert zeroes them)
    both = (u_ref > 0) & (u_txt > 0)
    assert both.any()
    np.testing.assert_allclose(
        u_txt[both] ** 2, u_ref[both] ** 2 + lam[both],
        rtol=1e-5, atol=1e-7,
    )

    # independent numpy pin of the textbook formula
    S = covariance[grid_idx[:, None], grid_idx[None, :]] + err_vals
    SS = covariance[grid_idx, :]
    N, M = SS.shape
    S_ext = np.block([[S, np.ones((N, 1))], [np.ones((1, N)), 0]])
    SS_ext = np.concatenate((SS, np.ones((1, M))), axis=0)
    W = np.linalg.solve(S_ext, SS_ext).T
    u2_txt_ref = np.diag(covariance - W @ SS_ext)  # C - w'c - lam
    np.testing.assert_allclose(
        u_txt, np.sqrt(np.maximum(u2_txt_ref, 0)), rtol=1e-5, atol=1e-6
    )

    # injected-weights path honours the convention too
    txt2 = OrdinaryKriging(
        covariance,
        idx=grid_idx,
        obs=obs_vals,
        error_cov=err_cov,
        uncertainty="textbook",
    )
    txt2.set_kriging_weights(W)
    np.testing.assert_allclose(
        txt2.get_uncertainty(), u_txt, rtol=1e-5, atol=1e-7
    )

    with pytest.raises(ValueError, match="uncertainty"):
        OrdinaryKriging(
            covariance, idx=grid_idx, obs=obs_vals, uncertainty="bogus"
        )


def test_stochastic_textbook_uncertainty(rng):
    covariance, grid_idx, obs_vals = _setup()
    err_cov, _ = _rand_error_cov(covariance.shape, grid_idx, rng)
    ref = StochasticKriging(
        covariance, idx=grid_idx, obs=obs_vals, error_cov=err_cov
    )
    txt = StochasticKriging(
        covariance,
        idx=grid_idx,
        obs=obs_vals,
        error_cov=err_cov,
        uncertainty="textbook",
    )
    ref.get_kriging_weights()
    txt.get_kriging_weights()
    lam = np.asarray(ref.kriging_weights)[:, -1]
    u_ref = ref.get_uncertainty()
    u_txt = txt.get_uncertainty()
    both = (u_ref > 0) & (u_txt > 0)
    assert both.any()
    np.testing.assert_allclose(
        u_txt[both] ** 2,
        u_ref[both] ** 2 + lam[both],
        rtol=1e-5,
        atol=1e-7,
    )
    with pytest.raises(ValueError, match="uncertainty"):
        StochasticKriging(
            covariance,
            idx=grid_idx,
            obs=obs_vals,
            error_cov=err_cov,
            uncertainty="bogus",
        )


def test_batched_ensemble_step_non_pd_rescue(rng):
    """batched_ensemble_step must rescue a merely near-PSD covariance
    (the normal case for clipped/estimated inputs) instead of emitting
    all-NaN members."""
    import jax

    from glomargridding_jax.models.stochastic import batched_ensemble_step

    n = 40
    A = rng.normal(size=(n, 8))
    cov = (A @ A.T).astype(np.float64)
    w, v = np.linalg.eigh(cov)
    w[0] = -1e-9  # near-PSD: Cholesky fails, repair must engage
    cov = (v @ np.diag(w) @ v.T).astype(np.float32)
    idx = np.arange(0, n, 2)
    obs = rng.normal(size=len(idx)).astype(np.float32)
    E = np.diag(np.full(len(idx), 0.1, dtype=np.float32))

    members, field = batched_ensemble_step(
        jax.random.key(3), cov, E, idx, obs, n_members=5
    )
    members = np.asarray(members)
    assert members.shape == (5, n)
    assert np.isfinite(members).all()
    assert np.isfinite(np.asarray(field)).all()
    # members scatter around the kriged field (not degenerate)
    assert np.asarray(members).std(axis=0).mean() > 0
