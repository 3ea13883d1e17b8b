"""Maximum-likelihood variogram fitting: parameter recovery."""

import numpy as np
import pytest

from glomargridding_jax.ops.distances import haversine_matrix
from glomargridding_jax.ops.variogram import MaternVariogram
from glomargridding_jax.ops.variogram_fit import (
    fit_variogram_mle,
    gp_negative_log_likelihood,
)


def _draws(rng, n=300, psill=1.5, range_km=1500.0, nugget=0.05, nu=1.5):
    lats = rng.uniform(-60, 60, n)
    lons = rng.uniform(-180, 180, n)
    d = np.asarray(haversine_matrix(lats, lons))
    cov = np.asarray(
        MaternVariogram(psill=psill, nugget=0.0, range=range_km, nu=nu)
        .covariance(d, variance=psill)
    ) + nugget * np.eye(n)
    y = rng.multivariate_normal(np.zeros(n), cov)
    return d, y


@pytest.mark.parametrize("optimizer", ["L-BFGS-B", "Nelder-Mead"])
def test_recovers_known_parameters(rng, optimizer):
    d, y = _draws(rng)
    fit = fit_variogram_mle(
        d,
        y,
        nu=1.5,
        guesses=(0.5, 500.0, 0.2),
        optimizer=optimizer,
        tol=1e-8 if optimizer == "L-BFGS-B" else 1e-6,
    )
    # single-realisation MLE scatter is sizeable; order-of-magnitude +
    # factor-two recovery is the appropriate bar at n=300
    assert 0.5 < fit.psill < 4.0
    assert 700.0 < fit.range < 3500.0
    assert fit.nugget < 0.5
    assert np.isfinite(fit.nll)


def test_fit_improves_likelihood(rng):
    d, y = _draws(rng)
    import jax.numpy as jnp

    start = gp_negative_log_likelihood(
        jnp.asarray([0.5, 500.0, 0.2]), jnp.asarray(d), jnp.asarray(y),
        kind="matern", nu=1.5, method="sklearn",
    )
    fit = fit_variogram_mle(d, y, nu=1.5, guesses=(0.5, 500.0, 0.2))
    assert fit.nll < float(start)


def test_bad_optimizer_rejected(rng):
    d, y = _draws(rng, n=40)
    with pytest.raises(ValueError, match="optimizer"):
        fit_variogram_mle(d, y, optimizer="Powell")
