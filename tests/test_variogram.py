"""Variogram property + oracle tests (reference test_variogram idioms)."""

import numpy as np
import pytest
from scipy.special import gamma as scipy_gamma
from scipy.special import kv as scipy_kv

from glomargridding_jax.grid import (
    grid_from_resolution,
    grid_to_distance_matrix,
)
from glomargridding_jax.core.labeled import DataArray
from glomargridding_jax.ops.variogram import (
    ExponentialVariogram,
    GaussianVariogram,
    MaternVariogram,
    SphericalVariogram,
    variogram_to_covariance,
)

# Coarse 15-degree grid keeps the PSD eigen checks fast while spanning the
# full globe (12 x 24 = 288 points).
GRID = grid_from_resolution(15, [(-82.5, 90), (-172.5, 180)], ["lat", "lon"])
DIST = grid_to_distance_matrix(GRID)

MODELS = [
    SphericalVariogram(psill=1.2, nugget=0.0, range=1200.0),
    SphericalVariogram(psill=2.0, nugget=0.1, effective_range=3000.0),
    GaussianVariogram(psill=1.2, nugget=0.0, range=1200.0),
    ExponentialVariogram(psill=1.2, nugget=0.05, range=1200.0),
    MaternVariogram(psill=1.2, nugget=0.0, range=1200.0, nu=0.5),
    MaternVariogram(psill=1.2, nugget=0.0, range=1200.0, nu=1.5),
    MaternVariogram(psill=1.2, nugget=0.0, range=1200.0, nu=3.0),
    MaternVariogram(
        psill=1.2, nugget=0.0, range=1200.0, nu=1.5, method="gstat"
    ),
    MaternVariogram(
        psill=1.2, nugget=0.0, range=1200.0, nu=1.5, method="karspeck"
    ),
]


@pytest.mark.parametrize("model", MODELS)
def test_positive_definite_covariance(model):
    vario = model.fit(np.asarray(DIST.values))
    cov = variogram_to_covariance(vario, model.psill + model.nugget)
    eigs = np.linalg.eigvalsh(cov)
    assert eigs.min() > -1e-8 * abs(eigs.max())


@pytest.mark.parametrize("model", MODELS)
def test_array_types_agree(model):
    as_np = model.fit(np.asarray(DIST.values))
    as_da = model.fit(DIST)
    assert isinstance(as_da, DataArray)
    np.testing.assert_allclose(np.asarray(as_np), as_da.values, rtol=1e-12)
    assert as_da.name == "variogram"


def test_effective_range_conversions():
    assert SphericalVariogram(1, 0, effective_range=100.0).range == 100.0
    assert GaussianVariogram(1, 0, effective_range=100.0).range == 50.0
    assert ExponentialVariogram(1, 0, effective_range=99.0).range == 33.0
    assert MaternVariogram(1, 0, effective_range=100.0, nu=1.5).range == 50.0
    assert (
        MaternVariogram(1, 0, effective_range=99.0, nu=0.3).range == 33.0
    )
    assert MaternVariogram(1, 0, range=50.0, nu=1.5).effective_range == 100.0
    with pytest.raises(ValueError):
        SphericalVariogram(1, 0)


def _matern_reference(d, psill, nugget, rng_, nu, method):
    """Independent numpy/scipy oracle of the reference formulation."""
    left = 1.0 / (scipy_gamma(nu) * 2.0 ** (nu - 1.0))
    dor = d / rng_
    if method == "sklearn":
        inner = np.sqrt(2.0 * nu) * dor
    elif method == "gstat":
        inner = dor
    else:
        inner = 2.0 * np.sqrt(nu) * dor
    with np.errstate(invalid="ignore"):
        out = psill * (1 - left * inner**nu * scipy_kv(nu, inner)) + nugget
    np.fill_diagonal(out, nugget)
    return out


@pytest.mark.parametrize("method", ["sklearn", "gstat", "karspeck"])
@pytest.mark.parametrize("nu", [0.5, 1.5, 3.0])
def test_matern_matches_scipy_oracle(method, nu):
    d = np.asarray(DIST.values)[:100, :100]
    model = MaternVariogram(
        psill=1.2, nugget=0.1, range=1200.0, nu=nu, method=method
    )
    ours = np.asarray(model.fit(d))
    ref = _matern_reference(d, 1.2, 0.1, 1200.0, nu, method)
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-12)


def test_spherical_truncation():
    model = SphericalVariogram(psill=1.2, nugget=0.1, range=100.0)
    d = np.array([[0.0, 99.0], [150.0, 0.0]])
    out = np.asarray(model.fit(d))
    assert out[1, 0] == pytest.approx(1.3)  # nugget + psill beyond range
    assert out[0, 1] < 1.3


def test_fused_covariance_matches_two_step():
    model = MaternVariogram(psill=1.2, nugget=0.0, range=1200.0, nu=1.5)
    d = np.asarray(DIST.values)[:50, :50]
    fused = np.asarray(model.covariance(d, variance=1.2))
    two_step = variogram_to_covariance(np.asarray(model.fit(d)), 1.2)
    np.testing.assert_allclose(fused, two_step, rtol=1e-12)
