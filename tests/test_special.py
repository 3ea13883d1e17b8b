"""Matern K_nu oracle tests vs scipy.special.kv."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import kv as scipy_kv

from glomargridding_jax.ops.special import kv, kv_nan_guard

X = np.concatenate(
    [np.linspace(1e-4, 2.0, 200), np.linspace(2.001, 60.0, 200)]
)


@pytest.mark.parametrize(
    "v", [0.5, 1.5, 2.5, 3.5, 0.3, 0.8, 1.0, 1.2, 2.0, 3.0, 3.7, 4.0, 5.3]
)
def test_kv_matches_scipy_f64(v):
    ours = np.asarray(kv(v, jnp.asarray(X, jnp.float64)))
    ref = scipy_kv(v, X)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


@pytest.mark.parametrize("v", [0.5, 1.5, 3.0, 1.2])
def test_kv_f32_reasonable(v):
    ours = np.asarray(kv(v, jnp.asarray(X, jnp.float32)))
    ref = scipy_kv(v, X)
    assert np.isfinite(ours).all()
    sel = ref > 1e-30  # exclude the f32 underflow tail
    rel = np.abs(ours[sel] - ref[sel]) / np.abs(ref[sel])
    assert rel.max() < 5e-5


def test_kv_edge_cases():
    out = np.asarray(kv(1.5, jnp.array([0.0, -1.0])))
    assert np.isinf(out[0])
    assert np.isnan(out[1])
    guarded = np.asarray(kv_nan_guard(1.5, jnp.array([0.0])))
    assert np.isnan(guarded[0])


def test_kv_negative_order_symmetry():
    a = np.asarray(kv(1.5, jnp.asarray(X)))
    b = np.asarray(kv(-1.5, jnp.asarray(X)))
    np.testing.assert_allclose(a, b)


@pytest.mark.parametrize("v", [0.5, 1.5, 2.5, 3.5])
def test_xv_kv_half_integer_matches_product(v):
    from glomargridding_jax.ops.special import xv_kv_half_integer

    ours = np.asarray(xv_kv_half_integer(v, jnp.asarray(X, jnp.float64)))
    ref = X**v * scipy_kv(v, X)
    np.testing.assert_allclose(ours, ref, rtol=1e-12)
    # generic-product limit semantics: 0 * inf -> nan; negative -> nan
    edge = np.asarray(
        xv_kv_half_integer(v, jnp.asarray([0.0, -1.0], jnp.float64))
    )
    assert np.isnan(edge).all()


def test_xv_kv_rejects_non_half_integer():
    from glomargridding_jax.ops.special import xv_kv_half_integer

    with pytest.raises(ValueError):
        xv_kv_half_integer(1.2, jnp.asarray(X))
