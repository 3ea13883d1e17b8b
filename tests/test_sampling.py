"""Matrix-free Chebyshev sqrt sampling vs exact factorisations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glomargridding_jax.ops.sampling import (
    chebyshev_apply,
    chebyshev_sqrt_coeffs,
    dense_matvec,
    estimate_spectral_range,
    kernel_matvec,
    sample_mvn_chebyshev,
)


def _spd(rng, n=96, nugget=0.05):
    pts = rng.uniform(0, 1, size=(n, 2))
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    return np.exp(-d / 0.3) + nugget * np.eye(n)


def test_chebyshev_sqrt_matches_eigh(rng):
    cov = _spd(rng)
    w = np.linalg.eigvalsh(cov)
    lam_min, lam_max = float(w[0]) * 0.9, float(w[-1]) * 1.1
    z = rng.normal(size=(cov.shape[0], 4))

    coeffs = jnp.asarray(
        chebyshev_sqrt_coeffs(lam_min, lam_max, 120), jnp.float64
    )
    y = np.asarray(
        chebyshev_apply(
            dense_matvec(jnp.asarray(cov), jnp.float64),
            jnp.asarray(z),
            coeffs,
            lam_min,
            lam_max,
        )
    )
    # exact sqrtm via eigh
    ww, vv = np.linalg.eigh(cov)
    y_ref = (vv * np.sqrt(ww)) @ vv.T @ z
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-7)


def test_sample_covariance_converges(rng):
    cov = _spd(rng, n=48)
    w = np.linalg.eigvalsh(cov)
    draws = sample_mvn_chebyshev(
        jax.random.key(0),
        dense_matvec(jnp.asarray(cov, jnp.float32)),
        48,
        20_000,
        float(w[0]) * 0.9,
        float(w[-1]) * 1.1,
        degree=80,
    )
    sample_cov = np.cov(np.asarray(draws).T)
    # 20k draws: elementwise sampling error ~ 1/sqrt(20000) ~ 0.7%
    assert np.abs(sample_cov - cov).max() < 0.08
    np.testing.assert_allclose(
        np.diag(sample_cov), np.diag(cov), rtol=0.1
    )


def test_kernel_matvec_matches_dense(rng):
    n = 70
    lats = jnp.asarray(rng.uniform(-60, 60, n))
    lons = jnp.asarray(rng.uniform(-180, 180, n))

    def kern(la1, lo1, la2, lo2):
        a = (
            jnp.sin((la1[:, None] - la2[None, :]) / 2) ** 2
            + jnp.cos(la1)[:, None]
            * jnp.cos(la2)[None, :]
            * jnp.sin((lo1[:, None] - lo2[None, :]) / 2) ** 2
        )
        d = 2 * 6371.0 * jnp.arcsin(jnp.sqrt(jnp.clip(a, 0, 1)))
        return jnp.exp(-d / 2000.0)

    la = jnp.radians(lats)
    lo = jnp.radians(lons)
    dense = np.asarray(kern(la, lo, la, lo))
    v = jnp.asarray(rng.normal(size=(n, 3)))
    mv = kernel_matvec(kern, la, lo, n_blocks=4)
    np.testing.assert_allclose(
        np.asarray(mv(v)), dense @ np.asarray(v), rtol=1e-6, atol=1e-8
    )


def test_estimate_spectral_range(rng):
    cov = _spd(rng)
    w = np.linalg.eigvalsh(cov)
    lam_min, lam_max = estimate_spectral_range(
        dense_matvec(jnp.asarray(cov)), cov.shape[0], jax.random.key(1),
        dtype=jnp.float64,
    )
    assert lam_max >= w[-1] * 0.99
    assert lam_max <= w[-1] * 1.2
    assert lam_min > 0


def test_coeffs_reject_nonpositive_floor():
    with pytest.raises(ValueError, match="lam_min"):
        chebyshev_sqrt_coeffs(0.0, 1.0, 10)


def test_degree_guidance_formula(rng):
    """degree ~ 4 sqrt(b/a) achieves <1e-3 sqrt error on the interval."""
    a, b = 0.05, 60.0
    degree = int(4.0 * np.sqrt(b / a))
    coeffs = chebyshev_sqrt_coeffs(a, b, degree)
    x = np.linspace(a, b, 500)
    # evaluate expansion directly
    t = (2 * x - (b + a)) / (b - a)
    vals = np.polynomial.chebyshev.chebval(t, coeffs)
    rel = np.abs(vals - np.sqrt(x)) / np.sqrt(x)
    assert rel.max() < 1e-3


def test_out_of_interval_diverges(rng):
    """Underestimating lam_max (e.g. using the sill instead of the matrix
    spectral bound) makes the polynomial blow up — the failure mode the
    spectral-range estimator exists to prevent."""
    cov = _spd(rng, n=64)
    w = np.linalg.eigvalsh(cov)
    bad_lam_max = float(w[-1]) * 0.2  # too small
    draws = sample_mvn_chebyshev(
        jax.random.key(0),
        dense_matvec(jnp.asarray(cov, jnp.float32)),
        64,
        8,
        float(w[0]) * 0.9,
        bad_lam_max,
        degree=60,
    )
    arr = np.asarray(draws)
    assert (~np.isfinite(arr)).any() or np.abs(arr).max() > 100  # diverged


def test_chebyshev_accepts_plain_closure(rng):
    """Back-compat: a bare callable matvec (no Matvec wrapper) works."""
    import jax.numpy as jnp

    from glomargridding_jax.ops.sampling import (
        Matvec,
        chebyshev_apply,
        chebyshev_sqrt_coeffs,
        dense_matvec,
    )

    n = 40
    B = rng.normal(size=(n, n))
    cov = (B @ B.T / n + np.eye(n)).astype(np.float64)
    z = rng.normal(size=(n, 3))
    coeffs = jnp.asarray(chebyshev_sqrt_coeffs(0.5, 30.0, 60))
    A = jnp.asarray(cov)

    wrapped = dense_matvec(A, jnp.float64)
    assert isinstance(wrapped, Matvec)
    got_wrapped = chebyshev_apply(wrapped, jnp.asarray(z), coeffs, 0.5, 30.0)
    got_closure = chebyshev_apply(
        lambda v: A @ v, jnp.asarray(z), coeffs, 0.5, 30.0
    )
    np.testing.assert_allclose(
        np.asarray(got_wrapped), np.asarray(got_closure), rtol=1e-10
    )
