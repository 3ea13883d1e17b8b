"""Spherical-harmonic stationary sampling: exactness vs dense covariance."""

import jax
import numpy as np

from glomargridding_jax.ops.sphere import (
    SphericalHarmonicSampler,
    angular_power,
    legendre_table,
    matern_correlation,
)


def test_angular_power_recovers_correlation():
    """Legendre series with computed c_l reproduces corr(gamma).

    (nu = 1.5: smooth enough that L = 256 retains ~all the variance; the
    gamma = 0 value is the truncation-sensitive point.)"""
    corr = matern_correlation(nu=1.5, range_km=2000.0)
    L = 256
    c_l = angular_power(corr, L)
    gammas = np.linspace(0.0, np.pi, 64)
    # P_l(cos gamma) recurrence
    t = np.cos(gammas)
    series = np.zeros_like(gammas)
    p_prev = np.ones_like(t)
    p_cur = t.copy()
    series += (1 / (4 * np.pi)) * c_l[0] * p_prev
    series += (3 / (4 * np.pi)) * c_l[1] * p_cur
    for l in range(2, L + 1):
        p_next = ((2 * l - 1) * t * p_cur - (l - 1) * p_prev) / l
        series += ((2 * l + 1) / (4 * np.pi)) * c_l[l] * p_next
        p_prev, p_cur = p_cur, p_next
    np.testing.assert_allclose(series, corr(gammas), atol=5e-3)


def test_legendre_orthonormality():
    """Quadrature check: sum over a Gauss grid of P̃_lm pairs ~ delta."""
    L = 24
    t, w = np.polynomial.legendre.leggauss(64)
    lats = np.degrees(np.arcsin(t))
    P = legendre_table(L, lats)
    # integral over sphere of Y_lm Y_l'm = 2 pi int P̃_lm P̃_l'm dx (m=0)
    for m in (0, 3):
        for l1 in (m, m + 2, m + 5):
            for l2 in (m, m + 2, m + 5):
                val = 2 * np.pi * np.sum(w * P[l1, m] * P[l2, m])
                if m > 0:
                    val *= 2  # sqrt(2) normalisation of real harmonics
                    val /= 2  # cos^2 average folds the 2 pi... direct:
                expected = 1.0 if l1 == l2 else 0.0
                if m == 0:
                    np.testing.assert_allclose(
                        val, expected, atol=1e-10
                    )
                else:
                    # for m>0 the longitude integral of cos^2 gives pi,
                    # so orthonormality reads 2pi/2 * int = 1
                    np.testing.assert_allclose(
                        val, expected, atol=1e-10
                    )


def test_sample_covariance_matches_kernel(rng):
    """Sample covariance of SH draws == corr(great-circle) * variance."""
    lats = np.arange(-60.0, 61.0, 30.0)  # 5 lats
    lons = np.arange(-180.0, 180.0, 60.0)  # 6 lons
    corr = matern_correlation(nu=1.5, range_km=8000.0)
    import jax.numpy as jnp

    sampler = SphericalHarmonicSampler(
        corr, variance=2.0, lats_deg=lats, lons_deg=lons, l_max=64,
        dtype=jnp.float32,
    )
    assert sampler.truncation_fraction > 0.999

    draws = np.asarray(sampler.draw(jax.random.key(0), 12_000))
    sample_cov = np.cov(draws.T)

    glat = np.repeat(lats, len(lons))
    glon = np.tile(lons, len(lats))
    la = np.radians(glat)
    lo = np.radians(glon)
    a = (
        np.sin((la[:, None] - la[None, :]) / 2) ** 2
        + np.cos(la)[:, None]
        * np.cos(la)[None, :]
        * np.sin((lo[:, None] - lo[None, :]) / 2) ** 2
    )
    gamma = 2 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
    expected = 2.0 * corr(gamma)

    # 12k draws -> sampling noise ~ 2/sqrt(12000) ~ 2%
    assert np.abs(sample_cov - expected).max() < 0.15
    np.testing.assert_allclose(
        np.diag(sample_cov), np.diag(expected), rtol=0.05
    )


def test_nugget_adds_independent_variance(rng):
    lats = np.arange(-45.0, 46.0, 45.0)
    lons = np.arange(0.0, 360.0, 90.0)
    corr = matern_correlation(nu=0.5, range_km=3000.0)
    import jax.numpy as jnp

    s0 = SphericalHarmonicSampler(
        corr, 1.0, lats, lons, l_max=64, nugget=0.0, dtype=jnp.float32
    )
    s1 = SphericalHarmonicSampler(
        corr, 1.0, lats, lons, l_max=64, nugget=0.5, dtype=jnp.float32
    )
    d0 = np.asarray(s0.draw(jax.random.key(1), 8_000))
    d1 = np.asarray(s1.draw(jax.random.key(1), 8_000))
    v0 = d0.var(axis=0).mean()
    v1 = d1.var(axis=0).mean()
    assert abs(v1 - v0 - 0.5) < 0.08


def test_draw_counts_share_one_compiled_program():
    """Member counts up to ``member_batch`` reuse ONE synthesis program.

    Drawing a training cube and then a single truth state must not
    recompile the (members, l, m) einsum — ``draw`` rounds the count up
    to a multiple of ``member_batch`` and slices, so `_synthesize` sees
    one signature for every count <= member_batch (and one dispatch,
    never a per-batch host loop, for larger counts).
    """
    from glomargridding_jax.ops import sphere

    lats = np.arange(-60.0, 61.0, 30.0)
    lons = np.arange(-180.0, 180.0, 60.0)
    corr = matern_correlation(nu=1.5, range_km=6000.0)
    sampler = SphericalHarmonicSampler(
        corr, 1.0, lats, lons, l_max=32, member_batch=16
    )

    calls = []
    real = sphere._synthesize

    def spy(key, c_l, P, trig, n_members):
        calls.append(n_members)
        return real(key, c_l, P, trig, n_members)

    sphere._synthesize, orig = spy, sphere._synthesize
    try:
        a = sampler.draw(jax.random.key(0), 10)   # < batch
        b = sampler.draw(jax.random.key(1), 16)   # == batch
        c = sampler.draw(jax.random.key(2), 37)   # 3 batches
        d = sampler.draw(jax.random.key(3), 1)    # truth draw
    finally:
        sphere._synthesize = orig

    # 10, 16 and 1 members all hit the SAME 16-member program; 37 is
    # one 48-member dispatch (a multiple of the batch, no host loop)
    assert calls == [16, 16, 48, 16], calls
    assert a.shape == (10, len(lats) * len(lons))
    assert b.shape[0] == 16 and c.shape[0] == 37 and d.shape[0] == 1
    # batches are independent draws, not repeats of one batch
    assert not np.allclose(np.asarray(c[:16]), np.asarray(c[16:32]))
    # distribution unchanged: unit variance to sampling noise
    big = np.asarray(sampler.draw(jax.random.key(4), 4000))
    assert abs(big.var() - 1.0) < 0.1


def test_device_legendre_table_matches_f64_oracle():
    """On-device scaled-scan table == host f64 recurrence to f32 limits.

    Also pins the underflow protection: a plain f32 recurrence loses
    every (l, m, lat) whose diagonal seed cos(lat)^m flushes below the
    f32 minimum (0.02 absolute error by l_max = 256); the exact 2^40
    rescaling keeps those lanes (measured ~2e-4 relative here).
    """
    import jax.numpy as jnp

    from glomargridding_jax.ops.sphere import _legendre_table_device

    lats = np.arange(-89.5, 90.0, 1.0)
    L = 256
    host = legendre_table(L, lats)
    dev = np.asarray(
        _legendre_table_device(
            jnp.asarray(np.sin(np.radians(lats)), jnp.float32), L
        )
    )
    assert np.abs(dev - host).max() < 2e-3
    # pin that the 2^40 rescaling is doing real work: the SAME
    # recurrence run in plain f32 (diagonal seeded as an unscaled
    # product, exactly like the f64 oracle but narrow) flushes
    # cos(lat)^m seeds to zero and loses the values regrown at l >> m
    plain = np.zeros_like(host, dtype=np.float32)
    x32 = np.sin(np.radians(lats)).astype(np.float32)
    sx32 = np.sqrt(np.maximum(1 - x32 * x32, 0)).astype(np.float32)
    plain[0, 0] = np.float32(np.sqrt(1 / (4 * np.pi)))
    for m in range(1, L + 1):
        plain[m, m] = (
            -np.float32(np.sqrt((2 * m + 1) / (2.0 * m)))
            * sx32 * plain[m - 1, m - 1]
        )
    for m in range(L):
        plain[m + 1, m] = x32 * np.float32(np.sqrt(2 * m + 3.0)) * plain[m, m]
    for l in range(2, L + 1):
        m = np.arange(l - 1)
        a = np.sqrt((4.0 * l * l - 1) / (l * l - m * m)).astype(np.float32)
        b = np.sqrt(
            ((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1)
        ).astype(np.float32)
        plain[l, : l - 1] = a[:, None] * (
            x32[None, :] * plain[l - 1, : l - 1]
            - b[:, None] * plain[l - 2, : l - 1]
        )
    plain_err = np.abs(plain - host).max()
    assert plain_err > 5e-3, plain_err  # underflow visibly bites...
    assert np.abs(dev - host).max() < plain_err / 2  # ...and we don't
