"""Batched Nelder-Mead vs scipy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import minimize

from glomargridding_jax.ops.optim import batched_nelder_mead, nelder_mead


def rosenbrock(x):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


def test_rosenbrock_matches_scipy():
    x0 = jnp.array([-1.2, 1.0])
    res = nelder_mead(rosenbrock, x0, xatol=1e-6, fatol=1e-6, maxiter=1000)
    ref = minimize(
        lambda x: float(rosenbrock(jnp.asarray(x))),
        np.array([-1.2, 1.0]),
        method="Nelder-Mead",
        options={"xatol": 1e-6, "fatol": 1e-6, "maxiter": 1000},
    )
    assert bool(res.success)
    np.testing.assert_allclose(np.asarray(res.x), ref.x, atol=1e-4)


def test_bounded_quadratic():
    # minimum outside the box -> converges onto the bound
    def f(x):
        return jnp.sum((x - 5.0) ** 2)

    lo = jnp.array([0.0, 0.0])
    hi = jnp.array([2.0, 2.0])
    res = nelder_mead(f, jnp.array([1.0, 1.0]), bounds=(lo, hi))
    np.testing.assert_allclose(np.asarray(res.x), [2.0, 2.0], atol=1e-3)


def test_batched_quadratics(rng):
    # B independent quadratics with different centres
    centres = jnp.asarray(rng.uniform(-3, 3, size=(64, 3)))

    def f(x, c):
        return jnp.sum((x - c) ** 2)

    x0 = jnp.zeros((64, 3))
    lo = jnp.full(3, -10.0)
    hi = jnp.full(3, 10.0)
    res = batched_nelder_mead(
        f, x0, (centres,), (lo, hi), xatol=1e-6, fatol=1e-10, maxiter=600
    )
    assert bool(res.success.all())
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(centres), atol=1e-3
    )
    assert res.nit.shape == (64,)


def test_batched_matches_vmapped_per_lane(rng):
    """The native batched NM is step-for-step the vmapped scalar one.

    Rosenbrock from scattered starts mixes every branch of the decision
    tree (including shrinks) and converges at different per-lane rates,
    so agreement here pins the stacked candidate evaluation, the
    cond-guarded shrink, and the frozen-lane bookkeeping against the
    reference per-lane implementation.
    """

    def rosen_args(x, a):
        return (a - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    B = 16
    a = jnp.asarray(rng.uniform(0.5, 1.5, size=(B,)))
    x0 = jnp.asarray(rng.uniform(-2, 2, size=(B, 2)))
    lo = jnp.full(2, -5.0)
    hi = jnp.full(2, 5.0)

    res = batched_nelder_mead(
        rosen_args, x0, (a,), (lo, hi), xatol=1e-6, fatol=1e-6,
        maxiter=800,
    )

    def solve_one(x0_i, a_i):
        return nelder_mead(
            lambda x: rosen_args(x, a_i), x0_i, bounds=(lo, hi),
            xatol=1e-6, fatol=1e-6, maxiter=800,
        )

    ref = jax.vmap(solve_one)(x0, a)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(ref.x), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(res.nit), np.asarray(ref.nit)
    )
    np.testing.assert_array_equal(
        np.asarray(res.success), np.asarray(ref.success)
    )
    # lanes genuinely differ in convergence time, so the frozen-lane
    # path was exercised
    assert len(np.unique(np.asarray(res.nit))) > 1


def test_batched_shrink_path(rng):
    """Non-smooth max-norm objectives force genuine shrink steps."""

    def f(x, c):
        return jnp.max(jnp.abs(x - c))

    B = 8
    c = jnp.asarray(rng.uniform(-1, 1, size=(B, 3)))
    x0 = jnp.zeros((B, 3))
    lo = jnp.full(3, -4.0)
    hi = jnp.full(3, 4.0)
    res = batched_nelder_mead(
        f, x0, (c,), (lo, hi), xatol=1e-5, fatol=1e-8, maxiter=1500
    )

    def solve_one(x0_i, c_i):
        return nelder_mead(
            lambda x: f(x, c_i), x0_i, bounds=(lo, hi),
            xatol=1e-5, fatol=1e-8, maxiter=1500,
        )

    ref = jax.vmap(solve_one)(x0, c)
    # NM legitimately stalls short of the corner optimum on max-norm
    # objectives; the pin here is that the native batched loop takes
    # EXACTLY the vmapped reference's shrink decisions, not that NM
    # solves non-smooth problems.
    np.testing.assert_array_equal(
        np.asarray(res.nit), np.asarray(ref.nit)
    )
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(ref.x), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res.fun), np.asarray(ref.fun), rtol=1e-5, atol=1e-8
    )


def test_batched_maxiter_reports_failure():
    def f(x, c):
        return rosenbrock(x - c)

    c = jnp.zeros((4, 2))
    x0 = jnp.broadcast_to(jnp.asarray([-1.2, 1.0]), (4, 2))
    res = batched_nelder_mead(
        f, x0, (c,), None, xatol=1e-12, fatol=1e-12, maxiter=3
    )
    assert not bool(res.success.any())
    np.testing.assert_array_equal(np.asarray(res.nit), 3)


def test_maxiter_reports_failure():
    res = nelder_mead(
        rosenbrock, jnp.array([-1.2, 1.0]), maxiter=3, xatol=1e-12,
        fatol=1e-12,
    )
    assert not bool(res.success)
    assert int(res.nit) == 3


def test_lbfgs_bounded_quadratic():
    from glomargridding_jax.ops.optim import lbfgs_minimize

    def f(x):
        return jnp.sum((x - 5.0) ** 2)

    lo = jnp.array([0.0, 0.0])
    hi = jnp.array([2.0, 2.0])
    res = lbfgs_minimize(f, jnp.array([1.0, 1.0]), bounds=(lo, hi))
    np.testing.assert_allclose(np.asarray(res.x), [2.0, 2.0], atol=1e-2)

    # interior optimum found precisely
    res2 = lbfgs_minimize(
        f, jnp.array([1.0, 1.0]), bounds=(lo, jnp.array([10.0, 10.0]))
    )
    assert bool(res2.success)
    np.testing.assert_allclose(np.asarray(res2.x), [5.0, 5.0], atol=1e-4)


def test_batched_lbfgs(rng):
    from glomargridding_jax.ops.optim import batched_lbfgs

    centres = jnp.asarray(rng.uniform(-3, 3, size=(32, 3)))

    def f(x, c):
        return jnp.sum((x - c) ** 2)

    x0 = jnp.zeros((32, 3))
    lo = jnp.full(3, -10.0)
    hi = jnp.full(3, 10.0)
    res = batched_lbfgs(f, x0, (centres,), (lo, hi), tol=1e-8)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(centres), atol=1e-3
    )


def test_nm_matches_scipy_on_ellipse_nll(rng):
    """Our batched NM lands on the same optimum as scipy's bounded NM on
    the real (Fisher-transformed) ellipse likelihood."""
    from scipy.optimize import minimize
    from scipy.special import kv as skv

    from glomargridding_jax.models.ellipse import EllipseModel

    m = EllipseModel(
        anisotropic=True, rotated=True, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    # synthetic anisotropic correlations
    Lx_t, Ly_t, th_t = 1800.0, 700.0, 0.5
    dx = rng.uniform(-4000, 4000, 400)
    dy = rng.uniform(-4000, 4000, 400)
    X = np.column_stack([dx, dy])
    R = np.array([[np.cos(th_t), -np.sin(th_t)],
                  [np.sin(th_t), np.cos(th_t)]])
    S = R @ np.diag([Lx_t**2, Ly_t**2]) @ R.T
    Si = np.linalg.inv(S)
    tau = np.sqrt(dx * (Si[0, 0] * dx + Si[0, 1] * dy)
                  + dy * (Si[1, 0] * dx + Si[1, 1] * dy))
    inner = 2 * tau * np.sqrt(0.5)
    y = inner**0.5 * skv(0.5, inner) / np.sqrt(np.pi / 2)
    y = np.clip(y + rng.normal(0, 0.03, 400), -0.999, 0.999)

    bounds = [(300.0, 10000.0), (300.0, 10000.0),
              (-2 * np.pi, 2 * np.pi)]
    guesses = [1000.0, 1000.0, 0.0]

    ours, _, _ = m.fit(X, y, guesses=list(guesses), bounds=list(bounds),
                       tol=1e-6, estimate_SE=None)

    ref = minimize(
        lambda p: m.negative_log_likelihood(X, y.copy(), list(p)),
        np.array(guesses),
        bounds=bounds,
        method="Nelder-Mead",
        tol=1e-6,
    )
    # same optimum (scale lengths within 2%, angle within 0.05 rad
    # modulo the Lx/Ly symmetry)
    np.testing.assert_allclose(np.asarray(ours.x)[:2], ref.x[:2], rtol=0.02)
    assert abs(float(ours.fun) - ref.fun) < abs(ref.fun) * 1e-3


def test_lm_success_semantics(rng):
    """Levenberg-Marquardt lane outcomes: a solvable lane and a lane
    that STARTS at its optimum both report success; a NaN-objective
    lane exits via damping saturation with success=False (it never
    accepted a step) so compute_params can mark it qc_code 9."""
    from glomargridding_jax.ops.optim import batched_levenberg_marquardt

    t = jnp.linspace(0.0, 1.0, 16)

    def res_fun(x, y):
        return x[0] * t + x[1] - y

    y_good = 2.0 * t + 1.0
    x0 = jnp.asarray(
        [
            [0.5, 0.0],   # converges to (2, 1)
            [2.0, 1.0],   # already AT the optimum
            [0.5, 0.0],   # NaN data: no step ever improves
        ]
    )
    ys = jnp.stack([y_good, y_good, jnp.full_like(y_good, jnp.nan)])
    res = batched_levenberg_marquardt(
        res_fun, x0, (ys,),
        (jnp.asarray([-10.0, -10.0]), jnp.asarray([10.0, 10.0])),
    )
    assert bool(res.success[0])
    np.testing.assert_allclose(
        np.asarray(res.x[0]), [2.0, 1.0], atol=1e-4
    )
    assert bool(res.success[1])
    np.testing.assert_allclose(
        np.asarray(res.x[1]), [2.0, 1.0], atol=1e-6
    )
    assert not bool(res.success[2])
