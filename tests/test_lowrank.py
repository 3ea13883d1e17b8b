"""Low-rank (factored-covariance) kriging + ensemble vs the dense path.

The ``models.lowrank`` solvers never materialise the n x n covariance;
these tests densify the same ``LowRankPSD`` and check every output —
field, uncertainty, constraint mask, deterministic member updates —
against the shipping dense ``OrdinaryKriging`` solver and an independent
numpy implementation of the two-stage perturbation update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glomargridding_jax.models.kriging import OrdinaryKriging
from glomargridding_jax.models.lowrank import (
    lowrank_ensemble_step,
    lowrank_kriging,
    lowrank_members_from_states,
)
from glomargridding_jax.ops.covariance_tools import (
    LowRankPSD,
    explained_variance_clip_lowrank,
)

N, R, M = 240, 12, 40


def _make_psd(rng, n=N, r=R, uniform_floor=False):
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    V = jnp.asarray(Q[:, :r])
    g = jnp.asarray(np.sort(rng.uniform(0.5, 4.0, r))[::-1].copy())
    if uniform_floor:
        f = jnp.full((n,), 0.07)
    else:
        f = jnp.asarray(rng.uniform(0.02, 0.3, n))
    return LowRankPSD(vectors=V, gains=g, floor=f)


def _obs_setup(rng, n=N, m=M):
    idx = np.sort(rng.choice(n, size=m, replace=False))
    y = rng.normal(size=m)
    B = rng.normal(size=(m, m))
    E = B @ B.T / m + 0.05 * np.eye(m)
    return idx, y, E


def test_lowrank_kriging_matches_dense(rng):
    psd = _make_psd(rng)
    idx, y, E = _obs_setup(rng)
    dense = np.asarray(psd.to_dense())

    res = lowrank_kriging(psd, idx, y, E)

    err_full = np.full((N, N), np.nan)
    err_full[np.ix_(idx, idx)] = E
    OK = OrdinaryKriging(dense, idx=idx, obs=y, error_cov=err_full)
    np.testing.assert_allclose(res.field, OK.solve(), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(
        res.uncertainty, OK.get_uncertainty(), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        res.constraint_mask, OK.constraint_mask(), rtol=1e-8, atol=1e-10
    )


def test_lowrank_kriging_uniform_floor(rng):
    """The exact form the clips produce: uniform floor, orthonormal V."""
    psd = _make_psd(rng, uniform_floor=True)
    idx, y, E = _obs_setup(rng)
    dense = np.asarray(psd.to_dense())
    res = lowrank_kriging(psd, idx, y, E)

    err_full = np.full((N, N), np.nan)
    err_full[np.ix_(idx, idx)] = E
    OK = OrdinaryKriging(dense, idx=idx, obs=y, error_cov=err_full)
    np.testing.assert_allclose(res.field, OK.solve(), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(
        res.uncertainty, OK.get_uncertainty(), rtol=1e-8, atol=1e-10
    )


def test_members_from_states_matches_dense_two_stage(rng):
    """Deterministic member update == field + W'(state[idx]+eps) - state."""
    psd = _make_psd(rng)
    idx, y, E = _obs_setup(rng)
    dense = np.asarray(psd.to_dense())
    n_members = 7
    states = rng.normal(size=(n_members, N))
    eps = rng.normal(size=(n_members, M))

    got = lowrank_members_from_states(psd, idx, y, E, states, eps)

    K = dense[np.ix_(idx, idx)] + E
    C_cross = dense[idx, :]  # (m, n)
    W = np.linalg.solve(K, C_cross)  # (m, n) simple weights
    # ordinary field
    K_ext = np.block(
        [[K, np.ones((M, 1))], [np.ones((1, M)), np.zeros((1, 1))]]
    )
    C_ext = np.concatenate([C_cross, np.ones((1, N))], axis=0)
    field = (np.linalg.solve(K_ext, C_ext).T @ np.append(y, 0.0)).ravel()
    sim_obs = states[:, idx] + eps
    expected = field[None, :] + (sim_obs @ W - states)
    np.testing.assert_allclose(got, expected, rtol=1e-8, atol=1e-9)


def test_ensemble_step_statistics(rng):
    """Random path: mean of members ~ field, spread ~ uncertainty."""
    psd = _make_psd(rng, uniform_floor=True)
    idx, y, E = _obs_setup(rng)
    n_members = 4000
    res, members = lowrank_ensemble_step(
        psd, idx, y, E, jax.random.key(7), n_members=n_members
    )
    assert members.shape == (n_members, N)
    assert np.all(np.isfinite(members))
    dev = np.asarray(members) - np.asarray(res.field)[None, :]
    # per-point sample std vs the SIMPLE-kriging posterior sd: the
    # two-stage perturbation eps = W'(state[idx]+noise) - state has
    # covariance C - C_x' K^{-1} C_x exactly (densified here).
    dense = np.asarray(psd.to_dense())
    K = dense[np.ix_(idx, idx)] + E
    C_cross = dense[idx, :]
    post = np.diag(dense) - np.einsum(
        "mn,mn->n", C_cross, np.linalg.solve(K, C_cross)
    )
    u = np.sqrt(np.maximum(post, 0.0))
    sd = dev.std(axis=0)
    ratio = sd[u > 1e-3] / u[u > 1e-3]
    assert abs(np.mean(ratio) - 1.0) < 0.05
    assert np.mean(dev, axis=0) == pytest.approx(0.0, abs=0.15)


def test_pipeline_clip_to_ensemble(rng):
    """End-to-end: dense non-PSD-ish covariance -> low-rank clip ->
    kriging matches the dense solver on the densified clip."""
    n = 300
    A = rng.normal(size=(n, 6))
    C = A @ A.T + 0.2 * np.eye(n)
    psd = explained_variance_clip_lowrank(
        jnp.asarray(C), target_variance_fraction=0.9, key=jax.random.key(0)
    )
    idx, y, E = _obs_setup(rng, n=n, m=30)
    res = lowrank_kriging(psd, idx, y, E)

    dense = np.asarray(psd.to_dense())
    err_full = np.full((n, n), np.nan)
    err_full[np.ix_(idx, idx)] = E
    OK = OrdinaryKriging(dense, idx=idx, obs=y, error_cov=err_full)
    np.testing.assert_allclose(res.field, OK.solve(), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(
        res.uncertainty, OK.get_uncertainty(), rtol=1e-6, atol=1e-8
    )


def test_pad_rank_is_numerically_inert(rng):
    """Zero-gain padding changes shapes only: kriging outputs, matvec,
    diagonal and trace are identical; rank becomes the next multiple."""
    psd = _make_psd(rng)
    idx, y, E = _obs_setup(rng)
    padded = psd.pad_rank(16)
    assert padded.rank == 16 and psd.rank == R
    assert padded.pad_rank(16) is padded  # already aligned: no-op

    x = jnp.asarray(rng.normal(size=(N,)))
    np.testing.assert_allclose(padded.matvec(x), psd.matvec(x), rtol=1e-12)
    np.testing.assert_allclose(
        padded.diagonal(), psd.diagonal(), rtol=1e-12
    )
    assert np.isclose(padded.trace(), psd.trace(), rtol=1e-12)

    a = lowrank_kriging(psd, idx, y, E)
    b = lowrank_kriging(padded, idx, y, E)
    np.testing.assert_allclose(b.field, a.field, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        b.uncertainty, a.uncertainty, rtol=1e-7, atol=1e-9
    )
    np.testing.assert_allclose(
        b.constraint_mask, a.constraint_mask, rtol=1e-9, atol=1e-12
    )

    states = rng.normal(size=(3, N))
    eps = rng.normal(size=(3, M))
    ma = lowrank_members_from_states(psd, idx, y, E, states, eps)
    mb = lowrank_members_from_states(padded, idx, y, E, states, eps)
    np.testing.assert_allclose(mb, ma, rtol=1e-8, atol=1e-10)


def test_months_scan_matches_per_month_calls(rng):
    """One scanned program == independent per-month solves."""
    from glomargridding_jax.models.lowrank import lowrank_months_scan

    psd = _make_psd(rng)
    T = 3
    idx_m = np.stack(
        [np.sort(rng.choice(N, size=M, replace=False)) for _ in range(T)]
    )
    obs_m = rng.normal(size=(T, M))
    err_m = np.stack([0.05 * np.eye(M) for _ in range(T)])

    key = jax.random.key(5)
    res, members = lowrank_months_scan(
        psd, idx_m, obs_m, err_m, key=key, n_members=4
    )
    assert res.field.shape == (T, N)
    assert members.shape == (T, 4, N)

    keys = jax.random.split(key, T)
    for t in range(T):
        ref = lowrank_kriging(psd, idx_m[t], obs_m[t], err_m[t])
        np.testing.assert_allclose(
            np.asarray(res.field[t]), np.asarray(ref.field), rtol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(res.uncertainty[t]),
            np.asarray(ref.uncertainty),
            rtol=1e-8,
        )
        _, mem_ref = lowrank_ensemble_step(
            psd, idx_m[t], obs_m[t], err_m[t], keys[t], n_members=4
        )
        np.testing.assert_allclose(
            np.asarray(members[t]), np.asarray(mem_ref), rtol=1e-8,
            atol=1e-10,
        )


def test_months_scan_diagnostics_off(rng):
    """diagnostics=False: identical fields/members, zeroed diagnostics."""
    from glomargridding_jax.models.lowrank import lowrank_months_scan

    psd = _make_psd(rng)
    T = 2
    idx_m = np.stack(
        [np.sort(rng.choice(N, size=M, replace=False)) for _ in range(T)]
    )
    obs_m = rng.normal(size=(T, M))
    err_m = np.stack([0.05 * np.eye(M) for _ in range(T)])
    key = jax.random.key(9)

    full, mem_full = lowrank_months_scan(
        psd, idx_m, obs_m, err_m, key=key, n_members=3
    )
    fast, mem_fast = lowrank_months_scan(
        psd, idx_m, obs_m, err_m, key=key, n_members=3, diagnostics=False
    )
    np.testing.assert_allclose(
        np.asarray(fast.field), np.asarray(full.field), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(mem_fast), np.asarray(mem_full), rtol=1e-12
    )
    assert not np.any(np.asarray(fast.uncertainty))
    assert not np.any(np.asarray(fast.constraint_mask))


def test_duplicate_obs_indices_warn(rng):
    """Genuinely duplicated grid indices warn (the factored observation
    system drops the floor coupling between them, models/lowrank.py:57);
    pad-convention duplicates (huge error diagonal) stay silent."""
    import warnings

    from glomargridding_jax.models.lowrank import check_idx_unique

    psd = _make_psd(rng)
    idx, y, E = _obs_setup(rng)
    idx_dup = idx.copy()
    idx_dup[1] = idx_dup[0]  # two real obs share a grid cell

    with pytest.warns(UserWarning, match="multiple observations"):
        lowrank_kriging(psd, idx_dup, y, E)

    # pad convention: duplicates whose error diagonal is huge are exempt
    E_pad = E.copy()
    E_pad[1, 1] = 1e8
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert check_idx_unique(idx_dup, E_pad)
        lowrank_kriging(psd, idx_dup, y, E_pad)

    # unique indices never warn
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert check_idx_unique(idx, E)


def test_woodbury_route_matches_dense_cholesky_route(rng):
    """e_diag=True (Woodbury, r-sized solves only) == e_diag=False.

    With a diagonal E the obs-noise draws coincide exactly
    (cholesky(diag) = sqrt(diag)), so field, diagnostics AND members
    must match the m-Cholesky route to solver tolerance.
    """
    import jax

    from glomargridding_jax.models.lowrank import _lowrank_solve_impl
    from glomargridding_jax.ops.covariance_tools import LowRankPSD

    n, r, m = 400, 48, 120
    Q, _ = np.linalg.qr(rng.normal(size=(n, r)))
    g = np.sort(rng.uniform(0.5, 30.0, r))[::-1].copy()
    g[-8:] = 0.0  # pad_rank-style zero-gain columns ride along
    psd = LowRankPSD(
        jnp.asarray(Q, jnp.float32),
        jnp.asarray(g, jnp.float32),
        jnp.asarray(np.full(n, 0.3, np.float32)),
    )
    idx = jnp.asarray(np.sort(rng.choice(n, m, replace=False)))
    y = jnp.asarray(rng.normal(size=m).astype(np.float32))
    E = jnp.asarray(np.diag(rng.uniform(0.05, 0.4, m)).astype(np.float32))

    key = jax.random.key(7)
    outs = {}
    for flag in (False, True):
        outs[flag] = _lowrank_solve_impl(
            psd.vectors, psd.gains, psd.floor, E, idx, y, key,
            8, True, flag,
        )
    for a, b, name in zip(
        outs[False], outs[True],
        ("field", "uncert2", "cmask", "members"),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-4,
            err_msg=name,
        )


def test_diagonal_error_cov_as_vector(rng):
    """error_cov given as the (m,) diagonal == the dense np.diag form.

    Same Woodbury route, same draws (the noise is drawn from sqrt of
    the diagonal either way), so results match bitwise.
    """
    import jax

    from glomargridding_jax.models.lowrank import (
        lowrank_ensemble_step,
        lowrank_kriging,
    )
    from glomargridding_jax.ops.covariance_tools import LowRankPSD

    n, r, m = 300, 32, 80
    Q, _ = np.linalg.qr(rng.normal(size=(n, r)))
    g = np.sort(rng.uniform(0.5, 20.0, r))[::-1].copy()
    psd = LowRankPSD(
        jnp.asarray(Q, jnp.float32),
        jnp.asarray(g, jnp.float32),
        jnp.asarray(np.full(n, 0.2, np.float32)),
    )
    idx = jnp.asarray(np.sort(rng.choice(n, m, replace=False)))
    y = jnp.asarray(rng.normal(size=m).astype(np.float32))
    ed = rng.uniform(0.05, 0.4, m).astype(np.float32)

    res_v = lowrank_kriging(psd, idx, y, ed)
    res_m = lowrank_kriging(psd, idx, y, np.diag(ed))
    np.testing.assert_array_equal(
        np.asarray(res_v.field), np.asarray(res_m.field)
    )
    np.testing.assert_array_equal(
        np.asarray(res_v.uncertainty), np.asarray(res_m.uncertainty)
    )

    key = jax.random.key(11)
    _, mem_v = lowrank_ensemble_step(psd, idx, y, ed, key, 6)
    _, mem_m = lowrank_ensemble_step(psd, idx, y, np.diag(ed), key, 6)
    np.testing.assert_array_equal(np.asarray(mem_v), np.asarray(mem_m))


def test_months_scan_stacked_diagonal_vectors(rng):
    """error_cov_months as (T, m) stacked diagonals == (T, m, m) diags.

    Both take the Woodbury route with identical noise draws, so the
    results match bitwise; the vector form skips the T m^2 upload.
    """
    from glomargridding_jax.models.lowrank import lowrank_months_scan

    psd = _make_psd(rng)
    T = 3
    idx_m = np.stack(
        [np.sort(rng.choice(N, size=M, replace=False)) for _ in range(T)]
    )
    obs_m = rng.normal(size=(T, M))
    diags = rng.uniform(0.03, 0.2, size=(T, M)).astype(np.float32)
    err_mat = np.stack([np.diag(d) for d in diags])

    key = jax.random.key(9)
    res_v, mem_v = lowrank_months_scan(
        psd, idx_m, obs_m, diags, key=key, n_members=4
    )
    res_m, mem_m = lowrank_months_scan(
        psd, idx_m, obs_m, err_mat, key=key, n_members=4
    )
    np.testing.assert_array_equal(
        np.asarray(res_v.field), np.asarray(res_m.field)
    )
    np.testing.assert_array_equal(
        np.asarray(res_v.uncertainty), np.asarray(res_m.uncertainty)
    )
    np.testing.assert_array_equal(np.asarray(mem_v), np.asarray(mem_m))


def test_woodbury_refinement_survives_ill_conditioning(rng):
    """f32 Woodbury field == f64 oracle under harsh conditioning.

    Gains spanning 1e-2..1e4 over floor 1e-3 give kappa(K) ~ 1e7: the
    two Woodbury terms cancel and a single f32 pass loses ~kappa*eps of
    the FIELD (measured 0.45 vs 0.39 self-consistent RMSE at the 65k
    realistic workload). The iterative-refinement step must keep the
    f32 route within ~1e-3 of the f64 direct solve.
    """
    from glomargridding_jax.models.lowrank import _lowrank_solve_impl

    n, r, m = 2000, 256, 500
    Q, _ = np.linalg.qr(rng.normal(size=(n, r)))
    g = np.logspace(4, -2, r)
    f = np.full(n, 1e-3)
    idx = np.sort(rng.choice(n, m, replace=False))
    e = np.full(m, 0.05)

    # f64 oracle: the same ordinary-kriging algebra, dense direct solve
    V_o = Q[idx]
    f_o = f[idx]
    K = (V_o * g) @ V_o.T + np.diag(f_o + e)
    truth_y = rng.normal(size=m)
    u = np.linalg.solve(K, np.ones(m))
    w = np.linalg.solve(K, truth_y)
    s = u.sum()
    uy = u @ truth_y

    def cross_t(z):
        out = Q @ (g * (V_o.T @ z))
        out[idx] += f_o * z
        return out

    t = cross_t(u)
    cw = cross_t(w)
    lam = (t - 1.0) / s
    field64 = cw - lam * uy

    fields = {}
    for flag in (True, False):
        E32 = (
            jnp.asarray(e, jnp.float32)
            if flag
            else jnp.asarray(np.diag(e), jnp.float32)
        )
        fields[flag], _, _, _ = _lowrank_solve_impl(
            jnp.asarray(Q, jnp.float32),
            jnp.asarray(g, jnp.float32),
            jnp.asarray(f, jnp.float32),
            E32,
            jnp.asarray(idx),
            jnp.asarray(truth_y, jnp.float32),
            jax.random.key(0),
            0,
            True,
            flag,
        )
    scale = np.abs(field64).max()
    # at kappa ~ 1e7 each f32 route legitimately sits O(kappa * eps)
    # from the oracle (and from the other route — they factor slightly
    # different f32 perturbations of K), so the pin here is "no
    # catastrophic loss": the pre-fix failure (reduced-precision
    # matmuls) was ~15% field error, two orders above this bound. The
    # production-scale consistency (RMSE == uncertainty == spread for
    # truth drawn from the model) is checked by chip_smoke.py.
    for flag in (True, False):
        err = np.abs(np.asarray(fields[flag]) - field64).max()
        assert err < 2e-2 * scale, (flag, err, scale)


def test_lowrank_crossval_matches_bruteforce(rng):
    """Factored-covariance LOO CV equals literal remove-one-and-refit
    against the densified factors."""
    import jax.numpy as jnp

    from glomargridding_jax.models.lowrank import lowrank_crossval
    from glomargridding_jax.ops.covariance_tools import LowRankPSD

    n, r, m = 80, 12, 20
    Q, _ = np.linalg.qr(rng.standard_normal((n, r)))
    psd = LowRankPSD(
        vectors=jnp.asarray(Q, jnp.float32),
        gains=jnp.asarray(np.linspace(4.0, 1.0, r), jnp.float32),
        floor=jnp.asarray(
            rng.uniform(0.05, 0.2, n).astype(np.float32)
        ),
    )
    idx = np.sort(rng.choice(n, m, replace=False))
    y = rng.normal(size=m).astype(np.float32)
    E = (0.1 + 0.05 * rng.random(m)).astype(np.float32)

    cv = lowrank_crossval(psd, idx, y, E, method="ordinary")

    C = np.asarray(psd.to_dense(), np.float64)[np.ix_(idx, idx)]
    K = C + np.diag(E.astype(np.float64))
    for i in range(m):
        keep = np.arange(m) != i
        Ki = K[np.ix_(keep, keep)]
        ci = C[keep, i]
        ones = np.ones(m - 1)
        Kx = np.block(
            [[Ki, ones[:, None]], [ones[None, :], np.zeros((1, 1))]]
        )
        w = np.linalg.solve(Kx, np.concatenate([ci, [1.0]]))
        pred = w[:-1] @ y[keep]
        var = K[i, i] - w[:-1] @ ci - w[-1]
        np.testing.assert_allclose(
            float(cv.residuals[i]), y[i] - pred, rtol=2e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            float(cv.loo_variance[i]), var, rtol=2e-4, atol=1e-5
        )
