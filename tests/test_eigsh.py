"""Randomized top-k eigensolver + partial-spectrum PSD repair tests.

The 16,384-point test uses an implicit operator with an analytically
known spectrum (sign-scaled orthonormal DCT conjugation), so the
device-scale clip is verified against exact ground truth without any
O(n^3) LAPACK oracle — the partial path never materialises an n x n
array at all.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from glomargridding_jax.ops.covariance_tools import (
    LowRankPSD,
    explained_variance_clip,
    explained_variance_clip_lowrank,
    laloux_clip,
    laloux_clip_lowrank,
)
from glomargridding_jax.ops.eigsh import topk_eigh


def _damaged_kernel_cov(n, rng, damage=0.05):
    """Gaussian kernel matrix with an indefinite low-rank perturbation
    (typical of ellipse-assembled covariances: smooth decaying spectrum
    plus small negative eigenvalues)."""
    x = rng.uniform(0.0, 1.0, size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    A = np.exp(-d2 / 0.02)
    P = rng.normal(size=(n, 32)) / np.sqrt(n)
    A = A - damage * (P @ P.T)
    return 0.5 * (A + A.T)


def test_topk_matches_lapack(rng):
    """Convergence contract: the HEAD of the computed Ritz values (the
    part a clip retains, k - oversample) is LAPACK-accurate at defaults;
    with generous oversampling the whole top-k is exact."""
    n, k = 600, 50
    A = _damaged_kernel_cov(n, rng)
    w_full = np.linalg.eigh(A)[0][::-1]

    w, _ = topk_eigh(jnp.asarray(A), k, key=jax.random.key(1))
    np.testing.assert_allclose(w[:30], w_full[:30], rtol=1e-8)

    w, V = topk_eigh(
        jnp.asarray(A), k, key=jax.random.key(1), oversample=32
    )
    np.testing.assert_allclose(w, w_full[:k], rtol=1e-9)
    # Ritz vectors: A v = w v within tolerance, orthonormal
    V = np.asarray(V)
    resid = A @ V - V * w[None, :]
    assert np.linalg.norm(resid) / np.linalg.norm(A) < 1e-6
    np.testing.assert_allclose(V.T @ V, np.eye(k), atol=1e-10)


def test_topk_callable_operator(rng):
    n, k = 300, 20
    A = _damaged_kernel_cov(n, rng)
    Adev = jnp.asarray(A)
    w_dense, _ = topk_eigh(Adev, k)
    w_call, _ = topk_eigh(lambda X: Adev @ X, k, n)
    np.testing.assert_allclose(w_call, w_dense, rtol=1e-12)
    with pytest.raises(ValueError, match="n is required"):
        topk_eigh(lambda X: X, k)


def test_topk_full_width_fallback(rng):
    n = 24
    A = _damaged_kernel_cov(n, rng)
    w, V = topk_eigh(jnp.asarray(A), n)  # k + oversample >= n
    w_full, _ = np.linalg.eigh(A)
    np.testing.assert_allclose(w, w_full[::-1], rtol=1e-12)


def test_partial_clip_matches_full_dense(rng):
    """The partial (randomized top-k) explained-variance clip must
    reproduce the full-LAPACK clip to solver accuracy (run at the
    largest size the 1-core CPU
    oracle affords; the 16,384 case below checks scale vs an analytic
    oracle)."""
    n = 2048
    A = _damaged_kernel_cov(n, rng)
    full = explained_variance_clip(A, 0.95, spectrum="full")
    part = explained_variance_clip(A, 0.95, spectrum="partial")
    err = np.linalg.norm(part - full) / np.linalg.norm(full)
    assert err < 1e-8
    assert np.linalg.eigvalsh(part).min() > 0  # PSD after repair


def test_laloux_partial_matches_full(rng):
    """Block-correlated data: a few eigenvalues far above the RMT
    ceiling; partial and full Laloux clips must agree."""
    n, b = 1024, 256
    rho = 0.6
    blocks = np.kron(np.eye(n // b), np.full((b, b), rho))
    cor = (1.0 - rho) * np.eye(n) + blocks
    variances = rng.uniform(0.5, 2.0, size=n)
    cov = cor * np.sqrt(np.outer(variances, variances))
    full = laloux_clip(cov, num_time_pts=40, spectrum="full")
    part = laloux_clip(cov, num_time_pts=40, spectrum="partial")
    err = np.linalg.norm(part - full) / np.linalg.norm(full)
    assert err < 1e-8


def test_lowrank_psd_container(rng):
    n = 64
    A = _damaged_kernel_cov(n, rng, damage=0.2)
    lr = explained_variance_clip_lowrank(A, target_variance_fraction=0.9)
    dense = lr.to_dense()
    # matvec/diagonal/trace agree with the dense materialisation
    X = rng.normal(size=(n, 3))
    np.testing.assert_allclose(
        np.asarray(lr.matvec(jnp.asarray(X))), dense @ X, rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(lr.matvec(jnp.asarray(X[:, 0]))),
        dense @ X[:, 0],
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(lr.diagonal()), np.diag(dense), rtol=1e-10
    )
    np.testing.assert_allclose(lr.trace(), np.trace(dense), rtol=1e-10)
    assert lr.shape == (n, n)
    # draws have the clipped covariance: projected variances match
    draws = np.asarray(lr.draw(jax.random.key(3), 20000))
    assert draws.shape == (20000, n)
    u = rng.normal(size=(n, 4))
    u /= np.linalg.norm(u, axis=0)
    sample_var = np.var(draws @ u, axis=0)
    true_var = np.einsum("nk,nm,mk->k", u, dense, u)
    np.testing.assert_allclose(sample_var, true_var, rtol=0.06)


def test_partial_clip_16k_implicit_operator():
    """65k-path 'done' check at n=16,384: clip an operator that is never
    materialised, against its analytically known spectrum.

    A = Q diag(s) Q' with Q the orthonormal DCT-II basis: matvecs are
    O(n log n) host FFTs, the true spectrum is `s` exactly, and the true
    clip is A_clip = Q diag(s_clip) Q'."""
    from scipy.fft import dct, idct

    n = 16_384
    i = np.arange(n)
    # exponentially decaying spectrum (smooth spatial kernel) + small
    # negative tail (damage): 95% of variance sits in the top ~45 modes
    s = 250.0 * np.exp(-i / 15.0)
    s[-n // 8 :] = -1e-3 * np.linspace(1.0, 2.0, n // 8)
    trace = float(s.sum())

    def matvec(X):
        Xh = np.asarray(X)
        squeeze = Xh.ndim == 1
        if squeeze:
            Xh = Xh[:, None]
        out = idct(s[:, None] * dct(Xh, axis=0, norm="ortho"), axis=0,
                   norm="ortho")
        return out[:, 0] if squeeze else out

    target = 0.95
    lr = explained_variance_clip_lowrank(
        matvec,
        n=n,
        trace=trace,
        target_variance_fraction=target,
        key=jax.random.key(5),
        k0=128,
    )
    # analytic ground truth
    csum = np.cumsum(s)
    r_true = int(np.nonzero(csum > target * trace)[0][0]) + 1
    assert lr.rank == r_true
    w_ritz = np.asarray(lr.gains) + np.asarray(lr.floor)[0]
    np.testing.assert_allclose(w_ritz, s[:r_true], rtol=1e-4)
    avg_true = (trace - s[:r_true].sum()) / (n - r_true)
    np.testing.assert_allclose(np.asarray(lr.floor)[0], avg_true, rtol=1e-4)

    # clipped-operator action matches the analytic clip on random probes
    s_clip = np.where(i < r_true, s, avg_true)
    probes = np.random.default_rng(11).normal(size=(n, 4))
    true_act = idct(
        s_clip[:, None] * dct(probes, axis=0, norm="ortho"),
        axis=0,
        norm="ortho",
    )
    got_act = np.asarray(lr.matvec(jnp.asarray(probes)))
    err = np.linalg.norm(got_act - true_act) / np.linalg.norm(true_act)
    assert err < 1e-4


def test_laloux_lowrank_callable_requires_diag():
    with pytest.raises(ValueError, match="diag are required"):
        laloux_clip_lowrank(lambda X: X, n=10)


def test_partial_clip_flat_spectrum_raises(rng):
    """A near-identity (flat-spectrum) matrix cannot be low-rank clipped:
    the adaptive loop must fail loudly, not silently truncate."""
    n = 256
    A = np.eye(n) + 1e-6 * _damaged_kernel_cov(n, rng)
    with pytest.raises(ValueError, match="max_rank"):
        explained_variance_clip_lowrank(
            A, target_variance_fraction=0.99, max_rank=64
        )

def test_adaptive_residual_gate_accepts_past_half_width(rng):
    """Round-3 acceptance: a retained rank r > k//2 (which the round-2
    structural rule would reject, forcing a k-doubling) is accepted by
    the residual certificate at width ~ r + oversample, with
    LAPACK-accurate eigenvalues."""
    from glomargridding_jax.ops.eigsh import adaptive_topk_eigh

    n = 512
    A = _damaged_kernel_cov(n, rng)
    w_full = np.linalg.eigh(A)[0][::-1]
    trace = float(np.trace(A))
    target = 0.95 * trace

    def accept(w):
        csum = np.cumsum(w)
        hit = np.nonzero(csum > target)[0]
        return int(hit[0]) + 1 if hit.size else None

    csum = np.cumsum(w_full)
    r_true = int(np.nonzero(csum > target)[0][0]) + 1
    # pick k0 so that r_true > k0 // 2 but r_true <= k0: the structural
    # gate must fail and ONLY the residual gate can accept at this width
    k0 = r_true + 8
    assert r_true > k0 // 2
    w, V, r = adaptive_topk_eigh(
        jnp.asarray(A), accept, k0=k0, key=jax.random.key(3)
    )
    assert r == r_true
    np.testing.assert_allclose(w[:r], w_full[:r], rtol=1e-9)
    V = np.asarray(V)
    assert V.shape == (n, r)
    resid = A @ V - V * w[None, :r]
    assert np.linalg.norm(resid) / np.linalg.norm(A) < 1e-8


def test_adaptive_warm_start_widening(rng):
    """k-doublings carry the converged block: starting far too small
    still converges to the right rank and LAPACK-accurate values."""
    from glomargridding_jax.ops.eigsh import adaptive_topk_eigh

    n = 512
    A = _damaged_kernel_cov(n, rng)
    w_full = np.linalg.eigh(A)[0][::-1]
    trace = float(np.trace(A))
    target = 0.95 * trace

    def accept(w):
        csum = np.cumsum(w)
        hit = np.nonzero(csum > target)[0]
        return int(hit[0]) + 1 if hit.size else None

    w, V, r = adaptive_topk_eigh(
        jnp.asarray(A), accept, k0=4, key=jax.random.key(7)
    )
    csum = np.cumsum(w_full)
    r_true = int(np.nonzero(csum > target)[0][0]) + 1
    assert r == r_true
    np.testing.assert_allclose(w[:r], w_full[:r], rtol=1e-8)


def test_cholqr_failure_falls_back_to_householder(monkeypatch):
    """An operator whose Gram matrix overflows (entries ~ 1e200 in f64:
    Y'Y = inf -> Cholesky NaN -> ok=False) must take the Householder-QR
    rescue and still return accurate leading pairs."""
    import glomargridding_jax.ops.eigsh as eigsh_mod

    calls = {"n": 0}
    real_rescue = eigsh_mod._householder_iterate

    def spy(*args, **kwargs):
        calls["n"] += 1
        return real_rescue(*args, **kwargs)

    monkeypatch.setattr(eigsh_mod, "_householder_iterate", spy)

    n = 128
    rng_l = np.random.default_rng(5)
    Qb = np.linalg.qr(rng_l.normal(size=(n, n)))[0]
    s = np.exp(-np.arange(n) / 3.0)  # decaying spectrum: fast converge
    Apsd = (Qb * s[None, :]) @ Qb.T
    scale = 1e200  # sqrt(f64 max) ~ 1.3e154: Gram entries overflow
    A = jnp.asarray(scale * Apsd)
    w_true = scale * s

    w, V = eigsh_mod.topk_eigh(A, 5, key=jax.random.key(2), oversample=16)
    assert calls["n"] == 1, "Householder rescue did not run"
    np.testing.assert_allclose(w, w_true[:5], rtol=1e-8)
    V = np.asarray(V)
    # scale out 1e200 before norms: squaring would overflow f64
    resid = Apsd @ V - V * (w[None, :] / scale)
    assert np.linalg.norm(resid) / np.linalg.norm(Apsd) < 1e-10

    # the adaptive solver takes the same rescue
    calls["n"] = 0

    def accept(w):
        return 3

    w2, V2, r = eigsh_mod.adaptive_topk_eigh(
        A, accept, k0=8, key=jax.random.key(2), oversample=16
    )
    assert calls["n"] >= 1
    assert r == 3
    np.testing.assert_allclose(w2[:3], w_true[:3], rtol=1e-8)


def test_clip_wrappers_never_densify_callables(rng):
    """Return-type contract: the parity
    wrappers must return the factored LowRankPSD for callable operators
    — never an implicit n x n materialisation."""
    n = 256
    A = _damaged_kernel_cov(n, rng, damage=0.2)
    Adev = jnp.asarray(A)
    trace = float(np.trace(A))

    out = explained_variance_clip(
        lambda X: Adev @ X, 0.9, n=n, trace=trace
    )
    assert isinstance(out, LowRankPSD)
    dense_oracle = explained_variance_clip(A, 0.9, spectrum="partial")
    err = np.linalg.norm(out.to_dense() - dense_oracle) / np.linalg.norm(
        dense_oracle
    )
    assert err < 1e-10

    out2 = laloux_clip(
        lambda X: Adev @ X, n=n, diag=jnp.asarray(np.diag(A)),
        num_time_pts=40,
    )
    assert isinstance(out2, LowRankPSD)

    # dense inputs past the densify guard also stay factored
    import glomargridding_jax.ops.covariance_tools as ct

    assert ct._DENSIFY_GUARD == 32768


def test_predicted_widening_saves_stages(rng):
    """The rank predictor narrows the widening instead of blind
    doubling: a geometric spectrum whose target rank is ~12x k0 reaches
    the SAME answer as the full-spectrum clip while never allocating a
    block much wider than the needed rank, and (with Ritz locking
    forced) in fewer operator column-sweeps than the doubling schedule.
    Locking is forced via the size threshold: on a small problem
    the solver would (correctly) choose the joint warm start, which
    this test does not measure."""
    import glomargridding_jax.ops.eigsh as eigsh_mod
    from glomargridding_jax.ops.covariance_tools import (
        explained_variance_clip_lowrank,
    )

    n = 640
    rho = 0.97
    lam = rho ** np.arange(n)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T)
    trace = float(np.trace(A))

    widths = []

    def mv(X):
        X = np.asarray(X)
        widths.append(X.shape[1] if X.ndim == 2 else 1)
        return A @ X

    old_thresh = eigsh_mod._LOCK_MIN_N
    eigsh_mod._LOCK_MIN_N = 0  # force the locked flavour
    try:
        psd = explained_variance_clip_lowrank(
            mv, n=n, trace=trace, target_variance_fraction=0.95,
            key=jax.random.key(3), k0=8, max_rank=512, n_iter=6,
            # production (f32) residual tolerance: the f64 default
            # 1e-10 would push acceptance to the structural gate and
            # double the widths this test pins
            tol=1e-2,
        )
    finally:
        eigsh_mod._LOCK_MIN_N = old_thresh
    # exact target rank for this spectrum
    csum = np.cumsum(np.linalg.eigh(A)[0][::-1])
    r_true = int(np.nonzero(csum > 0.95 * trace)[0][0]) + 1
    assert abs(psd.rank - r_true) <= 2
    # trace preserved, factored result matches the dense clip where the
    # retained head dominates
    np.testing.assert_allclose(psd.trace(), trace, rtol=1e-6)
    # prediction must never allocate far beyond the needed width
    assert max(widths) <= int(1.5 * r_true) + 24, (max(widths), r_true)
    total_sweep_cols = sum(widths)
    # joint re-iteration measures 2256-2646 col-sweeps on this problem
    # (3557 without the rank predictor); locked widening pays only the
    # ACTIVE width per sweep -> measured 1566 (with the active block's
    # n_iter + 2 compensation sweeps). Pin the regression boundary
    # between the flavours.
    assert total_sweep_cols < 1900, total_sweep_cols


def test_laloux_predicted_widening(rng):
    """The Laloux clip's rank predictor (extrapolate to the RMT
    ceiling) drives widening from a far-too-small k0 to the full-
    spectrum answer."""
    from glomargridding_jax.ops.covariance_tools import (
        laloux_clip,
        laloux_clip_lowrank,
    )

    # 96 blocks of 8 with DECAYING internal correlation: one distinct
    # eigenvalue 1 + 7 rho_i per block, decaying geometrically through
    # the q=1 RMT ceiling of 4.0 -> ~70 retained pairs, a spectrum the
    # rank predictor can extrapolate
    n, b = 768, 8
    rhos = 0.9 * 0.99 ** np.arange(n // b)
    blocks = [
        (1.0 - r) * np.eye(b) + np.full((b, b), r) for r in rhos
    ]
    import scipy.linalg as sla

    cor = sla.block_diag(*blocks)
    variances = rng.uniform(0.5, 2.0, size=n)
    cov = cor * np.sqrt(np.outer(variances, variances))
    full = laloux_clip(cov, num_time_pts=n, spectrum="full")

    widths = []

    def mv(X):
        X = np.asarray(X)
        widths.append(X.shape[1] if X.ndim == 2 else 1)
        return cov @ X

    import glomargridding_jax.ops.eigsh as eigsh_mod

    old_thresh = eigsh_mod._LOCK_MIN_N
    eigsh_mod._LOCK_MIN_N = 0  # force the locked flavour
    try:
        psd = laloux_clip_lowrank(
            mv, diag=np.diag(cov), n=n, num_time_pts=n,
            key=jax.random.key(4), k0=8, max_rank=512, n_iter=6,
            tol=1e-2,
        )
    finally:
        eigsh_mod._LOCK_MIN_N = old_thresh
    part = np.asarray(psd.to_dense())
    err = np.linalg.norm(part - full) / np.linalg.norm(full)
    assert err < 5e-3, err
    # the predictor must jump close to the ~96-rank answer instead of
    # walking the full doubling ladder; the widest block stays bounded
    assert max(widths) <= int(1.6 * psd.rank) + 24, (max(widths), psd.rank)
