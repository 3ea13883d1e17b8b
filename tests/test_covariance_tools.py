"""PSD-repair property tests (reference test_covariance_tools idioms)."""

import numpy as np
import pytest

from glomargridding_jax.ops.covariance_tools import (
    check_symmetric,
    clean_small,
    csum_up_to_val,
    eigenvalue_clip,
    explained_variance_clip,
    laloux_clip,
    perturb_cov_to_positive_definite,
    simple_clipping,
)


def _damaged_covariance(rng, n=80, t=20):
    """Rank-deficient sample covariance (T << N => negative eigs after
    noise), with a strong common mode (so RMT clipping retains signal)."""
    common = rng.normal(size=(t, 1)) @ np.ones((1, n))
    data = rng.normal(size=(t, n)) + 2.0 * common
    cov = data.T @ data / (t - 1)
    # perturb to indefinite
    w, v = np.linalg.eigh(cov)
    w[: n // 2] -= 1e-6  # push some to negative
    return (v * w) @ v.T


def test_explained_variance_clip_preserves_trace(rng):
    cov = _damaged_covariance(rng)
    out = explained_variance_clip(cov, 0.95)
    np.testing.assert_allclose(np.trace(out), np.trace(cov), rtol=1e-8)
    eigs = np.linalg.eigvalsh(out)
    assert eigs.min() > 0
    # top eigenvalues preserved
    top_in = np.linalg.eigvalsh(cov)[-5:]
    top_out = np.linalg.eigvalsh(out)[-5:]
    np.testing.assert_allclose(top_in, top_out, rtol=1e-8)


def test_eigenvalue_clip_dispatch(rng):
    cov = _damaged_covariance(rng)
    out1 = eigenvalue_clip(cov, method="explained_variance")
    out2 = eigenvalue_clip(
        cov, method="Laloux_2000", num_time_pts=20
    )
    for out in (out1, out2):
        assert np.linalg.eigvalsh(out).min() > 0
    with pytest.raises(ValueError):
        eigenvalue_clip(cov, method="nope")


def test_laloux_preserves_variances(rng):
    # The clip is trace-preserving on the correlation matrix; after
    # rescaling back the per-element variances are approximate (the
    # resynthesised correlation diagonal is no longer exactly 1).
    cov = _damaged_covariance(rng)
    out = laloux_clip(cov, num_time_pts=20)
    np.testing.assert_allclose(np.trace(out), np.trace(cov), rtol=0.05)
    np.testing.assert_allclose(np.diag(out), np.diag(cov), rtol=0.25)


def test_explained_variance_bad_threshold_message(rng):
    # A covariance whose top EOFs hold almost everything: overly high
    # target triggers the corrected-threshold suggestion.
    n = 40
    w = np.concatenate([np.full(n - 1, -0.01), [10.0]])
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    cov = (q * w) @ q.T
    with pytest.raises(ValueError, match="A value below"):
        explained_variance_clip(cov, 1.0)


def test_simple_clipping(rng):
    cov = _damaged_covariance(rng)
    out, meta = simple_clipping(cov, threshold="auto")
    assert meta["smallest_eigv"] > 0
    eigs = np.linalg.eigvalsh(out)
    assert eigs.min() > 0
    # top of spectrum unchanged
    np.testing.assert_allclose(
        np.linalg.eigvalsh(cov)[-3:], eigs[-3:], rtol=1e-7
    )
    with pytest.raises(TypeError):
        simple_clipping(cov, threshold="bogus")


def test_perturb_deprecated(rng):
    cov = _damaged_covariance(rng)
    with pytest.warns(DeprecationWarning):
        out = perturb_cov_to_positive_definite(cov, threshold=1e-10)
    assert np.linalg.eigvalsh(out).min() >= 0
    # already-PSD input returned unchanged
    spd = np.eye(5)
    with pytest.warns(DeprecationWarning):
        out2 = perturb_cov_to_positive_definite(spd)
    np.testing.assert_array_equal(out2, spd)


def test_csum_up_to_val():
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    csum, i = csum_up_to_val(vals, 5.0, reverse=True)
    # reversed walk: 4, 7 -> exceeds after consuming 2 elements; vals[-2:]
    # is the exceeding tail
    assert csum == 7.0 and i == -2
    assert vals[i:].sum() == csum
    csum, i = csum_up_to_val(vals, 5.0, reverse=False)
    assert csum == 6.0 and i == 3
    with pytest.warns(UserWarning, match="not exceeded"):
        csum_up_to_val(vals, 100.0)
    with pytest.warns(UserWarning, match="empty"):
        csum_up_to_val(np.array([]), 1.0)


def test_csum_matches_reference_convention():
    # Reference idiom: vals = arange(n+1); consuming i elements reaches
    # (i-1)i/2, so targeting T(e)-1 returns i with expected == i - 1.
    for n, expected_i in [(10, 7), (25, 24), (15, 1)]:
        vals = np.arange(n + 1)
        target = expected_i * (expected_i + 1) / 2
        csum, i = csum_up_to_val(vals, target - 1, reverse=False)
        assert expected_i == i - 1
        assert target == csum


def test_explained_clip_reference_construction(rng):
    """The reference's own failing construction raises with the suggested
    corrected threshold, and the corrected threshold then works."""
    A = rng.random((5, 5))
    S = A @ A.T
    _, evecs = np.linalg.eigh(S)
    new_evals = np.array([-3.0, 2.0, 4.2, 5.5, 5.8])
    total = new_evals.sum()
    csum, i = csum_up_to_val(new_evals, 0.9 * total)
    assert csum > total
    valid_target = np.sum(new_evals[i + 1 :]) / total
    S_new = (evecs * new_evals) @ evecs.T
    with pytest.raises(ValueError, match=f"{valid_target:.2f}"):
        explained_variance_clip(S_new, 0.9)
    out = explained_variance_clip(S_new, valid_target * 0.99)
    assert out.shape == S.shape
    assert (np.linalg.eigvalsh(out) > 0).all()


def test_clean_small_and_symmetric():
    m = np.array([[1.0, 1e-7], [1e-7, 1.0]])
    out = clean_small(m, atol=1e-5)
    assert out[0, 1] == 0.0
    assert check_symmetric(out)
    assert not check_symmetric(np.array([[1.0, 2.0], [0.0, 1.0]]))


def test_lowrank_trace_exact_for_scaled_vectors(rng):
    """LowRankPSD.trace() must not assume orthonormal vectors: the
    laloux clip scales columns by sqrt(diag)."""
    import jax.numpy as jnp

    from glomargridding_jax.ops.covariance_tools import (
        LowRankPSD,
        laloux_clip_lowrank,
    )

    n, r = 80, 6
    Q, _ = np.linalg.qr(rng.normal(size=(n, r)))
    scale = rng.uniform(0.5, 2.0, n)
    psd = LowRankPSD(
        vectors=jnp.asarray(scale[:, None] * Q),
        gains=jnp.asarray(np.linspace(5.0, 1.0, r)),
        floor=jnp.asarray(rng.uniform(0.05, 0.3, n)),
    )
    assert np.isclose(psd.trace(), np.trace(psd.to_dense()), rtol=1e-10)

    # end-to-end: trace() is self-consistent with the densified matrix
    # (laloux preserves the CORRELATION trace exactly; the covariance
    # trace only approximately — same as the reference)
    T = 30
    X = rng.normal(size=(T, n)) * np.sqrt(scale)[None, :]
    cov = X.T @ X / (T - 1)
    lr = laloux_clip_lowrank(cov, num_time_pts=T, k0=16)
    assert np.isclose(lr.trace(), np.trace(lr.to_dense()), rtol=1e-6)
    assert np.isclose(lr.trace(), np.trace(cov), rtol=0.05)


def test_auto_spectrum_falls_back_on_flat_spectrum(rng, monkeypatch):
    """spectrum='auto' on a dense matrix whose spectrum is too flat for
    the low-rank path must fall back to the exact full clip instead of
    raising (0.1.0 behaviour)."""
    import glomargridding_jax.ops.covariance_tools as ct

    # drop the auto threshold so n=300 genuinely takes the PARTIAL
    # path first (the branch under test), then falls back
    monkeypatch.setattr(ct, "_AUTO_PARTIAL_THRESHOLD", 100)
    n = 300
    cov = np.eye(n) + 1e-3 * np.ones((n, n))  # near-flat spectrum
    out = ct.explained_variance_clip(
        cov, target_variance_fraction=0.99, spectrum="auto",
        k0=8, max_rank=16,  # forces the partial path to give up
    )
    assert np.isclose(np.trace(out), np.trace(cov), rtol=1e-8)
    # explicit "partial" must still raise the typed non-convergence
    import pytest as _pytest

    with _pytest.raises(ct.PartialSpectrumError, match="max_rank"):
        ct.explained_variance_clip(
            cov, target_variance_fraction=0.99, spectrum="partial",
            k0=8, max_rank=16,
        )
    # an unrelated argument error must NOT be swallowed by the fallback
    with _pytest.raises(ValueError, match="k must be >= 1"):
        ct.explained_variance_clip(
            cov, target_variance_fraction=0.99, spectrum="auto", k0=0
        )


def test_lowrank_clip_full_rank_no_division_error(rng):
    """target_variance_fraction=1.0 retaining every eigenvalue must
    return the exact factorisation, not divide by (n - n)."""
    import jax.numpy as jnp

    from glomargridding_jax.ops.covariance_tools import (
        explained_variance_clip_lowrank,
    )

    n = 24
    B = rng.normal(size=(n, n))
    cov = (B @ B.T / n + np.eye(n)).astype(np.float64)
    psd = explained_variance_clip_lowrank(
        jnp.asarray(cov), target_variance_fraction=1.0, k0=n
    )
    np.testing.assert_allclose(psd.to_dense(), cov, rtol=1e-8, atol=1e-10)
