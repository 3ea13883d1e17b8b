"""Edge-path coverage: io writer utilities, labeled containers, draws,
ellipse kernels vs scipy, config."""

import jax
import numpy as np
import pandas as pd
import pytest

from glomargridding_jax.core.labeled import (
    Coordinates,
    DataArray,
    Dataset,
    select_bounds,
)
from glomargridding_jax.io import save_dataset, add_empty_layers, open_dataset
from glomargridding_jax.models.stochastic import (
    mv_normal_draw,
    scipy_mv_normal_draw,
)
from glomargridding_jax.models.ellipse.model import (
    cov_ij_anisotropic,
    cov_ij_isotropic,
)


def test_add_empty_layers(tmp_path, rng):
    coords = Coordinates(
        {
            "time": np.arange(3),
            "lat": np.arange(4.0),
            "lon": np.arange(5.0),
        }
    )
    data = rng.random((3, 4, 5)).astype(np.float32)
    ds = Dataset({"sst": DataArray(data, coords, name="sst")}, coords)
    path = str(tmp_path / "layers.nc")
    save_dataset(ds, path)
    add_empty_layers(path, "sst", [0, 2], (4, 5))
    back = open_dataset(path)
    np.testing.assert_allclose(back["sst"].values[0], 0.0)
    np.testing.assert_allclose(back["sst"].values[1], data[1])
    np.testing.assert_allclose(back["sst"].values[2], 0.0)


def test_select_bounds_dataset():
    coords = Coordinates(
        {
            "lat": np.arange(-80.0, 90.0, 20.0),
            "lon": np.arange(0.0, 360.0, 40.0),
        }
    )
    arr = DataArray(
        np.arange(9.0 * 9.0).reshape(9, 9), coords, name="v"
    )
    ds = Dataset({"v": arr}, coords)
    out = select_bounds(ds, [(-40, 40), (80, 200)], ["lat", "lon"])
    assert out["v"].shape == (5, 4)
    np.testing.assert_array_equal(
        out["v"].coords["lat"], [-40, -20, 0, 20, 40]
    )


def test_dataarray_to_dataframe():
    coords = Coordinates({"a": [0, 1], "b": [10, 20, 30]})
    arr = DataArray(np.arange(6.0).reshape(2, 3), coords, name="x")
    df = arr.to_dataframe()
    assert list(df.columns) == ["a", "b", "x"]
    assert len(df) == 6
    # row-major order
    np.testing.assert_array_equal(df["x"], np.arange(6.0))


def test_scipy_mv_normal_draw_api(rng):
    A = rng.random((5, 5))
    cov = A @ A.T + np.eye(5)
    out = scipy_mv_normal_draw(np.zeros(5), cov, ndraws=5)
    assert out.shape == (5, 5)
    single = scipy_mv_normal_draw(np.zeros(5), cov)
    assert single.shape == (5,)
    with pytest.raises(ValueError, match="2D"):
        scipy_mv_normal_draw(np.zeros(5), np.zeros((5, 5, 5)))
    with pytest.raises(ValueError, match="square"):
        scipy_mv_normal_draw(np.zeros(5), np.zeros((5, 4)))


def test_mv_normal_draw_distribution(rng):
    A = rng.random((4, 4))
    cov = A @ A.T + 0.5 * np.eye(4)
    draws = np.asarray(
        mv_normal_draw(jax.random.key(0), np.zeros(4), cov, ndraws=40_000)
    )
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.15)


def test_mv_normal_draw_eigen_repair(rng):
    # indefinite input triggers the eigen-floor fallback (non-strict)
    A = rng.random((6, 6))
    cov = A @ A.T
    w, v = np.linalg.eigh(cov)
    w[0] = -0.01
    bad = (v * w) @ v.T
    out = np.asarray(
        mv_normal_draw(jax.random.key(1), np.zeros(6), bad, ndraws=3)
    )
    assert np.isfinite(out).all()
    with pytest.raises(ValueError, match="unexpectedly large"):
        mv_normal_draw(
            jax.random.key(1), np.zeros(6), bad, strict=True
        )


def test_cov_ij_kernels_vs_scipy(rng):
    from scipy.special import gamma as sgamma
    from scipy.special import kv as skv

    v = 1.5
    dx = rng.uniform(-2000, 2000, 30)
    dy = rng.uniform(-2000, 2000, 30)
    Lx, Ly, theta = 1500.0, 700.0, 0.4
    ours = np.asarray(
        cov_ij_anisotropic(v, 1.0, dx, dy, Lx, Ly, theta=theta)
    )
    # independent oracle
    R = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )
    S = R @ np.diag([Lx**2, Ly**2]) @ R.T
    Si = np.linalg.inv(S)
    tau = np.sqrt(
        dx * (Si[0, 0] * dx + Si[0, 1] * dy)
        + dy * (Si[1, 0] * dx + Si[1, 1] * dy)
    )
    inner = 2 * tau * np.sqrt(v)
    ref = inner**v * skv(v, inner) / (sgamma(v) * 2 ** (v - 1))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)

    d = rng.uniform(10, 5000, 30)
    ours_iso = np.asarray(cov_ij_isotropic(v, 1.0, d, R=1200.0))
    inner = 2 * (d / 1200.0) * np.sqrt(v)
    ref_iso = inner**v * skv(v, inner) / (sgamma(v) * 2 ** (v - 1))
    np.testing.assert_allclose(ours_iso, ref_iso, rtol=1e-6)


def test_weights_unsorted_gridboxes():
    from glomargridding_jax.ops.error_covariance import dist_weight, get_weights

    df = pd.DataFrame(
        {
            "grid_idx": [7, 2, 7, 5, 2, 2],
            "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
        }
    )
    W = get_weights(df)
    # rows ordered by sorted gridbox: 2, 5, 7
    np.testing.assert_allclose(W.sum(axis=1), 1.0)
    means = W @ df["v"].to_numpy()
    np.testing.assert_allclose(
        means, [13.0 / 3.0, 4.0, 2.0]
    )
    dist, W2 = dist_weight(df, lambda sub: np.eye(len(sub)))
    np.testing.assert_allclose(W, W2)
    assert dist[0, 2] == 0.0 and dist[0, 0] == 1.0


def test_config_default_dtype():
    import jax.numpy as jnp

    from glomargridding_jax.config import (
        default_dtype,
        default_dtype_ctx,
        set_default_dtype,
    )

    base = default_dtype()
    with default_dtype_ctx(jnp.float64):
        assert default_dtype() == jnp.float64
    assert default_dtype() == base
    set_default_dtype(jnp.float32)
    assert default_dtype() == jnp.dtype(jnp.float32)


def test_enable_compile_cache(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR unset, the cache goes to the fixed
    ``.jax_cache`` directory of the checkout (the path is part of the
    cache key, so it must not move between runs)."""
    import os

    import jax

    from glomargridding_jax import config

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        p = config.enable_compile_cache()
        assert p == config.CHECKOUT_CACHE_DIR
        root = os.path.dirname(os.path.dirname(config.__file__))
        assert p == os.path.join(root, ".jax_cache")
        assert os.path.isdir(p)
        assert jax.config.jax_compilation_cache_dir == p
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_enable_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting is left
    alone and the helper reports that directory."""
    import jax

    from glomargridding_jax import config

    want = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        assert config.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == "sentinel"
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_clip_rank_multiple_pads_shapes(rng):
    """rank_multiple pads the factor block with zero-gain columns;
    numerics are unchanged and effective_rank reports the true rank."""
    import jax
    import jax.numpy as jnp

    from glomargridding_jax.ops.covariance_tools import (
        explained_variance_clip_lowrank,
    )

    n = 256
    x = rng.uniform(0.0, 1.0, size=(n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    A = np.exp(-d2 / 0.02)
    A = 0.5 * (A + A.T)

    exact = explained_variance_clip_lowrank(
        jnp.asarray(A), target_variance_fraction=0.9,
        key=jax.random.key(0),
    )
    padded = explained_variance_clip_lowrank(
        jnp.asarray(A), target_variance_fraction=0.9,
        key=jax.random.key(0), rank_multiple=16,
    )
    assert padded.rank % 16 == 0
    assert padded.rank >= exact.rank
    assert padded.effective_rank == exact.rank
    X = rng.normal(size=(n, 4))
    np.testing.assert_allclose(
        np.asarray(padded.matvec(jnp.asarray(X))),
        np.asarray(exact.matvec(jnp.asarray(X))),
        rtol=1e-8,
        atol=1e-10,
    )
    np.testing.assert_allclose(padded.trace(), exact.trace(), rtol=1e-10)
