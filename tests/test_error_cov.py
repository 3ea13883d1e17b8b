"""Error-covariance assembly tests (reference test_error_cov idioms)."""

import numpy as np
import pandas as pd
import pytest

from glomargridding_jax.ops.error_covariance import (
    correlated_components,
    dist_weight,
    get_weights,
    uncorrelated_components,
)


@pytest.fixture
def obs_df():
    return pd.DataFrame(
        {
            "grid_idx": [0, 0, 1, 2, 2, 2],
            "data_type": ["ship", "buoy", "ship", "buoy", "buoy", "argo"],
            "val": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
            "lat": [0.0, 0.1, 5.0, 10.0, 10.1, 10.2],
            "lon": [0.0, 0.1, 5.0, 10.0, 10.1, 10.2],
        }
    )


def test_uncorrelated_from_map(obs_df):
    E = uncorrelated_components(
        obs_df, "data_type", obs_sig_map={"ship": 2.0, "buoy": 1.0, "argo": 0.5}
    )
    np.testing.assert_allclose(
        np.diag(E), [4.0, 1.0, 4.0, 1.0, 1.0, 0.25]
    )
    assert np.count_nonzero(E - np.diag(np.diag(E))) == 0


def test_uncorrelated_warns_on_missing(obs_df):
    with pytest.warns(UserWarning, match="Some values"):
        uncorrelated_components(obs_df, "data_type", obs_sig_map={"ship": 2.0})
    with pytest.warns(UserWarning, match="No values"):
        uncorrelated_components(obs_df, "data_type", obs_sig_map={})


def test_uncorrelated_from_column(obs_df):
    df = obs_df.assign(sig2=[1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    E = uncorrelated_components(df, obs_sig_col="sig2")
    np.testing.assert_allclose(np.diag(E), df["sig2"])


def test_correlated_block_structure(obs_df):
    E = correlated_components(
        obs_df, "data_type",
        bias_sig_map={"ship": 2.0, "buoy": 1.0, "argo": 3.0},
    )
    # ship rows: 0, 2
    assert E[0, 2] == 4.0 and E[2, 0] == 4.0 and E[0, 0] == 4.0
    # buoy rows: 1, 3, 4
    assert E[1, 3] == 1.0 and E[3, 4] == 1.0
    # cross-group zero
    assert E[0, 1] == 0.0 and E[5, 0] == 0.0
    assert E[5, 5] == 9.0
    # symmetric & permutation-block-diagonal
    np.testing.assert_array_equal(E, E.T)


def test_weights_rows_sum_to_one(obs_df):
    W = get_weights(obs_df)
    assert W.shape == (3, 6)
    np.testing.assert_allclose(W.sum(axis=1), 1.0)
    # Weighted average reproduces pandas groupby mean
    means = W @ obs_df["val"].to_numpy()
    ref = obs_df.groupby("grid_idx")["val"].mean().to_numpy()
    np.testing.assert_allclose(means, ref)


def test_dist_weight_blocks(obs_df):
    def dist_fn(sub):
        n = len(sub)
        return np.full((n, n), 7.0)

    dist, W = dist_weight(obs_df, dist_fn)
    np.testing.assert_allclose(W, get_weights(obs_df))
    # blocks: records of the same gridbox get 7, others 0
    assert dist[0, 1] == 7.0
    assert dist[3, 5] == 7.0
    assert dist[0, 2] == 0.0
    assert dist[2, 2] == 7.0


def test_gridbox_error_covariance(obs_df):
    from glomargridding_jax.ops.error_covariance import (
        gridbox_error_covariance,
    )

    E = uncorrelated_components(
        obs_df, "data_type",
        obs_sig_map={"ship": 2.0, "buoy": 1.0, "argo": 0.5},
    )
    E += correlated_components(
        obs_df, "data_type",
        bias_sig_map={"ship": 0.5, "buoy": 0.3, "argo": 0.2},
    )
    W = get_weights(obs_df)
    E_grid = gridbox_error_covariance(W, E)
    np.testing.assert_allclose(E_grid, W @ E @ W.T, rtol=1e-6)
    assert E_grid.shape == (3, 3)
    # SPD-ish: diagonal positive, symmetric
    assert (np.diag(E_grid) > 0).all()
    np.testing.assert_allclose(E_grid, E_grid.T, rtol=1e-6)
