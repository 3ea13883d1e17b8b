"""Observation-error covariance assembly.

Capability parity with reference ``error_covariance.py``: uncorrelated
(diagonal) and correlated (group-block) components from group sigma
assignments, within-gridbox distance matrices, and gridbox-averaging weight
matrices. The host side is pandas-based (observation frames are inherently
ragged/host data); the produced matrices are dense arrays ready to ship to
the device, and ``weights_matmul``/gridbox reductions are plain matmuls
downstream.
"""

from typing import Callable
from warnings import warn

import numpy as np
import pandas as pd

from ..utils.frames import check_cols


def uncorrelated_components(
    df: pd.DataFrame,
    group_col: str = "data_type",
    obs_sig_col: str | None = None,
    obs_sig_map: dict[str, float] | None = None,
) -> np.ndarray:
    """Diagonal (uncorrelated) error-covariance component.

    If `obs_sig_col` exists in the frame its values form the diagonal
    directly; otherwise the `group_col` values are mapped through
    `obs_sig_map` (sigma -> sigma^2, default 0 with warnings), matching
    reference ``error_covariance.py:42-96``.
    """
    from ..utils.frames import ColumnNotFoundError

    if obs_sig_col is not None and obs_sig_col in df.columns:
        return np.diag(np.asarray(df[obs_sig_col], dtype=float))
    elif obs_sig_col is not None:
        raise ColumnNotFoundError(
            f"Observation Bias Column {obs_sig_col} not found."
        )

    obs_sig_map = obs_sig_map or {}
    sq_map = {k: v**2 for k, v in obs_sig_map.items()}
    s = (
        df[group_col]
        .map(lambda g: sq_map.get(g, 0.0))
        .to_numpy(dtype=float)
    )
    if (s == 0.0).all():
        warn("No values in obs_covariance set")
    elif (s == 0.0).any():
        warn("Some values in obs_covariance not set")
    return np.diag(s)


def correlated_components(
    df: pd.DataFrame,
    group_col: str,
    bias_sig_col: str | None = None,
    bias_sig_map: dict[str, float] | None = None,
) -> np.ndarray:
    """Correlated (bias) error-covariance component.

    Produces a matrix that is block-diagonal under permutation by the group:
    entry (i, j) is the group's squared bias sigma when rows i and j share a
    group, else 0. Values come from `bias_sig_col` if present (first value
    per group, used as-is) or from `bias_sig_map` (sigma -> sigma^2),
    matching reference ``error_covariance.py:99-186``.
    """
    check_cols(df, [group_col])
    n = len(df)
    groups = df[group_col].to_numpy()

    if bias_sig_col is not None and bias_sig_col in df.columns:
        bias_vals = df[bias_sig_col].to_numpy(dtype=float)
        # first value per group
        first_per_group: dict = {}
        for g, b in zip(groups, bias_vals):
            first_per_group.setdefault(g, b)
        per_row = np.array([first_per_group[g] for g in groups], dtype=float)
    else:
        bias_sig_map = bias_sig_map or {}
        sq_map = {k: v**2 for k, v in bias_sig_map.items()}
        per_row = np.array(
            [sq_map.get(g, 0.0) for g in groups], dtype=float
        )
        if (per_row == 0.0).all():
            warn("No bias uncertainty values set")
        elif (per_row == 0.0).any():
            warn("Some bias uncertainty values not set")

    # One-hot group membership; the outer same-group test is vectorised.
    codes = pd.factorize(pd.Series(groups))[0]
    same_group = codes[:, None] == codes[None, :]
    covx = np.where(same_group, per_row[:, None], 0.0)
    assert covx.shape == (n, n)
    return covx


def dist_weight(
    df: pd.DataFrame,
    dist_fn: Callable,
    grid_idx: str = "grid_idx",
    **dist_kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """Within-gridbox distance matrix + gridbox-averaging weight matrix.

    `dist_fn(sub_frame, **kwargs)` produces the distance matrix for the
    records of a single gridbox; blocks are scattered into the full
    n_obs x n_obs matrix. `weights` is n_gridboxes x n_obs with rows equal
    to 1/count over the gridbox's records (rows ordered by sorted gridbox
    value). Parity: reference ``error_covariance.py:189-276``.
    """
    gridboxes = sorted(df[grid_idx].unique())
    n_obs = len(df)
    weights = np.zeros((len(gridboxes), n_obs))
    dist = np.zeros((n_obs, n_obs))

    positions = np.arange(n_obs)
    df = df.reset_index(drop=True)
    for i, gb in enumerate(gridboxes):
        sel = df[grid_idx].to_numpy() == gb
        idcs = positions[sel]
        weights[i, idcs] = 1.0 / len(idcs)
        if dist_fn is not None:
            sub = df.loc[sel]
            dist[np.ix_(idcs, idcs)] = dist_fn(sub, **dist_kwargs)

    return dist, weights


def get_weights(
    df: pd.DataFrame,
    grid_idx: str = "grid_idx",
) -> np.ndarray:
    """Gridbox-averaging weight matrix only (rows: sorted gridbox order).

    Parity: reference ``error_covariance.py:279-321``.
    """
    n_obs = len(df)
    codes, uniques = pd.factorize(df[grid_idx], sort=True)
    counts = np.bincount(codes)
    weights = np.zeros((len(uniques), n_obs))
    weights[codes, np.arange(n_obs)] = 1.0 / counts[codes]
    return weights


def gridbox_error_covariance(weights, obs_error_cov):
    """Reduce a per-record error covariance to gridbox level: W E W'.

    `weights` is the (n_gridboxes x n_obs) averaging matrix from
    ``get_weights``/``dist_weight``; `obs_error_cov` the per-record error
    covariance (uncorrelated + correlated + distance components summed).
    The reference leaves this reduction to user workflows (SURVEY.md
    §3.4); here it is one fused device matmul chain.
    """
    import jax.numpy as jnp

    W = jnp.asarray(weights)
    E = jnp.asarray(obs_error_cov, W.dtype)
    return np.asarray(W @ E @ W.T)
