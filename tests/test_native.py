"""Native binning kernels vs numpy fallback / pandas groupby."""

import numpy as np
import pandas as pd
import pytest

import glomargridding_jax.native.gridbin as gb
from glomargridding_jax.grid import grid_from_resolution, map_to_grid
from glomargridding_jax.grid.grid import aggregate_observations
from glomargridding_jax.native import bin_mean, snap_to_grid


def test_snap_to_grid_matches_map_to_grid(rng):
    grid = grid_from_resolution(
        5, [(-87.5, 90), (-177.5, 180)], ["lat", "lon"]
    )
    lats = rng.uniform(-86, 86, 500)
    lons = rng.uniform(-176, 176, 500)
    idx = snap_to_grid(lats, lons, -87.5, 5.0, 36, -177.5, 5.0, 72)
    obs = pd.DataFrame({"lat": lats, "lon": lons})
    mapped = map_to_grid(obs, grid, grid_coords=["lat", "lon"], sort=False)
    np.testing.assert_array_equal(idx, mapped["grid_idx"].to_numpy())


def test_snap_clamps_out_of_range():
    idx = snap_to_grid(
        np.array([-95.0, 95.0]),
        np.array([0.0, 0.0]),
        -87.5, 5.0, 36, -177.5, 5.0, 72,
    )
    rows = idx // 72
    assert rows[0] == 0 and rows[1] == 35


def test_bin_mean_matches_groupby(rng):
    n = 10_000
    idx = rng.integers(0, 100, n)
    vals = rng.normal(size=n)
    u, m, c = bin_mean(idx, vals, 100)
    ref = pd.DataFrame({"i": idx, "v": vals}).groupby("i")["v"].agg(
        ["mean", "count"]
    )
    np.testing.assert_array_equal(u, ref.index.to_numpy())
    np.testing.assert_allclose(m, ref["mean"].to_numpy())
    np.testing.assert_array_equal(c, ref["count"].to_numpy())


def test_native_and_fallback_agree(rng):
    lats = rng.uniform(-90, 90, 1000)
    lons = rng.uniform(-180, 180, 1000)
    vals = rng.normal(size=1000)
    idx_a = gb.snap_to_grid(lats, lons, -87.5, 5.0, 36, -177.5, 5.0, 72)
    have = gb._HAVE_NATIVE
    try:
        gb._HAVE_NATIVE = False
        idx_b = gb.snap_to_grid(
            lats, lons, -87.5, 5.0, 36, -177.5, 5.0, 72
        )
        ub, mb, cb = gb.bin_mean(idx_b, vals, 36 * 72)
    finally:
        gb._HAVE_NATIVE = have
    ua, ma, ca = gb.bin_mean(idx_a, vals, 36 * 72)
    np.testing.assert_array_equal(idx_a, idx_b)
    np.testing.assert_array_equal(ua, ub)
    np.testing.assert_allclose(ma, mb)
    np.testing.assert_array_equal(ca, cb)


def test_bin_mean_range_check(rng):
    with pytest.raises(ValueError, match="out of range"):
        bin_mean(np.array([5]), np.array([1.0]), 3)


def test_aggregate_observations(rng):
    grid = grid_from_resolution(
        5, [(-87.5, 90), (-177.5, 180)], ["lat", "lon"]
    )
    lats = rng.uniform(-86, 86, 2000)
    lons = rng.uniform(-176, 176, 2000)
    vals = rng.normal(size=2000)
    u, m, c = aggregate_observations(lats, lons, vals, grid)
    assert c.sum() == 2000
    # oracle through the frame path
    obs = pd.DataFrame({"lat": lats, "lon": lons, "v": vals})
    mapped = map_to_grid(obs, grid, grid_coords=["lat", "lon"])
    ref = mapped.groupby("grid_idx")["v"].mean()
    np.testing.assert_array_equal(u, ref.index.to_numpy())
    np.testing.assert_allclose(m, ref.to_numpy())

    # irregular grid raises
    from glomargridding_jax.core.labeled import Coordinates, DataArray

    irregular = DataArray(
        coords=Coordinates(
            {"lat": np.array([0.0, 1.0, 5.0]), "lon": np.array([0.0, 1.0])}
        )
    )
    with pytest.raises(ValueError, match="not regular"):
        aggregate_observations(lats, lons, vals, irregular)
