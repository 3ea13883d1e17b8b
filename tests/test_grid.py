"""Grid construction / mapping tests."""

import numpy as np
import pandas as pd
import pytest

from glomargridding_jax.grid import (
    assign_to_grid,
    cross_coords,
    grid_from_resolution,
    grid_to_distance_matrix,
    map_to_grid,
)


def test_grid_from_resolution_shape():
    grid = grid_from_resolution(
        5, [(-87.5, 90), (-177.5, 180)], ["lat", "lon"]
    )
    assert grid.shape == (36, 72)
    np.testing.assert_allclose(grid.coords["lat"][0], -87.5)
    np.testing.assert_allclose(grid.coords["lat"][-1], 87.5)
    np.testing.assert_allclose(grid.coords["lon"][-1], 177.5)


def test_grid_from_resolution_mixed_res():
    grid = grid_from_resolution(
        [5, 10], [(-87.5, 90), (-175.0, 180)], ["lat", "lon"]
    )
    assert grid.shape == (36, 36)
    with pytest.raises(ValueError):
        grid_from_resolution([5], [(-87.5, 90), (-175, 180)], ["lat", "lon"])


def test_map_to_grid_row_major_idx():
    grid = grid_from_resolution(1, [(1, 21), (1, 21)], ["lat", "lon"])
    obs = pd.DataFrame(
        {
            "lat": [5.0, 15.0, 10.0],
            "lon": [5.0, 10.0, 15.0],
            "val": [1.0, 0.0, 1.0],
        }
    )
    mapped = map_to_grid(obs, grid, grid_coords=["lat", "lon"])
    # C-order: idx = (lat_i * 20 + lon_i) with coords starting at 1
    expected = sorted([(5 - 1) * 20 + (5 - 1), (15 - 1) * 20 + (10 - 1),
                       (10 - 1) * 20 + (15 - 1)])
    assert list(mapped["grid_idx"]) == expected
    assert "grid_lat" in mapped.columns and "grid_lon" in mapped.columns


def test_map_to_grid_bounds_filter():
    grid = grid_from_resolution(1, [(1, 21), (1, 21)], ["lat", "lon"])
    obs = pd.DataFrame(
        {"lat": [5.0, 50.0], "lon": [5.0, 5.0], "val": [1.0, 2.0]}
    )
    mapped = map_to_grid(
        obs, grid, grid_coords=["lat", "lon"], bounds=[(0, 25), (0, 25)]
    )
    assert len(mapped) == 1


def test_assign_to_grid_roundtrip():
    grid = grid_from_resolution(1, [(1, 21), (1, 21)], ["lat", "lon"])
    idx = np.array([0, 25, 399])
    vals = np.array([1.0, 2.0, 3.0])
    out = assign_to_grid(vals, idx, grid)
    assert out.shape == (20, 20)
    assert out.values[0, 0] == 1.0
    assert out.values[1, 5] == 2.0
    assert out.values[19, 19] == 3.0
    assert np.isnan(out.values[0, 1])


def test_cross_coords():
    grid = grid_from_resolution(1, [(0, 2), (4, 6)], ["lat", "lon"])
    crossed = cross_coords(grid.coords, "lat", "lon")
    np.testing.assert_array_equal(crossed["lat_1"], [0, 0, 1, 1])
    np.testing.assert_array_equal(crossed["lon_1"], [4, 5, 4, 5])
    np.testing.assert_array_equal(crossed["index_1"], np.arange(4))


def test_grid_to_distance_matrix():
    grid = grid_from_resolution(
        5, [(-87.5, 90), (-177.5, 180)], ["lat", "lon"]
    )
    dist = grid_to_distance_matrix(grid)
    assert dist.shape == (2592, 2592)
    np.testing.assert_allclose(np.diag(dist.values), 0.0, atol=1e-6)
    # First off-diagonal neighbour at -87.5 latitude, 5 deg longitude apart
    assert abs(dist.values[0, 1] - 24.24359308) < 1e-4
    assert np.allclose(dist.values, dist.values.T, atol=1e-8)


def test_distance_matrix_carries_crossed_coords():
    """Parity pin for the documented deviation from the reference: the
    crossed per-axis coordinates (reference grid.py:233-320 returns them
    as non-dim xarray coordinates) ride in attrs['crossed_coords'] with
    identical content."""
    from glomargridding_jax.grid import (
        cross_coords,
        grid_from_resolution,
        grid_to_distance_matrix,
    )

    grid = grid_from_resolution(
        30, [(-75, 90), (-165, 180)], ["lat", "lon"]
    )
    arr = grid_to_distance_matrix(grid, lat_coord="lat", lon_coord="lon")
    crossed = arr.attrs["crossed_coords"]
    expect = cross_coords(grid.coords, "lat", "lon")
    for k in ("lat_1", "lon_1", "lat_2", "lon_2"):
        np.testing.assert_array_equal(crossed[k], np.asarray(expect[k]))
    n = len(grid.coords["lat"]) * len(grid.coords["lon"])
    assert arr.values.shape == (n, n)
    assert np.allclose(np.diag(arr.values), 0.0)
