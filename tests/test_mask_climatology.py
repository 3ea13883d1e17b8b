"""Mask + climatology tests."""

import numpy as np
import pandas as pd
import pytest

from glomargridding_jax.core.labeled import Coordinates, DataArray, Dataset
from glomargridding_jax.grid import grid_from_resolution
from glomargridding_jax.grid.climatology import join_climatology_by_doy
from glomargridding_jax.grid.mask import (
    get_mask_idx,
    mask_array,
    mask_dataset,
    mask_from_obs_array,
    mask_from_obs_frame,
    mask_observations,
)


def _mask_grid():
    coords = Coordinates(
        {"latitude": np.array([0.0, 1.0]), "longitude": np.array([0.0, 1.0])}
    )
    vals = np.array([[True, False], [False, True]])
    return DataArray(vals, coords, name="mask")


def test_mask_observations():
    mask = _mask_grid()
    obs = pd.DataFrame(
        {
            "lat": [0.0, 0.0, 1.0, 1.0],
            "lon": [0.0, 1.0, 0.0, 1.0],
            "sst": [10.0, 11.0, 12.0, 13.0],
        }
    )
    out = mask_observations(obs, mask, "sst")
    assert np.isnan(out["sst"].iloc[0])
    assert out["sst"].iloc[1] == 11.0
    assert np.isnan(out["sst"].iloc[3])

    dropped = mask_observations(obs, mask, "sst", drop=True)
    assert len(dropped) == 2


def test_mask_array_and_dataset():
    mask = _mask_grid()
    grid = DataArray(
        np.arange(4.0).reshape(2, 2),
        Coordinates(
            {
                "latitude": np.array([0.0, 1.0]),
                "longitude": np.array([0.0, 1.0]),
            }
        ),
    )
    out = mask_array(grid.copy(), mask)
    assert np.isnan(out.values[0, 0]) and np.isnan(out.values[1, 1])
    assert out.values[0, 1] == 1.0

    ds = Dataset({"sst": grid.copy()}, grid.coords)
    out_ds = mask_dataset(ds, mask, "sst")
    assert np.isnan(out_ds["sst"].values[0, 0])

    with pytest.raises(TypeError):
        mask_array(np.zeros((2, 2)), mask)
    # misaligned coords raise
    bad = DataArray(
        np.zeros((2, 2)),
        Coordinates(
            {
                "latitude": np.array([5.0, 6.0]),
                "longitude": np.array([0.0, 1.0]),
            }
        ),
    )
    with pytest.raises(ValueError):
        mask_array(bad, mask)


def test_mask_from_obs_array():
    data = np.random.rand(3, 2, 2)
    data[:, 0, 0] = np.nan
    data[0, 1, 1] = np.nan  # only sometimes NaN -> not masked
    mask = mask_from_obs_array(data, 0)
    assert mask[0, 0] and not mask[1, 1]


def test_mask_from_obs_frame_with_grid():
    grid = grid_from_resolution(1, [(0, 2), (0, 2)], ["lat", "lon"])
    obs = pd.DataFrame(
        {
            "lat": [0.0, 1.0],
            "lon": [0.0, 0.0],
            "sst": [1.0, 2.0],
            "datetime": [1, 1],
        }
    )
    out = mask_from_obs_frame(
        obs, ["lat", "lon"], "sst", "datetime", grid, ["lat", "lon"]
    )
    assert len(out) == 4
    lookup = {
        (r["lat"], r["lon"]): r["mask"] for _, r in out.iterrows()
    }
    assert not lookup[(0.0, 0.0)]
    assert lookup[(0.0, 1.0)]
    assert lookup[(1.0, 1.0)]


def test_get_mask_idx():
    mask = _mask_grid()
    idx = get_mask_idx(mask, mask_val=True)
    np.testing.assert_array_equal(idx.flatten(), [0, 3])
    idx_un = get_mask_idx(mask, mask_val=True, masked=False)
    np.testing.assert_array_equal(idx_un.flatten(), [1, 2])


def _climatology():
    coords = Coordinates(
        {
            "doy": np.arange(1, 366),
            "latitude": np.array([0.0, 10.0]),
            "longitude": np.array([0.0, 10.0]),
        }
    )
    # climatology value = doy + lat/100 (in Kelvin)
    doy, lat, lon = np.meshgrid(
        np.arange(1, 366),
        np.array([0.0, 10.0]),
        np.array([0.0, 10.0]),
        indexing="ij",
    )
    vals = 273.15 + doy + lat / 100.0
    arr = DataArray(vals, coords, name="climatology")
    return Dataset({"climatology": arr}, coords)


def test_join_climatology_by_doy():
    clim = _climatology()
    obs = pd.DataFrame(
        {
            "lat": [0.0, 9.0],
            "lon": [0.0, 9.0],
            "date": pd.to_datetime(["2001-01-05", "2001-03-01"]),
            "sst": [7.0, 62.0],
        }
    )
    out = join_climatology_by_doy(obs, clim)
    # DOY 5 at lat 0 -> 5.0 deg C
    assert out["sst_climatology"].iloc[0] == pytest.approx(5.0)
    assert out["sst_anomaly"].iloc[0] == pytest.approx(2.0)
    # 2001-03-01 is DOY 60 (non-leap) at lat 10 -> 60.1
    assert out["sst_climatology"].iloc[1] == pytest.approx(60.1)


def test_join_climatology_leap_day():
    clim = _climatology()
    obs = pd.DataFrame(
        {
            "lat": [0.0],
            "lon": [0.0],
            "date": pd.to_datetime(["2008-02-29"]),
            "sst": [100.0],
        }
    )
    out = join_climatology_by_doy(obs, clim)
    # mean of DOY 59 and 60 at lat 0 -> 59.5
    assert out["sst_climatology"].iloc[0] == pytest.approx(59.5)
    # and a non-leap-day obs in a leap year: 2008-03-01 is DOY 61 in the
    # leap calendar but must map to the 365-day DOY 60
    obs2 = pd.DataFrame(
        {
            "lat": [0.0],
            "lon": [0.0],
            "date": pd.to_datetime(["2008-03-01"]),
            "sst": [1.0],
        }
    )
    out2 = join_climatology_by_doy(obs2, clim)
    assert out2["sst_climatology"].iloc[0] == pytest.approx(60.0)
