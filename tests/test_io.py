"""netCDF IO tests (h5py-backed reader/writer)."""

import numpy as np
import pytest

from glomargridding_jax.core.labeled import Coordinates, DataArray, Dataset
from glomargridding_jax.io import (
    load_array,
    load_covariance,
    load_dataset,
    open_dataset,
    save_covariance,
    save_dataset,
)

from conftest import (
    reference_data_path,
    requires_reference_data,
)


def test_save_load_roundtrip(tmp_path, rng):
    coords = Coordinates(
        {
            "lat": np.arange(-80.0, 90.0, 20.0),
            "lon": np.arange(0.0, 360.0, 40.0),
        }
    )
    data = rng.random(coords.shape)
    ds = Dataset(
        {"sst": DataArray(data, coords, name="sst", attrs={"units": "K"})},
        coords,
        attrs={"title": "test"},
    )
    path = str(tmp_path / "test.nc")
    save_dataset(ds, path)
    back = open_dataset(path)
    np.testing.assert_allclose(back["sst"].values, data)
    assert back["sst"].dims == ("lat", "lon")
    np.testing.assert_allclose(back.coords["lat"], coords["lat"])
    assert back["sst"].attrs["units"] == "K"


def test_format_string_paths(tmp_path):
    save_covariance(np.eye(3), str(tmp_path / "cov_03.nc"))
    out = load_covariance(str(tmp_path / "cov_{month:02d}.nc"), month=3)
    np.testing.assert_allclose(out, np.eye(3))
    with pytest.raises(FileNotFoundError):
        load_dataset(str(tmp_path / "missing_{month:02d}.nc"), month=4)
    with pytest.raises(FileNotFoundError):
        load_dataset(str(tmp_path / "nope.nc"))


def test_fill_value_exact_equality(tmp_path):
    """netCDF fill matching is EXACT equality — data merely near the
    fill (within the old np.isclose tolerance) must survive decoding."""
    import h5py

    path = str(tmp_path / "fill.nc")
    vals = np.array([-999.0, -998.995, 1.5, -999.0001], dtype=np.float64)
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=vals)
        d.attrs["_FillValue"] = np.float64(-999.0)
    out = open_dataset(path)["x"].values
    assert np.isnan(out[0])
    # |-998.995 + 999| = 5e-3 < rtol*999 ~ 1e-2: isclose would NaN it
    assert out[1] == -998.995
    assert out[2] == 1.5
    assert out[3] == -999.0001


def test_packed_int_valid_range_and_unsigned(tmp_path):
    """CF packed-domain decoding: _FillValue/valid_range are matched on
    the RAW ints before scale/offset; _Unsigned reinterprets storage."""
    import h5py

    path = str(tmp_path / "packed.nc")
    raw = np.array([-32768, -32767, 0, 20000, 32000], dtype=np.int16)
    with h5py.File(path, "w") as f:
        d = f.create_dataset("sst", data=raw)
        d.attrs["_FillValue"] = np.int16(-32768)
        d.attrs["valid_range"] = np.array([-32767, 30000], dtype=np.int16)
        d.attrs["scale_factor"] = np.float64(0.01)
        d.attrs["add_offset"] = np.float64(273.15)
        u = f.create_dataset("counts", data=np.array([-1, 5], dtype=np.int8))
        u.attrs["_Unsigned"] = b"true"
    ds = open_dataset(path)
    sst = ds["sst"].values
    assert np.isnan(sst[0])  # fill (exact, packed domain)
    np.testing.assert_allclose(sst[1], 273.15 - 327.67)
    np.testing.assert_allclose(sst[2], 273.15)
    np.testing.assert_allclose(sst[3], 273.15 + 200.0)
    assert np.isnan(sst[4])  # above valid_range max
    counts = ds["counts"].values
    assert counts.dtype == np.uint8
    assert counts[0] == 255 and counts[1] == 5


def test_nan_fill_value(tmp_path):
    import h5py

    path = str(tmp_path / "nanfill.nc")
    with h5py.File(path, "w") as f:
        d = f.create_dataset(
            "x", data=np.array([np.nan, 2.0], dtype=np.float32)
        )
        d.attrs["_FillValue"] = np.float32(np.nan)
        d.attrs["add_offset"] = np.float64(1.0)
    out = open_dataset(path)["x"].values
    assert np.isnan(out[0]) and out[1] == 3.0


@requires_reference_data
def test_read_reference_ellipse_params():
    ds = open_dataset(reference_data_path("Atlantic_Ocean_07.nc"))
    for var in ("lx", "ly", "theta", "standard_deviation", "qc_code"):
        assert var in ds
        assert ds[var].shape == (120, 120)
    assert ds["lx"].dims == ("latitude", "longitude")
    assert len(ds.coords["latitude"]) == 120


@requires_reference_data
def test_read_reference_covariance():
    ds = open_dataset(reference_data_path("cov_no_hfix.nc"))
    cov = ds["covariance"].values
    assert cov.shape[0] == cov.shape[1]
    assert np.isfinite(cov).all()


@requires_reference_data
def test_load_array_from_reference():
    arr = load_array(
        reference_data_path("Atlantic_Ocean_07.nc"), "standard_deviation"
    )
    assert arr.shape == (120, 120)


def test_lowrank_roundtrip(tmp_path, rng):
    """save_lowrank/load_lowrank: factored covariance persists exactly."""
    import jax.numpy as jnp

    from glomargridding_jax.io import load_lowrank, save_lowrank
    from glomargridding_jax.ops.covariance_tools import LowRankPSD

    n, r = 60, 5
    Q, _ = np.linalg.qr(rng.normal(size=(n, r)))
    psd = LowRankPSD(
        vectors=jnp.asarray(Q, jnp.float32),
        gains=jnp.asarray(np.linspace(4.0, 1.0, r), jnp.float32),
        floor=jnp.asarray(rng.uniform(0.05, 0.2, n), jnp.float32),
    )
    path = str(tmp_path / "psd_{month:02d}.nc")
    save_lowrank(psd, path, month=3)
    back = load_lowrank(path, month=3)
    np.testing.assert_array_equal(
        np.asarray(back.vectors), np.asarray(psd.vectors)
    )
    np.testing.assert_array_equal(
        np.asarray(back.gains), np.asarray(psd.gains)
    )
    np.testing.assert_array_equal(
        np.asarray(back.floor), np.asarray(psd.floor)
    )
    np.testing.assert_allclose(back.to_dense(), psd.to_dense())
