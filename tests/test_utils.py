"""Utility-layer tests (parity with the reference's test_utils idioms)."""

import numpy as np
import pandas as pd
import pytest

from glomargridding_jax.utils import (
    adjust_small_negative,
    batched,
    cor_2_cov,
    cov_2_cor,
    days_since_by_month,
    filter_bounds,
    find_nearest,
    get_date_index,
    get_month_midpoint,
    get_pentad_range,
    get_spatial_mean,
    intersect_mtlb,
    sizeof_fmt,
    uncompress_masked,
)
from glomargridding_jax.utils.frames import get_recurse


def test_find_nearest():
    array = np.array([1.0, 2.5, 2.7, 2.1, 4.5])
    tests = np.array([1.1, 4.4, 2.2])
    idx, vals = find_nearest(array, tests)
    assert list(idx) == [0, 4, 3]
    np.testing.assert_allclose(vals, [1.0, 4.5, 2.1])


def test_find_nearest_regular_grid():
    grid = np.arange(-87.5, 90, 5.0)
    obs = np.array([-90.0, -87.6, 0.1, 33.0, 89.9])
    idx, vals = find_nearest(grid, obs)
    # brute-force oracle
    for o, i in zip(obs, idx):
        assert i == int(np.argmin(np.abs(grid - o)))


def test_intersect_mtlb():
    a = np.array([1, 2, 3])
    b = np.array([1, 1, 2, 5, 6])
    c, ia, ib = intersect_mtlb(a, b)
    np.testing.assert_array_equal(c, [1, 2])
    np.testing.assert_array_equal(ia, [0, 1])
    np.testing.assert_array_equal(ib, [0, 2])


def test_adjust_small_negative_warns():
    arr = np.array([1.0, -1e-10, 2.0])
    with pytest.warns(UserWarning, match="Small negative"):
        out = adjust_small_negative(arr)
    np.testing.assert_array_equal(out, [1.0, 0.0, 2.0])


def test_adjust_small_negative_large_negative_warns():
    arr = np.array([1.0, -0.5])
    with pytest.warns(UserWarning, match="Negative values"):
        out = adjust_small_negative(arr)
    assert out[1] == -0.5


def test_uncompress_masked_roundtrip(rng):
    arr = rng.random(16)
    mask = arr > 0.65
    compressed = arr[~mask]
    out = uncompress_masked(compressed, mask, fill_value=-999.0)
    assert (out[mask] == -999.0).all()
    np.testing.assert_array_equal(out[~mask], compressed)
    ma = uncompress_masked(compressed, mask, apply_mask=True)
    assert isinstance(ma, np.ma.MaskedArray)


def test_cov_cor_roundtrip(rng):
    A = rng.random((6, 6))
    cov = A @ A.T
    cor = cov_2_cor(cov)
    np.testing.assert_allclose(np.diag(cor), 1.0)
    cov2 = cor_2_cov(cor, np.diag(cov))
    np.testing.assert_allclose(cov, cov2, rtol=1e-12)


def test_cov_2_cor_bad_diagonal_raises():
    cov = np.array([[1.0, 0.5], [0.6, 1.0]])  # asymmetric -> fine
    # force a broken diagonal by passing a non-cov matrix
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    bad_cov = bad.copy()
    bad_cov[0, 0] = -1.0
    with pytest.raises((ValueError, FloatingPointError)):
        with np.errstate(invalid="raise"):
            cov_2_cor(bad_cov)
    del cov


def test_get_spatial_mean_identity(rng):
    obs = rng.random(10)
    cov = np.eye(10)
    assert np.isclose(get_spatial_mean(obs, cov), obs.mean())


def test_calendar_helpers():
    np.testing.assert_array_equal(
        days_since_by_month(1988, 14),
        [0, 31, 60, 91, 121, 152, 182, 213, 244, 274, 305, 335],
    )
    assert get_date_index(2009, 14, start_year=1988) == 265
    from datetime import date

    assert get_pentad_range(date(2008, 2, 29)) == (
        date(2008, 2, 27),
        date(2008, 3, 2),
    )
    # leap year, not 29 Feb: pentad must skip the leap day
    start, end = get_pentad_range(date(2008, 3, 1))
    assert (start, end) == (date(2008, 2, 27), date(2008, 3, 3))
    mid = get_month_midpoint(pd.Series(pd.to_datetime(["1990-01-01"])))
    assert mid.iloc[0] == pd.Timestamp("1990-01-16 12:00:00")


def test_batched():
    assert list(batched("ABCDEFG", 3)) == [
        ("A", "B", "C"),
        ("D", "E", "F"),
        ("G",),
    ]
    with pytest.raises(ValueError):
        list(batched("ABC", 0))


def test_filter_bounds():
    df = pd.DataFrame({"lat": [0.0, 10.0, 20.0], "lon": [5.0, 15.0, 25.0]})
    out = filter_bounds(df, [(0, 20), (0, 20)], ["lat", "lon"])
    assert len(out) == 2  # left-closed: 20 excluded
    out = filter_bounds(
        df, [(0, 20), (0, 25)], ["lat", "lon"], closed="both"
    )
    assert len(out) == 3


def test_get_recurse():
    cfg = {"a": {"b": {"c": 1}}}
    assert get_recurse(cfg, "a", "b", "c") == 1
    assert get_recurse(cfg, "a", "x", "c", default=-1) == -1
    assert get_recurse(cfg, "a") == {"b": {"c": 1}}


def test_sizeof_fmt():
    assert sizeof_fmt(123456789) == "117.7MiB"


def test_bounded_cache_lru():
    """BoundedCache: setdefault/get refresh recency; eviction drops the
    least-recently-used entry at maxsize."""
    from glomargridding_jax.utils.cache import BoundedCache

    c = BoundedCache(2)
    assert c.setdefault("a", 1) == 1
    assert c.setdefault("b", 2) == 2
    assert c.setdefault("a", 99) == 1  # hit refreshes, keeps value
    c["c"] = 3  # evicts "b" (least recent), not "a"
    assert "b" not in c
    assert c.get("a") == 1 and c.get("c") == 3
    assert c.get("missing", "dflt") == "dflt"
    assert len(c) == 2
    c.clear()
    assert len(c) == 0
