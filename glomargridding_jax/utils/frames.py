"""DataFrame helpers (pandas-backed) and unit conversions.

The reference builds its data-prep layer on polars; this environment ships
pandas, so the observation-frame API here is pandas-first. Functions accept
any object with a pandas-like interface (``.columns``, boolean-mask
``__getitem__``).
"""

from itertools import islice
from typing import TYPE_CHECKING, Any, Iterable

from ..constants import KM_TO_NM, NM_PER_LAT

if TYPE_CHECKING:  # pandas is imported only by filter_bounds
    import pandas as pd


class ColumnNotFoundError(Exception):
    """A required DataFrame column is missing."""


def check_cols(df, cols: list[str]) -> None:
    """Raise ColumnNotFoundError listing any of `cols` missing from `df`."""
    missing = [c for c in cols if c not in df.columns]
    if missing:
        raise ColumnNotFoundError(
            "DataFrame is missing required columns: " + ", ".join(missing)
        )


def filter_bounds(
    df: "pd.DataFrame",
    bounds: list[tuple[float, float]],
    bound_cols: list[str],
    closed: str | list[str] = "left",
) -> "pd.DataFrame":
    """Filter a DataFrame to rows within per-column (lower, upper) bounds.

    `closed` is one of "both", "left", "right", "none" (scalar or per-bound
    list), with the same interval semantics as the reference
    (``utils.py:314-364``).
    """
    if len(bounds) != len(bound_cols):
        raise ValueError("Length of 'bounds' must equal length of 'bound_cols'")
    if not isinstance(closed, list):
        closed = [closed] * len(bounds)
    if len(closed) != len(bounds):
        raise ValueError(
            "Length of 'closed' must equal length of 'bounds', "
            "or be a single value."
        )
    import pandas as pd

    check_cols(df, bound_cols)
    mask = pd.Series(True, index=df.index)
    for (lo, hi), col, cl in zip(bounds, bound_cols, closed):
        s = df[col]
        if cl == "both":
            mask &= (s >= lo) & (s <= hi)
        elif cl == "left":
            mask &= (s >= lo) & (s < hi)
        elif cl == "right":
            mask &= (s > lo) & (s <= hi)
        elif cl == "none":
            mask &= (s > lo) & (s < hi)
        else:
            raise ValueError(f"Unknown closed value: {cl}")
    return df[mask]


def batched(iterable: Iterable, n: int, *, strict: bool = False):
    """itertools.batched backport (parity: reference ``utils.py:697-712``)."""
    if n < 1:
        raise ValueError("'n' must be >= 1")
    iterator = iter(iterable)
    while batch := tuple(islice(iterator, n)):
        if strict and len(batch) != n:
            raise ValueError("batched(): incomplete batch")
        yield batch


def deg_to_nm(deg: float) -> float:
    """Degrees latitude -> nautical miles."""
    return NM_PER_LAT * deg


def deg_to_km(deg: float) -> float:
    """Degrees latitude -> kilometres."""
    return KM_TO_NM * deg_to_nm(deg)


def km_to_deg(km: float) -> float:
    """Meridional kilometres -> degrees latitude."""
    return (km / KM_TO_NM) / NM_PER_LAT


def get_recurse(config: dict, *keys, default: Any = None) -> Any:
    """Recursively get nested dict keys: config[k0][k1]...[kn].

    Returns `default` if any key along the path is absent or not a dict.
    (Parity: reference ``io.py:103-145``.)
    """
    if len(keys) == 1:
        return config.get(keys[0], default)
    new_config = config.get(keys[0])
    if new_config is None or not isinstance(new_config, dict):
        return default
    return get_recurse(new_config, *keys[1:], default=default)
