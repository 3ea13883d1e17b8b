"""Host-side utilities (arrays, calendars, frames, logging).

Names are imported on first access (PEP 562): the calendar and frame
helpers need pandas, and the device path imports ``utils`` submodules
without it.
"""

import importlib

_EXPORTS = {
    "adjust_small_negative": ".arrays",
    "cor_2_cov": ".arrays",
    "cov_2_cor": ".arrays",
    "find_nearest": ".arrays",
    "get_spatial_mean": ".arrays",
    "intersect_mtlb": ".arrays",
    "is_iter": ".arrays",
    "mask_array": ".arrays",
    "sizeof_fmt": ".arrays",
    "uncompress_masked": ".arrays",
    "MonthName": ".calendar",
    "days_since_by_month": ".calendar",
    "get_date_index": ".calendar",
    "get_month_midpoint": ".calendar",
    "get_pentad_range": ".calendar",
    "ColumnNotFoundError": ".frames",
    "batched": ".frames",
    "check_cols": ".frames",
    "deg_to_km": ".frames",
    "deg_to_nm": ".frames",
    "filter_bounds": ".frames",
    "km_to_deg": ".frames",
    "init_logging": ".logging",
    "hbm_budget_check": ".profiling",
    "hbm_estimate": ".profiling",
    "stage_timer": ".profiling",
    "select_bounds": "..core.labeled",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
