"""glomargridding_jax — a JAX kriging framework.

A JAX/XLA re-design of the GloMarGridding capability surface
(see SURVEY.md / ARCHITECTURE.md): spatial interpolation of sparse climate
observations to complete gridded fields via Gaussian-process regression,
with stationary (variogram) and non-stationary (Paciorek-Schervish ellipse)
covariance models, observation-error covariance assembly, PSD repair, and
stochastic ensemble generation.

Curated top-level API (parity: reference ``__init__.py:21-45``). The
names are imported on first access (PEP 562), so importing a submodule
on the device path does not pull in the pandas-based grid and
error-covariance helpers.
"""

import importlib

_EXPORTS = {
    "assign_to_grid": ".grid.grid",
    "cross_coords": ".grid.grid",
    "grid_from_resolution": ".grid.grid",
    "grid_to_distance_matrix": ".grid.grid",
    "map_to_grid": ".grid.grid",
    "correlated_components": ".ops.error_covariance",
    "dist_weight": ".ops.error_covariance",
    "get_weights": ".ops.error_covariance",
    "gridbox_error_covariance": ".ops.error_covariance",
    "uncorrelated_components": ".ops.error_covariance",
    "ExponentialVariogram": ".ops.variogram",
    "GaussianVariogram": ".ops.variogram",
    "MaternVariogram": ".ops.variogram",
    "SphericalVariogram": ".ops.variogram",
    "variogram_to_covariance": ".ops.variogram",
}

__all__ = sorted(_EXPORTS)

__version__ = "0.5.0"


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
