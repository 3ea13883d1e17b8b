"""ESA-CCI SST 5-degree monthly 1982-2022: kriging 41 Marches in one
compiled scan (BASELINE.md benchmark config #3).

Each March's ocean anomalies become that month's observations; monthly
obs sets are bucketed to one static size (huge-nugget padding) and the
whole 41-month sequence runs as a single ``lax.scan`` device program over
the streamed kernel-kriging core.

Run: python examples/esa_months_scan.py
"""

import os
import sys
import time

import numpy as np

try:  # prefer the installed package; fall back to a repo checkout
    import glomargridding_jax  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from glomargridding_jax.io import load_array
from glomargridding_jax.models.kernel_kriging import (
    months_scan_kriging,
    pad_month_observations,
    variogram_kernel,
)
from glomargridding_jax.ops.variogram import MaternVariogram

def _data_dir():
    """Vendored workflow data (examples/data), with the reference
    notebooks directory as a fallback for older checkouts."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (
        os.path.join(here, "data"),
        os.path.join(here, "examples", "data"),
        "/root/reference/notebooks",
    ):
        if os.path.isdir(cand) and any(
            f.endswith(".nc") for f in os.listdir(cand)
        ):
            return cand
    raise FileNotFoundError(
        "workflow data not found: expected .nc files in examples/data"
    )


DATA = _data_dir()
MONTH = 3


def main():
    from glomargridding_jax.config import enable_compile_cache

    enable_compile_cache()  # monthly reruns skip minutes of XLA compile
    esa = load_array(
        f"{DATA}/esa_cci_sst_5deg_monthly_1982-2022_{MONTH:02d}.nc",
        "sst_anomaly",
    )
    vals = np.asarray(esa.values, dtype=np.float32)  # (41, 36, 72)
    vals[vals > 1e5] = np.nan
    lat = np.asarray(esa.coords["lat"])
    lon = np.asarray(esa.coords["lon"])
    glat = np.repeat(lat, len(lon))
    glon = np.tile(lon, len(lat))

    n_months = vals.shape[0]
    idx_months, obs_months, err_months = [], [], []
    for t in range(n_months):
        flat = vals[t].reshape(-1)
        idx = np.nonzero(np.isfinite(flat))[0]
        idx_months.append(idx)
        obs_months.append(flat[idx])
        err_months.append(np.diag(np.full(len(idx), 0.05)))

    idx_m, obs_m, err_m = pad_month_observations(
        idx_months, obs_months, err_months
    )
    print(
        f"{n_months} months, obs per month "
        f"{min(map(len, idx_months))}..{max(map(len, idx_months))}, "
        f"bucket {idx_m.shape[1]}"
    )

    vario = MaternVariogram(
        psill=1.2, nugget=0.0, range=1300.0, nu=1.5, method="sklearn"
    )
    kernel = variogram_kernel(vario)

    def run(diagnostics):
        out = months_scan_kriging(
            kernel, glat, glon, idx_m, obs_m, err_m,
            variance=1.2, n_blocks=4, diagnostics=diagnostics,
        )
        jax.block_until_ready(out)
        return out[0] if diagnostics else out

    t0 = time.perf_counter()
    fields = run(False)
    print(f"cold (compile + run): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    fields = run(False)
    warm = time.perf_counter() - t0
    print(
        f"warm (fields only): {warm:.3f}s total, "
        f"{warm / n_months * 1e3:.1f} ms/month"
    )
    run(True)  # compile the diagnostics variant
    t0 = time.perf_counter()
    run(True)
    warm = time.perf_counter() - t0
    print(
        f"warm (+uncertainty+mask): {warm:.3f}s total, "
        f"{warm / n_months * 1e3:.1f} ms/month"
    )

    fields = np.asarray(fields)
    assert fields.shape == (n_months, 2592)
    assert np.isfinite(fields).all()
    print(
        "per-month field rms:",
        np.sqrt((fields**2).mean(axis=1)).round(3)[:8],
        "...",
    )


if __name__ == "__main__":
    main()
