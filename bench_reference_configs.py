"""Warm-timing benchmarks of the reference's headline configurations.

BASELINE.md's published reference numbers (author laptop):
  1. Ellipse parameter MLE fit, 5-degree global ocean grid . 58.4 s
  2. Non-stationary covariance assembly (5-degree ocean) .... 0.312 s
  3. StochasticKriging.solve on a 2592-cell grid ............ 3.2 s

This script reproduces each configuration with the shipped notebook data
and reports warm (post-compile) wall times on the current backend.
Run: python bench_reference_configs.py
"""

import json
import time

import numpy as np


def timed(fn, repeats=3):
    fn()  # warm-up/compile
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


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


def run():
    import jax

    from glomargridding_jax.core.labeled import Coordinates
    from glomargridding_jax.io import load_array
    from glomargridding_jax.models.ellipse import (
        EllipseBuilder,
        EllipseCovarianceBuilder,
        EllipseModel,
    )
    from glomargridding_jax.models.stochastic import StochasticKriging
    from glomargridding_jax.ops.covariance_tools import eigenvalue_clip


    MONTH = 3

    esa = load_array(
        f"{DATA}/esa_cci_sst_5deg_monthly_1982-2022_{MONTH:02d}.nc",
        "sst_anomaly",
    )
    esa_vals = np.ma.masked_greater(np.asarray(esa.values), 1e5)
    lat = np.asarray(esa.coords["lat"])
    lon = np.asarray(esa.coords["lon"])
    coords = Coordinates(
        {
            "time": np.asarray(esa.coords["time"]),
            "latitude": lat,
            "longitude": lon,
        }
    )
    ellipse = EllipseModel(
        anisotropic=True,
        rotated=True,
        physical_distance=True,
        v=1.5,
        unit_sigma=True,
    )
    builder = EllipseBuilder(esa_vals, coords)

    fit_kwargs = dict(
        default_value=[-999.9, -999.9, -999.9, -999.9, -1, -1],
        matern_ellipse=ellipse,
        max_distance=10_000.0,
        guesses=[2000.0, 2000.0, 0.0],
        bounds=[
            (300.0, 30000.0),
            (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi),
        ],
        tol=1e-3,
        chunk_size=2048,
    )

    t_fit = timed(lambda: builder.compute_params(**fit_kwargs), repeats=2)
    # round-3 throughput lane: damped Gauss-Newton on the exact
    # Fisher-z least-squares likelihood (same optimum, ~20 iterations)
    t_fit_lm = timed(
        lambda: builder.compute_params(opt_method="lm", **fit_kwargs),
        repeats=2,
    )
    params = builder.compute_params(**fit_kwargs)
    Lx = params["Lx"].values
    mask = Lx < 0

    def build_cov():
        return EllipseCovarianceBuilder(
            np.ma.masked_where(mask, Lx),
            np.ma.masked_where(mask, params["Ly"].values),
            np.ma.masked_where(mask, params["theta"].values),
            np.ma.masked_where(
                mask, params["standard_deviation"].values
            ),
            lat,
            lon,
            v=ellipse.v,
        ).cov_ns

    def build_cov_synced():
        return jax.block_until_ready(build_cov())

    t_cov = timed(build_cov_synced)
    cov_ns = build_cov_synced()

    # stochastic solve on the full 2592 grid (as the notebook cell 40)
    sc = eigenvalue_clip(cov_ns.astype(np.float32))

    # re-inflate to the 2592 grid
    b = EllipseCovarianceBuilder(
        np.ma.masked_where(mask, Lx),
        np.ma.masked_where(mask, params["Ly"].values),
        np.ma.masked_where(mask, params["theta"].values),
        np.ma.masked_where(mask, params["standard_deviation"].values),
        lat,
        lon,
        v=ellipse.v,
    )
    b.cov_ns = sc.astype(np.float32)
    b.uncompress_cov(diag_fill_value=1.2, fill_value=0.0)
    cov_full = b.cov_ns

    rng = np.random.default_rng(0)
    n_obs = 1341
    idx = np.sort(rng.choice(2592, n_obs, replace=False))
    obs = rng.normal(size=n_obs).astype(np.float32)
    err = np.diag(0.05 + 0.02 * rng.random(n_obs)).astype(np.float32)

    def stoch():
        sk = StochasticKriging(
            cov_full, idx=idx, obs=obs, error_cov=err
        )
        out = sk.solve(key=jax.random.key(0))
        float(np.asarray(out[0]).ravel()[0])  # sync
        return out

    t_stoch = timed(stoch)

    # draws/sec on the reference's 2592-cell grid: factor once, batch
    # draws (the reference notes 1 draw costs ~ the same as 200).
    from glomargridding_jax.models.stochastic import (
        draw_factor,
        draws_from_factor,
    )
    import jax.numpy as jnp

    spd = (cov_full + cov_full.T) / 2 + 0.05 * np.eye(
        cov_full.shape[0], dtype=np.float32
    )
    L = draw_factor(jnp.asarray(spd))

    def draws():
        out = draws_from_factor(
            jax.random.key(3), L, jnp.zeros(spd.shape[0]), 200
        )
        float(out[-1, -1])  # sync

    t_draws = timed(draws)
    draws_per_s = 200.0 / t_draws

    return {
        "ellipse_fit_5deg_s": round(t_fit, 3),
        "ellipse_fit_5deg_lm_s": round(t_fit_lm, 3),
        "assembly_5deg_s": round(t_cov, 4),
        "stochastic_2592_s": round(t_stoch, 3),
        "draws_2592_per_s": round(200.0 / t_draws, 1),
        # reference laptop numbers (BASELINE.md): 58.4 s fit /
        # 0.312 s assembly / 3.2 s solve / ~62 draws/s
        "vs_baseline": {
            "fit": round(58.4 / t_fit, 1),
            "fit_lm": round(58.4 / t_fit_lm, 1),
            "assembly": round(0.312 / t_cov, 1),
            "stochastic": round(3.2 / t_stoch, 1),
            "draws": round(200.0 / t_draws / 62.0, 1),
        },
    }


def main():
    for key, val in run().items():
        print(json.dumps({key: val}))


if __name__ == "__main__":
    main()
