"""Smoke run of the main path on one NVIDIA GPU, checked against float64.

    python chip_smoke.py          # phases A-C on one card
    python chip_smoke.py --four   # phase D only, on four cards

Phases, each through the public API at full width:

A. stationary 1-degree kriging (64,800 cells, 5,000 obs, Matern 1.5)
   and a 100-member ensemble, against a float64 NumPy/SciPy solve on
   2,048 sampled cells;
B. the 1-degree non-stationary pipeline with fitted ellipses (~44k
   ocean points): training cube -> ellipse MLE -> dense assembly ->
   low-rank PSD repair -> kriging + 100 members;
C. covariance operators: the 64,800-cell bf16 store -> matvec-only
   repair -> factored ensemble, and the 259,200-cell banded stream
   operator through every narrow-matvec route and the wide XLA path,
   with warm timings of each route and of the stored builds;
D. (--four) sharded kriging and the sharded stream operator at
   259,200 cells on a 4x1 mesh, against the same calls on one card.

Every phase prints its wall, its tolerances and the matmul precision it
ran at; any failed check raises, and the script exits non-zero. The last
line of stdout is one JSON object naming the device.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
R_KM = 6371.0  # the package's RADIUS_OF_EARTH_KM, restated for the oracle

# ---------------------------------------------------------------- helpers


def _log(msg):
    print(msg, flush=True)


def _check(name, value, limit):
    """Print ``value <= limit`` and raise if it does not hold."""
    ok = bool(np.isfinite(value)) and value <= limit
    _log(f"    {name}: {value:.3e} (limit {limit:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value!r} exceeds {limit!r}")


def _timed(fn, reps=3):
    """(first-call wall, sorted warm walls) of ``fn``, synced on the device."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return first, sorted(warm)


def _grid(deg):
    lats = np.arange(-90 + deg / 2, 90, deg)
    lons = np.arange(-180 + deg / 2, 180, deg)
    return lats, lons


def _precision_note():
    import jax

    default = jax.config.jax_default_matmul_precision
    return (
        f"default matmul precision {default or 'DEFAULT'} (f32 products "
        "may run as TF32 on the GPU); explicit HIGHEST in the kriging "
        "products (Linv @ Cc, u/w/member weights @ Cc), the stream "
        "tiles @ x and the Triton kernel's dot"
    )


# ---------------------------------------------------------- f64 oracles


def haversine_km(la1, lo1, la2, lo2):
    """Great-circle km between points given in radians (broadcasting)."""
    a = (
        np.sin(0.5 * (la1 - la2)) ** 2
        + np.cos(la1) * np.cos(la2) * np.sin(0.5 * (lo1 - lo2)) ** 2
    )
    return 2.0 * R_KM * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def matern_cov_f64(d_km, psill, range_km, nu):
    """sklearn-convention Matern covariance, float64, via scipy's K_nu."""
    from scipy.special import gamma, kv

    x = math.sqrt(2.0 * nu) * np.asarray(d_km, np.float64) / range_km
    with np.errstate(invalid="ignore", over="ignore"):
        c = psill * (2.0 ** (1.0 - nu) / gamma(nu)) * x**nu * kv(nu, x)
    return np.where(x == 0.0, psill, c)


def kriging_f64(la, lo, idx, y, rows, psill, range_km, nu, err):
    """Ordinary kriging at grid cells ``rows`` from the bordered system.

    Returns (field, variance, constraint mask) with the package's
    definitions: the reference's published variance C(0) - lambda'c -
    2 mu (the multiplier subtracted twice, see ``models.kriging``) and
    constraint mask c'K^{-1}c / C(0). Plain float64 linear algebra on
    the host.
    """
    from scipy.linalg import cho_factor, cho_solve, solve

    la_o, lo_o = la[idx], lo[idx]
    K = matern_cov_f64(
        haversine_km(la_o[:, None], lo_o[:, None], la_o[None], lo_o[None]),
        psill, range_km, nu,
    ) + err * np.eye(len(idx))
    c = matern_cov_f64(
        haversine_km(la_o[:, None], lo_o[:, None], la[rows][None],
                     lo[rows][None]),
        psill, range_km, nu,
    )
    n = len(idx)
    A = np.zeros((n + 1, n + 1))
    A[:n, :n] = K
    A[:n, n] = A[n, :n] = 1.0
    rhs = np.vstack([c, np.ones((1, c.shape[1]))])
    sol = solve(A, rhs, assume_a="sym")
    lam, mu = sol[:n], sol[n]
    field = lam.T @ y
    var = psill - np.einsum("nb,nb->b", lam, c) - 2.0 * mu
    cf = cho_factor(K)
    sv = np.einsum("nb,nb->b", c, cho_solve(cf, c))
    return field, var, sv / psill


def ps06_rows_f64(rows, la, lo, Lx, Ly, theta, sd, v, max_dist=None,
                  antimeridian=None):
    """Paciorek-Schervish rows C[rows, :] in float64 (Modified Met Office
    displacement, diag = stdev^2), with an optional haversine cutoff.

    The wrapped longitude difference is discontinuous at +-pi, where the
    sign of dx (and with it the cross term of the quadratic form) flips;
    ``antimeridian`` = +1 or -1 puts pairs within 1e-6 rad of it on that
    side (None: the plain ``> pi`` wrap).
    """
    from scipy.special import gamma, kv

    ct, st = np.cos(theta), np.sin(theta)
    s00 = ct * ct * Lx**2 + st * st * Ly**2
    s01 = ct * st * (Lx**2 - Ly**2)
    s11 = st * st * Lx**2 + ct * ct * Ly**2
    det = s00 * s11 - s01 * s01
    i = np.asarray(rows)[:, None]
    dy = R_KM * (la[i] - la[None])
    dlon = lo[i] - lo[None]
    dlon = np.where(dlon > np.pi, dlon - 2 * np.pi, dlon)
    dlon = np.where(dlon < -np.pi, dlon + 2 * np.pi, dlon)
    if antimeridian is not None:
        at_pi = np.abs(np.abs(dlon) - np.pi) < 1e-6
        dlon = np.where(at_pi, antimeridian * np.pi, dlon)
    dx = R_KM * dlon * 0.5 * (np.cos(la[i]) + np.cos(la[None]))
    b00 = 0.5 * (s00[i] + s00[None])
    b01 = 0.5 * (s01[i] + s01[None])
    b11 = 0.5 * (s11[i] + s11[None])
    bdet = b00 * b11 - b01 * b01
    tau2 = (dx * dx * b11 - 2 * dx * dy * b01 + dy * dy * b00) / bdet
    x = 2.0 * math.sqrt(v) * np.sqrt(np.maximum(tau2, 0.0))
    with np.errstate(invalid="ignore", over="ignore"):
        corr = x**v * kv(v, x) / (gamma(v) * 2.0 ** (v - 1.0))
    corr = np.where(x == 0.0, 1.0, corr)
    out = (
        sd[i] * sd[None] * det[i] ** 0.25 * det[None] ** 0.25
        / np.sqrt(bdet) * corr
    )
    same = np.asarray(rows)[:, None] == np.arange(len(la))[None]
    out = np.where(same, sd[i] ** 2, np.where(x == 0.0, 0.0, out))
    if max_dist is not None:
        far = haversine_km(la[i], lo[i], la[None], lo[None]) > max_dist
        out = np.where(far & ~same, 0.0, out)
    return out


# ---------------------------------------------------------- phase A


def phase_a(n_lat=180, n_lon=360, n_obs=5000, n_members=100, n_check=2048,
            seed=0):
    """Stationary ordinary kriging + ensemble vs a float64 solve."""
    import jax

    from glomargridding_jax.models.kernel_kriging import (
        ensemble_from_kernel,
        kriging_from_kernel,
        variogram_kernel,
    )
    from glomargridding_jax.ops.variogram import MaternVariogram

    psill, range_km, nu, err = 1.2, 1300.0, 1.5, 0.09
    lats, lons = _grid(180.0 / n_lat)
    glat = np.repeat(lats, n_lon).astype(np.float32)
    glon = np.tile(lons, n_lat).astype(np.float32)
    m = glat.size
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(m, n_obs, replace=False))
    la64, lo64 = np.radians(glat.astype(np.float64)), np.radians(
        glon.astype(np.float64)
    )
    y = (
        np.sin(2 * la64[idx]) * np.cos(3 * lo64[idx])
        + 0.3 * rng.normal(size=n_obs)
    ).astype(np.float32)
    E = (err * np.eye(n_obs)).astype(np.float32)
    _log(f"[A] stationary kriging: {m} cells, {n_obs} obs, Matern "
         f"nu={nu} range={range_km} km psill={psill}, error {err}")

    kernel = variogram_kernel(
        MaternVariogram(psill=psill, range=range_km, nu=nu)
    )
    t0 = time.perf_counter()
    res = kriging_from_kernel(
        kernel, glat, glon, idx, y, E, variance=psill, method="ordinary"
    )
    jax.block_until_ready(res)
    _log(f"    kriging_from_kernel first call {time.perf_counter() - t0:.2f} s")
    _, warm = _timed(lambda: kriging_from_kernel(
        kernel, glat, glon, idx, y, E, variance=psill, method="ordinary"))
    _log(f"    kriging_from_kernel warm {warm}")

    t0 = time.perf_counter()
    field_e, members = ensemble_from_kernel(
        kernel, glat, glon, idx, y, E, jax.random.key(seed + 1),
        n_members=n_members,
    )
    jax.block_until_ready(members)
    _log(f"    ensemble_from_kernel ({n_members}) first call "
         f"{time.perf_counter() - t0:.2f} s")
    _, warm = _timed(lambda: ensemble_from_kernel(
        kernel, glat, glon, idx, y, E, jax.random.key(seed + 1),
        n_members=n_members))
    _log(f"    ensemble_from_kernel warm {warm}")

    field = np.asarray(res.field, np.float64)
    unc = np.asarray(res.uncertainty, np.float64)
    cmask = np.asarray(res.constraint_mask, np.float64)
    members = np.asarray(members, np.float64)
    field_e = np.asarray(field_e, np.float64)
    assert field.shape == unc.shape == cmask.shape == (m,)
    assert members.shape == (n_members, m)
    for name, a in (("field", field), ("uncertainty", unc),
                    ("constraint mask", cmask), ("members", members)):
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite {name}")

    rows = np.sort(rng.choice(m, min(n_check, m), replace=False))
    t0 = time.perf_counter()
    f_ref, var_ref, cm_ref = kriging_f64(
        la64, lo64, idx, y.astype(np.float64), rows, psill, range_km, nu,
        err,
    )
    _log(f"    float64 reference on {len(rows)} cells "
         f"{time.perf_counter() - t0:.2f} s")
    unc_ref = np.sqrt(np.clip(var_ref, 0.0, None))
    # f32 Cholesky of a K with condition ~1e4 carries ~1e-3 relative
    # error into the weights; the variance is C(0) - c'K^{-1}c, a
    # difference of terms ~1 whose f32 rounding is ~1e-4 each
    _check("max |field - f64| / max |f64 field|",
           np.abs(field[rows] - f_ref).max() / np.abs(f_ref).max(), 5e-3)
    _check("max |uncertainty - f64|", np.abs(unc[rows] - unc_ref).max(),
           5e-3)
    _check("max |constraint mask - f64|",
           np.abs(cmask[rows] - cm_ref).max(), 2e-3)
    _check("max |ensemble field - kriging field|",
           np.abs(field_e - field).max(), 5e-3)
    # members - field ~ N(0, c'K^{-1}c): its variance is the constraint
    # mask times C(0); 100 members give ~14% noise per cell, averaged
    pert_var = (members - field_e[None]).var(axis=0)
    ratio = pert_var[rows].mean() / (psill * cm_ref).mean()
    _check("|member variance / c'K^-1c - 1| (mean over cells)",
           abs(ratio - 1.0), 0.15)
    _log(f"    {_precision_note()}")


# ---------------------------------------------------------- phase B


def _ocean_mask(lats, lons):
    """Synthetic continents: a smooth deterministic ~35% land mask."""
    LA, LO = np.meshgrid(np.radians(lats), np.radians(lons), indexing="ij")
    f = (
        np.sin(2.0 * LO + 1.0) * np.cos(LA)
        + 0.7 * np.sin(3.0 * LA + 0.5)
        + 0.4 * np.cos(5.0 * LO - 2.0 * LA)
    )
    land = f > 0.55
    land |= np.abs(LA) > np.radians(78.0)
    return land


def phase_b(deg=1.0, n_train=60, n_obs=5000, n_members=100, n_check=256,
            k0=1024, max_rank=4096, chunk_size=2048, max_train_cols=4096,
            seed=0):
    """The 1-degree non-stationary pipeline with fitted ellipses."""
    import jax
    import jax.numpy as jnp

    from glomargridding_jax.core.labeled import Coordinates
    from glomargridding_jax.models import lowrank_ensemble_step
    from glomargridding_jax.models.ellipse import (
        EllipseBuilder,
        EllipseCovarianceBuilder,
        EllipseModel,
    )
    from glomargridding_jax.ops.covariance_tools import (
        explained_variance_clip_lowrank,
    )
    from glomargridding_jax.ops.sphere import SphericalHarmonicSampler

    lats, lons = _grid(deg)
    lats, lons = lats.astype(np.float32), lons.astype(np.float32)
    mask = _ocean_mask(lats, lons)
    _log(f"[B] 1-degree non-stationary pipeline: {(~mask).sum()} ocean "
         f"points of {mask.size}")
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    r = 1000.0 / R_KM  # e-folding angle of a 3000 km effective range
    sampler = SphericalHarmonicSampler(
        lambda ang: np.exp(-ang / r), 1.0, lats, lons, nugget=0.05,
        l_max=256,
    )
    cube = sampler.draw(jax.random.key(seed), n_train).reshape(
        n_train, len(lats), len(lons)
    )
    cube = jnp.where(jnp.asarray(mask)[None], jnp.nan, cube)
    jax.block_until_ready(cube)
    _log(f"    training cube ({n_train} states) {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    builder = EllipseBuilder(
        cube,
        Coordinates({"time": np.arange(n_train), "latitude": lats,
                     "longitude": lons}),
    )
    params = builder.compute_params(
        default_value=[-999.9, -999.9, -999.9, -999.9, -1, -1],
        matern_ellipse=EllipseModel(
            anisotropic=True, rotated=True, physical_distance=True, v=1.5,
            unit_sigma=True,
        ),
        max_distance=6000.0,
        guesses=[2000.0, 2000.0, 0.0],
        bounds=[(300.0, 30000.0), (300.0, 30000.0),
                (-2.0 * np.pi, 2.0 * np.pi)],
        tol=1e-3,
        chunk_size=chunk_size,
        dispatch_chunks=4,
        max_train_cols=max_train_cols,
    )
    Lx = params["Lx"].values
    good = (Lx > 0) & (params["qc_code"].values != 9)
    n_ocean = int((~mask).sum())
    n_fit = int((good & ~mask).sum())
    _log(f"    ellipse MLE: {n_fit}/{n_ocean} converged "
         f"{time.perf_counter() - t0:.2f} s")
    if n_fit < 0.9 * n_ocean:
        raise AssertionError(f"only {n_fit} of {n_ocean} fits converged")
    del builder

    t0 = time.perf_counter()
    fit_mask = mask | ~good
    cb = EllipseCovarianceBuilder(
        np.ma.masked_where(fit_mask, Lx),
        np.ma.masked_where(fit_mask, params["Ly"].values),
        np.ma.masked_where(fit_mask, params["theta"].values),
        np.ma.masked_where(fit_mask, params["standard_deviation"].values),
        lats, lons, v=1.5,
    )
    cov = jax.block_until_ready(jnp.asarray(cb.cov_ns))
    n = cov.shape[0]
    _log(f"    covariance assembly ({n} points) "
         f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n, min(n_check, n), replace=False))
    f64 = np.float64
    ref, slack = ps06_rows_with_slack(
        rows,
        cb.lat_grid_compressed_rad.astype(f64),
        cb.lon_grid_compressed_rad.astype(f64),
        cb.Lx_compressed.astype(f64), cb.Ly_compressed.astype(f64),
        cb.theta_compressed.astype(f64), cb.stdev_compressed.astype(f64),
        1.5,
    )
    got = np.asarray(cov[jnp.asarray(rows)], f64)
    if not np.isfinite(got).all():
        raise AssertionError("non-finite covariance rows")
    scale = np.abs(ref).max()
    # every entry is a product of f32 factors (~1e-6 relative each);
    # far pairs carry the displacement's rounding into tau
    _check(f"max |rows - f64| beyond slack / max |C| ({len(rows)} rows)",
           _excess(got, ref, slack) / scale, 1e-4)
    trace = float(jnp.trace(cov))

    t0 = time.perf_counter()
    psd = explained_variance_clip_lowrank(
        cov, target_variance_fraction=0.90, key=jax.random.key(seed + 1),
        k0=k0, max_rank=max_rank, rank_multiple=128,
    )
    rank = psd.rank
    psd = psd.pad_rank(256)
    jax.block_until_ready(psd.vectors)
    _log(f"    low-rank clip 0.90 (rank {rank}) "
         f"{time.perf_counter() - t0:.2f} s")
    _check("|trace(clipped) / trace(C) - 1|", abs(psd.trace() / trace - 1),
           1e-4)
    del cov, cb

    idx = np.sort(rng.choice(n, min(n_obs, n // 2), replace=False))
    truth = np.asarray(sampler.draw(jax.random.key(seed + 2), 1)).reshape(
        len(lats), len(lons)
    )[~fit_mask].astype(np.float32)
    y = truth[idx] + 0.3 * rng.normal(size=idx.size).astype(np.float32)
    E = np.full(idx.size, 0.09, np.float32)
    t0 = time.perf_counter()
    res, members = lowrank_ensemble_step(
        psd, idx, y, E, jax.random.key(seed + 3), n_members=n_members
    )
    jax.block_until_ready(members)
    _log(f"    kriging + {n_members} members first call "
         f"{time.perf_counter() - t0:.2f} s")
    _, warm = _timed(lambda: lowrank_ensemble_step(
        psd, idx, y, E, jax.random.key(seed + 3), n_members=n_members))
    _log(f"    kriging + members warm {warm}")
    field = np.asarray(res.field)
    members = np.asarray(members)
    unc = np.asarray(res.uncertainty)
    for name, a in (("field", field), ("uncertainty", unc),
                    ("members", members)):
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite {name}")
    spread = (members - field[None]).std(axis=0).mean()
    # a calibrated two-stage ensemble spreads like the kriging
    # uncertainty; 100 members leave a few per cent of sampling noise
    _check("|member spread / kriging uncertainty - 1|",
           abs(spread / unc.mean() - 1.0), 0.15)
    rmse = float(np.sqrt(np.mean((field - truth) ** 2)))
    _log(f"    field RMSE vs truth {rmse:.3f}, spread {spread:.3f}, "
         f"uncertainty {unc.mean():.3f}")
    _log(f"    phase B wall {time.perf_counter() - t_all:.2f} s; "
         f"{_precision_note()}")


# ---------------------------------------------------------- phase C


def _ellipse_fields(glat, seed):
    """Smooth seeded ellipse parameter fields (km, radians)."""
    rng = np.random.default_rng(seed)
    c = np.cos(np.radians(glat))
    ph = rng.uniform(0, 2 * np.pi, 4)
    Lx = 1800.0 + 1200.0 * c**2 + 300.0 * np.sin(3 * np.radians(glat) + ph[0])
    Ly = 1200.0 + 500.0 * c + 200.0 * np.cos(2 * np.radians(glat) + ph[1])
    theta = 0.3 * np.sin(np.radians(2.0 * glat) + ph[2])
    sd = 0.6 + 0.5 * c + 0.1 * np.sin(np.radians(glat) + ph[3])
    return [a.astype(np.float32) for a in (Lx, Ly, theta, sd)]


def _operator_inputs(glat, glon, fields):
    import jax.numpy as jnp

    from glomargridding_jax.ops.distances import sigma_rot_flat

    Lx, Ly, theta, sd = fields
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)
    )
    return (
        jnp.radians(jnp.asarray(glat)), jnp.radians(jnp.asarray(glon)),
        jnp.stack([s00, s01, s11], axis=-1),
        jnp.sqrt(s00 * s11 - s01 * s01), jnp.asarray(sd),
    )


def ps06_rows_with_slack(rows, la, lo, Lx, Ly, theta, sd, v,
                         max_dist=None, rel=1e-4, block=64):
    """(C[rows, :] in float64, slack) where slack bounds, pair by pair,
    how far an f32 evaluation may legitimately differ from it.

    The model is discontinuous in two places where an f32 and an f64
    evaluation may land on different sides: pairs within ``rel`` of the
    cutoff (the device decides it in f32, relative error ~1e-6 in the
    distance; on a regular grid many pairs sit at identical distances
    near it), and pairs whose longitudes differ by exactly 180 degrees
    (the wrap of the Met Office displacement flips the sign of dx
    there; near the poles such pairs are close). Elsewhere slack is 0.
    Inputs in float64, radians; rows in blocks of ``block``.
    """
    refs, slacks = [], []
    for i in range(0, len(rows), block):
        r = rows[i:i + block]
        args = (r, la, lo, Lx, Ly, theta, sd, v)
        ref = ps06_rows_f64(*args, max_dist)
        sides = [ps06_rows_f64(*args, max_dist, s) for s in (1.0, -1.0)]
        slack = np.abs(sides[0] - sides[1])
        if max_dist is not None:
            d = haversine_km(la[r][:, None], lo[r][:, None], la[None],
                             lo[None])
            slack = slack + np.where(
                np.abs(d - max_dist) <= rel * max_dist,
                np.abs(ps06_rows_f64(*args)), 0.0,
            )
        refs.append(ref)
        slacks.append(slack)
    return np.concatenate(refs), np.concatenate(slacks)


def _grid_rows(rows, glat, glon, fields, max_dist=None):
    f64 = np.float64
    return ps06_rows_with_slack(
        rows, np.radians(glat.astype(f64)), np.radians(glon.astype(f64)),
        *(a.astype(f64) for a in fields), 1.5, max_dist,
    )


def _excess(got, want, slack):
    """max(|got - want| - slack, 0): the error no discontinuity excuses."""
    return max((np.abs(got - want) - slack).max(), 0.0)


def phase_c_store(n_lat=180, n_lon=360, n_obs=5000, n_members=100,
                  n_check=256, k0=1024, max_rank=4096, seed=0):
    """64,800-cell bf16 store -> matvec-only clip -> factored ensemble."""
    import jax
    import jax.numpy as jnp

    from glomargridding_jax.models import lowrank_ensemble_step
    from glomargridding_jax.models.ellipse.covariance import (
        ellipse_covariance_operator,
    )
    from glomargridding_jax.ops.covariance_tools import (
        explained_variance_clip_lowrank,
    )

    lats, lons = _grid(180.0 / n_lat)
    glat = np.repeat(lats, n_lon).astype(np.float32)
    glon = np.tile(lons, n_lat).astype(np.float32)
    n = glat.size
    fields = _ellipse_fields(glat, seed)
    args = _operator_inputs(glat, glon, fields)
    _log(f"[C1] bf16 store operator: {n} cells")
    t0 = time.perf_counter()
    mv, n_op, trace = ellipse_covariance_operator(*args, v=1.5, store="bf16")
    jax.block_until_ready(mv.operands)
    _log(f"    bf16 store build first call {time.perf_counter() - t0:.2f} s")
    del mv
    first, warm = _timed(lambda: ellipse_covariance_operator(
        *args, v=1.5, store="bf16")[0].operands, reps=2)
    _log(f"    bf16 store build warm {warm}")
    mv, n_op, trace = ellipse_covariance_operator(*args, v=1.5, store="bf16")

    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n, min(n_check, n), replace=False))
    eye = jnp.zeros((n, rows.size), jnp.float32).at[
        jnp.asarray(rows), jnp.arange(rows.size)].set(1.0)
    got = np.asarray(mv(eye), np.float64).T
    ref, slack = _grid_rows(rows, glat, glon, fields)
    # bf16 keeps 8 mantissa bits: ~4e-3 relative per stored entry
    _check("max |store rows - f64| beyond slack / max |C|",
           _excess(got, ref, slack) / np.abs(ref).max(), 8e-3)

    t0 = time.perf_counter()
    psd = explained_variance_clip_lowrank(
        mv, n=n_op, trace=trace, target_variance_fraction=0.90,
        key=jax.random.key(seed + 1), k0=k0, max_rank=max_rank, n_iter=4,
        rank_multiple=128,
    )
    rank = psd.rank
    psd = psd.pad_rank(256)
    jax.block_until_ready(psd.vectors)
    _log(f"    matvec-only clip 0.90 (rank {rank}) "
         f"{time.perf_counter() - t0:.2f} s")
    _check("|trace(clipped) / trace - 1|", abs(psd.trace() / trace - 1),
           1e-4)
    del mv

    idx = np.sort(rng.choice(n, n_obs, replace=False))
    truth = np.asarray(psd.draw(jax.random.key(seed + 2), 1))[0]
    y = truth[idx] + 0.3 * rng.normal(size=n_obs).astype(np.float32)
    E = np.full(n_obs, 0.09, np.float32)
    t0 = time.perf_counter()
    res, members = lowrank_ensemble_step(
        psd, idx, y, E, jax.random.key(seed + 3), n_members=n_members
    )
    jax.block_until_ready(members)
    _log(f"    factored kriging + {n_members} members first call "
         f"{time.perf_counter() - t0:.2f} s")
    field, unc = np.asarray(res.field), np.asarray(res.uncertainty)
    members = np.asarray(members)
    if not (np.isfinite(field).all() and np.isfinite(members).all()):
        raise AssertionError("non-finite factored kriging output")
    spread = (members - field[None]).std(axis=0).mean()
    _check("|member spread / kriging uncertainty - 1|",
           abs(spread / unc.mean() - 1.0), 0.15)


def phase_c_stream(n_lat=360, n_lon=720, max_dist=3000.0, n_check=512,
                   interpret=False, seed=0, reps=3):
    """259,200-cell banded stream operator: every route vs float64."""
    import jax
    import jax.numpy as jnp

    from glomargridding_jax.models.ellipse.covariance import (
        ellipse_covariance_operator,
        with_kernel_route,
    )

    lats, lons = _grid(180.0 / n_lat)
    glat = np.repeat(lats, n_lon).astype(np.float32)
    glon = np.tile(lons, n_lat).astype(np.float32)
    n = glat.size
    fields = _ellipse_fields(glat, seed + 10)
    args = _operator_inputs(glat, glon, fields)
    t0 = time.perf_counter()
    mv, _, _ = ellipse_covariance_operator(
        *args, v=1.5, store="stream", max_dist=max_dist
    )
    st = mv.band_stats
    _log(f"[C2] banded stream operator: {n} cells, cutoff {max_dist} km, "
         f"window {st['bwg']}/{st['n_cols_pad']}, plan "
         f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    x64 = jnp.asarray(rng.normal(size=(n, 64)).astype(np.float32))
    x8 = x64[:, :8]
    routes = {"xla": with_kernel_route(mv, None)}
    routes["triton"] = with_kernel_route(
        mv, "interpret" if interpret else "triton"
    )
    ys = {}
    for name, op in routes.items():
        first, warm = _timed(lambda op=op: op(x8), reps=reps)
        ys[name] = np.asarray(op(x8), np.float64)
        pairs = st["kernel_pairs"] if name == "triton" else st["wide_pairs"]
        _log(f"    8-col {name}: first {first:.3f} s, warm {warm} "
             f"({pairs} pairs)")
    first, warm = _timed(lambda: routes["xla"](x64), reps=reps)
    y64 = np.asarray(routes["xla"](x64), np.float64)
    _log(f"    64-col xla: first {first:.3f} s, warm {warm}")

    rows = np.sort(rng.choice(n, min(n_check, n), replace=False))
    x = np.asarray(x64, np.float64)
    ref, slack = _grid_rows(rows, glat, glon, fields, max_dist)
    want = ref @ x
    # pairs at the model's discontinuities (the cutoff, the 180-degree
    # longitude wrap) may land on either side in f32: their possible
    # difference is allowed on top of the rounding bound
    slack = slack @ np.abs(x)
    scale = np.abs(want).max()
    _log(f"    discontinuity slack: max {slack.max() / scale:.3e} of max |y|")

    def err(y, cols):
        # the XLA stream and the kernel contract f32 tiles at HIGHEST;
        # f32 rounding summed over the band stays ~1e-5 of max |y|
        return _excess(y[rows], want[:, cols], slack[:, cols]) / scale

    for name, y in ys.items():
        _check(f"8-col {name}: max |y - f64| beyond slack "
               "/ max |y_f64|", err(y, slice(0, 8)), 2e-4)
        _check(f"8-col {name} vs 64-col xla",
               np.abs(y - y64[:, :8]).max() / scale, 2e-4)
    _check("64-col xla: max |y - f64| beyond slack / max |y_f64|",
           err(y64, slice(None)), 2e-4)
    _log(f"    {_precision_note()}")


def phase_c_timings(n_side=128, interpret=False, reps=5, seed=0):
    """16,384 cells, no band: kernel vs XLA at 8 columns, and the f32
    stored build."""
    from glomargridding_jax.models.ellipse.covariance import (
        build_ellipse_covariance,
        ellipse_covariance_operator,
        with_kernel_route,
    )
    import jax.numpy as jnp

    lats = _grid(180.0 / n_side)[0]
    lons = _grid(360.0 / n_side)[1]
    glat = np.repeat(lats, n_side).astype(np.float32)
    glon = np.tile(lons, n_side).astype(np.float32)
    n = glat.size
    fields = _ellipse_fields(glat, seed + 20)
    args = _operator_inputs(glat, glon, fields)
    _log(f"[C3] {n} cells, no cutoff")
    first, warm = _timed(
        lambda: build_ellipse_covariance(*args, v=1.5, row_block=n),
        reps=reps,
    )
    _log(f"    f32 stored build: first {first:.3f} s, warm {warm}")
    mv, _, _ = ellipse_covariance_operator(*args, v=1.5, store="stream")
    x8 = jnp.asarray(
        np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)
    )
    ys = {}
    for name, kernel in (("xla", None),
                         ("triton", "interpret" if interpret else "triton")):
        op = with_kernel_route(mv, kernel)
        first, warm = _timed(lambda op=op: op(x8), reps=reps)
        ys[name] = np.asarray(op(x8), np.float64)
        _log(f"    8-col {name}: first {first:.3f} s, warm {warm}")
    _check("8-col triton vs xla", np.abs(ys["triton"] - ys["xla"]).max()
           / np.abs(ys["xla"]).max(), 2e-4)


# ---------------------------------------------------------- phase D


def phase_d(n_lat=360, n_lon=720, n_obs=5000, max_dist=3000.0, seed=0,
            devices=None):
    """Sharded kriging and stream operator on 4 cards vs one card."""
    import jax
    import jax.numpy as jnp

    from glomargridding_jax.models.kernel_kriging import variogram_kernel
    from glomargridding_jax.ops.variogram import MaternVariogram
    from glomargridding_jax.parallel import (
        make_mesh,
        sharded_ellipse_stream_operator,
        sharded_kriging_from_kernel,
    )

    devs = jax.devices() if devices is None else list(devices)
    if len(devs) != 4:
        raise AssertionError(f"--four needs 4 devices, found {len(devs)}")
    mesh4 = make_mesh(4, 1, devices=devs)
    mesh1 = make_mesh(1, 1, devices=devs[:1])
    lats, lons = _grid(180.0 / n_lat)
    glat = np.repeat(lats, n_lon).astype(np.float32)
    glon = np.tile(lons, n_lat).astype(np.float32)
    m = glat.size
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(m, n_obs, replace=False))
    y = (np.sin(2 * np.radians(glat[idx])) + 0.3 * rng.normal(size=n_obs)
         ).astype(np.float32)
    E = (0.09 * np.eye(n_obs)).astype(np.float32)
    kernel = variogram_kernel(MaternVariogram(psill=1.2, range=1300.0,
                                              nu=1.5))
    _log(f"[D] sharded kriging: {m} cells, {n_obs} obs, 4x1 mesh")
    out = {}
    for name, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
        first, warm = _timed(lambda mesh=mesh: sharded_kriging_from_kernel(
            mesh, kernel, glat, glon, idx, y, E, variance=1.2), reps=2)
        res = sharded_kriging_from_kernel(
            mesh, kernel, glat, glon, idx, y, E, variance=1.2)
        _log(f"    {name}: first {first:.3f} s, warm {warm}")
        if name == "4 cards":
            held = {s.device for s in res[0].addressable_shards}
            if len(held) != 4:
                raise AssertionError(f"shards on {len(held)} devices")
        out[name] = [np.asarray(a, np.float64) for a in res]
    for k, label in enumerate(("field", "uncertainty^2", "constraint mask")):
        a, b = out["4 cards"][k], out["1 card"][k]
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite sharded {label}")
        _check(f"{label}: max |4 cards - 1 card|", np.abs(a - b).max(), 1e-4)

    fields = _ellipse_fields(glat, seed + 10)
    x8 = jnp.asarray(rng.normal(size=(m, 8)).astype(np.float32))
    _log(f"[D] sharded stream operator: {m} cells, cutoff {max_dist} km")
    ys = {}
    for name, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
        mv, _, _ = sharded_ellipse_stream_operator(
            mesh, *fields[:3], fields[3], glat, glon, v=1.5,
            max_dist=max_dist,
        )
        first, warm = _timed(lambda mv=mv: mv(x8), reps=2)
        y8 = mv(x8)
        _log(f"    {name}: 8-col first {first:.3f} s, warm {warm}")
        if name == "4 cards":
            held = {s.device for s in y8.addressable_shards}
            if len(held) != 4:
                raise AssertionError(f"shards on {len(held)} devices")
        ys[name] = np.asarray(y8, np.float64)
    scale = np.abs(ys["1 card"]).max()
    # the same tiles summed in another order (ring steps): f32 rounding
    _check("stream: max |4 cards - 1 card| / max |y|",
           np.abs(ys["4 cards"] - ys["1 card"]).max() / scale, 1e-5)


# ---------------------------------------------------------- main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run phase D only, on four cards")
    opts = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import jax

    jax.config.update("jax_platforms", "cuda")
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: backend {jax.default_backend()!r}")
    from glomargridding_jax.config import enable_compile_cache

    _log(f"compile cache: {enable_compile_cache()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _log(smi)
    devs = jax.devices()
    _log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    phases = [("D", phase_d)] if opts.four else [
        ("A", phase_a), ("C3", phase_c_timings), ("C2", phase_c_stream),
        ("C1", phase_c_store), ("B", phase_b),
    ]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        _log(f"phase {name} wall {time.perf_counter() - t0:.2f} s")

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
