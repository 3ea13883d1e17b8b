"""Full non-stationary 1-degree pipeline, end to end on one card
(BASELINE.md configs #4 + #5 joined).

This is the production claim measured stage by stage:

  1. synthetic training cube   — exact stationary draws (spherical-
                                 harmonic sampler) on the 1-degree grid
  2. empirical cov/correlation — EllipseBuilder.calc_cov (one matmul)
  3. ellipse MLE               — ~40k per-gridpoint anisotropic Matern
                                 fits, batched Nelder-Mead on device
                                 (the reference loops scipy: 58.4 s for
                                 just 2,592 points at 5 degrees)
  4. covariance assembly       — Paciorek-Schervish, tiled XLA
                                 assembly (~2G pairs)
  5. PSD repair                — explained-variance clip via randomized
                                 top-k eigensolver; result stays in
                                 factored LowRankPSD form
  6. kriging + 100 members     — ordinary field, uncertainty,
                                 constraint mask and a two-stage
                                 perturbation ensemble straight off the
                                 factors (models.lowrank)

Stages 4-6 never form more than ONE dense n x n matrix (the assembled
covariance); the repaired covariance and everything downstream is
factored. The reference's dense path (explicit inverse + dense MVN,
``stochastic.py:291-349``) cannot allocate at this size.

Run: python examples/nonstationary_1deg_pipeline.py [--small]
(--small = 4-degree grid for a quick smoke run).
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
import jax.numpy as jnp

from glomargridding_jax.core.labeled import Coordinates
from glomargridding_jax.models import (
    lowrank_ensemble_step,
)
from glomargridding_jax.models.ellipse import (
    EllipseBuilder,
    EllipseCovarianceBuilder,
    EllipseModel,
)
from glomargridding_jax.ops.covariance_tools import (
    explained_variance_clip_lowrank,
)
from glomargridding_jax.ops.sphere import SphericalHarmonicSampler

T_TRAIN = 60
N_OBS = 5000
N_MEMBERS = 100
EFF_RANGE_KM = 3000.0
EARTH_KM = 6371.0


def stage(name, t0):
    dt = time.perf_counter() - t0
    print(f"[{name:<34s}] {dt:7.2f}s", flush=True)
    return time.perf_counter()


def ocean_mask(lats, lons):
    """Synthetic continents: a smooth deterministic ~35% land mask."""
    LA, LO = np.meshgrid(np.radians(lats), np.radians(lons), indexing="ij")
    f = (
        np.sin(2.0 * LO + 1.0) * np.cos(LA)
        + 0.7 * np.sin(3.0 * LA + 0.5)
        + 0.4 * np.cos(5.0 * LO - 2.0 * LA)
    )
    land = f > 0.55
    land |= np.abs(LA) > np.radians(78.0)  # polar ice
    return land  # True = masked


def main(small=False):
    from glomargridding_jax.config import enable_compile_cache

    enable_compile_cache()  # monthly reruns skip minutes of XLA compile
    deg = 4.0 if small else 1.0
    lats = np.arange(-90 + deg / 2, 90, deg, dtype=np.float32)
    lons = np.arange(-180 + deg / 2, 180, deg, dtype=np.float32)
    mask = ocean_mask(lats, lons)
    n_ocean = int((~mask).sum())
    print(
        f"grid {len(lats)}x{len(lons)} ({deg} deg), "
        f"{n_ocean} ocean points, backend={jax.default_backend()}"
    )

    t0 = time.perf_counter()
    # 1 -- training cube: exact stationary draws, exponential correlation
    r = EFF_RANGE_KM / 3.0 / EARTH_KM  # e-folding central angle
    # l_max=256 captures essentially all power of a 3000 km-range field
    # (spectrum dies by l ~ 60) and keeps the synthesis program small:
    # the default l_max (3 * n_lat = 540 at 1 degree) costs ~200 s of
    # XLA compile for a field that is numerically identical here.
    sampler = SphericalHarmonicSampler(
        lambda ang: np.exp(-ang / r), 1.0, lats, lons,
        nugget=0.05, l_max=256,
    )
    # the cube STAYS on device: land cells become NaN (the device-path
    # mask convention) and EllipseBuilder consumes the jax.Array
    # directly — no host round-trip of the 15.6 MB cube
    cube = sampler.draw(jax.random.key(0), T_TRAIN).reshape(
        T_TRAIN, len(lats), len(lons)
    )
    cube = jnp.where(jnp.asarray(mask)[None], jnp.nan, cube)
    float(cube[0, 0, 0])  # sync
    t0 = stage(f"training cube ({T_TRAIN} states, on device)", t0)

    # 2+3 -- empirical correlation + batched ellipse MLE at every point
    coords = Coordinates(
        {
            "time": np.arange(T_TRAIN),
            "latitude": lats,
            "longitude": lons,
        }
    )
    builder = EllipseBuilder(cube, coords)
    float(builder.cor[0, 0])  # sync
    t0 = stage("empirical cov/cor (calc_cov)", t0)

    ellipse = EllipseModel(
        anisotropic=True,
        rotated=True,
        physical_distance=True,
        v=1.5,
        unit_sigma=True,
    )
    params = builder.compute_params(
        default_value=[-999.9, -999.9, -999.9, -999.9, -1, -1],
        matern_ellipse=ellipse,
        max_distance=6000.0,
        guesses=[2000.0, 2000.0, 0.0],
        bounds=[
            (300.0, 30000.0),
            (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi),
        ],
        tol=1e-3,
        chunk_size=2048,
        # 4 chunks per jitted lax.scan dispatch (the production lane)
        dispatch_chunks=4,
        # batched Nelder-Mead (default); opt_method="lm" (damped
        # Gauss-Newton on the Fisher-z least-squares form) is
        # available when gradients/Hessians are wanted
        # cap each fit's training correlations to its 4096 nearest
        # in-window points: whole-grid cost is n_points x n_cols, and
        # at 1 degree the unrestricted 40k x 40k fit would be ~170x
        # the 5-degree one for columns that are pure noise beyond the
        # correlation range
        max_train_cols=4096,
    )
    Lx = params["Lx"].values
    qc = params["qc_code"].values
    good = (Lx > 0) & (qc != 9)
    n_fit = int(good.sum())
    t0 = stage(f"ellipse MLE ({n_fit} converged fits)", t0)
    del builder  # frees the (n, n) correlation before assembly

    # 4 -- Paciorek-Schervish assembly (tiled XLA build)
    fit_mask = mask | ~good
    cov_builder = EllipseCovarianceBuilder(
        np.ma.masked_where(fit_mask, Lx),
        np.ma.masked_where(fit_mask, params["Ly"].values),
        np.ma.masked_where(fit_mask, params["theta"].values),
        np.ma.masked_where(fit_mask, params["standard_deviation"].values),
        lats,
        lons,
        v=1.5,
    )
    cov = jnp.asarray(cov_builder.cov_ns)
    n = cov.shape[0]
    jax.block_until_ready(cov)
    t0 = stage(f"PS covariance assembly ({n} pts)", t0)

    # 5 -- PSD repair: randomized top-k clip, factored result
    psd = explained_variance_clip_lowrank(
        cov,
        target_variance_fraction=0.90,
        key=jax.random.key(1),
        k0=512 if small else 1024,
        max_rank=1536 if small else 4096,
        rank_multiple=128,
    )
    rel_trace = abs(psd.trace() - float(jnp.trace(cov))) / float(
        jnp.trace(cov)
    )
    true_rank = psd.rank
    # fixed rank multiple -> stable compiled shapes month over month
    psd = psd.pad_rank(256)
    t0 = stage(f"low-rank clip (rank {true_rank}->{psd.rank})", t0)
    print(f"    trace preserved to {rel_trace:.2e}")
    del cov, cov_builder  # the dense matrix is no longer needed

    # 6 -- kriging + two-stage 100-member ensemble off the factors
    rng = np.random.default_rng(7)
    n_obs = min(N_OBS, n // 2)
    idx = np.sort(rng.choice(n, n_obs, replace=False))
    # truth on the same compression the covariance uses (fit_mask:
    # ocean AND converged), not the plain ocean mask
    truth_full = np.asarray(sampler.draw(jax.random.key(2), 1)).reshape(
        len(lats), len(lons)
    )
    truth_fit = truth_full[~fit_mask].astype(np.float32)
    assert truth_fit.shape[0] == n
    y = truth_fit[idx] + 0.3 * rng.normal(size=n_obs).astype(np.float32)
    # the (m,) diagonal — not np.diag: the m^2 form is a 100 MB upload
    E = np.full(n_obs, 0.09, np.float32)

    t0 = stage("  (truth draw + obs prep)", t0)
    res, members = lowrank_ensemble_step(
        psd, idx, y, E, jax.random.key(3), n_members=N_MEMBERS
    )
    float(members[-1, -1])  # sync
    t0 = stage(f"kriging + {N_MEMBERS} members", t0)

    rmse = float(np.sqrt(np.mean((np.asarray(res.field) - truth_fit) ** 2)))
    spread = float(
        (np.asarray(members) - np.asarray(res.field)).std(axis=0).mean()
    )
    print(
        f"    field RMSE vs truth {rmse:.3f}, "
        f"mean member spread {spread:.3f}, "
        f"mean kriging uncertainty {float(res.uncertainty.mean()):.3f}"
    )


if __name__ == "__main__":
    main(small="--small" in sys.argv)
