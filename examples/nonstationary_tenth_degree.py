"""The 0.1-degree (n = 6,480,000) NON-STATIONARY pipeline on ONE chip:
zero-storage banded covariance operator -> reduced-rank matvec-only
PSD repair -> factored 100-member ensemble.

This is the grid the reference cannot touch at ANY stage (its
covariance assembly refuses >10,000 points and falls back to a pair
loop — reference ``ellipse/covariance.py:206-215``; a dense f32
covariance here would be 168 TB, a bf16 store 84 TB, and even one
f32 eigensolver block of 1024 columns is 26.5 GB). What runs on one
card:

  1. heterogeneous ellipse parameter fields at 6.48M cells
     (synthetic spherical-harmonic-style roughness — the whole-grid
     MLE at this n is projected from the ``lazy_mle_1M`` bench section
     at about an hour; this demo spends its wall on the operator
     stages instead);
  2. the 3000 km-banded zero-storage stream operator: the band plan
     is two O(n log n) ``searchsorted`` passes, and applications run
     as per-group programs (one per row-block group) accumulating
     ~256 MB column chunks. One W=64 application assembles ~13e12
     pairs;
  3. a REDUCED-RANK PSD repair runs single-chip: rank <= 88 keeps
     every (n, width) eigensolver block ~2.4 GB so the randomized
     subspace iteration (4 operator sweeps at n_iter=2) fits in
     device memory.
     This is a spectrum CAP, stated plainly: the production-grade
     0.80-variance repair at this n needs rank ~3000 (26 GB+ of
     basis) — that is what `parallel/`'s ring-SUMMA sharded operator
     + row-sharded basis is for (tested on an 8-device CPU mesh).
     The demo reports the variance fraction
     its rank actually explains;
  4. kriging + a 100-member two-stage ensemble off the factors
     (Woodbury, diagonal obs error) — linear in n at fixed rank.

Wall-clock is dominated by the operator sweeps (each of the repair's
4 sweeps + the demonstration matvec is one full pass over ~13e12
pairs); on the GPU the walls are not measured yet.

Run: python examples/nonstationary_tenth_degree.py
Env:  GLOMAR_SAVE_OUTPUTS=<dir>   store .npz + stage walls
      GLOMAR_TENTH_RANK=<k>       repair rank cap (default 88)
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

from glomargridding_jax.config import enable_compile_cache
from glomargridding_jax.models.ellipse.covariance import (
    ellipse_covariance_operator,
)
from glomargridding_jax.models import lowrank_ensemble_step
from glomargridding_jax.ops.covariance_tools import (
    explained_variance_clip_lowrank,
)
from glomargridding_jax.ops.distances import sigma_rot_flat

SMALL = "--small" in sys.argv  # 2-degree smoke run (CPU-friendly)
M_LAT, M_LON = (90, 180) if SMALL else (1800, 3600)
N_OBS = 500 if SMALL else 5000
N_MEMBERS = 100


def stage(label, t0):
    t1 = time.perf_counter()
    print(f"  [{t1 - t0:8.2f}s] {label}", flush=True)
    return t1


def heterogeneous_ellipse_fields(glat, glon, seed=42):
    """Rough spatially-correlated ellipse fields (base scales
    ~900-1800 km with O(30%) log-variation) — the same difficulty
    class as the fitted quarter-degree fields, built host-side from a
    few dozen low-order spherical harmonics."""
    rng = np.random.default_rng(seed)
    la, lo = np.radians(glat), np.radians(glon)

    def rough(scale):
        out = np.zeros_like(la)
        for _ in range(12):
            k1, k2 = rng.integers(1, 7, size=2)
            s1, s2 = rng.choice([-1.0, 1.0], size=2)
            out += rng.normal() * np.sin(
                s1 * k1 * la + s2 * k2 * lo + rng.uniform(0, 2 * np.pi)
            )
        return scale * out / np.sqrt(12.0)

    coslat = np.cos(la)
    Lx = (900.0 + 600.0 * coslat**2) * np.exp(rough(0.35))
    Ly = (600.0 + 300.0 * coslat) * np.exp(rough(0.35))
    theta = rough(0.4)
    stdev = (0.8 + 0.4 * coslat) * np.exp(rough(0.25))
    return (
        a.astype(np.float32) for a in (Lx, Ly, theta, stdev)
    )


def main():
    enable_compile_cache()
    lat = np.linspace(-89.95, 89.95, M_LAT).astype(np.float32)
    lon = np.linspace(-179.95, 179.95, M_LON).astype(np.float32)
    glat = np.repeat(lat, M_LON)
    glon = np.tile(lon, M_LAT)
    n = glat.shape[0]
    print(f"n = {n} grid cells, backend={jax.default_backend()}")
    walls = {}

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    Lx, Ly, theta, stdev = heterogeneous_ellipse_fields(glat, glon)
    la = jnp.radians(jnp.asarray(glat))
    lo = jnp.radians(jnp.asarray(glon))
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)
    )
    sig = jnp.stack([s00, s01, s11], axis=-1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)
    float(sqd[0])  # drain the derived-field programs
    t0 = stage(f"ellipse parameter fields ({n} cells)", t0)

    mv, n_op, trace = ellipse_covariance_operator(
        la, lo, sig, sqd, jnp.asarray(stdev), v=1.5, store="stream",
        max_dist=3000.0,
    )
    walls["operator_build_s"] = round(time.perf_counter() - t0, 2)
    t0 = stage(
        f"banded stream operator (plan bwg={mv.band_stats['bwg']}, "
        "0 bytes stored)", t0,
    )

    # one demonstration application (this is the bench-recorded
    # number: ~260-310 s warm = 49-51 G pairs/s over ~13e12 pairs)
    rng = np.random.default_rng(11)
    X = jnp.asarray(rng.normal(size=(n, 64)).astype(np.float32))
    float(mv(X)[0, 0])
    walls["first_mv64_s"] = round(time.perf_counter() - t0, 1)
    t0 = stage("W=64 operator application (incl. compile)", t0)
    t0w = time.perf_counter()
    float(mv(X)[0, 0])
    walls["warm_mv64_s"] = round(time.perf_counter() - t0w, 1)
    del X
    t0 = stage("W=64 operator application (warm)", t0)

    # reduced-rank repair: plain-callable wrapper ON PURPOSE — the
    # Matvec fast path would fuse all 4 sweeps into ONE program that
    # runs for many minutes; the host-level loop dispatches each
    # sweep's per-group programs instead.
    k_cap = int(os.environ.get("GLOMAR_TENTH_RANK", "88"))
    psd = explained_variance_clip_lowrank(
        lambda x: mv(x), n=n_op, trace=trace,
        target_variance_fraction=0.15,
        key=jax.random.key(1),
        k0=k_cap, max_rank=k_cap, oversample=8, n_iter=2,
        rank_multiple=8,
    )
    true_rank = psd.rank
    retained = float(np.asarray(psd.gains).sum())
    walls["repair_s"] = round(time.perf_counter() - t0, 1)
    t0 = stage(
        f"matvec-only PSD repair (rank {true_rank}, 4 sweeps)", t0
    )
    print(
        f"    retained top-spectrum variance "
        f"{retained / trace:.3f} of trace (cap rank {k_cap}; "
        f"production 0.80 target needs a sharded mesh at this n)"
    )
    print(
        f"    trace preserved to {abs(psd.trace() - trace) / trace:.2e}"
    )

    idx = np.sort(rng.choice(n, N_OBS, replace=False))
    truth = np.asarray(psd.draw(jax.random.key(2), 1))[0]
    y = truth[idx] + 0.3 * rng.normal(size=N_OBS).astype(np.float32)
    E = np.full(N_OBS, 0.09, np.float32)

    res, members = lowrank_ensemble_step(
        psd, idx, y, E, jax.random.key(3), n_members=N_MEMBERS
    )
    float(members[-1, -1])
    walls["members_first_s"] = round(time.perf_counter() - t0, 1)
    t0 = stage(f"kriging + {N_MEMBERS} members (incl. compile)", t0)
    t0w = time.perf_counter()
    res, members = lowrank_ensemble_step(
        psd, idx, y, E, jax.random.key(4), n_members=N_MEMBERS
    )
    float(members[-1, -1])
    walls["members_warm_s"] = round(time.perf_counter() - t0w, 2)
    t0 = stage("kriging + members (warm)", t0)

    rmse = float(np.sqrt(np.mean((np.asarray(res.field) - truth) ** 2)))
    spread = float(
        (np.asarray(members) - np.asarray(res.field)).std(axis=0).mean()
    )
    print(
        f"    field RMSE vs truth {rmse:.3f}, member spread {spread:.3f},"
        f" mean kriging uncertainty {float(res.uncertainty.mean()):.3f}"
    )
    walls["total_s"] = round(time.perf_counter() - t_all, 1)
    print(f"  total: {walls['total_s']} s")

    out_dir = os.environ.get("GLOMAR_SAVE_OUTPUTS")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # store DOWNSAMPLED fields (the full 6.48M f32 field is 26 MB
        # per array; 0.5-degree subsampling keeps the artifact small)
        f2 = np.asarray(res.field, np.float32).reshape(M_LAT, M_LON)
        u2 = np.asarray(res.uncertainty, np.float32).reshape(
            M_LAT, M_LON
        )
        m0 = np.asarray(members[0], np.float32).reshape(M_LAT, M_LON)
        tr = truth.reshape(M_LAT, M_LON)
        np.savez_compressed(
            os.path.join(out_dir, "nonstationary_6480k.npz"),
            field=f2[::5, ::5], uncertainty=u2[::5, ::5],
            member0=m0[::5, ::5], truth=tr[::5, ::5],
            walls=np.array(
                [(k, v) for k, v in walls.items()], dtype=object
            ),
            rank=true_rank, retained_variance=retained / trace,
            rmse=rmse, spread=spread,
        )
        print(f"  outputs -> {out_dir}/nonstationary_6480k.npz")


if __name__ == "__main__":
    main()
