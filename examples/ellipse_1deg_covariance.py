"""Non-stationary anisotropic covariance at 1-degree scale (config #4).

The reference's vectorised "array" strategy is capped at 10,000 grid
points — beyond that it auto-downgrades to a sequential Python pair loop
(C(40k,2) = 800M pairs; hours). Here ``build_ellipse_covariance``
assembles a 40,000-point Paciorek-Schervish covariance (6.4 GB f32) on
one card, each row block one fused XLA program.

Parameters are smoothly-varying synthetic ellipse fields (latitude-
dependent zonal stretching, like fitted SST fields show).

Run: python examples/ellipse_1deg_covariance.py
"""

import os
import sys
import time

import numpy as np

try:  # prefer the installed package; fall back to a repo checkout
    import glomargridding_jax  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp

from glomargridding_jax.ops.distances import sigma_rot_flat
from glomargridding_jax.models.ellipse.covariance import (
    build_ellipse_covariance,
)

N_POINTS = 40_000


def main():
    from glomargridding_jax.config import enable_compile_cache

    enable_compile_cache()  # monthly reruns skip minutes of XLA compile
    rng = np.random.default_rng(0)
    # 1-degree ocean-like point cloud
    lats = rng.uniform(-65.0, 65.0, N_POINTS).astype(np.float32)
    lons = rng.uniform(-180.0, 180.0, N_POINTS).astype(np.float32)
    # smooth parameter fields: tropics stretch zonally
    coslat = np.cos(np.radians(lats))
    Lx = (800.0 + 2200.0 * coslat**2).astype(np.float32)
    Ly = (600.0 + 400.0 * coslat).astype(np.float32)
    theta = (0.3 * np.sin(np.radians(2 * lats))).astype(np.float32)
    stdev = (0.5 + 0.4 * coslat).astype(np.float32)

    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)
    )
    sig_flat = jnp.stack([s00, s01, s11], axis=-1)
    sqrt_dets = jnp.sqrt(s00 * s11 - s01 * s01)
    la = jnp.radians(jnp.asarray(lats))
    lo = jnp.radians(jnp.asarray(lons))

    def build():
        cov = build_ellipse_covariance(
            la, lo, sig_flat, sqrt_dets, jnp.asarray(stdev), v=0.5,
            row_block=8192,
        )
        cov.block_until_ready()
        return cov

    t0 = time.perf_counter()
    cov = build()
    print(f"cold (compile + run): {time.perf_counter() - t0:.2f}s")
    # keep only one 6.4 GiB matrix alive at a time
    d = np.asarray(jnp.diagonal(cov)[:1000])
    blk = np.asarray(cov[:512, :512], dtype=np.float64)
    del cov
    t0 = time.perf_counter()
    cov = build()
    warm = time.perf_counter() - t0
    n_pairs = N_POINTS * (N_POINTS - 1) // 2
    print(
        f"warm: {warm:.3f}s for {N_POINTS} points "
        f"({n_pairs / warm / 1e9:.1f} Gpairs/s), "
        f"{cov.nbytes / 2**30:.1f} GiB matrix"
    )

    # sanity: diagonal is stdev^2, symmetric sample, PSD-ish local block
    np.testing.assert_allclose(d, stdev[:1000] ** 2, rtol=1e-4)
    assert np.abs(blk - blk.T).max() < 1e-6
    eigs = np.linalg.eigvalsh(blk)
    print(
        f"512-block spectrum: [{eigs.min():.2e}, {eigs.max():.2e}] "
        f"(min/max ratio {eigs.min() / eigs.max():.1e})"
    )


if __name__ == "__main__":
    main()
