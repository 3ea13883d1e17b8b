"""100-member stochastic ensemble at 1-degree (M = 64,800) on ONE chip.

BASELINE.md benchmark config #5. A dense f32 Cholesky factor of the grid
covariance alone is ~17 GB and the reference cannot
attempt this size at all. Here:

- simulated states are drawn EXACTLY in the spectral domain: a
  stationary kernel diagonalises in spherical harmonics, so 100 members
  cost one (members x lm) x (lm x lat) einsum + an FFT over longitude —
  no covariance matrix, no factorisation, milliseconds per batch
  (ops/sphere.py; the general-kernel fallback is the Chebyshev sqrt
  matvec in ops/sampling.py);
- the two-stage Morice perturbation reuses the streamed kernel-kriging
  solve for the ordinary field and the simple-kriged simulated obs.

Run: python examples/large_ensemble_65k.py
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
import jax.scipy.linalg as jsl

from glomargridding_jax.ops.sphere import (
    SphericalHarmonicSampler,
    matern_correlation,
)

M_LAT, M_LON = 180, 360
N_OBS = 5000
N_MEMBERS = 100
PSILL = 1.2
NUGGET = 0.012  # spectral floor for the sqrt expansion
RANGE_KM = 1200.0


def kernel_block(la1, lo1, la2, lo2):
    a = (
        jnp.sin((la1[:, None] - la2[None, :]) / 2.0) ** 2
        + jnp.cos(la1)[:, None]
        * jnp.cos(la2)[None, :]
        * jnp.sin((lo1[:, None] - lo2[None, :]) / 2.0) ** 2
    )
    d = (2.0 * 6371.0) * jnp.arcsin(jnp.sqrt(jnp.clip(a, 0.0, 1.0)))
    cov = PSILL * jnp.exp(-d / RANGE_KM)
    same = (jnp.abs(la1[:, None] - la2[None, :]) < 1e-9) & (
        jnp.abs(lo1[:, None] - lo2[None, :]) < 1e-9
    )
    return cov + jnp.where(same, NUGGET, 0.0)


def main():
    from glomargridding_jax.config import enable_compile_cache

    enable_compile_cache()  # monthly reruns skip minutes of XLA compile
    lat = jnp.arange(-89.5, 90.0, 180.0 / M_LAT, dtype=jnp.float32)
    lon = jnp.arange(-179.5, 180.0, 360.0 / M_LON, dtype=jnp.float32)
    la = jnp.radians(jnp.repeat(lat, M_LON))
    lo = jnp.radians(jnp.tile(lon, M_LAT))
    m = la.shape[0]

    rng = np.random.default_rng(0)
    idx = jnp.asarray(
        np.sort(rng.choice(m, N_OBS, replace=False)).astype(np.int32)
    )
    y = jnp.asarray(rng.normal(size=N_OBS).astype(np.float32))
    err_diag = jnp.asarray(
        (0.1 + 0.05 * rng.random(N_OBS)).astype(np.float32)
    )

    n_blocks = 16
    la_b = la.reshape(n_blocks, -1)
    lo_b = lo.reshape(n_blocks, -1)

    t0 = time.perf_counter()
    sampler = SphericalHarmonicSampler(
        matern_correlation(nu=0.5, range_km=RANGE_KM),
        variance=PSILL,
        lats_deg=np.asarray(lat),
        lons_deg=np.asarray(lon),
        nugget=NUGGET,
    )
    print(
        f"SH sampler ready in {time.perf_counter() - t0:.1f}s "
        f"(l_max {sampler.l_max}, retained variance "
        f"{sampler.truncation_fraction:.4f})"
    )

    def draw_states(key):
        return sampler.draw(key, N_MEMBERS).T  # (m, members)

    @jax.jit
    def krige_and_perturb(la_b, lo_b, idx, y, err_diag, states, key):
        la_o = la.reshape(-1)[idx]
        lo_o = lo.reshape(-1)[idx]
        K = kernel_block(la_o, lo_o, la_o, lo_o) + jnp.diag(err_diag)
        factor = jsl.cho_factor(K)
        ones = jnp.ones((N_OBS,), jnp.float32)
        u = jsl.cho_solve(factor, ones)
        s = jnp.sum(u)
        uy = u @ y

        obs_noise = jax.random.normal(
            key, (N_OBS, N_MEMBERS), jnp.float32
        ) * jnp.sqrt(err_diag)[:, None]
        sim_obs = states[idx, :] + obs_noise

        def per_block(_, inputs):
            la_blk, lo_blk = inputs
            Cc = kernel_block(la_o, lo_o, la_blk, lo_blk)  # (n, B)
            V = jsl.cho_solve(factor, Cc)
            t = jnp.sum(V, axis=0)
            lam = (t - 1.0) / s
            field = V.T @ y - lam * uy  # (B,)
            sim_grid = V.T @ sim_obs  # (B, members)
            return None, (field, sim_grid)

        _, (field_b, sim_grid_b) = jax.lax.scan(
            per_block, None, (la_b, lo_b)
        )
        field = field_b.reshape(-1)
        sim_grid = sim_grid_b.reshape(m, N_MEMBERS)
        members = field[:, None] + (sim_grid - states)
        return field, members.T

    def ensemble(la_b, lo_b, idx, y, err_diag, key):
        import time as _t

        k_state, k_obs = jax.random.split(key)
        t = _t.perf_counter()
        states = draw_states(k_state)
        states.block_until_ready()
        print(f"  SH state draws x{N_MEMBERS}: {_t.perf_counter()-t:.2f}s")
        t = _t.perf_counter()
        out = krige_and_perturb(la_b, lo_b, idx, y, err_diag, states, k_obs)
        jax.block_until_ready(out)
        print(f"  krige + perturb: {_t.perf_counter()-t:.2f}s")
        return out

    key = jax.random.key(0)
    t0 = time.perf_counter()
    field, members = ensemble(la_b, lo_b, idx, y, err_diag, key)
    jax.block_until_ready((field, members))
    print(f"cold (compile + run): {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    field, members = ensemble(la_b, lo_b, idx, y, err_diag, key)
    jax.block_until_ready((field, members))
    warm = time.perf_counter() - t0
    print(
        f"warm: {warm:.2f}s for {N_MEMBERS} members at M={m} "
        f"({N_MEMBERS / warm:.1f} draws/s)"
    )

    members_np = np.asarray(members[:, :2000], dtype=np.float64)
    field_np = np.asarray(field[:2000], dtype=np.float64)
    spread = members_np.std(axis=0)
    print(
        "member spread (first 2k cells): "
        f"mean {spread.mean():.3f}, max {spread.max():.3f}"
    )
    print(
        "ensemble-mean deviation from field:",
        f"{np.abs(members_np.mean(0) - field_np).mean():.4f}",
    )
    assert np.isfinite(members_np).all()


if __name__ == "__main__":
    main()
