"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glomargridding_jax.models.kriging import OrdinaryKriging
from glomargridding_jax.parallel import (
    ensemble_kriging_step,
    make_mesh,
    sharded_ordinary_kriging,
)


def _problem(rng, m=128, n_obs=10):
    pts = rng.uniform(0, 1, size=(m, 2))
    d = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
    cov = np.exp(-d / 0.3) + 1e-6 * np.eye(m)
    idx = np.sort(rng.choice(m, size=n_obs, replace=False))
    obs = rng.normal(size=n_obs)
    err = 0.05 * np.eye(n_obs)
    return cov, idx, obs, err


def test_make_mesh_factorisations():
    mesh = make_mesh()
    assert mesh.devices.size == jax.device_count()
    mesh2 = make_mesh(n_grid=4, n_ens=2)
    assert mesh2.shape == {"grid": 4, "ens": 2}
    with pytest.raises(ValueError):
        make_mesh(n_grid=3, n_ens=2)


def test_sharded_matches_single_device(rng):
    cov, idx, obs, err = _problem(rng)
    mesh = make_mesh(n_grid=8, n_ens=1)
    field, uncert2, cmask = sharded_ordinary_kriging(
        mesh, cov, idx, obs, err
    )

    OK = OrdinaryKriging(cov, idx=idx, obs=obs, error_cov=err)
    k_ref = OK.solve()
    u_ref = OK.get_uncertainty()
    a_ref = OK.constraint_mask()

    np.testing.assert_allclose(np.asarray(field), k_ref, rtol=1e-8)
    np.testing.assert_allclose(
        np.sqrt(np.maximum(np.asarray(uncert2), 0)), u_ref, rtol=1e-6
    )
    np.testing.assert_allclose(np.asarray(cmask), a_ref, rtol=1e-8)

    # outputs are actually sharded over the grid axis
    shard_devs = {s.device for s in field.addressable_shards}
    assert len(shard_devs) == 8


def test_ensemble_step_2d_mesh(rng):
    cov, idx, obs, err = _problem(rng)
    mesh = make_mesh(n_grid=4, n_ens=2)
    members, field, uncert2 = ensemble_kriging_step(
        mesh, jax.random.key(0), cov, err, idx, obs, n_members=8
    )
    assert members.shape == (8, 128)
    assert np.isfinite(np.asarray(members)).all()

    # statistical sanity: the ensemble mean approaches the kriged field
    mesh1 = make_mesh(n_grid=8, n_ens=1)
    members_many, field2, _ = ensemble_kriging_step(
        mesh1, jax.random.key(1), cov, err, idx, obs, n_members=512
    )
    np.testing.assert_allclose(np.asarray(field), np.asarray(field2))
    spread = np.abs(np.asarray(members_many).mean(0) - np.asarray(field))
    assert spread.mean() < 0.2  # members fluctuate around the field

    # ensemble members at observed points stay near the obs-field values
    err_at_obs = np.abs(
        np.asarray(members_many)[:, idx].mean(0)
        - np.asarray(field)[idx]
    )
    assert err_at_obs.mean() < 0.2


def test_graft_entry_roundtrip():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert all(np.isfinite(np.asarray(o)).all() for o in out)

    mod.dryrun_multichip(8)


def test_sharded_kernel_kriging_matches_single(rng):
    from glomargridding_jax.models.kernel_kriging import (
        kriging_from_kernel,
        variogram_kernel,
    )
    from glomargridding_jax.ops.variogram import MaternVariogram
    from glomargridding_jax.parallel.kernel_kriging import (
        sharded_kriging_from_kernel,
    )

    # 8-divisible grid
    lat = np.arange(-82.5, 90, 15.0)  # 12
    lon = np.arange(-172.5, 180, 22.5)  # 16
    glat = np.repeat(lat, 16)
    glon = np.tile(lon, 12)
    m = len(glat)  # 192
    idx = np.sort(rng.choice(m, 15, replace=False))
    obs = rng.normal(size=15)
    err = np.diag(0.1 + 0.05 * rng.random(15))

    vario = MaternVariogram(psill=1.2, nugget=0.0, range=2500.0, nu=1.5)
    kernel = variogram_kernel(vario)
    mesh = make_mesh(n_grid=8, n_ens=1)
    field, uncert2, cmask = sharded_kriging_from_kernel(
        mesh, kernel, glat, glon, idx, obs, err, variance=1.2
    )

    single = kriging_from_kernel(
        kernel, glat, glon, idx, obs, err, variance=1.2, n_blocks=4
    )
    np.testing.assert_allclose(
        np.asarray(field), np.asarray(single.field), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.sqrt(np.clip(np.asarray(uncert2), 0, None)),
        np.asarray(single.uncertainty),
        rtol=1e-5,
        atol=1e-7,
    )
    shard_devs = {s.device for s in field.addressable_shards}
    assert len(shard_devs) == 8


def test_sharded_cholesky_matches_numpy(rng):
    from glomargridding_jax.parallel.linalg import sharded_cholesky

    n = 256
    A = rng.normal(size=(n, n))
    spd = A @ A.T + n * np.eye(n)

    mesh = make_mesh(n_grid=8, n_ens=1)
    L = np.asarray(sharded_cholesky(mesh, spd.astype(np.float64),
                                    n_blocks=16))
    ref = np.linalg.cholesky(spd)
    np.testing.assert_allclose(L, ref, rtol=1e-9, atol=1e-9)
    # strictly lower triangular result
    assert np.abs(np.triu(L, 1)).max() == 0.0


def test_sharded_cholesky_block_count_validation(rng):
    from glomargridding_jax.parallel.linalg import sharded_cholesky

    mesh = make_mesh(n_grid=8, n_ens=1)
    A = np.eye(100)
    with pytest.raises(ValueError, match="divide"):
        sharded_cholesky(mesh, A, n_blocks=7)


def test_sharded_triangular_solve_matches_lapack(rng):
    """Distributed forward substitution: apply a row-sharded factor
    without gathering it; parity vs scipy-style dense solve."""
    import jax.scipy.linalg as jsl

    from glomargridding_jax.parallel.linalg import (
        sharded_cholesky,
        sharded_triangular_solve,
    )

    n, k = 192, 5
    A = rng.normal(size=(n, n))
    spd = A @ A.T + n * np.eye(n)
    mesh = make_mesh(n_grid=8, n_ens=1)
    L = sharded_cholesky(mesh, spd, n_blocks=24)

    B = rng.normal(size=(n, k))
    X = np.asarray(sharded_triangular_solve(mesh, L, B, n_blocks=24))
    ref = np.asarray(
        jsl.solve_triangular(np.asarray(L), B, lower=True)
    )
    np.testing.assert_allclose(X, ref, rtol=1e-8, atol=1e-10)

    # 1-d RHS round-trips shape; full solve inverts the factorisation
    b = rng.normal(size=n)
    x = np.asarray(sharded_triangular_solve(mesh, L, b, n_blocks=24))
    assert x.shape == (n,)
    y = np.asarray(
        jsl.solve_triangular(np.asarray(L).T, x, lower=False)
    )
    np.testing.assert_allclose(spd @ y, b, rtol=1e-6, atol=1e-8)


def test_sharded_ellipse_covariance_and_draws(rng):
    """Full multi-chip non-stationary pipeline on the CPU mesh:
    row-sharded PS06 assembly == single-device builder; distributed
    Cholesky + sharded L@z draws have the right distribution."""
    import jax.numpy as jnp

    from glomargridding_jax.models.ellipse.covariance import (
        build_ellipse_covariance,
    )
    from glomargridding_jax.ops.distances import sigma_rot_flat
    from glomargridding_jax.parallel.ellipse import (
        sharded_ellipse_covariance,
        sharded_state_draws,
    )
    from glomargridding_jax.parallel.linalg import sharded_cholesky

    n = 128
    lats = rng.uniform(-60, 60, n)
    lons = rng.uniform(-180, 180, n)
    Lx = rng.uniform(900, 2000, n)
    Ly = rng.uniform(500, 900, n)
    theta = rng.uniform(-np.pi, np.pi, n)
    stdev = rng.uniform(0.6, 1.4, n)

    mesh = make_mesh(n_grid=8, n_ens=1)
    cov_sharded = sharded_ellipse_covariance(
        mesh, Lx, Ly, theta, stdev, lats, lons, v=0.5
    )

    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)
    )
    sig = jnp.stack([s00, s01, s11], -1)
    sdets = jnp.sqrt(s00 * s11 - s01 * s01)
    ref = np.asarray(
        build_ellipse_covariance(
            jnp.radians(jnp.asarray(lats)),
            jnp.radians(jnp.asarray(lons)),
            sig,
            sdets,
            jnp.asarray(stdev),
            v=0.5,
        )
    )
    np.testing.assert_allclose(
        np.asarray(cov_sharded), ref, rtol=1e-5, atol=1e-8
    )
    assert len({s.device for s in cov_sharded.addressable_shards}) == 8

    # PSD repair then distributed factor + draws
    from glomargridding_jax.ops.covariance_tools import eigenvalue_clip

    spd = eigenvalue_clip(ref, target_variance_fraction=0.95)
    L = sharded_cholesky(mesh, spd, n_blocks=16)
    ref_L = np.linalg.cholesky(spd)
    np.testing.assert_allclose(np.asarray(L), ref_L, rtol=1e-6, atol=1e-8)

    draws = sharded_state_draws(mesh, jax.random.key(0), L, 20_000)
    assert draws.shape == (20_000, n)
    sample_cov = np.cov(np.asarray(draws).T)
    assert np.abs(sample_cov - spd).max() < 0.15


def test_sharded_lowrank_matches_single_device(rng):
    """Row-sharded factored kriging + ensemble == the local path."""
    import jax.numpy as jnp

    from glomargridding_jax.models.lowrank import (
        lowrank_ensemble_step,
        lowrank_kriging,
    )
    from glomargridding_jax.ops.covariance_tools import LowRankPSD
    from glomargridding_jax.parallel import (
        sharded_lowrank_ensemble_step,
        sharded_lowrank_kriging,
    )

    n, r, m = 256, 16, 24
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    psd = LowRankPSD(
        vectors=jnp.asarray(Q[:, :r], jnp.float32),
        gains=jnp.asarray(
            np.sort(rng.uniform(0.5, 4.0, r))[::-1].copy(), jnp.float32
        ),
        floor=jnp.asarray(rng.uniform(0.05, 0.3, n), jnp.float32),
    )
    idx = np.sort(rng.choice(n, size=m, replace=False))
    y = rng.normal(size=m).astype(np.float32)
    E = (0.05 * np.eye(m)).astype(np.float32)

    mesh = make_mesh(n_grid=4, n_ens=2)
    res_s = sharded_lowrank_kriging(mesh, psd, idx, y, E)
    res_l = lowrank_kriging(psd, idx, y, E)
    np.testing.assert_allclose(
        np.asarray(res_s.field), np.asarray(res_l.field), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(res_s.uncertainty),
        np.asarray(res_l.uncertainty),
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(res_s.constraint_mask),
        np.asarray(res_l.constraint_mask),
        atol=1e-4,
    )

    key = jax.random.key(11)
    res2, mem_s = sharded_lowrank_ensemble_step(
        mesh, psd, idx, y, E, key, n_members=8
    )
    _, mem_l = lowrank_ensemble_step(psd, idx, y, E, key, n_members=8)
    # keyed draws are sharding-invariant; only reduction order differs
    np.testing.assert_allclose(
        np.asarray(mem_s), np.asarray(mem_l), atol=1e-4
    )
    # members really live sharded over (ens, grid)
    shapes = {s.data.shape for s in mem_s.addressable_shards}
    assert shapes == {(4, 64)}, shapes
    vec_shapes = {s.data.shape for s in res2.field.addressable_shards}
    assert vec_shapes == {(64,)}, vec_shapes


def test_clip_on_row_sharded_store(rng):
    """Pod-scale PSD repair: the randomized clip works unchanged on a
    ROW-SHARDED covariance store (the Matvec operand is sharded; GSPMD
    places the collectives), completing sharded-assembly -> sharded
    clip -> sharded low-rank ensemble."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from glomargridding_jax.ops.covariance_tools import (
        explained_variance_clip_lowrank,
    )
    from glomargridding_jax.ops.sampling import dense_matvec

    n, r = 256, 12
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    w = np.concatenate([np.linspace(30.0, 5.0, r), np.full(n - r, 0.1)])
    cov = (Q * w[None, :]) @ Q.T
    cov = ((cov + cov.T) / 2).astype(np.float32)

    psd_local = explained_variance_clip_lowrank(
        jnp.asarray(cov), target_variance_fraction=0.9, k0=16
    )

    mesh = make_mesh(n_grid=8, n_ens=1)
    cov_sharded = jax.device_put(
        jnp.asarray(cov), NamedSharding(mesh, P("grid", None))
    )
    psd_sharded = explained_variance_clip_lowrank(
        dense_matvec(cov_sharded),
        n=n,
        trace=float(np.trace(cov)),
        target_variance_fraction=0.9,
        k0=16,
    )
    assert psd_sharded.rank == psd_local.rank
    np.testing.assert_allclose(
        np.asarray(psd_sharded.gains),
        np.asarray(psd_local.gains),
        rtol=1e-4,
        atol=1e-3 * float(np.asarray(psd_local.gains).max()),
    )
    # the clipped MATRICES agree (eigenvectors are sign/rotation free)
    np.testing.assert_allclose(
        psd_sharded.to_dense(), psd_local.to_dense(), atol=1e-3
    )


def test_ensemble_step_non_divisible_grid(rng):
    """Grid sizes that don't divide the block grid (ocean-masked grids)
    are identity-padded internally; outputs match the dense reference
    on the true m rows."""
    cov, idx, obs, err = _problem(rng, m=130, n_obs=9)  # 130 % 8 != 0
    mesh = make_mesh(n_grid=4, n_ens=2)
    members, field, uncert2 = ensemble_kriging_step(
        mesh, jax.random.key(3), cov, err, idx, obs, n_members=4
    )
    assert members.shape == (4, 130)
    assert field.shape == (130,)
    OK = OrdinaryKriging(cov, idx=idx, obs=obs, error_cov=err)
    np.testing.assert_allclose(
        np.asarray(field), OK.solve(), rtol=1e-5, atol=1e-6
    )
    assert np.isfinite(np.asarray(members)).all()


def test_sharded_whiten_and_mvn_logpdf(rng):
    """The factor-once/solve-many pipeline: sharded Cholesky ->
    whitening + Gaussian scoring, vs the dense host oracle
    (sharded_triangular_solve's production consumers)."""
    from scipy.stats import multivariate_normal

    from glomargridding_jax.parallel import (
        make_mesh,
        sharded_cholesky,
        sharded_mvn_logpdf,
        sharded_whiten,
    )

    n, b = 256, 5
    M = rng.normal(size=(n, n))
    C = M @ M.T / n + np.eye(n)
    mean = rng.normal(size=n)
    X = rng.normal(size=(n, b))

    mesh = make_mesh()
    L = sharded_cholesky(mesh, jnp.asarray(C))

    # whitening: z = L^{-1} X matches the host solve
    z = np.asarray(sharded_whiten(mesh, L, jnp.asarray(X)))
    z_ref = np.linalg.solve(np.linalg.cholesky(C), X)
    np.testing.assert_allclose(z, z_ref, rtol=1e-8, atol=1e-10)

    # scoring: batch logpdf matches scipy
    got = np.asarray(
        sharded_mvn_logpdf(mesh, L, jnp.asarray(X), mean=jnp.asarray(mean))
    )
    want = multivariate_normal(mean=mean, cov=C).logpdf(X.T)
    np.testing.assert_allclose(got, want, rtol=1e-9)

    # single-vector form returns a scalar
    one = sharded_mvn_logpdf(mesh, L, jnp.asarray(X[:, 0]))
    want1 = multivariate_normal(mean=np.zeros(n), cov=C).logpdf(X[:, 0])
    np.testing.assert_allclose(float(one), want1, rtol=1e-9)


def test_sharded_stream_operator_parity():
    """Ring-SUMMA sharded zero-storage matvec == dense single-process
    assembly of the same Paciorek-Schervish covariance."""
    from glomargridding_jax.models.ellipse.covariance import (
        ellipse_covariance_block,
    )
    from glomargridding_jax.ops.distances import sigma_rot_flat
    from glomargridding_jax.parallel.ellipse import (
        sharded_ellipse_stream_operator,
    )

    rng = np.random.default_rng(11)
    n = 256
    lats = rng.uniform(-60, 60, n).astype(np.float32)
    lons = rng.uniform(-180, 180, n).astype(np.float32)
    Lx = rng.uniform(800, 2000, n).astype(np.float32)
    Ly = rng.uniform(500, 1200, n).astype(np.float32)
    th = rng.uniform(-1, 1, n).astype(np.float32)
    sd = rng.uniform(0.5, 1.5, n).astype(np.float32)

    mesh = make_mesh(n_grid=8, n_ens=1)
    mv, n_op, trace = sharded_ellipse_stream_operator(
        mesh, Lx, Ly, th, sd, lats, lons, v=1.5
    )
    assert n_op == n
    X = jnp.asarray(rng.standard_normal((n, 7)).astype(np.float32))
    out = np.asarray(mv(X))

    la = jnp.radians(jnp.asarray(lats))
    lo = jnp.radians(jnp.asarray(lons))
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(th)
    )
    sig = jnp.stack([s00, s01, s11], axis=-1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)
    dense = np.asarray(
        ellipse_covariance_block(
            la, lo, sig, sqd, jnp.asarray(sd),
            la, lo, sig, sqd, jnp.asarray(sd),
            v=1.5,
        )
    ) + np.diag(sd.astype(np.float64) ** 2)
    want = dense @ np.asarray(X)
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-5)

    # 1-d vector form and trace contract
    v1 = np.asarray(mv(X[:, 0]))
    np.testing.assert_allclose(v1, want[:, 0], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(trace, float(np.trace(dense)), rtol=1e-5)

    # fn memoisation: re-created operator shares the fn slot (fused
    # clip stages hit the jit cache across monthly re-creations)
    mv2, _, _ = sharded_ellipse_stream_operator(
        mesh, Lx, Ly, th, sd, lats, lons, v=1.5
    )
    assert mv2.fn is mv.fn


def test_sharded_stream_clip_matches_dense_clip():
    """The device-scale explained-variance clip runs UNCHANGED on the
    row-sharded stream operator (fused stages, deflated widening) and
    reproduces the full-LAPACK dense clip."""
    from glomargridding_jax.models.ellipse.covariance import (
        ellipse_covariance_block,
    )
    from glomargridding_jax.ops.covariance_tools import (
        explained_variance_clip,
        explained_variance_clip_lowrank,
    )
    from glomargridding_jax.ops.distances import sigma_rot_flat
    from glomargridding_jax.parallel.ellipse import (
        sharded_ellipse_stream_operator,
    )

    rng = np.random.default_rng(12)
    n = 256
    lats = rng.uniform(-60, 60, n).astype(np.float32)
    lons = rng.uniform(-180, 180, n).astype(np.float32)
    Lx = rng.uniform(1500, 3000, n).astype(np.float32)
    Ly = rng.uniform(900, 1800, n).astype(np.float32)
    th = rng.uniform(-1, 1, n).astype(np.float32)
    sd = rng.uniform(0.5, 1.5, n).astype(np.float32)

    mesh = make_mesh(n_grid=8, n_ens=1)
    mv, n_op, trace = sharded_ellipse_stream_operator(
        mesh, Lx, Ly, th, sd, lats, lons, v=1.5
    )
    psd = explained_variance_clip_lowrank(
        mv, n=n_op, trace=trace, target_variance_fraction=0.90,
        key=jax.random.key(2), k0=32, max_rank=256, n_iter=6,
    )

    la = jnp.radians(jnp.asarray(lats))
    lo = jnp.radians(jnp.asarray(lons))
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(th)
    )
    sig = jnp.stack([s00, s01, s11], axis=-1)
    sqd = jnp.sqrt(s00 * s11 - s01 * s01)
    dense = np.asarray(
        ellipse_covariance_block(
            la, lo, sig, sqd, jnp.asarray(sd),
            la, lo, sig, sqd, jnp.asarray(sd),
            v=1.5,
        )
    ).astype(np.float64) + np.diag(sd.astype(np.float64) ** 2)
    want = explained_variance_clip(
        dense, 0.90, spectrum="full"
    )
    got = np.asarray(psd.to_dense())
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 5e-4, err
    np.testing.assert_allclose(
        float(psd.trace()), float(np.trace(dense)), rtol=1e-5
    )


def test_sharded_compute_params_matches_single(rng):
    """compute_params(mesh=...) — the multi-chip whole-grid MLE — must
    reproduce the single-program fit: the lane axis is shard_map-split
    over the mesh, each device fitting only its own grid points (no
    collectives). Converged lanes are frozen inside the batched NM, so
    splitting the batch does not move any lane's optimum; only the
    shared iteration counter may differ per shard."""
    from test_ellipse import _synthetic_builder

    from glomargridding_jax.models.ellipse import EllipseModel

    builder, lats, lons = _synthetic_builder(rng, size=(8, 10), n=1500)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    kwargs = dict(
        default_value=[-999.0] * iso.supercategory_n_params,
        matern_ellipse=iso,
        bounds=[(100.0, 20000.0)],
        guesses=[500.0],
        max_distance=8000.0,
        delta_x_method="Modified_Met_Office",
        chunk_size=16,  # 80 points -> 5 chunks, 2 lanes per device
        estimate_SE="hessian",
    )
    p1 = builder.compute_params(**kwargs)
    mesh = make_mesh(n_grid=8, n_ens=1)
    p2 = builder.compute_params(mesh=mesh, **kwargs)

    np.testing.assert_array_equal(
        p1["qc_code"].values, p2["qc_code"].values
    )
    np.testing.assert_allclose(
        p2["R"].values, p1["R"].values, rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        p2["R_se"].values, p1["R_se"].values, rtol=1e-5, atol=1e-8
    )


def test_sharded_compute_params_rounds_chunk(rng):
    """A chunk_size not divisible by the mesh axis is rounded down (with
    a warning) instead of failing inside shard_map."""
    from test_ellipse import _synthetic_builder

    from glomargridding_jax.models.ellipse import EllipseModel

    builder, _, _ = _synthetic_builder(rng, size=(4, 6), n=600)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    mesh = make_mesh(n_grid=8, n_ens=1)
    with pytest.warns(UserWarning, match="sharded"):
        params = builder.compute_params(
            default_value=[-999.0] * iso.supercategory_n_params,
            matern_ellipse=iso,
            bounds=[(100.0, 20000.0)],
            guesses=[500.0],
            max_distance=8000.0,
            delta_x_method="Modified_Met_Office",
            chunk_size=12,  # -> 8
            mesh=mesh,
        )
    assert np.isfinite(params["R"].values).any()


def test_sharded_compute_params_subchunk_grid(rng):
    """A grid SMALLER than one chunk whose point count is not a multiple
    of the mesh axis (4 x 6 = 24 points minus any masked) must pad its
    single fit row up to the axis size instead of crashing in
    shard_map's divisibility check."""
    from test_ellipse import _synthetic_builder

    from glomargridding_jax.models.ellipse import EllipseModel

    builder, _, _ = _synthetic_builder(rng, size=(3, 6), n=600)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    mesh = make_mesh(n_grid=8, n_ens=1)
    params = builder.compute_params(
        default_value=[-999.0] * iso.supercategory_n_params,
        matern_ellipse=iso,
        bounds=[(100.0, 20000.0)],
        guesses=[500.0],
        max_distance=8000.0,
        delta_x_method="Modified_Met_Office",
        chunk_size=64,  # 18 points -> one short chunk, 18 % 8 != 0
        mesh=mesh,
        estimate_SE="hessian",
    )
    R = params["R"].values
    assert np.isfinite(R).any()
    assert np.isfinite(params["R_se"].values).any()


def test_sharded_fit_with_groups_and_checkpoint(rng, tmp_path):
    """mesh= composes with dispatch_chunks>1 and checkpoint=: the
    grouped (G, B) program shards its lane axis, sharded results fetch
    into the checkpoint accumulators, and a resume completes without
    refitting."""
    from test_ellipse import _synthetic_builder

    from glomargridding_jax.models.ellipse import EllipseModel

    builder, _, _ = _synthetic_builder(rng, size=(8, 10), n=1200)
    iso = EllipseModel(
        anisotropic=False, rotated=False, physical_distance=True,
        v=0.5, unit_sigma=True,
    )
    mesh = make_mesh(n_grid=8, n_ens=1)
    ckpt = str(tmp_path / "sharded_fit.npz")
    kwargs = dict(
        default_value=[-999.0] * iso.supercategory_n_params,
        matern_ellipse=iso,
        bounds=[(100.0, 20000.0)],
        guesses=[500.0],
        max_distance=8000.0,
        delta_x_method="Modified_Met_Office",
        chunk_size=16,  # 80 points -> 5 chunks
        dispatch_chunks=2,
        mesh=mesh,
    )
    p1 = builder.compute_params(checkpoint=ckpt, **kwargs)
    # completed checkpoint: the rerun reloads without fitting
    p2 = builder.compute_params(checkpoint=ckpt, **kwargs)
    np.testing.assert_array_equal(p1["R"].values, p2["R"].values)
    np.testing.assert_array_equal(
        p1["qc_code"].values, p2["qc_code"].values
    )
    # and matches the plain single-program fit
    p3 = builder.compute_params(
        **{**kwargs, "mesh": None, "dispatch_chunks": 1}
    )
    np.testing.assert_allclose(
        p1["R"].values, p3["R"].values, rtol=1e-6, atol=1e-6
    )


def test_ensemble_step_per_device_memory_is_o_shard():
    """Per-device peak of the FULL compiled ensemble step stays O(shard)
    (~4.1 row-shards measured), never O(full matrix): pins the
    no-device-holds-the-matrix design against GSPMD all-gather
    regressions. Also checks the peak/shard ratio
    is flat across grid-axis sizes — an all-gather would make it grow
    linearly with the axis."""
    import jax

    from glomargridding_jax.parallel import make_mesh
    from glomargridding_jax.parallel.kriging import (
        ensemble_step_memory_analysis,
    )

    ratios = {}
    for n_grid in (2, 4, 8):
        mesh = make_mesh(
            n_grid=n_grid, n_ens=1, devices=jax.devices()[:n_grid]
        )
        m = 2048
        peak, full, stats = ensemble_step_memory_analysis(
            mesh, m, 64, n_members=8
        )
        if peak is None:
            pytest.skip("backend reports no memory analysis")
        shard = full / n_grid
        assert peak <= 5 * shard, (n_grid, peak, shard)
        ratios[n_grid] = peak / shard
    # flat across axis sizes (within 20%): no hidden all-gather
    assert max(ratios.values()) / min(ratios.values()) < 1.2, ratios
