"""The fused Triton stream matvec (Pallas interpreter on the CPU), the
XLA stored builds, and the f32 haversine cutoff, each against a float64
reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chip_smoke import ps06_rows_f64
from glomargridding_jax.models.ellipse import covariance as cov_mod
from glomargridding_jax.models.ellipse import stream_kernel
from glomargridding_jax.models.ellipse.covariance import (
    build_ellipse_covariance,
    ellipse_covariance_operator,
    with_kernel_route,
)
from glomargridding_jax.ops.distances import sigma_rot_flat


def _fields(rng, n):
    lats = np.sort(rng.uniform(-70, 70, n)).astype(np.float32)
    lons = rng.uniform(-180, 180, n).astype(np.float32)
    Lx = rng.uniform(800, 2000, n).astype(np.float32)
    Ly = rng.uniform(400, 800, n).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    stdev = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return lats, lons, (Lx, Ly, theta, stdev)


def _inputs(lats, lons, fields):
    Lx, Ly, theta, stdev = fields
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)
    )
    return (
        jnp.radians(jnp.asarray(lats)), jnp.radians(jnp.asarray(lons)),
        jnp.stack([s00, s01, s11], axis=-1),
        jnp.sqrt(s00 * s11 - s01 * s01), jnp.asarray(stdev),
    )


def _dense_f64(lats, lons, fields, v, max_dist=None):
    f64 = np.float64
    return ps06_rows_f64(
        np.arange(len(lats)), np.radians(lats.astype(f64)),
        np.radians(lons.astype(f64)), *(a.astype(f64) for a in fields),
        v, max_dist,
    )


@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("max_dist", [None, 3000.0])
@pytest.mark.parametrize("v", [0.5, 1.5, 2.5, 3.5])
def test_stream_kernel_interpret_matches_f64(rng, v, max_dist, w):
    """The Triton kernel route (interpret mode) == the float64 dense
    product, banded and unbanded, for one and several columns."""
    lats, lons, fields = _fields(rng, 600)
    mv, n, _ = ellipse_covariance_operator(
        *_inputs(lats, lons, fields), v=v, store="stream",
        max_dist=max_dist,
    )
    kmv = with_kernel_route(mv, "interpret")
    X = rng.normal(size=(n, w)).astype(np.float32)
    x = jnp.asarray(X[:, 0] if w == 1 else X)
    got = np.asarray(kmv(x), np.float64).reshape(n, w)
    want = _dense_f64(lats, lons, fields, v, max_dist) @ X
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    first, last = (np.asarray(a) for a in mv.operands[-2:])
    # one band entry per kernel row block, padding blocks included
    assert first.shape == (mv.band_stats["n_cols_pad"] // 64,)
    if max_dist is not None:
        # the band plan must actually skip column blocks here
        assert (last - first + 1).sum() < len(first) ** 2


def test_stream_kernel_route_selection(rng):
    """Narrow x takes the kernel route only where one is set; wide x
    always takes the XLA stream; both agree."""
    lats, lons, fields = _fields(rng, 200)
    mv, n, _ = ellipse_covariance_operator(
        *_inputs(lats, lons, fields), v=1.5, store="stream",
        max_dist=2500.0,
    )
    # the CPU picks the XLA stream; the GPU would pick "triton"
    assert mv.band_stats["kernel"] is None
    kmv = with_kernel_route(mv, "interpret")
    assert kmv.band_stats["kernel"] == "interpret"
    assert all(a is b for a, b in zip(kmv.operands, mv.operands))
    X = jnp.asarray(rng.normal(size=(n, 20)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(kmv(X[:, :16])), np.asarray(mv(X[:, :16])),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_array_equal(np.asarray(kmv(X)), np.asarray(mv(X)))
    with pytest.raises(ValueError, match="kernel route"):
        with_kernel_route(mv, "mosaic")


def test_stream_kernel_compiles_for_gpu_only(rng):
    """Called off the GPU without interpret=True, the kernel refuses
    instead of falling back to the interpreter."""
    assert jax.default_backend() != "gpu"
    n = stream_kernel.BLOCK
    cols = tuple(jnp.ones((n,), jnp.float32) for _ in range(7))
    x = jnp.zeros((n, 8), jnp.float32)
    first = last = jnp.zeros((1,), jnp.int32)
    kp = (1.5, "Modified_Met_Office", 0.0, False)
    with pytest.raises(RuntimeError, match="GPU only"):
        stream_kernel.ellipse_matvec(cols, x, first, last, kparams=kp)
    with pytest.raises(ValueError, match="must be"):
        stream_kernel.ellipse_matvec(
            cols, jnp.zeros((n, 17), jnp.float32), first, last,
            kparams=kp, interpret=True,
        )
    # a band plan shorter than the grid (one entry per row block) is
    # refused: on the GPU the missing entries would be garbage bounds
    with pytest.raises(ValueError, match="first/last"):
        stream_kernel.ellipse_matvec(
            tuple(jnp.ones((2 * n,), jnp.float32) for _ in range(7)),
            jnp.zeros((2 * n, 8), jnp.float32), first, last,
            kparams=kp, interpret=True,
        )


def test_stream_kernel_constants_agree(rng):
    """The operator pads its columns to a whole number of kernel blocks
    and wide-path chunks, and plans the kernel band at the kernel's own
    block."""
    assert cov_mod._COL_PAD % stream_kernel.BLOCK == 0
    assert cov_mod._COL_PAD % cov_mod._STREAM_CHUNK == 0
    lats, lons, fields = _fields(rng, 700)
    mv, n, _ = ellipse_covariance_operator(
        *_inputs(lats, lons, fields), v=1.5, store="stream",
        max_dist=2000.0,
    )
    st = mv.band_stats
    assert st["n_cols_pad"] % cov_mod._COL_PAD == 0
    first, last = (np.asarray(a) for a in mv.operands[-2:])
    assert first.shape == (st["n_cols_pad"] // stream_kernel.BLOCK,)
    assert st["kernel_pairs"] == (
        int((last - first + 1).sum()) * stream_kernel.BLOCK**2
    )


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("v", [0.5, 1.5, 2.5, 3.5])
def test_stored_build_matches_f64(rng, v, store):
    """The XLA stored builds (dense f32, and the bf16 operator store)
    against the float64 oracle."""
    lats, lons, fields = _fields(rng, 300)
    args = _inputs(lats, lons, fields)
    want = _dense_f64(lats, lons, fields, v)
    if store == "f32":
        got = np.asarray(build_ellipse_covariance(*args, v=v), np.float64)
        tol = 2e-5
    else:
        mv, n, trace = ellipse_covariance_operator(
            *args, v=v, store="bf16", n_blocks=3
        )
        got = np.asarray(mv(jnp.eye(n, dtype=jnp.float32)), np.float64)
        assert trace == pytest.approx(np.trace(want), rel=1e-6)
        tol = 8e-3  # bf16 keeps 8 mantissa bits
    assert np.abs(got - want).max() / np.abs(want).max() < tol


def _f64_haversine_km(lats_deg, lons_deg):
    """f64 numpy haversine oracle (km), no library code."""
    la = np.radians(lats_deg.astype(np.float64))
    lo = np.radians(lons_deg.astype(np.float64))
    dla = la[:, None] - la[None, :]
    dlo = lo[:, None] - lo[None, :]
    a = (
        np.sin(0.5 * dla) ** 2
        + np.cos(la)[:, None] * np.cos(la)[None, :]
        * np.sin(0.5 * dlo) ** 2
    )
    return 2.0 * 6371.0088 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def test_small_cutoff_f32_boundary_precision(rng):
    """The haversine cutoff must stay f32-accurate at SMALL radii.

    The zero-transcendental cutoff once expanded (1 - cos(x - y))/2
    through per-point full-angle trig, which cancels catastrophically
    in f32: at a 10 km cutoff the boundary was misplaced by up to ~8%
    of the radius. The half-angle squared-difference form keeps the
    rounding BEFORE the square, so the error in haversine-a is
    relative (~2*sqrt(a)*eps). Pin: every pair classified differently
    from the f64 oracle lies within 0.5% of the boundary — across a
    mid-lat cluster, a dateline-straddling cluster, and a polar one.
    """
    cut_km = 10.0
    clusters = [
        (47.0, 8.0),      # mid-latitude
        (-35.0, 179.95),  # straddles the antimeridian
        (80.0, -120.0),   # high latitude (small cos-lat)
    ]
    lats, lons = [], []
    for la0, lo0 in clusters:
        # ~0.5-20 km spacings around each centre so many pairs land
        # near the 10 km boundary
        lats.append(la0 + rng.uniform(-0.09, 0.09, 24))
        lons.append(lo0 + rng.uniform(-0.13, 0.13, 24))
    lats = np.concatenate(lats).astype(np.float32)
    lons = ((np.concatenate(lons) + 180.0) % 360.0 - 180.0).astype(
        np.float32
    )
    n = lats.shape[0]

    dist = _f64_haversine_km(lats, lons)
    Lx = np.full(n, 30.0, np.float32)
    Ly = np.full(n, 20.0, np.float32)
    theta = np.zeros(n, np.float32)
    stdev = np.ones(n, np.float32)
    s00, s01, _, s11 = sigma_rot_flat(
        jnp.asarray(Lx), jnp.asarray(Ly), jnp.asarray(theta)
    )
    sig_flat = jnp.stack([s00, s01, s11], axis=-1)
    sqrt_dets = jnp.sqrt(s00 * s11 - s01 * s01)
    la = jnp.radians(jnp.asarray(lats))
    lo = jnp.radians(jnp.asarray(lons))

    off = ~np.eye(n, dtype=bool)
    cov = np.asarray(
        build_ellipse_covariance(
            la, lo, sig_flat, sqrt_dets, jnp.asarray(stdev),
            v=0.5, max_dist=cut_km,
        )
    )
    zeroed = (cov == 0.0) & off
    kept = (cov != 0.0) & off
    # sanity: the construction actually produces near-boundary work
    assert (dist[off] < cut_km).any() and (dist[off] > cut_km).any()
    # zeroed pairs must be beyond 99.5% of the radius; kept pairs
    # within 100.5% of it
    assert dist[zeroed].min() > cut_km * 0.995
    assert dist[kept].max() < cut_km * 1.005
