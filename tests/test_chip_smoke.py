"""``chip_smoke.py`` at toy sizes on the CPU: every phase function and
float64 oracle runs here (the kernel route through the Pallas
interpreter); the full-size run needs the GPU. Also: the device path
imports without the optional host packages, and the script refuses to
run without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_a_toy():
    cs.phase_a(n_lat=18, n_lon=36, n_obs=100, n_members=50, n_check=64)


def test_phase_b_toy():
    cs.phase_b(deg=6.0, n_train=30, n_obs=100, n_members=50, n_check=32,
               k0=256, max_rank=1024, chunk_size=256, max_train_cols=256)


def test_phase_c_store_toy():
    cs.phase_c_store(n_lat=18, n_lon=36, n_obs=100, n_members=50,
                     n_check=32, k0=128, max_rank=512)


def test_phase_c_stream_toy():
    cs.phase_c_stream(n_lat=24, n_lon=48, n_check=32, interpret=True,
                      reps=1)


def test_phase_c_timings_toy():
    cs.phase_c_timings(n_side=16, interpret=True, reps=1)


def test_phase_d_toy():
    cs.phase_d(n_lat=16, n_lon=32, n_obs=60, devices=jax.devices()[:4])


def test_oracles_agree_with_closed_forms():
    """The float64 oracles reproduce known values: Matern 1.5 is
    psill (1 + x) e^-x, and the PS06 diagonal is stdev^2 with a
    stationary isotropic field reducing to the Matern correlation."""
    d = np.array([0.0, 100.0, 1000.0, 5000.0])
    x = np.sqrt(3.0) * d / 1300.0
    np.testing.assert_allclose(
        cs.matern_cov_f64(d, 1.2, 1300.0, 1.5),
        1.2 * (1 + x) * np.exp(-x), rtol=1e-12,
    )
    la = np.radians(np.array([0.0, 0.0, 10.0]))
    lo = np.radians(np.array([0.0, 5.0, 0.0]))
    L = np.full(3, 1000.0)
    rows = cs.ps06_rows_f64(np.arange(3), la, lo, L, L, np.zeros(3),
                            np.full(3, 2.0), 1.5)
    np.testing.assert_allclose(np.diag(rows), 4.0)
    dy = cs.R_KM * np.radians(10.0)
    tau = 2.0 * np.sqrt(1.5) * dy / 1000.0
    np.testing.assert_allclose(
        rows[0, 2], 4.0 * (1 + tau) * np.exp(-tau), rtol=1e-12
    )


def test_oracle_slack_marks_only_discontinuities():
    """Slack is non-zero exactly for pairs 180 degrees of longitude
    apart (where the Met Office wrap flips dx) and pairs at the cutoff."""
    la = np.radians(np.array([80.0, 81.0, 80.0, 70.0]))
    lo = np.radians(np.array([10.0, -170.0, 20.0, 15.0]))
    Lx = np.array([1500.0, 1800.0, 1600.0, 1700.0])
    Ly = np.array([700.0, 900.0, 800.0, 600.0])
    th = np.array([0.4, -0.3, 0.2, 0.1])
    sd = np.ones(4)
    ref, slack = cs.ps06_rows_with_slack(
        np.arange(4), la, lo, Lx, Ly, th, sd, 1.5
    )
    assert slack[0, 1] > 0 and slack[1, 0] > 0  # across the pole
    off = np.ones((4, 4), bool)
    off[[0, 1], [1, 0]] = False
    assert (slack[off] == 0).all()
    d01 = cs.haversine_km(la[0], lo[0], la[2], lo[2])
    _, slack_cut = cs.ps06_rows_with_slack(
        np.arange(4), la, lo, Lx, Ly, th, sd, 1.5, max_dist=float(d01)
    )
    assert slack_cut[0, 2] > 0 and slack_cut[0, 3] == 0
    assert cs._excess(ref + slack, ref, slack) == 0.0
    assert cs._excess(ref + 2 * slack + 1.0, ref, slack) >= 1.0


_BLOCKED = ("pandas", "h5py", "yaml", "xarray", "matplotlib")
_DEVICE_PATH = (
    "glomargridding_jax",
    "glomargridding_jax.config",
    "glomargridding_jax.core.labeled",
    "glomargridding_jax.models",
    "glomargridding_jax.models.ellipse",
    "glomargridding_jax.models.ellipse.stream_kernel",
    "glomargridding_jax.ops",
    "glomargridding_jax.parallel",
    "glomargridding_jax.utils.roofline",
    "chip_smoke",
)


def test_device_path_imports_without_host_packages():
    """The modules the smoke run and the GPU machine need import with
    pandas, h5py, yaml, xarray and matplotlib all blocked."""
    code = (
        "import importlib, sys\n"
        f"BLOCK = {_BLOCKED!r}\n"
        "class Blocker:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCK:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Blocker())\n"
        f"for m in {_DEVICE_PATH!r}:\n"
        "    importlib.import_module(m)\n"
        "import glomargridding_jax as g\n"
        "assert 'MaternVariogram' in dir(g)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_lazy_top_level_exports():
    import glomargridding_jax as g

    from glomargridding_jax.ops.variogram import MaternVariogram

    assert g.MaternVariogram is MaternVariogram
    with pytest.raises(AttributeError):
        g.not_a_name  # noqa: B018


def test_smoke_refuses_without_gpu():
    """Off the GPU the script exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_smoke_kernel_phases_on_gpu(gpu):
    """The Triton kernel compiled for the card against the XLA stream
    and float64, at a small size, in a process of its own."""
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cuda')\n"
        "import chip_smoke as cs\n"
        "cs.phase_c_timings(n_side=64, reps=1)\n"
        "cs.phase_c_stream(n_lat=90, n_lon=180, n_check=64, reps=1)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
