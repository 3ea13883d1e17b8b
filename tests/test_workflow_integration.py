"""End-to-end workflow integration test (reference notebook pipeline,
reduced ESA training band for CPU runtime)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), "..", "examples")
)

_DATA_CANDIDATES = (
    os.path.join(os.path.dirname(__file__), "..", "examples", "data"),
    "/root/reference/notebooks",
)
requires_notebook_data = pytest.mark.skipif(
    not any(
        os.path.isfile(
            os.path.join(d, "esa_cci_sst_5deg_monthly_1982-2022_03.nc")
        )
        for d in _DATA_CANDIDATES
    ),
    reason="workflow data not available (examples/data)",
)


@requires_notebook_data
def test_hadsst_workflow_reduced():
    from hadsst_workflow import run

    out = run(esa_lat_band=(-40.0, 0.0), nm_tol=1e-3, chunk_size=512)
    field = out["anom_stat"]
    assert field.shape == (2592,)
    assert np.isfinite(field).all()
    # kriged anomalies are bounded SST-anomaly-like values
    assert np.abs(field).max() < 10.0
    # uncertainty positive away from obs, ~0 impossible everywhere
    u = out["uncert_stat"]
    assert (u >= 0).all() and u.max() > 0.1
    # at observed gridboxes the field should track the obs
    idx = out["grid_idx"]
    resid = field[idx] - out["grid_obs"]
    assert np.abs(resid).mean() < 0.5

    # ellipse parameters: fitted points have sane scales
    Lx = out["ellipse_params"]["Lx"].values
    fitted = Lx[Lx > 0]
    assert len(fitted) > 50
    assert (fitted >= 300.0).all() and (fitted <= 30000.0).all()
    qc = out["ellipse_params"]["qc_code"].values
    assert (qc[Lx > 0] != 9).mean() > 0.5  # most fits converged


def test_profiling_helpers():
    import jax.numpy as jnp

    from glomargridding_jax.utils.profiling import (
        hbm_budget_check,
        hbm_estimate,
        stage_timer,
    )

    assert hbm_estimate(((100, 100), jnp.float32)) == 40000
    assert hbm_budget_check(((10, 10), jnp.float32), limit_bytes=1 << 20)
    assert not hbm_budget_check(
        ((65000, 65000), jnp.float64), limit_bytes=16 * 1024**3
    )
    timings: dict = {}
    with stage_timer("noop", timings) as h:
        h["out"] = jnp.ones(4) * 2
    assert "noop" in timings and timings["noop"] >= 0
