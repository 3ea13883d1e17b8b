"""Roofline accounting: the analytic counts, the per-device peaks table
and the achieved-rate math the bench sections report."""

import numpy as np
import pytest

from glomargridding_jax.utils import roofline
from glomargridding_jax.utils.roofline import (
    achieved_bandwidth,
    achieved_matmul,
    achieved_pairs,
    cho_solve_flops,
    cholesky_flops,
    matmul_flops,
    peaks_for,
    trsm_flops,
)

H100 = peaks_for("NVIDIA H100 80GB HBM3")


def test_flop_formulas():
    assert matmul_flops(3, 5, 7) == 2 * 3 * 5 * 7
    assert cholesky_flops(6) == 6**3 / 3
    assert trsm_flops(4, 9) == 16 * 9
    assert cho_solve_flops(4, 9) == 2 * 16 * 9


def test_achieved_rates(monkeypatch):
    # one second at exactly peak -> 100% of roofline
    a = achieved_matmul(H100.bf16_tflops * 1e12, 1.0, H100.bf16_tflops)
    assert a.tflops == np.float64(H100.bf16_tflops)
    assert a.pct_roofline == 100.0
    d = a.as_dict()
    assert d["tflops"] == round(H100.bf16_tflops, 1)
    assert d["pct_roofline"] == 100.0

    a = achieved_matmul(
        H100.f32_tflops * 1e12 / 2, 1.0, peak_tflops=H100.f32_tflops,
    )
    assert abs(a.pct_roofline - 50.0) < 1e-9

    # no pair ceiling until one is measured: rate only, no share
    monkeypatch.setattr(roofline, "_PAIRS_PEAK_GS", None)
    monkeypatch.setattr(roofline, "_PAIRS_PEAK_SRC", None)
    p = achieved_pairs(40e9, 2.0)
    assert p.pct_roofline is None
    assert p.as_dict() == {"gpairs_per_s": 20.0}
    roofline.set_pairs_peak(40.0, "test")
    assert roofline.pairs_peak() == (40.0, "test")
    p = achieved_pairs(40e9, 2.0)
    assert abs(p.pct_roofline - 50.0) < 1e-9

    b = achieved_bandwidth(H100.hbm_gbs * 1e9, 1.0, H100.hbm_gbs)
    assert abs(b.pct_roofline - 100.0) < 1e-9
    assert b.as_dict()["hbm_gbs"] == H100.hbm_gbs


def test_peaks_table_is_keyed_by_device_kind():
    assert H100.bf16_tflops == 989.0
    assert H100.hbm_gbs == 3350.0
    assert "data sheet" in H100.source
    for kind in ("cpu", "Quadro RTX 8000", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError, match="no published peaks"):
            peaks_for(kind)


def test_bench_kriging_roofline_shape():
    """The helper bench.py uses emits the documented keys."""
    import bench

    out = bench._kriging_roofline(64800, 0.18, H100)
    assert set(out) >= {
        "tflops", "pct_roofline", "analytic_gflop", "kernel_gpairs"
    }
    # 2 n^2 m + n^3/3 at n=5000, m=64800 is ~3.28e12 flops
    assert 3.0e3 < out["analytic_gflop"] < 3.5e3
    assert 0 < out["pct_roofline"] < 200
