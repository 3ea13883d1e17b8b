"""Analytic FLOP / byte accounting and roofline ratios for benches.

Every ``bench.py`` section reports its wall time next to an ANALYTIC
work estimate divided by that wall — achieved TFLOP/s (or G pairs/s for
kernel-evaluation-bound sections and GB/s for bandwidth-bound ones) and
the fraction of the relevant device peak. The counts are standard
dense-linear-algebra formulas (matmul 2mnk, Cholesky n^3/3, triangular
solve n^2 rhs); nothing is measured from the compiler.

Peaks come from ``PEAKS``, keyed by ``jax.Device.device_kind``; a device
that is not in the table is an error, never a default. There is no
published rate for the ellipse pair kernel: a pair ceiling exists only
after ``bench_vpu_micro`` has measured one on the card and installed it
with ``set_pairs_peak``; until then pair sections report their rate
without a roofline share.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    """Published dense peaks of one device."""

    bf16_tflops: float  # tensor cores, bf16 in / f32 accumulate
    tf32_tflops: float  # tensor cores, f32 in at TF32 (DEFAULT precision)
    f32_tflops: float  # f32 outside the tensor cores (HIGHEST precision)
    hbm_gbs: float
    source: str


_H100_SXM = Peaks(
    bf16_tflops=989.0,
    tf32_tflops=495.0,
    f32_tflops=67.0,
    hbm_gbs=3350.0,
    source="NVIDIA H100 SXM data sheet, dense, 700 W",
)

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks_for(device_kind: str) -> Peaks:
    """Peaks of the device named ``device_kind``; raises if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind={device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


_PAIRS_PEAK_GS: float | None = None
_PAIRS_PEAK_SRC: str | None = None


def set_pairs_peak(gpairs: float, provenance: str) -> None:
    """Install a measured pair-kernel ceiling (G pairs/s) + provenance."""
    global _PAIRS_PEAK_GS, _PAIRS_PEAK_SRC
    if gpairs > 0:
        _PAIRS_PEAK_GS = float(gpairs)
        _PAIRS_PEAK_SRC = str(provenance)


def pairs_peak() -> tuple[float | None, str | None]:
    """Installed pair ceiling (G pairs/s) and where it came from."""
    return _PAIRS_PEAK_GS, _PAIRS_PEAK_SRC


def matmul_flops(m: int, n: int, k: int) -> float:
    """2 m n k — one dense (m, k) @ (k, n)."""
    return 2.0 * m * n * k


def cholesky_flops(n: int) -> float:
    """n^3 / 3 — dense SPD factorisation."""
    return n**3 / 3.0


def trsm_flops(n: int, n_rhs: int) -> float:
    """n^2 * n_rhs — one triangular solve against n_rhs columns."""
    return float(n) * n * n_rhs


def cho_solve_flops(n: int, n_rhs: int) -> float:
    """Two triangular solves: 2 n^2 rhs."""
    return 2.0 * trsm_flops(n, n_rhs)


@dataclass
class Achieved:
    """Achieved rate + roofline fraction for one bench section."""

    tflops: float | None = None
    pct_roofline: float | None = None
    gpairs_per_s: float | None = None
    hbm_gbs: float | None = None

    def as_dict(self) -> dict:
        out = {}
        if self.tflops is not None:
            out["tflops"] = round(self.tflops, 1)
        if self.pct_roofline is not None:
            out["pct_roofline"] = round(self.pct_roofline, 1)
        if self.gpairs_per_s is not None:
            out["gpairs_per_s"] = round(self.gpairs_per_s, 1)
        if self.hbm_gbs is not None:
            out["hbm_gbs"] = round(self.hbm_gbs, 1)
        return out


def achieved_matmul(flops: float, wall_s: float,
                    peak_tflops: float) -> Achieved:
    """Achieved TFLOP/s and % of the given peak."""
    tf = flops / wall_s / 1e12
    return Achieved(tflops=tf, pct_roofline=100.0 * tf / peak_tflops)


def achieved_pairs(n_pairs: float, wall_s: float,
                   peak_gpairs: float | None = None) -> Achieved:
    """Achieved kernel-evaluation rate and % of the pair ceiling.

    ``peak_gpairs=None`` (default) uses the measured ceiling installed
    by ``set_pairs_peak``; with none installed, no share is reported.
    """
    if peak_gpairs is None:
        peak_gpairs = _PAIRS_PEAK_GS
    gp = n_pairs / wall_s / 1e9
    return Achieved(
        gpairs_per_s=gp,
        pct_roofline=None if peak_gpairs is None
        else 100.0 * gp / peak_gpairs,
    )


def achieved_bandwidth(bytes_moved: float, wall_s: float,
                       peak_gbs: float) -> Achieved:
    """Achieved GB/s and % of the given device-memory bandwidth."""
    gbs = bytes_moved / wall_s / 1e9
    return Achieved(hbm_gbs=gbs, pct_roofline=100.0 * gbs / peak_gbs)
