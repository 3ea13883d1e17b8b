r"""PSD repair: eigenvalue clipping for estimated covariance matrices.

Estimated covariances (ellipse-based assembly, short training series) are
routinely not positive-definite; these tools coerce them by eigenvalue
surgery and re-synthesis, with the spectrum computed on-device
(``jnp.linalg.eigh``). Capability parity with reference
``covariance_tools.py``:

- ``eigenvalue_clip`` (recommended): trace-preserving clip, dispatching to
  ``explained_variance_clip`` (keep top EOFs to a target explained
  variance, average the rest) or ``laloux_clip`` (random-matrix-theory
  noise threshold lambda_max = (1 + sqrt(q))^2 on the correlation matrix).
- ``simple_clipping``: raise eigenvalues below a LAPACK-accuracy-aware
  threshold (5 * dtype resolution * max |lambda|) to that threshold. Not
  trace-preserving. The reference offers iterative rank-1 updates vs a
  direct synthesis (``covariance_tools.py:338-370``); here both
  reassemble through the same batched matmul, so `method` only selects
  logging granularity.

The re-synthesis V diag(w) V' runs as two matmuls.
"""

import logging
import math
from dataclasses import dataclass
from typing import Any, Literal
from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.arrays import cor_2_cov, cov_2_cor
from .eigsh import PartialSpectrumError, adaptive_topk_eigh
from .sampling import Matvec, dense_matvec

logger = logging.getLogger(__name__)

__all_errors__ = (PartialSpectrumError,)  # re-exported for API stability

# Above this size "auto" clips switch from the full spectrum to the
# randomized top-k path: host LAPACK eigh is O(n^3) single-threaded
# (minutes at 8k, hours at 65k) while the clip needs only the top of the
# spectrum + the trace.
_AUTO_PARTIAL_THRESHOLD = 4096

# Above this size the parity wrappers refuse to densify a partial-clip
# result: an (n, n) f32 materialisation at 65k is ~17 GB — exactly the
# allocation the factored path exists to avoid.
_DENSIFY_GUARD = 32768


def check_symmetric(a, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """True if a matrix is symmetric within tolerance."""
    a = np.asarray(a)
    return bool(np.allclose(a, a.T, rtol=rtol, atol=atol))


def clean_small(matrix, atol: float = 1e-5):
    """Zero out entries with |x| < atol."""
    matrix = np.asarray(matrix)
    cleaned = matrix.copy()
    cleaned[np.abs(matrix) < atol] = 0.0
    return cleaned


def csum_up_to_val(
    vals,
    target: float,
    reverse: bool = True,
    niter: int = 0,
    csum: float = 0.0,
) -> tuple[float, int]:
    """Cumulative-sum index at which `target` is first exceeded.

    With `reverse` the array is walked from the end and the returned index
    is negative (indexing the unreversed array). Warns when the target is
    never exceeded or `vals` is empty.
    (Parity: reference ``covariance_tools.py:393-460``.)
    """
    vals = np.asarray(vals)
    if vals.size == 0:
        warn("`vals` is empty")
        return csum, niter
    if vals.ndim != 1:
        raise ValueError("`vals` must be a vector")

    # The returned index counts how many elements were consumed when the
    # running sum first exceeds the target (negated for a reversed walk),
    # so `vals[i:]` is exactly the exceeding tail.
    walk = vals[::-1] if reverse else vals
    csums = csum + np.cumsum(walk)
    exceed = np.nonzero(csums > target)[0]
    if csum > target:
        return csum, niter
    if exceed.size == 0:
        warn("Out of `vals`, target not exceeded.")
        i = len(walk)
        return float(csums[-1]), niter + (-i if reverse else i)
    i = int(exceed[0]) + 1
    return float(csums[i - 1]), niter + (-i if reverse else i)


@jax.jit
def _resynthesise(eigvecs, eigvals):
    """V diag(w) V' as two batched matmuls."""
    return (eigvecs * eigvals[None, :]) @ eigvecs.T


def _eigh(a):
    """Symmetric eigendecomposition on the device; eigenvalues on the
    host (the clip's rank search reads them there)."""
    w, v = jnp.linalg.eigh(jnp.asarray(a))
    return np.asarray(w), v


def _eigenvalue_clip(eigvals, eigvecs, keep_i: int):
    """Replace all but the top `-keep_i` eigenvalues by their average.

    Trace-preserving: the clipped eigenvalues' total mass is redistributed
    uniformly among them. Warns if the result is still not PD.
    """
    eigvals = np.asarray(eigvals)
    total_var = float(np.sum(eigvals))
    var_explained = float(np.sum(eigvals[keep_i:]))

    logger.info("total explained variance = %s", total_var)
    logger.info("clipped explained variance = %s", var_explained)

    if total_var < var_explained:
        explained_needed = float(np.sum(eigvals[keep_i + 1 :]))
        new_threshold = explained_needed / total_var
        raise ValueError(
            "Variance explained by retained eigenvalues exceeds total "
            "variance. Resulting matrix will have negative eigenvalues. "
            f"Try using a lower threshold. A value below {new_threshold:.2f} "
            "may work with "
            "glomargridding_jax.ops.covariance_tools.explained_variance_clip."
        )

    keep_i = keep_i if keep_i < 0 else -keep_i
    n_eigvals = len(eigvals)
    clip_i = n_eigvals + keep_i
    unexplained = total_var - var_explained
    avg_for_unexplained = unexplained / clip_i

    new_eigvals = eigvals.copy()
    new_eigvals[:keep_i] = avg_for_unexplained
    out = np.asarray(
        _resynthesise(jnp.asarray(eigvecs), jnp.asarray(new_eigvals))
    )

    if not (np.linalg.eigvalsh(out) > 0).all():
        warn(
            "Resulting matrix is not positive-definite, and may not be a "
            "valid covariance matrix."
        )
    return out


def _find_index_explained_variance(eigvals, target: float = 0.95) -> int:
    """Index (negative) of the smallest kept eigenvalue for a variance
    target."""
    total_variance = float(np.sum(eigvals))
    target_explained = target * total_variance
    csum, i2goal = csum_up_to_val(eigvals, target_explained)
    if csum <= target_explained:
        raise ValueError("Target Explained Variance not exceeded")
    return i2goal


def _find_index_aspect_ratio(
    eigvals,
    num_grid_pts: int = 180 * 360,
    num_times: int = 41 * 6,
) -> int:
    """Negative count of eigenvalues above the RMT noise ceiling.

    threshold = (1 + sqrt(q))^2, q = max(N/T, T/N) — the largest eigenvalue
    a correlation matrix of uncorrelated data can produce (Laloux 2000 /
    Bun 2017 S7.2.2).
    """
    q = num_grid_pts / num_times
    if q < 1.0:
        q = 1.0 / q
    threshold = (1.0 + np.sqrt(q)) ** 2.0
    return -int(np.sum(np.asarray(eigvals) > threshold))


# ---------------------------------------------------------------------------
# Device-scale (partial-spectrum) clipping
# ---------------------------------------------------------------------------
@dataclass
class LowRankPSD:
    r"""A clipped covariance in factored form: diag(floor) + W diag(g) W'.

    Both trace-preserving clips produce exactly this structure — the
    retained eigenspace keeps its spectrum, everything orthogonal to it
    gets a uniform eigenvalue (the "floor") — so at 65k the repaired
    covariance never needs to exist as an n x n array: matvecs are one
    (n, r) matmul pair and exact N(0, C) draws cost O(n(r + members))
    (``draw``), which plugs straight into the ensemble pipeline.
    """

    vectors: jax.Array  # (n, r); orthonormal iff floor is uniform
    gains: jax.Array  # (r,) nonnegative spectral surplus over the floor
    floor: jax.Array  # (n,) nonnegative diagonal floor

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def rank(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def effective_rank(self) -> int:
        """Columns carrying non-zero gain (excludes shape padding from
        ``rank_multiple`` / ``pad_rank``)."""
        return int(np.asarray(jnp.sum(self.gains > 0)))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    def matvec(self, x):
        """(diag(floor) + W g W') @ x for x of shape (n,) or (n, b)."""
        x = jnp.asarray(x)
        fl = self.floor if x.ndim == 1 else self.floor[:, None]
        g = self.gains if x.ndim == 1 else self.gains[:, None]
        return fl * x + self.vectors @ (g * (self.vectors.T @ x))

    def diagonal(self):
        return self.floor + jnp.sum(
            self.vectors**2 * self.gains[None, :], axis=1
        )

    def trace(self) -> float:
        # Exact for NON-orthonormal vectors too (laloux scales columns
        # by sqrt(diag)): tr(W g W') = sum_k g_k ||w_k||^2.
        return float(
            jnp.sum(self.floor)
            + jnp.sum(self.gains * jnp.sum(self.vectors**2, axis=0))
        )

    def to_dense(self) -> np.ndarray:
        out = (self.vectors * self.gains[None, :]) @ self.vectors.T
        return np.asarray(out + jnp.diag(self.floor))

    def draw(self, key, n_members: int):
        """(n_members, n) exact draws of N(0, diag(floor) + W g W')."""
        k1, k2 = jax.random.split(jnp.asarray(key))
        dt = self.vectors.dtype
        z1 = jax.random.normal(k1, (self.n, n_members), dt)
        z2 = jax.random.normal(k2, (self.rank, n_members), dt)
        x = jnp.sqrt(self.floor)[:, None] * z1 + self.vectors @ (
            jnp.sqrt(self.gains)[:, None] * z2
        )
        return x.T

    def pad_rank(self, multiple: int = 128) -> "LowRankPSD":
        """Pad the factors with zero-gain columns to a rank multiple.

        Numerically inert (zero gains contribute nothing to W g W',
        draws, or the solvers), but operationally important in
        production: the adaptive clips return a DIFFERENT rank per
        month, and every distinct rank is a fresh compiled program for
        the downstream ensemble step. Padding to a fixed multiple keeps
        the compiled shapes stable across months and aligned for the
        matmuls.
        """
        if multiple < 1:
            raise ValueError("multiple must be >= 1")
        r = self.rank
        r_pad = -(-r // multiple) * multiple
        if r_pad == r:
            return self
        dt = self.vectors.dtype
        vecs = jnp.pad(self.vectors, ((0, 0), (0, r_pad - r)))
        gains = jnp.pad(self.gains.astype(dt), (0, r_pad - r))
        return LowRankPSD(vectors=vecs, gains=gains, floor=self.floor)


def _adaptive_topk(matvec, n, accept, k0, max_rank, **topk_kwargs):
    """Find the retained rank a clip needs (``ops.eigsh``
    :func:`adaptive_topk_eigh`): residual-certified early acceptance at
    width ~ r + oversample, the round-2 ``r <= k // 2`` structural rule
    as the provable fallback, warm-started widening."""
    return adaptive_topk_eigh(
        matvec, accept, n, k0=k0, max_rank=max_rank, **topk_kwargs
    )


def explained_variance_clip_lowrank(  # noqa: C901
    operator,
    n: int | None = None,
    trace: float | None = None,
    target_variance_fraction: float = 0.95,
    *,
    key=None,
    k0: int = 64,
    max_rank: int = 2048,
    oversample: int = 8,
    n_iter: int = 6,
    tol: float | None = None,
    rank_multiple: int = 1,
    dtype=None,
) -> LowRankPSD:
    """Trace-preserving explained-variance clip WITHOUT the full spectrum.

    The clip keeps the top-r eigenpairs (r = smallest count whose
    eigenvalues exceed ``target_variance_fraction`` of the trace) and
    assigns every remaining direction their average eigenvalue — which is
    exactly ``avg * I + V_r diag(w_r - avg) V_r'``, so only the top of the
    spectrum is ever computed (randomized subspace iteration,
    ``ops.eigsh``). Accepts a dense matrix or a matvec callable (with `n`
    and `trace` supplied); the 65k path passes
    ``ops.sampling.kernel_matvec`` / ``dense_matvec`` and never
    materialises anything n x n. (Scale analog of reference
    ``covariance_tools.py:633-728`` + ``:325``.)
    """
    if not 0.0 < target_variance_fraction <= 1.0:
        raise ValueError("'target_variance_fraction' must be (0, 1.0]")
    if not callable(operator):
        A = jnp.asarray(operator)
        trace = float(jnp.trace(A)) if trace is None else trace
        n = A.shape[0]
        matvec = None
    else:
        if n is None or trace is None:
            raise ValueError(
                "n and trace are required for a callable operator"
            )
        matvec = operator
    target = target_variance_fraction * trace

    def accept(w):
        csum = np.cumsum(w)
        hit = np.nonzero(csum > target)[0]
        return int(hit[0]) + 1 if hit.size else None

    def predict(w, k):
        """Estimate the rank the variance target needs by geometric
        extrapolation of the computed Ritz tail.

        Blind k-doubling overshoots the needed subspace width by up to
        2x, and every extra column costs a full operator sweep's
        matmul width (wall-clock on streamed operators). The decaying
        spectra this clip exists for are locally ~geometric, so the
        tail ratio of the last quarter of the head predicts how many
        more eigenvalues reach the target; the solver clamps the
        prediction to [k + step, 2k], so the provable doubling
        schedule is the worst case.
        """
        wv = np.asarray(w, np.float64)
        wv = wv[wv > 0]
        L = wv.size
        if L < 8:
            return None
        remaining = target - float(wv.sum())
        if remaining <= 0:
            return L
        q = max(4, L // 4)
        a, b = wv[L - q], wv[L - 1]
        if b <= 0 or a <= b * (1.0 + 1e-12):
            return None  # tail not decaying: no basis to extrapolate
        rho = (b / a) ** (1.0 / (q - 1))
        rho = min(max(rho, 1e-9), 0.99999)
        geo_inf = b * rho / (1.0 - rho)
        if geo_inf <= remaining:
            return None  # even an infinite geometric tail falls short
        x = remaining * (1.0 - rho) / (b * rho)
        m = int(math.ceil(math.log1p(-x) / math.log(rho)))
        return L + max(m, 1)

    w, V, r = _adaptive_topk(
        matvec if matvec is not None else A,
        n,
        accept,
        k0,
        max_rank,
        key=key,
        oversample=oversample,
        n_iter=n_iter,
        tol=tol,
        rank_multiple=rank_multiple,
        dtype=dtype,
        predict=predict,
    )
    retained = w[:r]
    var_explained = float(retained.sum())
    if trace < var_explained:
        rel_excess = (var_explained - trace) / max(abs(trace), 1e-30)
        if r < n and rel_excess > 1e-4:
            new_threshold = float(retained[:-1].sum()) / trace
            raise ValueError(
                "Variance explained by retained eigenvalues exceeds "
                "total variance. Resulting matrix will have negative "
                "eigenvalues. Try using a lower threshold. A value "
                f"below {new_threshold:.2f} may work."
            )
        # full-rank retention / solver roundoff: the clip is (near-)
        # exact — clamp instead of failing
        var_explained = trace
    # r == n: everything retained — the clip is exact, floor is 0
    avg = 0.0 if r >= n else (trace - var_explained) / (n - r)
    logger.info("total explained variance = %s", trace)
    logger.info("clipped explained variance = %s", var_explained)
    # re-normalise the retained columns: the solver's wide basis is
    # only ~1e-3 orthonormal in f32 when the operator's numerical rank
    # is below the iteration width, and tr(W g W') depends directly on
    # the column norms (trace preservation would silently degrade).
    # V may be rank_multiple-padded (stable compiled shapes across
    # months); padding columns get zero gain, built HOST-side so no
    # device program depends on the exact rank r.
    vecs = V / jnp.sqrt(jnp.sum(V**2, axis=0))[None, :]
    rp = int(V.shape[1])
    g_host = np.zeros(rp, dtype=np.float64)
    g_host[:r] = np.maximum(np.asarray(retained, np.float64) - avg, 0.0)
    gains = jnp.asarray(g_host, vecs.dtype)
    floor = jnp.full((n,), avg, vecs.dtype)
    return LowRankPSD(vectors=vecs, gains=gains, floor=floor)


def _make_cor_apply(base_fn):
    """D^{-1/2} A D^{-1/2} application preserving the Matvec split."""

    def apply(inv_d, *rest):
        *base_ops, X = rest
        scale = inv_d if X.ndim == 1 else inv_d[:, None]
        return scale * base_fn(*base_ops, scale * X)

    return apply


_COR_MV_BY_FN: dict = {}


def laloux_clip_lowrank(  # noqa: C901
    operator,
    diag=None,
    n: int | None = None,
    num_grid_pts: int | None = None,
    num_time_pts: int = 40,
    *,
    key=None,
    k0: int = 64,
    max_rank: int = 2048,
    oversample: int = 8,
    n_iter: int = 6,
    tol: float | None = None,
    rank_multiple: int = 1,
    dtype=None,
) -> LowRankPSD:
    """RMT (Laloux 2000) clip without the full spectrum.

    Standardises to the correlation operator, keeps every eigenvalue above
    the random-matrix ceiling (1 + sqrt(q))^2, floors the rest at their
    average (trace of a correlation matrix = n), and rescales back by the
    variances. `diag` (the covariance diagonal) is required for callable
    operators. (Scale analog of reference ``covariance_tools.py:519-630``.)
    """
    if not callable(operator):
        A = jnp.asarray(operator)
        n = A.shape[0]
        diag = jnp.diagonal(A) if diag is None else jnp.asarray(diag)
        base_mv = dense_matvec(
            A, compute_dtype=jnp.float32
            if A.dtype == jnp.bfloat16 else A.dtype,
        )
    else:
        if n is None or diag is None:
            raise ValueError(
                "n and diag are required for a callable operator"
            )
        diag = jnp.asarray(diag)
        base_mv = operator
    d = jnp.sqrt(diag)
    inv_d = 1.0 / d

    # keep the Matvec structure (static fn + operands) when the base
    # operator has it, so the adaptive solver's fused-stage dispatch
    # path survives the correlation standardisation
    if isinstance(base_mv, Matvec):
        fn = _COR_MV_BY_FN.setdefault(
            base_mv.fn, _make_cor_apply(base_mv.fn)
        )
        cor_mv = Matvec(fn, inv_d, *base_mv.operands)
    else:

        def cor_mv(X):
            scale = inv_d if X.ndim == 1 else inv_d[:, None]
            return scale * jnp.asarray(base_mv(scale * X))

    num_grid_pts = num_grid_pts or n
    q = num_grid_pts / num_time_pts
    if q < 1.0:
        q = 1.0 / q
    threshold = (1.0 + np.sqrt(q)) ** 2.0

    def accept(w):
        # all above-threshold pairs are captured once the computed head
        # dips below the ceiling
        if w[-1] > threshold:
            return None
        return max(int(np.sum(w > threshold)), 1)

    def predict(w, k):
        """Rank estimate: geometric tail extrapolation to where the
        spectrum crosses the RMT ceiling (see the explained-variance
        predictor for rationale; the solver clamps to [k + step, 2k])."""
        wv = np.asarray(w, np.float64)
        wv = wv[wv > 0]
        L = wv.size
        if L < 8:
            return None
        b = wv[-1]
        if b <= threshold:
            return L
        qq = max(4, L // 4)
        a = wv[L - qq]
        if a <= b * (1.0 + 1e-12):
            return None  # tail not decaying
        rho = (b / a) ** (1.0 / (qq - 1))
        rho = min(max(rho, 1e-9), 0.99999)
        m = int(math.ceil(math.log(threshold / b) / math.log(rho)))
        return L + max(m, 1)

    w, V, r = _adaptive_topk(
        cor_mv,
        n,
        accept,
        k0,
        max_rank,
        key=key,
        oversample=oversample,
        n_iter=n_iter,
        tol=tol,
        rank_multiple=rank_multiple,
        dtype=dtype,
        predict=predict,
    )
    retained = w[:r]
    avg = 0.0 if r >= n else (n - float(retained.sum())) / (n - r)
    if avg < 0:
        raise ValueError(
            "Retained eigenvalues exceed the correlation trace; the "
            "aspect-ratio threshold retained too much variance."
        )
    # unit-normalise the correlation eigenvectors before the sqrt(diag)
    # scaling (see explained_variance_clip_lowrank); V may be
    # rank_multiple-padded — zero gains on the padding columns
    Vr = V / jnp.sqrt(jnp.sum(V**2, axis=0))[None, :]
    vecs = d[:, None] * Vr
    rp = int(V.shape[1])
    g_host = np.zeros(rp, dtype=np.float64)
    g_host[:r] = np.maximum(np.asarray(retained, np.float64) - avg, 0.0)
    gains = jnp.asarray(g_host, vecs.dtype)
    floor = avg * diag.astype(vecs.dtype)
    return LowRankPSD(vectors=vecs, gains=gains, floor=floor)


Spectrum = Literal["auto", "full", "partial"]


def _shape0(cov) -> int:
    """Leading dimension WITHOUT np.asarray: that forces a full
    device-to-host copy of the covariance (seconds at large n) just to
    read a shape."""
    shape = getattr(cov, "shape", None)
    if shape is None:
        shape = np.asarray(cov).shape
    return int(shape[0])


def _use_partial(n: int, spectrum: Spectrum) -> bool:
    match spectrum:
        case "full":
            return False
        case "partial":
            return True
        case "auto":
            return n > _AUTO_PARTIAL_THRESHOLD
        case _:
            raise ValueError(f"unknown spectrum mode {spectrum!r}")


def explained_variance_clip(
    cov,
    target_variance_fraction: float = 0.95,
    spectrum: Spectrum = "auto",
    **partial_kwargs,
):
    """Trace-preserving clip keeping EOFs up to a target explained variance.

    Eigenvalues outside the retained set (small positive and negative) are
    replaced by their common average so the total variance is conserved.
    ``spectrum`` selects the eigensolver: "full" (exact LAPACK spectrum),
    "partial" (randomized top-k — the only path that scales past ~10k),
    or "auto" (partial above n=4096). Both return the same matrix to
    solver accuracy (pinned by tests).

    Return-type contract: for a DENSE input up to n=32768 the repaired
    matrix comes back dense (reference parity). For a CALLABLE operator,
    or a dense input past that guard, the result is the factored
    :class:`LowRankPSD` — densifying it would allocate the n x n array
    (~17 GB at 65k) that the matvec path exists to avoid; call
    ``.to_dense()`` explicitly if the allocation is truly wanted, or use
    :func:`explained_variance_clip_lowrank` directly.
    (Parity: reference ``covariance_tools.py:633-728``.)
    """
    n = _shape0(cov) if not callable(cov) else None
    if callable(cov) or _use_partial(n, spectrum):
        try:
            lr = explained_variance_clip_lowrank(
                cov,
                target_variance_fraction=target_variance_fraction,
                **partial_kwargs,
            )
            if callable(cov):
                return lr
            if n > _DENSIFY_GUARD:
                # LOUD: the caller handed us a dense matrix and gets a
                # different type back — a log line is too easy to miss
                warn(
                    f"explained_variance_clip: n={n} > "
                    f"{_DENSIFY_GUARD} returns the factored LowRankPSD "
                    "(densifying would allocate the n^2 array the "
                    "partial path avoids); call .to_dense() explicitly "
                    "or use explained_variance_clip_lowrank"
                )
                return lr
            return lr.to_dense()
        except PartialSpectrumError:
            # spectrum too flat for a low-rank clip: under "auto" a
            # dense input falls back to the exact full path (0.1.0
            # behaviour); explicit "partial" or a callable re-raises.
            # (Only this specific non-convergence triggers the
            # fallback — argument errors still surface.)
            if callable(cov) or spectrum != "auto":
                raise
            logger.warning(
                "partial-spectrum clip did not converge; falling back "
                "to the full host eigh (n=%s)", n,
            )
    if not 0.0 < target_variance_fraction <= 1.0:
        raise ValueError("'target_variance_fraction' must be (0, 1.0]")
    eigvals, eigvecs = _eigh(cov)
    keep_i = _find_index_explained_variance(
        eigvals, target=target_variance_fraction
    )
    return _eigenvalue_clip(eigvals, eigvecs, keep_i)


def laloux_clip(
    cov,
    num_grid_pts: int | None = None,
    num_time_pts: int = 40,
    spectrum: Spectrum = "auto",
    **partial_kwargs,
):
    """RMT (Laloux 2000) clip on the correlation matrix.

    Standardise to correlation, clip eigenvalues below the random-matrix
    ceiling (1 + sqrt(q))^2, rescale back to covariance with the original
    variances. ``spectrum`` as in :func:`explained_variance_clip`,
    including the return-type contract: callable operators and dense
    inputs past n=32768 come back as the factored :class:`LowRankPSD`
    (never an implicit n x n materialisation).
    (Parity: reference ``covariance_tools.py:519-630``.)
    """
    n = _shape0(cov) if not callable(cov) else None
    if callable(cov) or _use_partial(n, spectrum):
        try:
            lr = laloux_clip_lowrank(
                cov,
                num_grid_pts=num_grid_pts,
                num_time_pts=num_time_pts,
                **partial_kwargs,
            )
            if callable(cov):
                return lr
            if n > _DENSIFY_GUARD:
                warn(
                    f"laloux_clip: n={n} > {_DENSIFY_GUARD} returns "
                    "the factored LowRankPSD (densifying would "
                    "allocate the n^2 array the partial path avoids); "
                    "call .to_dense() explicitly or use "
                    "laloux_clip_lowrank"
                )
                return lr
            return lr.to_dense()
        except PartialSpectrumError:
            if callable(cov) or spectrum != "auto":
                raise
            # flat spectrum under "auto": exact full-path fallback
            logger.warning(
                "partial-spectrum clip did not converge; falling back "
                "to the full host eigh (n=%s)", n,
            )
    cov = np.asarray(cov)
    num_grid_pts = num_grid_pts or cov.shape[0]
    variances = np.diag(cov)
    cor = cov_2_cor(cov)

    eigvals, eigvecs = _eigh(cor)
    keep_i = _find_index_aspect_ratio(
        np.asarray(eigvals),
        num_grid_pts=num_grid_pts,
        num_times=num_time_pts,
    )
    clipped_cor = _eigenvalue_clip(np.asarray(eigvals), eigvecs, keep_i)
    return cor_2_cov(clipped_cor, variances)


def eigenvalue_clip(
    cov,
    method: Literal["explained_variance", "Laloux_2000"] = (
        "explained_variance"
    ),
    **kwargs,
):
    """Denoise a damaged covariance by eigenvalue clipping (recommended).

    (Parity: reference ``covariance_tools.py:788-847``.)
    """
    match method:
        case "explained_variance":
            return explained_variance_clip(cov, **kwargs)
        case "Laloux_2000":
            return laloux_clip(cov, **kwargs)
        case _:
            raise ValueError("Unknown clipping method")


def simple_clipping(
    cov,
    threshold: float | Literal["auto", "statsmodels_default"] = "auto",
    method: Literal["iterative", "direct"] = "iterative",
) -> tuple[np.ndarray, dict[str, Any]]:
    """Raise eigenvalues below a threshold to the threshold.

    'auto' threshold = 5 * dtype resolution * max|lambda| (the LAPACK
    eigenvalue accuracy bound); 'statsmodels_default' = 1e-15 (unsuitable
    for f32 inputs, kept for comparison). Not trace-preserving. Returns
    (adjusted covariance, summary dict with threshold / smallest_eigv /
    determinant / total_variance).
    (Parity: reference ``covariance_tools.py:206-390``; the iterative
    rank-1 route and the direct route coincide here — both synthesise
    V diag(w_new) V' in one fused matmul pass.)
    """
    cov = np.asarray(cov)
    eigvals, eigvecs = _eigh(cov)
    eigvals_np = np.asarray(eigvals)
    max_abs = float(np.max(np.abs(eigvals_np)))

    if threshold == "auto":
        finfo = np.finfo(eigvals_np.dtype)
        threshold = float(5.0 * finfo.resolution * max_abs)
    elif threshold == "statsmodels_default":
        threshold = 1e-15
    if not isinstance(threshold, (float, int)):
        raise TypeError(
            "threshold must either be number, auto or statsmodels_default. "
            f"Got {threshold = }."
        )

    n_below = int(np.sum(eigvals_np < threshold))
    if n_below == len(eigvals_np):
        warn("Input has all negative eigenvalues")
    logger.info("Minimum eigenvalue threshold = %s", threshold)
    logger.info("Eigenvalues below threshold = %s", n_below)

    new_eigvals = np.maximum(eigvals_np, threshold)
    cov_adj = np.asarray(
        _resynthesise(eigvecs, jnp.asarray(new_eigvals))
    )

    new_eigv = np.linalg.eigvalsh(cov_adj)
    meta = {
        "threshold": threshold,
        "smallest_eigv": float(np.min(new_eigv)),
        "determinant": float(np.linalg.det(cov_adj)),
        "total_variance": float(np.sum(np.diag(cov_adj))),
    }
    return cov_adj, meta


def perturb_cov_to_positive_definite(
    cov, threshold: float | Literal["auto"] = 1e-15
):
    """Deprecated statsmodels-based clip; delegates to simple_clipping."""
    warn(
        "This function is deprecated in favour of "
        "'glomargridding_jax.ops.covariance_tools.simple_clipping'",
        DeprecationWarning,
    )
    cov = np.asarray(cov)
    shape = cov.shape
    if len(shape) != 2 or shape[0] != shape[1] or not check_symmetric(cov):
        raise ValueError("Matrix is not square and/or symmetric.")
    eigenvalues = np.linalg.eigvalsh(cov)
    if float(np.min(eigenvalues)) >= 0.0:
        return cov
    adj, _ = simple_clipping(cov, threshold=threshold)
    return adj
