r"""Kriging solvers (Simple / Ordinary), Cholesky-first on the device.

Capability parity with reference ``kriging.py`` (classes, deprecated
function forms, obs-prep helpers, Guttman extended inverse), with the
numerics re-designed for an accelerator:

- One Cholesky factorisation of :math:`K = C_{obs} + E` drives everything.
  The ordinary-kriging Lagrange system is solved as a *bordered* system
  reusing the factor — never materialising or factorising the (n+1) x (n+1)
  indefinite extended matrix (reference builds and LU-solves it at
  ``kriging.py:579-585``):

  .. math::
      w_j = V_j - \lambda_j u, \qquad
      \lambda_j = \frac{\mathbf{1}^T V_j - 1}{\mathbf{1}^T u},

  with :math:`V = K^{-1} C_{cross}` and :math:`u = K^{-1}\mathbf{1}`.

- Uncertainty and constraint-mask diagonals are streamed reductions
  (``einsum('nm,nm->m')``) over C_cross and V — O(nM) memory. The reference
  forms the full M x M product ``W @ C_cross`` for its diagonal
  (``kriging.py:700``), which is O(M^2) and the dominant cost at scale.

- The ordinary-kriging uncertainty defaults to the reference's published
  formula (``kriging.py:699-701``): ``diag(C) - (w_j'c_j + lambda_j)
  - lambda_j`` — the multiplier is subtracted twice, which is a known
  quirk of the reference we replicate bit-for-bit for parity (its class
  and function forms agree with each other and with its tests).
  ``OrdinaryKriging(..., uncertainty="textbook")`` (and the same switch
  on ``StochasticKriging``) selects the standard OK variance
  ``diag(C) - w_j'c_j - lambda_j`` (one subtraction) instead.

All solver maths is jitted; classes are thin host-side wrappers holding
device arrays and matching the reference's constructor/attribute surface
(``covariance``, ``idx``, ``obs``, ``error_cov``, ``kriging_weights``).
"""

from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Literal
from warnings import warn

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

from ..utils.arrays import (
    adjust_small_negative,
    get_spatial_mean,
    intersect_mtlb,
)

KrigMethod = Literal["simple", "ordinary"]


# ===========================================================================
# Functional core (jitted)
# ===========================================================================
@jax.jit
def _gather_obs_blocks(covariance, idx):
    """C_obs (n x n), C_cross (n x M), diag(C) from a dense covariance."""
    obs_obs = covariance[idx[:, None], idx[None, :]]
    obs_grid = covariance[idx, :]
    return obs_obs, obs_grid, jnp.diagonal(covariance)


def _solve_sym(K, B):
    """Solve K X = B: Cholesky when SPD, LU fallback otherwise.

    Kriging systems built from true covariances are SPD and take the
    cheap Cholesky path; variogram-style systems (zero diagonal,
    conditionally negative definite — the GeoStats.jl configuration)
    are indefinite but invertible, so we fall back to LU, branch-free
    under jit via ``lax.cond``.
    """
    L = jnp.linalg.cholesky(K)
    spd = ~jnp.isnan(L[-1, -1])

    def cho_path(operands):
        L_, _, B_ = operands
        return jsl.cho_solve((L_, True), B_)

    def lu_path(operands):
        _, K_, B_ = operands
        return jnp.linalg.solve(K_, B_)

    return jax.lax.cond(spd, cho_path, lu_path, (L, K, B))


@jax.jit
def _simple_core(K, C_cross, C_diag, y, mean):
    """Simple kriging: field, uncertainty^2, constraint mask, V.

    V = K^{-1} C_cross; field = V'y + mean; sigma^2 = diag(C) - sum(C.*V);
    mask = sum(C.*V)/diag(C).
    """
    V = _solve_sym(K, C_cross)
    field = V.T @ y + mean
    sv = jnp.einsum("nm,nm->m", C_cross, V)
    uncert2 = C_diag - sv
    cmask = sv / C_diag
    return field, uncert2, cmask, V


@jax.jit
def _ordinary_core(K, C_cross, C_diag, y):
    """Ordinary kriging via the bordered system on one factorisation.

    Returns field, uncertainty^2 (reference formula), constraint mask
    (simple-weights based), V, u, lambda.
    """
    n = K.shape[0]
    ones = jnp.ones((n, 1), K.dtype)
    # One factorisation for both right-hand sides.
    Vu = _solve_sym(K, jnp.concatenate([C_cross, ones], axis=1))
    V = Vu[:, :-1]
    u = Vu[:, -1]
    s = jnp.sum(u)
    t = jnp.sum(V, axis=0)
    lam = (t - 1.0) / s
    # field_j = w_j' y with w_j = V_j - lam_j u (the appended 0 obs
    # contributes nothing).
    uy = u @ y
    field = V.T @ y - lam * uy
    sv = jnp.einsum("nm,nm->m", C_cross, V)
    # w_j'c_j = sv_j - lam_j * (u' c_j), and u'c_j = 1'K^{-1}c_j = t_j
    wc = sv - lam * t
    # Reference formula (kriging.py:699-701): diag(C) - (w'c + lam) - lam.
    uncert2 = C_diag - (wc + lam) - lam
    cmask = sv / C_diag
    return field, uncert2, cmask, V, u, lam


@jax.jit
def _extended_inverse_jax(simple_inv):
    """Guttman (1946) block inverse of [[S, 1], [1', 0]] from S^{-1}.

    Kept for API parity (reference ``kriging.py:815-829``); the solver path
    itself never forms it.
    """
    n = simple_inv.shape[0]
    B = jnp.ones((n, 1), simple_inv.dtype)
    E = simple_inv @ B
    f = -(B.T @ E)
    finv = 1.0 / f
    G = finv * E.T
    K = simple_inv + E @ G
    top = jnp.concatenate([K, -G.T], axis=1)
    bottom = jnp.concatenate([-G, finv], axis=1)
    return jnp.concatenate([top, bottom], axis=0)


def _extended_inverse(simple_inv):
    """Host-facing Guttman extended inverse (validates input rank)."""
    if simple_inv.ndim != 2:
        raise ValueError("S must be a matrix")
    return np.asarray(_extended_inverse_jax(jnp.asarray(simple_inv)))


def _finalise_uncert(uncert2):
    """sqrt of clamped squared uncertainty, NaN -> 0 (host side)."""
    uncert2 = adjust_small_negative(np.asarray(uncert2))
    with np.errstate(invalid="ignore"):
        uncert = np.sqrt(uncert2)
    uncert[np.isnan(uncert)] = 0.0
    return uncert


class _CovDeviceCache:
    """Size-capped LRU of device copies of host covariance matrices.

    Plain ``np.ndarray`` is not weakref-able, so eviction cannot ride the
    host array's garbage collection; instead each entry pins the host
    array (which also makes the ``id`` key collision-proof: an id cannot
    be reused while the entry holds a reference) and the cache is bounded
    to `max_entries` device copies, evicting least-recently-used. One 65k
    f32 covariance is ~17 GB of HBM, so the bound is deliberately tiny —
    the canonical ensemble loop builds many solvers from ONE covariance.
    """

    def __init__(self, max_entries: int = 2):
        self.max_entries = max_entries
        self._entries: "OrderedDict[int, tuple]" = OrderedDict()

    def get_or_put(self, host_array):
        key = id(host_array)
        hit = self._entries.get(key)
        if hit is not None and hit[0] is host_array:
            self._entries.move_to_end(key)
            return hit[1]
        device_array = jnp.asarray(host_array)
        self._entries[key] = (host_array, device_array)
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return device_array

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()


# Shared across solver instances (see Kriging._cov_device).
_COV_DEVICE_CACHE = _CovDeviceCache()


# ===========================================================================
# Classes
# ===========================================================================
class Kriging(ABC):
    """Kriging base: holds covariance C, obs indices, obs values, error cov.

    Use SimpleKriging / OrdinaryKriging / StochasticKriging. `idx` are
    row-major ("C"-order) 1-d grid indices of observed grid boxes, one per
    box (multiple obs per box must be pre-averaged, see
    ``prep_obs_for_kriging``). If `error_cov` is full-grid sized it is
    subset to `idx`; observations whose error-cov diagonal is NaN or 0 are
    dropped with a warning and remaining NaNs zero-filled (parity:
    reference ``kriging.py:89-121``).
    """

    def __init__(self, covariance, idx, obs, error_cov=None) -> None:
        if not hasattr(self, "method"):
            raise NotImplementedError(
                "Do not use the generic class directly, "
                "use SimpleKriging or OrdinaryKriging"
            )
        self.covariance = np.asarray(covariance)
        self.idx = np.asarray(idx)
        self.obs = np.asarray(obs)
        self.error_cov = (
            None if error_cov is None else np.asarray(error_cov)
        )
        self.subset_error_covariance()

    def subset_error_covariance(self) -> None:
        """Subset E to obs indices; drop NaN/zero-diagonal observations."""
        if self.error_cov is None:
            return
        if self.error_cov.shape[0] != len(self.idx):
            self.error_cov = self.error_cov[
                self.idx[:, None], self.idx[None, :]
            ]
        diag = self.error_cov.diagonal()
        mismatch = np.isnan(diag) | (diag == 0)
        if mismatch.any():
            idx_keep = np.where(~mismatch)[0]
            drop_idx = self.idx[mismatch].tolist()
            warn(
                "Have nans or zeros on the error covariance diagonal. "
                "At positions "
                + " ,".join(map(str, drop_idx))
                + ". Filtering input accordingly"
            )
            self.idx = self.idx[idx_keep]
            self.obs = self.obs[idx_keep]
            self.error_cov = self.error_cov[
                idx_keep[:, None], idx_keep[None, :]
            ]
        self.error_cov = np.nan_to_num(self.error_cov, nan=0.0)

    # -- shared device-side pieces -----------------------------------------
    def _cov_device(self):
        """Device copy of the covariance (uploaded once, then cached).

        The cache is shared across solver instances keyed on the host
        array's identity: the canonical ensemble loop constructs a fresh
        solver per member from ONE covariance, and re-uploading an
        N x N matrix per member would dominate the step time. The
        cache is a tiny LRU (device-memory-sized matrices; see
        :class:`_CovDeviceCache`).
        """
        if getattr(self, "_cov_dev", None) is None:
            self._cov_dev = _COV_DEVICE_CACHE.get_or_put(self.covariance)
        return self._cov_dev

    def _blocks(self):
        """(K, C_cross, C_diag) on device, error covariance folded in.

        Gathered blocks are cached — the covariance crosses the host
        link at most once per solver instance.
        """
        if getattr(self, "_blocks_cache", None) is not None:
            return self._blocks_cache
        cov = self._cov_device()
        idx = jnp.asarray(self.idx)
        obs_obs, obs_grid, diag = _gather_obs_blocks(cov, idx)
        if self.error_cov is not None:
            obs_obs = obs_obs + jnp.asarray(
                self.error_cov, dtype=obs_obs.dtype
            )
        self._blocks_cache = (obs_obs, obs_grid, diag)
        return self._blocks_cache

    def set_kriging_weights(self, kriging_weights) -> None:
        """Inject pre-computed kriging weights."""
        self.kriging_weights = np.asarray(kriging_weights)

    @abstractmethod
    def get_kriging_weights(self) -> None: ...

    @abstractmethod
    def kriging_weights_from_inverse(self, inv) -> None: ...

    @abstractmethod
    def solve(self): ...

    @abstractmethod
    def get_uncertainty(self): ...

    @abstractmethod
    def constraint_mask(self): ...


class SimpleKriging(Kriging):
    r"""Simple kriging: field = W y + mu with W = (C_obs+E)^{-1} C_cross.

    (Parity: reference ``kriging.py:282-491``; solve path is Cholesky +
    streamed diagonals instead of LU + dense M x M products.)
    """

    method: str = "simple"

    def get_kriging_weights(self) -> None:
        """Compute (and set) the M x n simple kriging weights W.

        Weights stay device-resident: pulling an M x n matrix to the
        host can cost more than the solve, and every consumer is a
        device computation.
        """
        K, C_cross, _ = self._blocks()
        self.kriging_weights = _solve_sym(K, C_cross).T

    def kriging_weights_from_inverse(self, inv) -> None:
        """Set weights from a pre-computed (C_obs+E)^{-1}."""
        if len(self.idx) != inv.shape[0]:
            raise ValueError("inv must be square with side length == len(idx)")
        _, C_cross, _ = self._blocks()
        self.kriging_weights = (jnp.asarray(inv) @ C_cross).T

    def solve(self, mean=0.0):
        """Kriged field W y + mean (uses cached weights when present)."""
        if hasattr(self, "kriging_weights"):
            return np.asarray(
                jnp.asarray(self.kriging_weights)
                @ jnp.asarray(self.obs, jnp.asarray(self.kriging_weights).dtype)
                + mean
            )
        K, C_cross, C_diag = self._blocks()
        field, uncert2, cmask, V = _simple_core(
            K, C_cross, C_diag, jnp.asarray(self.obs, K.dtype), mean
        )
        self.kriging_weights = V.T  # device-resident
        self._uncert2 = uncert2
        self._cmask = cmask
        return np.asarray(field)

    def get_uncertainty(self):
        """sqrt(diag(C) - diag(W C_cross)), small negatives clamped."""
        if hasattr(self, "_uncert2"):
            return _finalise_uncert(self._uncert2)
        if not hasattr(self, "kriging_weights"):
            raise KeyError("Please compute Kriging Weights first")
        _, C_cross, C_diag = self._blocks()
        W = jnp.asarray(self.kriging_weights)
        uncert2 = C_diag - jnp.einsum("nm,mn->m", C_cross, W)
        return _finalise_uncert(uncert2)

    def constraint_mask(self):
        """Observational-constraint diagnostic (Morice 2021 A14, corrected).

        diag(C_cross' (C_obs+E)^{-1} C_cross) / diag(C); mask where < 0.25.
        """
        if hasattr(self, "_cmask"):
            return np.asarray(self._cmask)
        if not hasattr(self, "kriging_weights"):
            raise KeyError("Please compute Kriging Weights first")
        _, C_cross, C_diag = self._blocks()
        W = jnp.asarray(self.kriging_weights)
        num = jnp.einsum("nm,mn->m", C_cross, W)
        return np.asarray(num / C_diag)


class OrdinaryKriging(Kriging):
    r"""Ordinary kriging: Lagrange-constrained weights summing to 1.

    The reference extends the system with a ones row/column and LU-solves
    the (n+1) x (n+1) matrix (``kriging.py:540-588``); here the bordered
    solve reuses one SPD Cholesky factor (see module docstring). The
    exposed `kriging_weights` attribute keeps the reference's layout:
    M x (n+1) with the Lagrange multiplier in the last column.

    ``uncertainty`` selects the variance convention: "reference"
    (default) replicates the reference's double lambda subtraction
    (``kriging.py:699-701``); "textbook" subtracts the Lagrange
    multiplier once (the standard OK variance).
    """

    method: str = "ordinary"

    def __init__(
        self,
        covariance,
        idx,
        obs,
        error_cov=None,
        *,
        uncertainty: Literal["reference", "textbook"] = "reference",
    ) -> None:
        if uncertainty not in ("reference", "textbook"):
            raise ValueError(
                f"Unknown 'uncertainty' convention: {uncertainty!r}"
            )
        self.uncertainty_convention = uncertainty
        super().__init__(
            covariance=covariance, idx=idx, obs=obs, error_cov=error_cov
        )

    def _full_solve(self):
        K, C_cross, C_diag = self._blocks()
        y = jnp.asarray(self.obs, K.dtype)
        field, uncert2, cmask, V, u, lam = _ordinary_core(
            K, C_cross, C_diag, y
        )
        # Reference-layout weights: rows w_j = V_j - lam_j u, last col lam.
        # Kept as a device array: pulling an M x (n+1) matrix to the host
        # is pure overhead unless the user reads it.
        W = V.T - lam[:, None] * u[None, :]
        self.kriging_weights = jnp.concatenate([W, lam[:, None]], axis=1)
        self._uncert2 = uncert2
        self._lam = lam
        self._cmask = cmask
        self._field = np.asarray(field)
        return self._field

    def get_kriging_weights(self) -> None:
        """Compute (and set) the M x (n+1) extended kriging weights."""
        self._full_solve()

    def kriging_weights_from_inverse(self, inv) -> None:
        """Weights from a pre-computed inverse of the EXTENDED system."""
        if len(self.idx) != inv.shape[0] - 1:
            raise ValueError("inv must be square with side length == len(idx)")
        _, C_cross, _ = self._blocks()
        M = C_cross.shape[1]
        ones_m = jnp.ones((1, M), C_cross.dtype)
        ext = jnp.concatenate([C_cross, ones_m], axis=0)
        self.kriging_weights = (jnp.asarray(inv, C_cross.dtype) @ ext).T

    def solve(self):
        """Kriged field; computes weights lazily via the bordered solve."""
        if hasattr(self, "_field"):
            return self._field
        if hasattr(self, "kriging_weights"):
            # user-injected weights path
            grid_obs = np.append(self.obs, 0).astype(self.obs.dtype)
            Wext = jnp.asarray(self.kriging_weights)
            return np.asarray(Wext @ jnp.asarray(grid_obs, Wext.dtype))
        return self._full_solve()

    def get_uncertainty(self):
        """OK uncertainty in the selected convention (see class docs).

        reference: diag(C) - (w'c + lam) - lam (double subtraction);
        textbook:  diag(C) - w'c - lam (= reference + lam).
        """
        textbook = (
            getattr(self, "uncertainty_convention", "reference")
            == "textbook"
        )
        if hasattr(self, "_uncert2"):
            uncert2 = self._uncert2
            if textbook:
                uncert2 = uncert2 + self._lam
            return _finalise_uncert(uncert2)
        if not hasattr(self, "kriging_weights"):
            raise KeyError("Please compute Kriging Weights first")
        _, C_cross, C_diag = self._blocks()
        Wext = jnp.asarray(self.kriging_weights)
        alpha = Wext[:, -1]
        M = C_cross.shape[1]
        ones_m = jnp.ones((1, M), C_cross.dtype)
        ext = jnp.concatenate([C_cross, ones_m], axis=0)
        # diag_wc = w'c + lam (the ones row contributes lam once)
        diag_wc = jnp.einsum("nm,mn->m", ext, Wext)
        uncert2 = C_diag - diag_wc
        if not textbook:
            uncert2 = uncert2 - alpha
        return _finalise_uncert(uncert2)

    def constraint_mask(self, simple_kriging_weights=None):
        """Constraint mask from the SIMPLE kriging weights of the system."""
        if simple_kriging_weights is None:
            if hasattr(self, "_cmask"):
                return np.asarray(self._cmask)
            K, C_cross, C_diag = self._blocks()
            V = _solve_sym(K, C_cross)
            sv = jnp.einsum("nm,nm->m", C_cross, V)
            return np.asarray(sv / C_diag)
        _, C_cross, C_diag = self._blocks()
        W = jnp.asarray(simple_kriging_weights)
        num = jnp.einsum("nm,mn->m", C_cross, W)
        return np.asarray(num / C_diag)

    def extended_inverse(self, simple_inv):
        """Guttman extended inverse (API parity helper)."""
        return _extended_inverse(simple_inv).astype(self.covariance.dtype)


# ===========================================================================
# Obs preparation
# ===========================================================================
def prep_obs_for_kriging(
    unmask_idx,
    unique_obs_idx,
    weights,
    obs,
    remove_obs_mean: int = 0,
    obs_bias=None,
    error_cov=None,
):
    """Average per-gridbox observations and optionally remove a mean.

    remove_obs_mean: 0 none, 1 mean, 2 median, 3 GLS spatial mean (needs
    error_cov). Returns (obs_idx, grid_obs).
    (Parity: reference ``kriging.py:832-904``.)
    """
    obs_idx = get_unmasked_obs_indices(
        np.asarray(unmask_idx), np.asarray(unique_obs_idx)
    )

    weights = np.asarray(weights)
    obs = np.asarray(obs)
    if obs_bias is not None:
        grid_obs = weights @ (obs - np.asarray(obs_bias))
    else:
        grid_obs = weights @ obs
    grid_obs = np.squeeze(grid_obs) if len(grid_obs) > 1 else grid_obs

    match remove_obs_mean:
        case 0:
            pass
        case 1:
            grid_obs = grid_obs - np.ma.average(grid_obs)
        case 2:
            grid_obs = grid_obs - np.ma.median(grid_obs)
        case 3:
            if error_cov is None:
                raise ValueError(
                    "'remove_obs_mean = 3 requires error covariance"
                )
            grid_obs = grid_obs - get_spatial_mean(grid_obs, error_cov)
        case _:
            raise ValueError("Unknown 'remove_obs_mean' value")

    return obs_idx, grid_obs


def get_unmasked_obs_indices(unmask_idx, unique_obs_idx):
    """Positions (within unmask_idx) of observed unmasked grid boxes.

    (Parity: reference ``kriging.py:907-932``.)
    """
    unmask_idx = np.squeeze(unmask_idx) if unmask_idx.ndim > 1 else unmask_idx
    _, obs_idx, _ = intersect_mtlb(unmask_idx, unique_obs_idx)
    return obs_idx.astype(int)


# ===========================================================================
# Deprecated function forms (API parity)
# ===========================================================================
def kriging_simple(obs_obs_cov, obs_grid_cov, grid_obs, interp_cov, mean=0.0):
    """Deprecated function form of SimpleKriging (kept for parity).

    Takes pre-gathered blocks; returns (field, uncertainty).
    """
    warn(
        "kriging_simple is deprecated, use SimpleKriging",
        DeprecationWarning,
    )
    K = jnp.asarray(obs_obs_cov)
    C_cross = jnp.asarray(obs_grid_cov, K.dtype)
    C_diag = jnp.diagonal(jnp.asarray(interp_cov, K.dtype))
    y = jnp.asarray(grid_obs, K.dtype)
    field, uncert2, _, _ = _simple_core(K, C_cross, C_diag, y, mean)
    return np.asarray(field), _finalise_uncert(uncert2)


def kriging_ordinary(obs_obs_cov, obs_grid_cov, grid_obs, interp_cov):
    """Deprecated function form of OrdinaryKriging (kept for parity)."""
    warn(
        "kriging_ordinary is deprecated, use OrdinaryKriging",
        DeprecationWarning,
    )
    K = jnp.asarray(obs_obs_cov)
    C_cross = jnp.asarray(obs_grid_cov, K.dtype)
    C_diag = jnp.diagonal(jnp.asarray(interp_cov, K.dtype))
    y = jnp.asarray(grid_obs, K.dtype)
    field, uncert2, _, _, _, _ = _ordinary_core(K, C_cross, C_diag, y)
    return np.asarray(field), _finalise_uncert(uncert2)


def constraint_mask(obs_obs_cov, obs_grid_cov, interp_cov):
    """diag(C_cross' (C_obs+E)^{-1} C_cross)/diag(C) (function form)."""
    K = jnp.asarray(obs_obs_cov)
    C_cross = jnp.asarray(obs_grid_cov, K.dtype)
    V = _solve_sym(K, C_cross)
    num = jnp.einsum("nm,nm->m", C_cross, V)
    return np.asarray(num / jnp.diagonal(jnp.asarray(interp_cov, K.dtype)))
