r"""Ellipse (non-stationary Matern) model and MLE fitting.

Capability parity with reference ``ellipse/model.py``: the
Paciorek-Schervish 2006 / Karspeck 2012 Matern "ellipse" correlation
kernel in six taxonomy variants (iso/aniso/rotated x degrees/physical
distance), the Fisher-transformed Gaussian negative log-likelihood, and
maximum-likelihood fitting with Nelder-Mead plus bootstrap standard
errors.

Design:

- the kernel and NLL are pure jitted functions of static shape, with an
  optional weight mask so a whole grid of fits shares one compiled
  program (see ``estimate.EllipseBuilder.compute_params``);
- the optimiser is the batched JAX Nelder-Mead (``ops.optim``) — scipy's
  sequential loop becomes one ``vmap``;
- bootstrap standard errors are a ``vmap`` over resample keys instead of
  a joblib process pool (reference ``model.py:504-548``).
"""

import math
from collections import OrderedDict
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.optim import (
    batched_nelder_mead,
    lbfgs_minimize,
    nelder_mead,
)
from ...ops.special import xv_kv as _xv_kv
from ...types import FForm, ModelType, SuperCategory
from ...utils.frames import deg_to_km

ARCTANH_THRESHOLD = 0.999999

MODEL_TYPE_TO_SUPERCATEGORY: dict[ModelType, SuperCategory] = {
    "ps2006_kks2011_iso": "1_param_matern",
    "ps2006_kks2011_ani": "2_param_matern",
    "ps2006_kks2011_ani_r": "3_param_matern",
    "ps2006_kks2011_iso_pd": "1_param_matern_pd",
    "ps2006_kks2011_ani_pd": "2_param_matern_pd",
    "ps2006_kks2011_ani_r_pd": "3_param_matern_pd",
}

FFORM_TO_MODELTYPE: dict[FForm, ModelType] = {
    "anisotropic_rotated": "ps2006_kks2011_ani_r",
    "anisotropic": "ps2006_kks2011_ani",
    "isotropic": "ps2006_kks2011_iso",
    "anisotropic_rotated_pd": "ps2006_kks2011_ani_r_pd",
    "anisotropic_pd": "ps2006_kks2011_ani_pd",
    "isotropic_pd": "ps2006_kks2011_iso_pd",
}

SUPERCATEGORY_PARAMS: dict[SuperCategory, OrderedDict] = {
    "3_param_matern": OrderedDict(
        [
            ("Lx", "degrees"),
            ("Ly", "degrees"),
            ("theta", "radians"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "2_param_matern": OrderedDict(
        [
            ("Lx", "degrees"),
            ("Ly", "degrees"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "1_param_matern": OrderedDict(
        [
            ("R", "degrees"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "3_param_matern_pd": OrderedDict(
        [
            ("Lx", "km"),
            ("Ly", "km"),
            ("theta", "radians"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "2_param_matern_pd": OrderedDict(
        [
            ("Lx", "km"),
            ("Ly", "km"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
    "1_param_matern_pd": OrderedDict(
        [
            ("R", "km"),
            ("standard_deviation", "K"),
            ("qc_code", "1"),
            ("number_of_iterations", "1"),
        ]
    ),
}

FFORM_PARAMETERS: dict[str, dict[str, Any]] = {
    "isotropic": {
        "n_params": 1,
        "default_guesses": [7.0],
        "default_bounds": [(0.5, 50.0)],
    },
    "isotropic_pd": {
        "n_params": 1,
        "default_guesses": [deg_to_km(7.0)],
        "default_bounds": [(deg_to_km(0.5), deg_to_km(50.0))],
    },
    "anisotropic": {
        "n_params": 2,
        "default_guesses": [7.0, 7.0],
        "default_bounds": [(0.5, 50.0), (0.5, 30.0)],
    },
    "anisotropic_pd": {
        "n_params": 2,
        "default_guesses": [deg_to_km(7.0), deg_to_km(7.0)],
        "default_bounds": [
            (deg_to_km(0.5), deg_to_km(50.0)),
            (deg_to_km(0.5), deg_to_km(30.0)),
        ],
    },
    "anisotropic_rotated": {
        "n_params": 3,
        "default_guesses": [7.0, 7.0, 0.0],
        "default_bounds": [
            (0.5, 50.0),
            (0.5, 30.0),
            (-2.0 * math.pi, 2.0 * math.pi),
        ],
    },
    "anisotropic_rotated_pd": {
        "n_params": 3,
        "default_guesses": [deg_to_km(7.0), deg_to_km(7.0), 0.0],
        "default_bounds": [
            (deg_to_km(0.5), deg_to_km(50.0)),
            (deg_to_km(0.5), deg_to_km(30.0)),
            (-2.0 * math.pi, 2.0 * math.pi),
        ],
    },
}


# ===========================================================================
# Kernels (Paciorek-Schervish locally-stationary Matern)
# ===========================================================================
def cov_ij_anisotropic(
    v: float,
    stdev,
    delta_x,
    delta_y,
    Lx,
    Ly,
    stdev_j=None,
    theta=None,
):
    r"""Anisotropic ellipse correlation at displacements (delta_x, delta_y).

    .. math::
        c = \frac{\sigma \sigma_j}{\Gamma(\nu) 2^{\nu-1}}
            (2\tau\sqrt{\nu})^\nu K_\nu(2\tau\sqrt{\nu}),

    with :math:`\tau` the Mahalanobis distance under
    Sigma(Lx, Ly, theta). Assumes local stationarity (Sigma_i ~ Sigma_j),
    which drops the PS06 prefactor (reference ``model.py:582-638``).
    `v` is static; displacements are traced.
    """
    from ...ops.distances import mahal_dist_func

    stdev_j = stdev if stdev_j is None else stdev_j
    tau = mahal_dist_func(delta_x, delta_y, Lx, Ly, theta=theta)
    first = (stdev * stdev_j) / (math.gamma(v) * (2.0 ** (v - 1.0)))
    inner = 2.0 * tau * jnp.sqrt(jnp.asarray(v, tau.dtype))
    return first * _xv_kv(v, inner)


def cov_ij_isotropic(v: float, stdev, delta, R, stdev_j=None):
    """Isotropic (circular) variant: Lx = Ly = R."""
    stdev_j = stdev if stdev_j is None else stdev_j
    delta = jnp.asarray(delta)
    tau = jnp.abs(delta) / R
    first = (stdev * stdev_j) / (math.gamma(v) * (2.0 ** (v - 1.0)))
    inner = 2.0 * tau * jnp.sqrt(jnp.asarray(v, tau.dtype))
    return first * _xv_kv(v, inner)


_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _norm_logpdf(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - jnp.log(scale) - _LOG_SQRT_2PI


class EllipseModel:
    """Ellipse correlation model + MLE fitting configuration.

    Inputs are standardised correlations (stdev == 1 inside the kernel).
    `unit_sigma=False` (default, as in Karspeck et al. 2012 practice)
    appends the likelihood scale as an extra fitted parameter.
    (Parity: reference ``model.py:156-550``.)
    """

    def __init__(
        self,
        anisotropic: bool,
        rotated: bool,
        physical_distance: bool,
        v: float,
        unit_sigma: bool = False,
    ) -> None:
        if v <= 0:
            raise ValueError("'v' must be > 0")
        self.anisotropic = anisotropic
        self.rotated = rotated
        self.physical_distance = physical_distance
        self.v = float(v)
        self.unit_sigma = unit_sigma

        self._get_model_names()
        self.supercategory_params = SUPERCATEGORY_PARAMS[self.supercategory]
        self.supercategory_n_params = len(self.supercategory_params)
        self._get_defaults()

    def _get_model_names(self) -> None:
        if self.rotated and not self.anisotropic:
            raise ValueError("Cannot have an isotropic rotated fform")
        parts = ["anisotropic" if self.anisotropic else "isotropic"]
        if self.rotated:
            parts.append("rotated")
        if self.physical_distance:
            parts.append("pd")
        fform_str = "_".join(parts)
        if fform_str not in FFORM_TO_MODELTYPE:
            raise ValueError("Could not compute fform value from inputs")
        self.fform: FForm = fform_str  # type: ignore[assignment]
        self.model_type: ModelType = FFORM_TO_MODELTYPE[self.fform]
        self.supercategory: SuperCategory = MODEL_TYPE_TO_SUPERCATEGORY[
            self.model_type
        ]

    def _get_defaults(self) -> None:
        params = FFORM_PARAMETERS[self.fform]
        self.n_params: int = params["n_params"]
        self.default_guesses: list[float] = list(params["default_guesses"])
        self.default_bounds: list[tuple[float, float]] = list(
            params["default_bounds"]
        )

        if self.anisotropic:

            def cov_ij(X, **kw):
                return cov_ij_anisotropic(
                    self.v, 1.0, X[:, 0], X[:, 1], **kw
                )
        else:

            def cov_ij(X, **kw):
                return cov_ij_isotropic(self.v, 1.0, X, **kw)

        self.cov_ij = cov_ij

    # -- likelihood ---------------------------------------------------------
    def _model_correlation(self, X, params):
        """Kernel correlation for a parameter vector (traced)."""
        match self.n_params:
            case 1:
                return self.cov_ij(X, R=params[0])
            case 2:
                return self.cov_ij(X, Lx=params[0], Ly=params[1])
            case 3:
                return self.cov_ij(
                    X, Lx=params[0], Ly=params[1], theta=params[2]
                )
            case _:
                raise ValueError("Unexpected length of self.n_params.")

    def _nll_fit(self, params, X, y, weights):
        """Positional-weights adapter used as the batched-fit objective.

        Passed as a STATIC argument to the jitted batched optimisers: a
        bound method of one model instance hashes stably across
        ``compute_params`` calls, so the whole-grid fit compiles once
        per model instance instead of once per call (a per-call closure
        used to force a full ~3.5 s retrace every fit).
        """
        return self.nll(params, X, y, weights=weights)

    def _nll_fit_z(self, params, X, z_y, weights):
        """``_nll_fit`` with PRE-TRANSFORMED observations.

        ``z_y = arctanh(clip(y))`` is constant across optimizer
        iterations, so the whole-grid batched fit computes it once in
        the chunk builder instead of on every Nelder-Mead candidate
        evaluation (one log per element per eval — material, because
        the objective is transcendental-bound). Masked lanes carry
        ``z_y = arctanh(0) = 0`` and are zero-weighted, so the weighted
        sum equals ``nll``'s exactly.
        """
        X = jnp.asarray(X)
        sigma = (
            jnp.asarray(1.0, X.dtype)
            if self.unit_sigma
            else params[self.n_params]
        )
        wmask = weights > 0
        wsel = wmask[..., None] if X.ndim == weights.ndim + 1 else wmask
        X = jnp.where(wsel, X, jnp.ones_like(X))
        y_ll = self._model_correlation(X, params)
        y_ll = jnp.where(wmask, y_ll, 0.0)
        y_ll = jnp.nan_to_num(y_ll, nan=0.0)
        y_ll = jnp.clip(y_ll, -ARCTANH_THRESHOLD, ARCTANH_THRESHOLD)
        ll = _norm_logpdf(z_y, jnp.arctanh(y_ll), sigma)
        return -jnp.sum(ll * weights)

    def _residuals_fit_z(self, params, X, z_y, weights):
        """``_residuals_fit`` with pre-transformed observations (see
        ``_nll_fit_z``)."""
        X = jnp.asarray(X)
        wmask = weights > 0
        wsel = wmask[..., None] if X.ndim == weights.ndim + 1 else wmask
        X = jnp.where(wsel, X, jnp.ones_like(X))
        y_ll = self._model_correlation(X, params)
        y_ll = jnp.where(wmask, y_ll, 0.0)
        y_ll = jnp.nan_to_num(y_ll, nan=0.0)
        y_ll = jnp.clip(y_ll, -ARCTANH_THRESHOLD, ARCTANH_THRESHOLD)
        r = z_y - jnp.arctanh(y_ll)
        return jnp.sqrt(weights) * r

    def _residuals_fit(self, params, X, y, weights):
        r"""Weighted Fisher-z residuals: sqrt(w) (z(y) - z(model(X))).

        The NLL is exactly ``sum w [z_j^2 / (2 sigma^2) + log sigma]``
        with z the arctanh (Fisher) transform — weighted least squares
        in z-space. The scale sigma profiles out monotonically
        (sigma_hat^2 = sum w r^2 / sum w), so minimising
        ``0.5 * sum(residual^2)`` recovers the SAME (Lx, Ly, theta)
        optimum as the joint NLL, for both unit_sigma settings. This is
        the objective for ``ops.optim.batched_levenberg_marquardt`` —
        a bound method so the jitted batched fit compiles once per
        model instance (see ``_nll_fit``). Masking follows ``nll``:
        masked displacements are sanitised BEFORE the kernel so
        gradients stay NaN-free.
        """
        X = jnp.asarray(X)
        y = jnp.asarray(y)
        wmask = weights > 0
        wsel = wmask[..., None] if X.ndim == weights.ndim + 1 else wmask
        X = jnp.where(wsel, X, jnp.ones_like(X))
        y_ll = self._model_correlation(X, params)
        y_ll = jnp.where(wmask, y_ll, 0.0)
        y = jnp.where(wmask, y, 0.0)
        y_ll = jnp.nan_to_num(y_ll, nan=0.0)
        y = jnp.clip(y, -ARCTANH_THRESHOLD, ARCTANH_THRESHOLD)
        y_ll = jnp.clip(y_ll, -ARCTANH_THRESHOLD, ARCTANH_THRESHOLD)
        r = jnp.arctanh(y) - jnp.arctanh(y_ll)
        return jnp.sqrt(weights) * r

    def nll(self, params, X, y, weights=None, arctanh_transform: bool = True):
        """Masked negative log-likelihood (traceable core).

        `weights` multiplies per-sample contributions (0/1 masks make a
        fixed-shape batch of variable-size training sets share one
        compiled program). Observed and model correlations are clamped to
        +-0.999999 before the Fisher transform — the reference warns and
        fudges at the same threshold (``model.py:326-373``).
        """
        X = jnp.asarray(X)
        sigma = (
            jnp.asarray(1.0, X.dtype)
            if self.unit_sigma
            else params[self.n_params]
        )
        y = jnp.asarray(y)
        if weights is not None:
            # Replace masked displacements with a benign value BEFORE the
            # kernel: masked lanes include the zero-displacement origin,
            # where K_nu is +inf — sanitising after the fact keeps the
            # VALUE finite but leaks NaN through the gradient (the
            # untaken where() branch), which matters for the L-BFGS path.
            wmask = weights > 0
            wsel = wmask[..., None] if X.ndim == weights.ndim + 1 else wmask
            X = jnp.where(wsel, X, jnp.ones_like(X))
        y_ll = self._model_correlation(X, params)
        if weights is not None:
            y_ll = jnp.where(wmask, y_ll, 0.0)
            y = jnp.where(wmask, y, 0.0)
        y_ll = jnp.nan_to_num(y_ll, nan=0.0)
        if arctanh_transform:
            y = jnp.clip(y, -ARCTANH_THRESHOLD, ARCTANH_THRESHOLD)
            y_ll = jnp.clip(y_ll, -ARCTANH_THRESHOLD, ARCTANH_THRESHOLD)
            ll = _norm_logpdf(jnp.arctanh(y), jnp.arctanh(y_ll), sigma)
        else:
            ll = _norm_logpdf(y, y_ll, sigma)
        if weights is not None:
            ll = ll * weights
        return -jnp.sum(ll)

    def negative_log_likelihood(
        self, X, y, params, arctanh_transform: bool = True
    ) -> float:
        """Reference-signature NLL (X, y, params) -> float."""
        return float(
            self.nll(
                jnp.asarray(params),
                X,
                y,
                arctanh_transform=arctanh_transform,
            )
        )

    def negative_log_likelihood_function(self, X, y) -> Callable:
        """params -> NLL closure over fixed training data."""
        Xj = jnp.asarray(X)
        yj = jnp.asarray(y)
        return lambda params: self.nll(jnp.asarray(params), Xj, yj)

    # -- fitting --------------------------------------------------------------
    def _fit_setup(self, guesses, bounds):
        guesses = list(guesses or self.default_guesses)
        bounds = list(bounds or self.default_bounds)
        if (not self.unit_sigma) and len(guesses) != self.n_params + 1:
            guesses.append(0.1)
            bounds.append((0.0001, 0.5))
        lo = jnp.asarray([b[0] for b in bounds], jnp.float64
                         if jax.config.jax_enable_x64 else jnp.float32)
        hi = jnp.asarray([b[1] for b in bounds], lo.dtype)
        return jnp.asarray(guesses, lo.dtype), (lo, hi), bounds

    def fit(
        self,
        X,
        y,
        guesses=None,
        bounds=None,
        opt_method: str = "Nelder-Mead",
        tol: float | None = None,
        estimate_SE: str | None = "bootstrap_parallel",
        n_sim: int = 500,
        n_jobs: int | None = None,
        backend: str | None = None,
        random_seed: int = 1234,
    ):
        """MLE fit; returns (NMResult, SE | None, bounds).

        `opt_method`: "Nelder-Mead" (the Karspeck method, default) or
        "L-BFGS-B" — gradient-based, possible here because the entire
        likelihood (Matern K_nu included) is differentiable JAX; the
        reference explicitly cannot ("autograd does not work with
        scipy's Bessel functions"). `tol` sets both xatol and fatol for
        NM, or the gradient-norm tolerance for L-BFGS. `estimate_SE` in
        {"bootstrap_serial", "bootstrap_parallel"} runs `n_sim`
        bootstrap refits — both map to the same vmapped batch (`n_jobs`
        / `backend` accepted for signature parity, ignored) — or
        "hessian" for Fisher-information standard errors via the
        autodiff Hessian at the optimum (NotImplementedError in the
        reference, ``model.py:539-544``).
        """
        x0, (lo, hi), bounds_out = self._fit_setup(guesses, bounds)
        tol = 1e-4 if tol is None else tol
        Xj = jnp.asarray(X)
        yj = jnp.asarray(y)

        if opt_method == "Nelder-Mead":
            result = nelder_mead(
                lambda p: self.nll(p, Xj, yj),
                x0,
                bounds=(lo, hi),
                xatol=tol,
                fatol=tol,
            )
        elif opt_method in ("L-BFGS-B", "L-BFGS", "lbfgs"):
            result = lbfgs_minimize(
                lambda p: self.nll(p, Xj, yj),
                x0,
                bounds=(lo, hi),
                tol=tol,
            )
        else:
            raise ValueError(
                "opt_method must be 'Nelder-Mead' or 'L-BFGS-B'"
            )

        if estimate_SE is None:
            return result, None, bounds_out
        if estimate_SE == "hessian":
            return (
                result,
                self._hessian_se(Xj, yj, jnp.asarray(result.x)),
                bounds_out,
            )
        if estimate_SE not in ("bootstrap_serial", "bootstrap_parallel"):
            raise ValueError(f"Unknown estimate_SE value: {estimate_SE}")

        SE = self._bootstrap_se(
            Xj, yj, x0, (lo, hi), tol, n_sim, random_seed
        )
        return result, SE, bounds_out

    def _hessian_se(self, X, y, x_opt):
        """Fisher-information standard errors: sqrt(diag(H^{-1})).

        H is the autodiff Hessian of the negative log-likelihood at the
        optimum — available because K_nu is differentiable JAX.
        Non-positive-curvature directions yield NaN.
        """
        H = jax.hessian(lambda p: self.nll(p, X, y))(x_opt)
        cov = jnp.linalg.inv(H)
        diag = jnp.diagonal(cov)
        return np.asarray(
            jnp.sqrt(jnp.where(diag > 0, diag, jnp.nan))
        )

    def _bootstrap_se(self, X, y, x0, bounds, tol, n_sim, seed):
        """Bootstrap refits, vmapped over resample keys."""
        n = y.shape[0]
        key = jax.random.key(seed)
        keys = jax.random.split(key, n_sim)

        # Resampling as weighted NLL: bootstrap counts are per-sample
        # weights — identical likelihood value to gathering rows, but
        # keeps every refit the same static shape.
        def counts(k):
            idx = jax.random.randint(k, (n,), 0, n)
            return jnp.zeros((n,), X.dtype).at[idx].add(1.0)

        w = jax.vmap(counts)(keys)  # (n_sim, n)

        def fun(p, w_i):
            return self.nll(p, X, y, weights=w_i)

        x0_b = jnp.broadcast_to(x0, (n_sim, x0.shape[0]))
        res = batched_nelder_mead(
            fun, x0_b, (w,), bounds, xatol=tol, fatol=tol
        )
        return np.std(np.asarray(res.x), axis=0)

    def _bootstrap_once(
        self, X, y, guesses, bounds, opt_method, tol=None, seed=1234
    ):
        """Single bootstrap refit (reference-shaped helper)."""
        rng = np.random.RandomState(seed)
        n = len(y)
        idx = rng.choice(np.arange(n), size=n, replace=True)
        Xb = np.asarray(X)[idx, ...]
        yb = np.asarray(y)[idx]
        x0, (lo, hi), _ = self._fit_setup(guesses, bounds)
        res = nelder_mead(
            lambda p: self.nll(p, jnp.asarray(Xb), jnp.asarray(yb)),
            x0,
            bounds=(lo, hi),
            xatol=tol or 1e-4,
            fatol=tol or 1e-4,
        )
        return np.asarray(res.x)
