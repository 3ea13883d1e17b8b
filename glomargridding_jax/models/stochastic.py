r"""Two-stage stochastic kriging (Morice et al. 2021 ensemble method).

Capability parity with reference ``stochastic.py``: ordinary-kriged field
plus a simulated perturbation epsilon = (simple-kriged simulated obs) -
simulated state, and multivariate-normal state draws with eigen-repair
fallback. Device design:

- One Cholesky of :math:`K = C_{obs} + E` yields BOTH the simple weights
  and the bordered ordinary solve (the reference computes an explicit
  N^3 inverse at ``stochastic.py:159-162`` and a Guttman extension).
- State draws are :math:`\mu + L z` with a single Cholesky factor of C and
  ``jax.random`` keys, vmapped over ensemble members — drawing 200 states
  costs barely more than one (the reference notes the factorisation
  dominates at ``stochastic.py:344-349``; here that's explicit API:
  factor once via ``draw_factor``, then ``draws_from_factor``).
"""

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kriging import (
    Kriging,
    _extended_inverse,
    _finalise_uncert,
    _ordinary_core,
)


# ===========================================================================
# Multivariate-normal draws
# ===========================================================================
@jax.jit
def _cholesky_jit(cov):
    return jnp.linalg.cholesky(cov)


def draw_factor(cov):
    """Lower Cholesky factor of a covariance (NaN if not SPD)."""
    return _cholesky_jit(cov)


@partial(jax.jit, static_argnames=("ndraws",))
def draws_from_factor(key, L, loc, ndraws: int = 1):
    """ndraws x N samples of N(loc, L L'). vmapped over members.

    This is the ensemble primitive: factor once, draw many.
    """
    n = L.shape[0]
    z = jax.random.normal(key, (ndraws, n), dtype=L.dtype)
    return loc[None, :] + z @ L.T


def eigen_repaired_factor(
    cov,
    eigen_rtol: float = 1e-6,
    eigen_fudge: float = 1e-8,
    strict: bool = False,
):
    """Symmetric factor of a nearly-PSD covariance via eigen repair.

    eigh, check |most negative| / largest against eigen_rtol (warn, or
    raise when `strict`), floor eigenvalues at eigen_fudge, return
    V sqrt(W) so that F F' equals the repaired covariance (rescue
    semantics of the reference's ``stochastic.py:459-499``; non-strict by
    default because the reference's primary draw path tolerates indefinite
    inputs without raising).
    """
    from ..ops.covariance_tools import _eigh

    w, v = _eigh(cov)
    w = jnp.asarray(w)
    v = jnp.asarray(v)
    w_min = float(w[0])
    w_max = float(w[-1])
    if w_min < 0:
        rtol_check = abs(w_min) / w_max
        logging.warning(
            "Negative eigenvalues detected: largest = "
            f"{w_max}; smallest = {w_min}; ratio = {rtol_check}"
        )
        if strict and rtol_check >= eigen_rtol:
            raise ValueError("Negative eigenvalues are unexpectedly large.")
    w = jnp.where(w < eigen_fudge, eigen_fudge, w)
    return v * jnp.sqrt(w)[None, :]


def mv_normal_draw(
    key,
    loc,
    cov,
    ndraws: int = 1,
    eigen_rtol: float = 1e-6,
    eigen_fudge: float = 1e-8,
    strict: bool = False,
):
    """Draw from N(loc, cov) with automatic eigen-repair fallback.

    Tries a Cholesky factor first; if the matrix is not positive-definite
    (NaNs in the factor) falls back to the eigen-repaired symmetric factor
    — same rescue semantics as the reference's ``scipy_mv_normal_draw``
    (``stochastic.py:395-502``) with explicit ``jax.random`` keys.
    Returns shape (N,) for ndraws == 1 else (ndraws, N).
    """
    cov = jnp.asarray(cov)
    if cov.ndim != 2:
        raise ValueError("cov should be 2D.")
    if cov.shape[0] != cov.shape[1]:
        raise ValueError("cov is not a square matrix")
    loc = jnp.asarray(loc, cov.dtype)
    L = draw_factor(cov)
    if bool(jnp.isnan(L[-1, -1])):
        L = eigen_repaired_factor(cov, eigen_rtol, eigen_fudge, strict)
    out = draws_from_factor(key, L, loc, ndraws)
    return out[0] if ndraws == 1 else out


@jax.jit
def _member_finish(field, W, state, sim_obs):
    """simulated grid, epsilon, and perturbed member from the draws."""
    sim_grid = W @ sim_obs
    eps = sim_grid - state
    return field + eps, sim_grid, eps


@jax.jit
def _stochastic_fused(key_state, key_obs, cov, E, idx, W, field):
    """Whole stochastic stage in ONE compiled dispatch (fast path).

    Factors C and E, draws the simulated state and observation noise,
    and assembles the perturbed member. Also returns NaN flags for the
    two Cholesky factors so the caller can detect a non-PD input with a
    single device sync and rerun through the eigen-repair rescue path
    (reference semantics, ``stochastic.py:344-392``) only when needed.
    """
    Lc = _cholesky_jit(cov)
    Le = _cholesky_jit(E)
    state = Lc @ jax.random.normal(key_state, (cov.shape[0],), cov.dtype)
    noise = Le @ jax.random.normal(key_obs, (E.shape[0],), E.dtype)
    sim_obs = state[idx] + noise
    member, sim_grid, eps = _member_finish(field, W, state, sim_obs)
    bad = jnp.stack([jnp.isnan(Lc[-1, -1]), jnp.isnan(Le[-1, -1])])
    return member, state, sim_obs, sim_grid, eps, bad


@jax.jit
def _stochastic_fused_with_state(key_obs, state, E, idx, W, field):
    """Fused stage for a pre-computed simulated state (one dispatch)."""
    Le = _cholesky_jit(E)
    noise = Le @ jax.random.normal(key_obs, (E.shape[0],), E.dtype)
    sim_obs = state[idx] + noise
    member, sim_grid, eps = _member_finish(field, W, state, sim_obs)
    return member, sim_obs, sim_grid, eps, jnp.isnan(Le[-1, -1])


_GLOBAL_SEED = np.random.SeedSequence(20260816)


def scipy_mv_normal_draw(
    loc,
    cov,
    ndraws: int = 1,
    eigen_rtol: float = 1e-6,
    eigen_fudge: float = 1e-8,
):
    """Keyless MVN draw (API parity with the reference's global-RNG form).

    Prefer ``mv_normal_draw`` with an explicit key; this wrapper draws a
    fresh key from a module-global seed sequence for drop-in workflows.
    """
    global _GLOBAL_SEED
    seed = int(_GLOBAL_SEED.spawn(1)[0].generate_state(1)[0])
    return np.asarray(
        mv_normal_draw(
            jax.random.key(seed), loc, cov, ndraws, eigen_rtol, eigen_fudge
        )
    )


# ===========================================================================
# StochasticKriging
# ===========================================================================
class StochasticKriging(Kriging):
    """Ordinary-kriged field plus simulated perturbation (ensemble member).

    After ``solve`` the attributes `gridded_field` (unperturbed),
    `simulated_grid`, `simulated_obs`, and `epsilon` are populated
    (parity: reference ``stochastic.py:32-392``). `error_cov` is required.
    """

    method = "stochastic"

    def __init__(
        self,
        covariance,
        idx,
        obs,
        error_cov,
        *,
        uncertainty: str = "reference",
    ) -> None:
        if error_cov is None:
            raise ValueError(
                "Error Covariance must be provided for StochasticKriging"
            )
        if uncertainty not in ("reference", "textbook"):
            raise ValueError(
                f"Unknown 'uncertainty' convention: {uncertainty!r}"
            )
        # "reference" replicates the reference's double lambda
        # subtraction (kriging.py:699-701); "textbook" subtracts the
        # Lagrange multiplier once (see OrdinaryKriging).
        self.uncertainty_convention = uncertainty
        super().__init__(
            covariance=covariance, idx=idx, obs=obs, error_cov=error_cov
        )

    def set_simple_kriging_weights(self, simple_kriging_weights) -> None:
        """Inject pre-computed simple kriging weights (second stage)."""
        self.simple_kriging_weights = np.asarray(simple_kriging_weights)

    def get_kriging_weights(self) -> None:
        """One factorisation -> simple AND extended ordinary weights."""
        K, C_cross, C_diag = self._blocks()
        y = jnp.asarray(self.obs, K.dtype)
        field, uncert2, cmask, V, u, lam = _ordinary_core(
            K, C_cross, C_diag, y
        )
        # Device arrays: the second-stage matvecs consume them in place;
        # conversion to numpy happens only if the user reads the attrs.
        self.simple_kriging_weights = V.T
        W = V.T - lam[:, None] * u[None, :]
        self.kriging_weights = jnp.concatenate([W, lam[:, None]], axis=1)
        self._field = field  # device-resident; fetched only on user read
        self._uncert2 = uncert2
        self._lam = lam
        self._cmask = cmask

    def kriging_weights_from_inverse(self, inv) -> None:
        """Simple + extended weights from a pre-computed (C_obs+E)^{-1}."""
        if len(self.idx) != inv.shape[0]:
            raise ValueError(
                "inv must be square with side length == len(self.idx)"
            )
        _, C_cross, _ = self._blocks()
        inv = jnp.asarray(inv, C_cross.dtype)
        self.simple_kriging_weights = np.asarray(inv @ C_cross).T
        inv_ext = jnp.asarray(_extended_inverse(np.asarray(inv)))
        M = C_cross.shape[1]
        ones_m = jnp.ones((1, M), C_cross.dtype)
        ext = jnp.concatenate([C_cross, ones_m], axis=0)
        self.kriging_weights = np.asarray((inv_ext @ ext).T)

    def get_uncertainty(self):
        """Ordinary-kriging uncertainty of the first stage.

        Convention selected at construction: "reference" (double lambda
        subtraction, parity) or "textbook" (single subtraction).
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
        ones_m = jnp.ones((1, C_cross.shape[1]), C_cross.dtype)
        ext = jnp.concatenate([C_cross, ones_m], axis=0)
        diag_wc = jnp.einsum("nm,mn->m", ext, Wext)
        uncert2 = C_diag - diag_wc
        if not textbook:
            uncert2 = uncert2 - alpha
        return _finalise_uncert(uncert2)

    def constraint_mask(self):
        """Constraint mask from the simple kriging weights."""
        if not hasattr(self, "simple_kriging_weights"):
            raise KeyError("Please set kriging weights")
        _, C_cross, C_diag = self._blocks()
        W = jnp.asarray(self.simple_kriging_weights)
        num = jnp.einsum("nm,mn->m", C_cross, W)
        return np.asarray(num / C_diag)

    def solve(self, simulated_state=None, key=None):
        """Perturbed ensemble member: ordinary field + epsilon.

        `simulated_state` may be pre-computed (recommended: factor C once
        and batch-draw states with ``draw_factor``/``draws_from_factor``).
        `key` is a jax PRNG key; one is derived from the module seed
        sequence when omitted.
        """
        if not hasattr(self, "kriging_weights"):
            self.get_kriging_weights()
        if self.error_cov is None:
            raise ValueError(
                "Error Covariance must be set to draw simulated observations"
            )
        if key is None:
            seed = int(_GLOBAL_SEED.spawn(1)[0].generate_state(1)[0])
            key = jax.random.key(seed)
        key_state, key_obs = jax.random.split(key)

        if hasattr(self, "_field"):
            field = jnp.asarray(self._field)
        else:
            grid_obs = np.append(self.obs, 0).astype(self.obs.dtype)
            field = jnp.asarray(self.kriging_weights) @ jnp.asarray(
                grid_obs
            )
        self.gridded_field = field

        W = jnp.asarray(self.simple_kriging_weights)
        E = jnp.asarray(self.error_cov, W.dtype)
        idx_dev = jnp.asarray(self.idx)

        # Fast path: everything (two Cholesky factors, two draws, the
        # perturbation algebra) in one compiled dispatch, then a single
        # sync on the tiny NaN-flag vector. Only a non-PD input falls
        # back to the per-piece eigen-repair path.
        if simulated_state is None:
            member, state, sim_obs, sim_grid, eps, bad = _stochastic_fused(
                key_state, key_obs, self._cov_device(), E, idx_dev, W, field
            )
            if not np.asarray(bad).any():
                self.simulated_obs = sim_obs
                self.simulated_grid = sim_grid
                self.epsilon = eps
                return member
            simulated_state = None  # rescue below redraws the state

        if simulated_state is None:
            simulated_state = mv_normal_draw(
                key_state,
                jnp.zeros(self.covariance.shape[0]),
                self._cov_device(),
                ndraws=1,
            )
        state = jnp.asarray(simulated_state, W.dtype)

        member, sim_obs, sim_grid, eps, bad = _stochastic_fused_with_state(
            key_obs, state, E, idx_dev, W, field
        )
        if not bool(np.asarray(bad)):
            self.simulated_obs = sim_obs
            self.simulated_grid = sim_grid
            self.epsilon = eps
            return member

        obs_noise = mv_normal_draw(
            key_obs,
            jnp.zeros(self.error_cov.shape[0]),
            E,
            ndraws=1,
        )
        self.simulated_obs = state[idx_dev] + obs_noise
        member, self.simulated_grid, self.epsilon = _member_finish(
            field, W, state, self.simulated_obs
        )
        return member


def precompute_states(
    key,
    n_states: int,
    covariance=None,
    corr_fn=None,
    variance: float | None = None,
    lats_deg=None,
    lons_deg=None,
    nugget: float = 0.0,
):
    """Pre-compute a batch of simulated states for StochasticKriging.

    The reference recommends precomputing states because one draw costs
    as much as two hundred (``stochastic.py:344-349``). Two routes:

    - dense: pass `covariance` — one Cholesky factor, vmapped L@z draws
      (right up to ~30k states on a 16 GB chip);
    - spectral: pass `corr_fn` (isotropic correlation of central angle),
      `variance`, and the regular `lats_deg`/`lons_deg` grid — EXACT
      stationary draws by spherical-harmonic synthesis at any grid size
      (see ``ops.sphere``).

    Returns (n_states, M); feed rows to ``StochasticKriging.solve``
    via `simulated_state=`.
    """
    if covariance is not None:
        cov = jnp.asarray(covariance)
        L = draw_factor(cov)
        if bool(jnp.isnan(L[-1, -1])):
            L = eigen_repaired_factor(cov)
        return np.asarray(
            draws_from_factor(
                key, L, jnp.zeros((cov.shape[0],), cov.dtype), n_states
            )
        )
    if corr_fn is None or variance is None:
        raise ValueError(
            "provide either covariance or (corr_fn, variance, grid axes)"
        )
    from ..ops.sphere import SphericalHarmonicSampler

    sampler = SphericalHarmonicSampler(
        corr_fn, variance, lats_deg, lons_deg, nugget=nugget
    )
    return np.asarray(sampler.draw(key, n_states))


def batched_ensemble_step(key, covariance, error_cov, idx, obs, n_members):
    """Fully-batched ensemble generation: one factor, vmapped members.

    Returns (members, gridded_field): members is (n_members, M). This is
    the production path for 100-member ensembles — the per-member work is
    two matvecs, all batched into matmuls.

    Merely near-PSD inputs (the normal case for clipped/estimated
    covariances) are rescued: a NaN Cholesky factor of either C or E
    falls back to the eigen-repaired symmetric factor instead of
    silently emitting all-NaN members (same rescue semantics as
    ``StochasticKriging.solve`` / reference ``stochastic.py:459-499``).
    """
    cov = jnp.asarray(covariance)
    idx = jnp.asarray(idx)
    E = jnp.asarray(error_cov, cov.dtype)
    y = jnp.asarray(obs, cov.dtype)

    obs_obs = cov[idx[:, None], idx[None, :]] + E
    C_cross = cov[idx, :]
    C_diag = jnp.diagonal(cov)
    field, _, _, V, u, lam = _ordinary_core(obs_obs, C_cross, C_diag, y)

    L = draw_factor(cov)
    LE = draw_factor(E)
    # ONE host sync resolves both NaN flags; the rescue (a full eigh)
    # runs only for the factor that actually failed.
    bad = np.asarray(jnp.stack([jnp.isnan(L[-1, -1]), jnp.isnan(LE[-1, -1])]))
    if bad[0]:
        L = eigen_repaired_factor(cov)
    if bad[1]:
        LE = eigen_repaired_factor(E)

    def one_member(k):
        k1, k2 = jax.random.split(k)
        state = (
            jax.random.normal(k1, (cov.shape[0],), cov.dtype) @ L.T
        )
        obs_sim = state[idx] + (
            jax.random.normal(k2, (E.shape[0],), cov.dtype) @ LE.T
        )
        grid_sim = V.T @ obs_sim
        return field + (grid_sim - state)

    keys = jax.random.split(key, n_members)
    members = jax.vmap(one_member)(keys)
    return members, field
