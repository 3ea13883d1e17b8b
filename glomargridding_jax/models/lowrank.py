r"""Kriging and stochastic ensembles on a factored (low-rank) covariance.

The device-scale PSD repair (``ops.covariance_tools.explained_variance_
clip_lowrank`` / ``laloux_clip_lowrank``) returns the clipped covariance
in factored form

.. math::  C = \mathrm{diag}(f) + V \, \mathrm{diag}(g) \, V^T

(``LowRankPSD``): the retained eigenspace keeps its spectrum, everything
orthogonal gets the uniform floor. This module closes the loop: ordinary
kriging, its uncertainty/constraint-mask diagnostics, and the two-stage
perturbation ensemble all evaluated straight off the factors — nothing
n x n is ever formed, so the non-stationary 1-degree pipeline (ellipse
MLE -> assembly -> low-rank clip -> kriging -> members) runs at
65k where the reference's dense path (`stochastic.py:291-349`, explicit
N^3 inverse + dense MVN draws) cannot allocate.

Key identities (m observed of n grid points, r = retained rank):

- obs block      K   = V_o g V_o' + diag(f_o) + E            (m x m)
- cross block    C_x[i, j] = V_o[i] g V[j]' + f_j [idx_i = j] (m x n)
- any C_x' z is one (r,)-bottleneck matmul plus a scatter-add,
- diag(C_x' K^{-1} C_x) reduces to an (r x r) Gram form plus exact
  corrections at the m observed columns,

so the full solve + diagnostics cost O(m^3 + n r (r + members)) flops
and O(n (r + members)) memory.

Capability analog of reference ``stochastic.py`` at scales it cannot
reach; algebra cross-checked against the dense path in
``tests/test_lowrank.py``.

Production note: the adaptive clips return a data-dependent rank, and
every distinct rank is a fresh compiled program here — call
``psd.pad_rank(256)`` (zero-gain columns, numerically inert) so monthly
reruns share one compiled ensemble step.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..ops.covariance_tools import LowRankPSD


class LowRankKrigingResult(NamedTuple):
    """Ordinary-kriged field + diagnostics from a factored covariance."""

    field: jax.Array
    uncertainty: jax.Array
    constraint_mask: jax.Array


def check_idx_unique(idx, error_cov=None, pad_error: float = 1e6):
    """Warn when observation grid indices repeat with real weight.

    The factored observation system builds its floor term as
    ``diag(f_o)``, which omits the floor coupling f_j on OFF-diagonal
    entries between two observations sharing a grid cell — genuinely
    duplicated station indices would give a silently-wrong K vs the
    dense OrdinaryKriging path. Duplicates whose error-covariance
    diagonal is huge (the ``pad_month_observations`` convention places
    all dummy obs at grid index 0 with pad_error ~1e8, suppressing
    their weights) are exempt. Host-side check on the SMALL (m,) index
    array; public low-rank entry points call it once per solve.
    """
    import numpy as np
    from warnings import warn

    idx_h = np.asarray(idx)
    if error_cov is not None:
        if isinstance(error_cov, jax.Array):
            ediag = np.asarray(
                error_cov
                if error_cov.ndim == 1
                else jnp.diagonal(error_cov)
            )
        else:  # host array: no device round-trip for the check
            Eh = np.asarray(error_cov)
            ediag = Eh if Eh.ndim == 1 else np.diagonal(Eh)
        idx_h = idx_h[ediag < pad_error]
    uniq, counts = np.unique(idx_h, return_counts=True)
    n_dup = int((counts > 1).sum())
    if n_dup:
        warn(
            f"{n_dup} grid cell(s) carry multiple observations with "
            "non-pad error: the factored observation system drops the "
            "floor coupling between duplicates and will diverge from "
            "the dense OrdinaryKriging path. Merge duplicate "
            "observations per cell (or inflate their error) first."
        )
    return n_dup == 0


def _stacked_obs_solve(V_o, g, f_o, E, y, extra=None):
    """One Cholesky of K = C_obs + E and ONE triangular solve for every
    right-hand side the caller needs.

    Returns (u, w, X) = K^{-1}(1, y, extra). Stacking [1, y, extra]
    into a single ``cho_solve`` matters beyond kernel-launch count: each
    distinct triangular instance can serialize to a multi-MB executable
    blob in the persistent compile cache. The stacked form keeps
    exactly one Cholesky and one forward/back substitution pair per
    program.
    """
    dtype = V_o.dtype
    m = V_o.shape[0]
    K = (V_o * g[None, :]) @ V_o.T + jnp.diag(f_o) + E
    L = jnp.linalg.cholesky(K)
    rhs = [jnp.ones((m, 1), dtype), y[:, None]]
    if extra is not None:
        rhs.append(extra)
    sol = jsl.cho_solve((L, True), jnp.concatenate(rhs, axis=1))
    u, w = sol[:, 0], sol[:, 1]
    return u, w, (sol[:, 2:] if extra is not None else None)


def _field_from_uw(V, g, f, idx, u, w, y):
    """Ordinary-kriged field + Lagrange terms from u = K^{-1}1 and
    w = K^{-1}y. Returns (field, t, lam, uy)."""
    s = jnp.sum(u)
    uy = u @ y
    t = _cross_t_apply(V, g, f, idx, u)  # (n,) colsums of K^{-1}C_x
    cw = _cross_t_apply(V, g, f, idx, w)
    lam = (t - 1.0) / s
    field = cw - lam * uy
    return field, t, lam, uy


def _cross_t_apply(V, g, f, idx, z):
    """C_cross' @ z for z of shape (m,) or (m, b); C never formed.

    C_cross[i, j] = V[idx_i] g V[j]' + f_j [idx_i == j], so
    C_cross' z = V (g (V_o' z)) + scatter_add(idx, f_o * z).
    """
    V_o = V[idx]
    f_o = f[idx]
    if z.ndim == 1:
        out = V @ (g * (V_o.T @ z))
        return out.at[idx].add(f_o * z)
    out = V @ (g[:, None] * (V_o.T @ z))
    return out.at[idx].add(f_o[:, None] * z)


def _lowrank_solve_impl(
    V, g, f, E, idx, y, key, n_members: int,
    diagnostics: bool = True, e_diag: bool = False,
):
    """Factorise K, field, diagnostics, members — traceable core.

    Jitted locally as ``_lowrank_solve``; ``parallel.lowrank`` re-jits
    it with row-sharded V/f and (ens, grid)-sharded members (the
    partitioner keeps every n-sized op local to its rows).
    n_members = 0 skips the ensemble entirely (XLA drops the dead
    branches: states, noise factor, member solves);
    diagnostics=False skips the uncertainty/constraint diagonals —
    the m^2-wide part of the stacked solve — and returns zeros for
    them; e_diag=True (set by the public wrappers when E is diagonal,
    the common production case) draws the obs noise elementwise instead
    of via a second m^3 Cholesky.

    Every right-hand side — [1, y] for the field, [V_o, I_m] for the
    diagnostics, the simulated observations for the members — goes
    through ONE stacked ``cho_solve`` (see ``_stacked_obs_solve``).
    """
    dtype = V.dtype
    m = idx.shape[0]
    n = V.shape[0]
    r = g.shape[0]
    V_o = V[idx]
    f_o = f[idx]

    # E may be the (m,) DIAGONAL of a diagonal error covariance — the
    # m^2-free form the public wrappers pass through for diagonal E
    # (uploading a dense np.diag at m = 5000 is 100 MB over the
    # host->device link; the diagonal is 20 KB)
    if E.ndim == 1:
        e_vec = E
        if not e_diag:  # caller bypassed the wrappers: stay correct
            E = jnp.diag(E)
    else:
        e_vec = jnp.diagonal(E)

    # draw states and simulated observations FIRST so they can join the
    # single stacked solve
    if n_members > 0:
        k_state, k_obs = jax.random.split(key)
        k1, k2 = jax.random.split(k_state)
        z1 = jax.random.normal(k1, (n, n_members), dtype)
        z2 = jax.random.normal(k2, (r, n_members), dtype)
        states = jnp.sqrt(f)[:, None] * z1 + V @ (
            jnp.sqrt(g)[:, None] * z2
        )  # (n, members)
        zo = jax.random.normal(k_obs, (m, n_members), dtype)
        if e_diag:
            eps = jnp.sqrt(e_vec)[:, None] * zo
        else:
            eps = jnp.linalg.cholesky(E) @ zo
        sim_obs = states[idx] + eps  # (m, members)

    if e_diag:
        # Woodbury route: K = D + U U' with D = diag(f_o + e) and
        # U = V_o sqrt(g), so K^{-1}Z = D^{-1}Z - D^{-1}U W^{-1}U'D^{-1}Z
        # with W = I_r + U'D^{-1}U — SPD with eigenvalues >= 1 (zero-gain
        # pad_rank columns are simply zero columns of U). EVERY solve is
        # r-sized: the m^3 Cholesky disappears, and with it the m-wide
        # triangular kernels whose serialized executables dominated the
        # program (50 MB -> a few MB) and the cold-process load time.
        # Numerical discipline, learned on the 65k realistic workload
        # (rank 1024, truth drawn from the model itself): with a
        # reduced-precision default matmul (bf16 passes; TF32 on the
        # GPU) and no refinement the field RMSE came out 0.450 where
        # the Cholesky route was self-consistent at 0.387. Two
        # measures restore it:
        # 1. the small Woodbury-core matmuls ((m, r) x (r, cols) and
        #    the (r, r) Gram) run at Precision.HIGHEST — full f32
        #    accumulation, trivial cost at these shapes;
        # 2. one step of iterative refinement with the residual taken
        #    through the exact factored K, which wipes the remaining
        #    cancellation error (the two Woodbury terms are each
        #    O(|Z| lambda_max / d) and cancel to the answer).
        # Re-measured: RMSE 0.392 vs mean uncertainty 0.393 vs member
        # spread 0.387 — consistent, matching the m^3 route.
        hi = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
        d = f_o + e_vec
        U = V_o * jnp.sqrt(g)[None, :]
        DiU = U / d[:, None]
        W = jnp.eye(r, dtype=dtype) + hi(U.T, DiU)
        Lw = jnp.linalg.cholesky(W)

        def kmat(Z):  # K @ Z off the factors (two (m, r) matmuls)
            return hi(U, hi(U.T, Z)) + d[:, None] * Z

        def ksolve_once(Z):
            Zd = Z / d[:, None]
            return Zd - hi(DiU, jsl.cho_solve((Lw, True), hi(U.T, Zd)))

        def ksolve(Z):
            X = ksolve_once(Z)
            return X + ksolve_once(Z - kmat(X))

        rhs = [jnp.ones((m, 1), dtype), y[:, None]]
        if n_members > 0:
            rhs.append(sim_obs)
        sol = ksolve(jnp.concatenate(rhs, axis=1))
        u, w = sol[:, 0], sol[:, 1]
        X = sol[:, 2:] if n_members > 0 else None
    else:
        parts = []
        if diagnostics:
            parts.append(V_o)
            parts.append(jnp.eye(m, dtype=dtype))
        if n_members > 0:
            parts.append(sim_obs)
        u, w, X = _stacked_obs_solve(
            V_o, g, f_o, E, y,
            jnp.concatenate(parts, axis=1) if parts else None,
        )
    field, t, lam, uy = _field_from_uw(V, g, f, idx, u, w, y)

    if diagnostics:
        # diag(C_x' K^{-1} C_x): C_x[:, j] = V_o (g V_j) + f_j e_pos(j),
        # so the quadratic form splits into the (r x r) Gram piece
        # V_j' g (V_o'K^{-1}V_o) g V_j, a cross piece on the m observed
        # columns via S = K^{-1}V_o, and f_j^2 diag(K^{-1}).
        if e_diag:
            S = ksolve(V_o)  # K^{-1} V_o, r-sized solves only
            # diag(K^{-1}) = 1/d - rowsum((Lw^{-1}DiU')^2): one narrow
            # forward substitution instead of an m-wide identity RHS
            R = jsl.solve_triangular(Lw, DiU.T, lower=True)  # (r, m)
            kinv_diag = 1.0 / d - jnp.sum(R**2, axis=0)
        else:
            S = X[:, :r]  # K^{-1} V_o
            kinv_diag = jnp.diagonal(X[:, r:r + m])
        M = (g[:, None] * (V_o.T @ S)) * g[None, :]  # (r, r)
        M = 0.5 * (M + M.T)
        sv = jnp.sum((V @ M) * V, axis=1)  # (n,)
        P = jnp.sum(S * (V_o * g[None, :]), axis=1)  # (m,)
        sv = sv.at[idx].add(2.0 * f_o * P + f_o**2 * kinv_diag)

        diag = f + jnp.sum(V**2 * g[None, :], axis=1)
        wc = sv - lam * t
        uncert2 = diag - (wc + lam) - lam
        cmask = sv / diag
    else:
        uncert2 = jnp.zeros_like(field)
        cmask = jnp.zeros_like(field)

    if n_members == 0:
        members = jnp.zeros((0, n), dtype)
        return field, uncert2, cmask, members

    A = X[:, -n_members:]  # K^{-1} sim_obs
    grid_sim = _cross_t_apply(V, g, f, idx, A)  # (n, members)
    members = field[None, :] + (grid_sim - states).T
    return field, uncert2, cmask, members


_lowrank_solve = partial(
    jax.jit, static_argnames=("n_members", "diagnostics", "e_diag")
)(_lowrank_solve_impl)


@jax.jit
def _offdiag_any(E):
    """True iff any off-diagonal entry of E ((m, m) or (T, m, m)) is
    nonzero — computed ON DEVICE so only one scalar crosses the link."""
    eye = jnp.eye(E.shape[-1], dtype=bool)
    if E.ndim == 3:
        eye = eye[None]
    return jnp.any(jnp.where(eye, 0.0, E) != 0.0)


def _is_diagonal(E) -> bool:
    """Is the error covariance diagonal (per month or stacked
    (T, m, m))?

    Host arrays are checked in numpy; device arrays via a jitted
    on-device reduction fetching a single scalar: ``np.asarray(E)`` on
    a device array would copy the full (m, m) matrix to the host on
    EVERY monthly solve.
    """
    import numpy as np

    if isinstance(E, jax.Array):
        if E.ndim == 1:
            return True  # a 1-D error_cov IS the diagonal
        return not bool(_offdiag_any(E))
    Eh = np.asarray(E)
    if Eh.ndim == 1:
        return True
    if Eh.ndim == 2:
        Eh = Eh[None]
    k = np.arange(Eh.shape[-1])
    off = Eh.copy()
    off[:, k, k] = 0.0
    return not np.any(off)


def lowrank_kriging(
    psd: LowRankPSD, idx, obs, error_cov
) -> LowRankKrigingResult:
    """Ordinary kriging against a factored (clipped) covariance.

    `psd` is the ``LowRankPSD`` from a `_lowrank` clip; `idx` the grid
    indices of the m observed cells; `error_cov` the (m, m)
    observation-error covariance OR its (m,) diagonal (diagonal E takes
    the m^3-free Woodbury route either way; passing the diagonal also
    skips uploading m^2 zeros — 100 MB at m = 5000). Field, uncertainty
    and constraint mask are EXACT for the factored covariance
    (cross-checked against the dense solver in tests); cost
    O(m^3 + n r^2) dense-E / O(n r^2 + m r^2) diagonal-E, memory O(n r).
    """
    y = jnp.asarray(obs, psd.vectors.dtype)
    E = jnp.asarray(error_cov, psd.vectors.dtype)
    check_idx_unique(idx, E)
    field, uncert2, cmask, _ = _lowrank_solve(
        psd.vectors,
        psd.gains,
        psd.floor,
        E,
        jnp.asarray(idx),
        y,
        jax.random.key(0),
        0,
        e_diag=_is_diagonal(error_cov),
    )
    return LowRankKrigingResult(
        field, jnp.sqrt(jnp.clip(uncert2, 0.0)), cmask
    )


def lowrank_ensemble_step(
    psd: LowRankPSD,
    idx,
    obs,
    error_cov,
    key,
    n_members: int = 100,
):
    """Two-stage perturbation ensemble on the factored covariance.

    Stage 1 draws exact N(0, C) states straight from the factors
    (O(n(r + members)), no Cholesky of C); stage 2 simple-kriges each
    state's simulated observations (+ correlated obs noise) back and
    forms ``member = field + grid_sim - state`` (same convention as
    ``models.stochastic.batched_ensemble_step``; reference scheme
    `stochastic.py:291-349`). Everything — factorisation, field,
    diagnostics, all members — is ONE compiled dispatch. `error_cov`
    may be the (m, m) matrix or its (m,) diagonal (see
    :func:`lowrank_kriging`).

    Returns (result, members): a ``LowRankKrigingResult`` and the
    (n_members, n) member stack.
    """
    y = jnp.asarray(obs, psd.vectors.dtype)
    E = jnp.asarray(error_cov, psd.vectors.dtype)
    check_idx_unique(idx, E)
    field, uncert2, cmask, members = _lowrank_solve(
        psd.vectors,
        psd.gains,
        psd.floor,
        E,
        jnp.asarray(idx),
        y,
        key,
        int(n_members),
        e_diag=_is_diagonal(error_cov),
    )
    res = LowRankKrigingResult(
        field, jnp.sqrt(jnp.clip(uncert2, 0.0)), cmask
    )
    return res, members


@partial(jax.jit, static_argnames=("n_members", "diagnostics", "e_diag"))
def _lowrank_months_scan(
    V, g, f, idx_m, obs_m, err_m, key, n_members, diagnostics, e_diag
):
    def one_month(carry, inputs):
        idx, y, E, k = inputs
        field, uncert2, cmask, members = _lowrank_solve_impl(
            V, g, f, E, idx, y, k, n_members, diagnostics, e_diag
        )
        return carry, (field, uncert2, cmask, members)

    keys = jax.random.split(key, idx_m.shape[0])
    _, out = jax.lax.scan(
        one_month, None, (idx_m, obs_m, err_m, keys)
    )
    return out


def lowrank_months_scan(
    psd: LowRankPSD,
    idx_months,
    obs_months,
    error_cov_months,
    key=None,
    n_members: int = 0,
    diagnostics: bool = True,
):
    """Batch kriging (+ optional ensembles) over months, one program.

    The non-stationary analog of
    ``models.kernel_kriging.months_scan_kriging``: the factored clipped
    covariance is fixed across months while observations change;
    `idx_months` (T, m), `obs_months` (T, m), `error_cov_months`
    (T, m, m) — or, for diagonal monthly error covariances, the
    (T, m) stack of their DIAGONALS, which takes the m^3-free Woodbury
    route and skips uploading T m^2 floats (1.2 GB for a year at
    m = 5000) — pad ragged months with
    ``models.kernel_kriging.pad_month_observations``. One ``lax.scan``
    evaluates every month (field, uncertainty, constraint mask, and
    `n_members` two-stage ensemble members each) in a single compiled
    dispatch. Returns (results, members): a ``LowRankKrigingResult`` of
    (T, n) stacks and the (T, n_members, n) member stack (empty when
    n_members=0). ``diagnostics=False`` zeroes the uncertainty /
    constraint-mask outputs and skips their m^3 triangular work. The
    per-month cost is dominated by the observation-system
    factorisation, not by the n-sized work.
    """
    dtype = psd.vectors.dtype
    if key is None:
        key = jax.random.key(0)
    err_m = jnp.asarray(error_cov_months, dtype)
    # (T, m): stacked DIAGONALS by contract (each month's scan slice is
    # then the 1-D form the solve core consumes); (T, m, m): stacked
    # matrices, diagonality checked on device
    e_diag = err_m.ndim == 2 or _is_diagonal(err_m)
    field, uncert2, cmask, members = _lowrank_months_scan(
        psd.vectors,
        psd.gains,
        psd.floor,
        jnp.asarray(idx_months),
        jnp.asarray(obs_months, dtype),
        err_m,
        key,
        int(n_members),
        bool(diagnostics),
        e_diag,
    )
    res = LowRankKrigingResult(
        field, jnp.sqrt(jnp.clip(uncert2, 0.0)), cmask
    )
    return res, members


def lowrank_members_from_states(
    psd: LowRankPSD, idx, obs, error_cov, states, eps
):
    """Deterministic member update for PRE-DRAWN states and obs noise.

    `states` (n_members, n), `eps` (n_members, m): the test seam — feed
    fixed draws and the output must equal the dense two-stage update
    ``field + W'(state[idx] + eps) - state`` with W the simple-kriging
    weights of the densified covariance.
    """
    dtype = psd.vectors.dtype
    V, g, f = psd.vectors, psd.gains, psd.floor
    idx = jnp.asarray(idx)
    y = jnp.asarray(obs, dtype)
    E = jnp.asarray(error_cov, dtype)
    return _members_from_states_jit(
        V, g, f, E, idx, y,
        jnp.asarray(states, dtype), jnp.asarray(eps, dtype),
    )


@jax.jit
def _members_from_states_jit(V, g, f, E, idx, y, states, eps):
    # one factorisation and ONE stacked solve shared by the field solve
    # and the member update (diagnostics are not needed here)
    V_o = V[idx]
    f_o = f[idx]
    sim_obs = states[:, idx] + eps
    u, w, A = _stacked_obs_solve(V_o, g, f_o, E, y, sim_obs.T)
    field, _, _, _ = _field_from_uw(V, g, f, idx, u, w, y)
    grid_sim = _cross_t_apply(V, g, f, idx, A)  # (n, members)
    return field[None, :] + (grid_sim - states.T).T


@partial(jax.jit, static_argnames=("method",))
def _lowrank_loo_jit(V_o, g, f_o, E, y, mean, method):
    from .kernel_kriging import _loo_from_K

    K = (V_o * g[None, :]) @ V_o.T + jnp.diag(f_o)
    K = K + (jnp.diag(E) if E.ndim == 1 else E)
    return _loo_from_K(K, y, mean, method)


def lowrank_crossval(
    psd, idx, obs, error_cov, mean: float = 0.0,
    method: str = "ordinary",
):
    """Leave-one-out cross-validation against a factored covariance.

    The production counterpart of
    :func:`models.kernel_kriging.kriging_crossval` for the CLIPPED
    non-stationary pipeline: scores the repaired ``LowRankPSD`` on the
    month's observations via the Dubrule LOO identity — one m-sized
    observation system (m = n_obs, built densely from the factors;
    ~100 MB at m = 5000) instead of m refits, with the
    Lagrange-bordered form for ``method="ordinary"``. Use it to choose
    between candidate parameter fields / clip targets before paying
    the grid solve. Returns a
    :class:`models.kernel_kriging.CrossValResult`.
    """
    from .kernel_kriging import CrossValResult

    if method not in ("ordinary", "simple"):
        raise ValueError(f"Unknown kriging method: {method}")
    y = jnp.asarray(obs, psd.vectors.dtype)
    E = jnp.asarray(error_cov, psd.vectors.dtype)
    check_idx_unique(idx, E)
    idx = jnp.asarray(idx)
    out = _lowrank_loo_jit(
        psd.vectors[idx], psd.gains.astype(psd.vectors.dtype),
        psd.floor[idx], E, y,
        jnp.asarray(mean, psd.vectors.dtype), method,
    )
    return CrossValResult(*out)
