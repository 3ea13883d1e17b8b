r"""Randomized partial symmetric eigensolver (top-k Ritz pairs).

Device analog of the reference's partial spectrum call
``scipy.linalg.eigh(subset_by_index=...)`` (``covariance_tools.py:325``):
a full ``eigh`` is O(n^3) and needs the dense matrix, while eigenvalue
clipping only ever needs the TOP of the spectrum plus the trace. This
module computes the dominant k Ritz pairs by randomized subspace
iteration (Halko, Martinsson & Tropp 2011, alg. 4.4 + Rayleigh-Ritz):
``n_iter + 2`` applications of the operator to an (n, k+p) block — each
one big matmul — plus tall-skinny QRs and one tiny host ``eigh`` of
the (k+p, k+p) projection.

The operator can be a dense device matrix, a bf16-stored matrix, or a
kernel-streamed matvec (``ops.sampling.dense_matvec`` /
``kernel_matvec``), so the same code path scales to the 65k 1-degree
grid where no dense factorisation or full spectrum fits.

Accuracy model: a Ritz pair retained by a clip (rank r << k, block size
l = k + oversample) converges like (lambda_l / lambda_r)^(2 n_iter + 1);
for the decaying spectra of spatial covariances the clip resynthesis is
exact to roundoff at the defaults (pinned by tests against full LAPACK
at n=2048 and against an analytic 16,384-point implicit operator).
Large-magnitude NEGATIVE eigenvalues, if present, enter the captured
subspace (the iteration converges in |lambda|) but are sorted to the
bottom of the Ritz values and excluded from the returned top-k — they
only consume subspace width.
"""

import logging
from typing import Callable

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

from .sampling import Matvec, dense_matvec

logger = logging.getLogger(__name__)

# A widening locks converged Ritz pairs (sweeps at the active width)
# only above this operator dimension. Rationale: locking pays when an
# operator SWEEP is expensive — streamed kernel-recompute operators
# whose per-sweep cost scales n² (~1-2.6 s at 259k), and only
# streamed/sharded operators exist at such n (a dense store would not
# fit). Below it, the joint warm start wins: its head gains extra
# passes each stage and accepts at round 0 (measured at 16k stream:
# 0.66-0.74 s joint vs 4-11 s locked). The threshold is a STATIC
# property of the problem, deliberately not a measured wall: a
# wall-clock decision flipped flavours between the compile call
# (compile-inflated wall) and the warm call of the same clip, and the
# flipped flavour's program compiled inside the "warm" run (measured:
# a 74 s warm 16k clip).
_LOCK_MIN_N = 200_000


class PartialSpectrumError(ValueError):
    """The adaptive partial-spectrum solve hit max_rank without
    converging (spectrum too flat for a low-rank clip)."""


@jax.jit
def _cholqr_once(Y):
    """One Cholesky-QR pass: Q = Y R^{-1} with R = chol(Y'Y)'.

    All the work is matmuls plus one (l, l) factorisation, instead of
    a Householder QR of a tall-skinny block. Returns (Q, ok): ok=False
    when Y'Y is numerically singular (Cholesky produced NaN) and the
    caller must fall back.
    """
    G = Y.T @ Y
    # small diagonal lift: keeps chol alive when Y is nearly rank-
    # deficient; the second pass removes the resulting non-orthogonality
    eps = jnp.asarray(1e-6 if Y.dtype == jnp.float32 else 1e-12, Y.dtype)
    G = G + (eps * jnp.trace(G) / G.shape[0]) * jnp.eye(
        G.shape[0], dtype=Y.dtype
    )
    L = jnp.linalg.cholesky(G)
    # Invert the SMALL (l, l) factor and apply it as a matmul: a tall
    # (n, l) triangular solve runs well below matmul throughput, while
    # Y @ L^{-T} is one dense matmul. Any inverse roundoff
    # lands in Q's non-orthogonality, which the second CholQR pass
    # removes (that is what the "2" in CholQR2 is for).
    Linv = jsl.solve_triangular(
        L, jnp.eye(L.shape[0], dtype=Y.dtype), lower=True
    )
    Q = Y @ Linv.T
    ok = jnp.isfinite(L[-1, -1])
    return Q, ok


def _cholqr2(Y):
    """CholQR2 orthonormal basis of range(Y) + a DEVICE validity flag.

    Two Cholesky-QR passes give orthogonality to ~machine precision for
    condition numbers up to ~1/sqrt(eps) (Yamamoto et al. 2015) — ample
    for subspace iteration, where Y is a covariance image of a random
    block. The flag stays on device: callers combine flags across all
    passes and sync ONCE instead of blocking on a host fetch per pass.
    """
    Q, ok1 = _cholqr_once(Y)
    Q, ok2 = _cholqr_once(Q)
    return Q, ok1 & ok2


def _as_matvec(operator, n: int | None):
    """Normalise (dense | callable) to (matvec, n).

    Dense matrices come back as an ``ops.sampling.Matvec`` (memoised
    static fn + the matrix as an operand) so the fused-stage dispatch
    path applies to them too; the matmul accumulates in the matrix
    dtype (f32 for a bf16 store).
    """
    if callable(operator):
        if n is None:
            raise ValueError("n is required for a callable operator")
        return operator, n
    A = jnp.asarray(operator)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"operator must be square, got {A.shape}")
    if n is not None and n != A.shape[0]:
        raise ValueError(f"n={n} does not match operator shape {A.shape}")
    compute = jnp.float32 if A.dtype == jnp.bfloat16 else A.dtype
    return dense_matvec(A, compute_dtype=compute), int(A.shape[0])


def topk_eigh(
    operator,
    k: int,
    n: int | None = None,
    *,
    key=None,
    oversample: int = 8,
    n_iter: int = 6,
    dtype=None,
) -> tuple[np.ndarray, jax.Array]:
    """Top-k (algebraically largest) eigenpairs of a symmetric operator.

    Parameters
    ----------
    operator : (n, n) array or callable
        Symmetric matrix, or a matvec closure mapping an (n, b) block to
        ``A @ block`` (e.g. ``ops.sampling.kernel_matvec``).
    k : int
        Number of eigenpairs to return.
    n : int, optional
        Operator dimension (required for callables).
    key : jax PRNG key, optional
        Seed for the random test block (default: ``jax.random.key(0)`` —
        the result is deterministic by default, like LAPACK).
    oversample : int
        Extra subspace width p; the k-th pair's accuracy is governed by
        the gap to lambda_{k+p}.
    n_iter : int
        Power (subspace) iterations; each sharpens convergence by
        (lambda_{k+p}/lambda_k)^2.
    dtype : optional
        Dtype of the random block (default: f64 when x64 is enabled on a
        CPU backend, else f32).

    Returns
    -------
    (eigvals, eigvecs)
        ``eigvals``: (k,) numpy array, DESCENDING. ``eigvecs``: (n, k)
        device array of matching Ritz vectors. Orthonormal to roundoff
        when the operator's numerical rank exceeds the iteration width;
        for rank-deficient operators (fast-decaying covariance spectra)
        f32 columns are orthonormal only to ~1e-3 — consumers that
        resynthesise matrices from a retained subset must re-normalise
        (the clips in ``ops.covariance_tools`` do).
    """
    matvec, n = _as_matvec(operator, n)
    if k < 1:
        raise ValueError("k must be >= 1")
    k = min(k, n)
    if key is None:
        key = jax.random.key(0)
    if dtype is None:
        dtype = jnp.asarray(0.0).dtype

    width = min(n, k + oversample)
    if width >= n:  # subspace is the whole space: just be exact
        A = jnp.asarray(matvec(jnp.eye(n, dtype=dtype)))
        w, V = np.linalg.eigh(np.asarray(A))
        order = np.argsort(w)[::-1][:k]
        return w[order], jnp.asarray(V[:, order.copy()])

    # All CholQR validity flags are combined ON DEVICE and checked once
    # at the end (no mid-loop host sync); on the rare failure the whole
    # iteration reruns with Householder QR, regenerating the start block
    # from the key (retaining it would cost an extra (n, width) buffer
    # — 2.1 GB at 259k — for a path that essentially never runs).
    Y = jnp.asarray(matvec(jax.random.normal(key, (n, width), dtype)))
    all_ok = jnp.asarray(True)
    for _ in range(n_iter):
        Q, ok = _cholqr2(Y)
        all_ok = all_ok & ok
        Y = jnp.asarray(matvec(Q))
    Q, ok = _cholqr2(Y)
    all_ok = all_ok & ok
    B = jnp.asarray(matvec(Q))
    T = Q.T @ B
    T = 0.5 * (T + T.T)
    # (width, width) projection: tiny — host LAPACK.
    # Fetching T is the single host sync that also resolves `all_ok`.
    T_host, ok_host = np.asarray(T), bool(np.asarray(all_ok))
    if not ok_host:  # pathological input: redo with Householder QR
        Q, B = _householder_iterate(matvec, key, n, width, n_iter, dtype)
        T = 0.5 * ((Q.T @ B) + (Q.T @ B).T)
        T_host = np.asarray(T)
    theta, U = np.linalg.eigh(T_host)
    order = np.argsort(theta)[::-1][:k]
    eigvecs = Q @ jnp.asarray(U[:, order.copy()])
    # NOTE: when the operator's numerical rank is below the iteration
    # width (covariances with fast-decaying spectra), the basis spans
    # degenerate directions and the returned columns are orthonormal
    # only to ~1e-3 in f32. The LEADING pairs stay accurate; consumers
    # that resynthesise matrices from a retained subset (the clips)
    # re-normalise those columns.
    return theta[order], eigvecs


@jax.jit
def _ritz_residual_norms(Q, B, U, theta):
    """Column norms of A u_i - theta_i u_i for Ritz pairs u_i = Q U_i.

    Uses B = A @ Q (already computed by the iteration), so the exact
    residual ||B U_i - theta_i Q U_i|| costs two (n, w) x (w, r)
    matmuls — no extra operator application. |theta_i - lambda| <=
    resid_i (Bauer-Fike for symmetric A), so these norms are a RIGOROUS
    accuracy certificate for the computed eigenvalues.
    """
    R = B @ U - (Q @ U) * theta[None, :]
    return jnp.sqrt(jnp.sum(R * R, axis=0))


@jax.jit
def _resid_and_vectors(Q, B, U_r, theta_r, mask):
    """(max masked Ritz residual, retained vectors Q U_r) in ONE
    dispatch. ``mask`` zeroes the residuals of shape-padding columns
    beyond the true retained rank — they carry zero gain downstream and
    must not fail the acceptance gate."""
    QU = Q @ U_r
    R = B @ U_r - QU * theta_r[None, :]
    resid = jnp.sqrt(jnp.sum(R * R, axis=0))
    return jnp.max(resid * mask), QU


# ---------------------------------------------------------------------------
# Fused stage execution for Matvec operators
# ---------------------------------------------------------------------------
# An unfused adaptive stage is ~15 dispatches (6 matvecs, 10 CholQR
# halves, projection), each with its own launch and host round-trip.
# When the operator is an ``ops.sampling.Matvec`` — a STATIC fn plus
# array operands — the whole stage (start-block application, n_iter
# subspace iterations, final projection) fuses into one jitted program
# with the operands as arguments. Cached per (fn, n_iter): the fn slot
# of Matvec is module-level/memoised, so re-created operators hit the
# same compiled stage.
_STAGE_JIT_CACHE: dict = {}


def _fused_stage_fns(fn, n_iter: int):
    cached = _STAGE_JIT_CACHE.get((fn, n_iter))
    if cached is not None:
        return cached

    def _iterate(operands, Y):
        all_ok = jnp.asarray(True)
        for _ in range(n_iter):
            Q, ok = _cholqr2(Y)
            all_ok = all_ok & ok
            Y = fn(*operands, Q)
        Q, ok = _cholqr2(Y)
        all_ok = all_ok & ok
        B = fn(*operands, Q)
        T = Q.T @ B
        T = 0.5 * (T + T.T)
        return Q, B, all_ok, T

    @jax.jit
    def cold(operands, Z):
        return _iterate(operands, fn(*operands, Z))

    @jax.jit
    def warm(operands, Q_lock, B_lock, B_act, Z_fresh):
        # LOCKED widening: the caller has split the previous stage's
        # Ritz pairs into a CONVERGED leading prefix (Q_lock with its
        # exact action B_lock = A Q_lock — measured residuals, not
        # assumed) and the rest (warm-started from their current action
        # B_act). Only [B_act | A Z_fresh] iterates, deflated against
        # the locked basis, so each sweep costs the ACTIVE width; the
        # final Rayleigh-Ritz on the combined block resolves coupling
        # exactly and acceptance still passes the exact-residual gate.
        # Q_lock may have zero columns (nothing converged: plain joint
        # re-iteration) or the full previous width (everything
        # converged: pure fresh-block deflation) — one code path.
        # The active block runs n_iter + 2 sweeps: a joint warm start
        # effectively gives carried pairs extra passes every stage;
        # the locked path must buy the same accuracy for its active
        # pairs explicitly, and active-width sweeps are the cheap ones
        # (measured at 16k: without these, round-0 acceptance fails
        # where the joint path passed, costing a full-width extra
        # round + host eigh + factor upload).
        all_ok = jnp.asarray(True)
        Y = jnp.concatenate([B_act, fn(*operands, Z_fresh)], axis=1)
        for _ in range(n_iter + 2):
            Y = Y - Q_lock @ (Q_lock.T @ Y)
            Qa, ok = _cholqr2(Y)
            all_ok = all_ok & ok
            Y = fn(*operands, Qa)
        Y = Y - Q_lock @ (Q_lock.T @ Y)
        Qa, ok = _cholqr2(Y)
        all_ok = all_ok & ok
        Ba = fn(*operands, Qa)
        Q = jnp.concatenate([Q_lock, Qa], axis=1)
        B = jnp.concatenate([B_lock, Ba], axis=1)
        T = Q.T @ B
        T = 0.5 * (T + T.T)
        return Q, B, all_ok, T

    @jax.jit
    def extra(operands, B):
        Q, ok = _cholqr2(B)
        B2 = fn(*operands, Q)
        T = Q.T @ B2
        T = 0.5 * (T + T.T)
        return Q, B2, ok, T

    cached = (cold, warm, extra)
    _STAGE_JIT_CACHE[(fn, n_iter)] = cached
    return cached


@jax.jit
def _rotate_ritz(Q, B, U_sorted, theta_sorted):
    """Ritz rotation + per-pair exact residual norms.

    QU = current Ritz vectors (descending eigenvalue order), BU their
    exact action (B = A Q so A QU = BU), rn_j = ||A u_j - theta_j u_j||
    — everything the locking split needs, two (n, w) matmuls total.
    """
    QU = Q @ U_sorted
    BU = B @ U_sorted
    rn = jnp.linalg.norm(BU - QU * theta_sorted[None, :], axis=0)
    return QU, BU, rn


def _householder_iterate(matvec, key, n, width, n_iter, dtype):
    """Subspace iteration orthonormalised by Householder QR.

    The rescue path for inputs that break Cholesky-QR (Gram-matrix
    overflow: entries beyond sqrt(dtype max)). LAPACK/XLA QR computes
    column norms with scaling, so it survives magnitudes CholQR cannot.
    Restarts from a key-derived random block (keeping the original block
    alive would cost an (n, width) buffer for a path that almost never
    runs). Returns (Q, B = A @ Q).
    """
    Y = jnp.asarray(matvec(jax.random.normal(key, (n, width), dtype)))
    for _ in range(n_iter):
        Y = jnp.asarray(matvec(jnp.linalg.qr(Y)[0]))
    Q = jnp.linalg.qr(Y)[0]
    B = jnp.asarray(matvec(Q))
    return Q, B


def adaptive_topk_eigh(  # noqa: C901
    operator,
    accept: Callable,
    n: int | None = None,
    *,
    k0: int = 64,
    max_rank: int = 2048,
    key=None,
    oversample: int = 8,
    n_iter: int = 6,
    tol: float | None = None,
    extra_rounds: int = 2,
    rank_multiple: int = 1,
    dtype=None,
    predict: Callable | None = None,
) -> tuple[np.ndarray, jax.Array, int]:
    """Adaptive top-of-spectrum solve: find the retained rank a clip
    needs, growing the subspace only as far as the spectrum demands.

    ``accept(w)`` maps the computed DESCENDING Ritz head to the retained
    rank r (or None when the head is not yet deep enough). A candidate
    rank is accepted through either of two gates:

    - **residual gate**: every retained pair's exact Ritz residual
      ||A u - theta u|| is <= ``tol * theta_1`` (rigorous eigenvalue
      error bound, measured on device from quantities the iteration
      already has). This typically accepts at width ~ r + oversample —
      half the matvec work, 4x less host-eigh work than the structural
      gate for decaying spectra.
    - **structural gate**: ``r <= k // 2`` — the round-2 rule (effective
      oversampling scales with r itself). Kept as the provable fallback
      so accuracy can never regress even when residuals are noisy.

    When a candidate fails only the residual gate, up to
    ``extra_rounds`` additional power iterations sharpen the SAME block
    (one matvec each) before widening. Widening is WARM-STARTED with
    RITZ LOCKING: the previous stage's Ritz pairs are split by their
    MEASURED residuals — the converged leading prefix is frozen
    (its basis and exact action carried; alignment rounds the lock
    count DOWN to ``rank_multiple`` so no unconverged pair is ever
    frozen), while the remaining pairs re-iterate (warm-started from
    their current action) together with the fresh random columns,
    deflated against the locked basis. Each widening sweep therefore
    costs only the ACTIVE width (a streamed operator's sweep cost is
    linear in block width), the poorly-converged block-edge pairs keep
    iterating rather than being frozen, and the final Rayleigh-Ritz on
    the combined block resolves locked/active coupling exactly.
    Acceptance always passes through the exact-residual gate, so
    locking affects cost, never correctness. (Round-2 weakness: the
    converged block was discarded on every k-doubling; plain joint
    re-iteration carried it but re-paid full-width sweeps for pairs
    that were already converged.)

    ``tol`` defaults by dtype: 1e-10 for f64 (the clip parity tests
    pin 1e-8 against full LAPACK), 1e-2 for f32. The f32 default is
    calibrated ABOVE the bf16 operator-application noise floor
    (measured at 65k: retained-pair residuals plateau at 3.5-6.6e-3
    regardless of iteration count, and the structural-gate result's own
    subspace action error is ~7e-3 — a tighter tolerance only buys a 6x
    more expensive answer of the same accuracy). Ritz VALUES converge
    as resid^2/gap, far tighter than the bound. Raises
    :class:`PartialSpectrumError` past ``max_rank``.

    ``rank_multiple`` pads the RETURNED vector block to a multiple
    (capped at the stage width): the adaptive rank differs run to run
    (boundary noise at the acceptance threshold), and every distinct
    rank is a fresh compiled program for the slice/normalise/solver
    chain downstream — measured at 65k, an 0.8 s warm clip becomes
    ~5 s of recompilation whenever the rank moves by one. Padding
    columns are genuine Ritz vectors whose values the caller must
    zero-gain (the clips do); ``r`` still reports the true retained
    rank.

    ``predict(w, k)`` (optional) maps the current Ritz head to an
    ESTIMATE of the rank the acceptance will need (or None when it
    cannot tell). Blind doubling overshoots the needed width by up to
    2x — and every sweep of a streamed operator pays the full n^2
    kernel assembly times the block width, so overshoot is wall-clock.
    A prediction (e.g. geometric tail extrapolation for an
    explained-variance target, as
    ``ops.covariance_tools.explained_variance_clip_lowrank`` supplies)
    NARROWS the widening to ~ the predicted rank (+10% + oversample,
    rounded to ``rank_multiple``), clamped to [k + step, 2k]: a
    doubling that overshoots a rank just past k pays CholQR cost
    quadratic in the excess width, while with Ritz locking an extra
    stage (the undershoot risk) is cheap. The prediction is fed only
    the measured-converged Ritz prefix, and jumping ahead of the
    doubling schedule is deliberately banned — real spectra decay
    faster than a local geometric fit, so trusted extrapolations
    overshoot (measured at 16k: 512 -> 1536 for a true need of ~650).

    Returns (w, V, r): ``w`` the full computed Ritz head (descending,
    numpy), ``V`` the (n, rp) retained Ritz vectors (device,
    rp = r rounded up to ``rank_multiple``), ``r`` the retained rank.
    """
    matvec, n = _as_matvec(operator, n)
    if k0 < 1:
        raise ValueError("k must be >= 1")
    if key is None:
        key = jax.random.key(0)
    if dtype is None:
        dtype = jnp.asarray(0.0).dtype
    if tol is None:
        tol = 1e-10 if jnp.finfo(dtype).bits >= 64 else 1e-2

    # Matvec operators (static fn + array operands) run each stage as
    # ONE fused jitted dispatch. Plain closures (host-side
    # matvecs, e.g. FFT-based test operators) take the unfused path.
    fused = None
    if isinstance(matvec, Matvec):
        fused = _fused_stage_fns(matvec.fn, n_iter)

    def run_stage(sub, width, locked):
        """(Q, B, all_ok(device), T_host) for one widened stage.

        `locked` is None for the cold first stage, else the
        (Q_lock, B_lock, B_act) split of the previous stage's Ritz
        pairs: the measured-converged leading prefix is frozen
        (deflation), the rest re-iterates warm-started from its
        current action alongside the fresh random columns.
        """
        if fused is not None:
            cold, warm_fn, _ = fused
            if locked is None:
                Z = jax.random.normal(sub, (n, width), dtype)
                return cold(matvec.operands, Z)
            Q_lock, B_lock, B_act = locked
            n_fresh = width - Q_lock.shape[1] - B_act.shape[1]
            Z = jax.random.normal(sub, (n, n_fresh), dtype)
            return warm_fn(matvec.operands, Q_lock, B_lock, B_act, Z)
        if locked is None:
            Y = jnp.asarray(
                matvec(jax.random.normal(sub, (n, width), dtype))
            )
            all_ok = jnp.asarray(True)
            for _ in range(n_iter):
                Q, ok = _cholqr2(Y)
                all_ok = all_ok & ok
                # drop the pre-QR block BEFORE the sweep: at 6.48M a
                # width-96 (n, w) buffer is 2.5 GB and holding it
                # across the sweep's pad/group/concat intermediates
                # tipped a 16 GB chip into ResourceExhausted
                Y = None
                Y = jnp.asarray(matvec(Q))
            Q, ok = _cholqr2(Y)
            all_ok = all_ok & ok
            Y = None
            Bn = jnp.asarray(matvec(Q))
            T = Q.T @ Bn
            return Q, Bn, all_ok, 0.5 * (T + T.T)
        # locked widening (see the fused `warm`): sweeps cost the
        # ACTIVE width only; n_iter + 2 active sweeps (see fused)
        Q_lock, B_lock, B_act = locked
        n_fresh = width - Q_lock.shape[1] - B_act.shape[1]
        fresh = jax.random.normal(sub, (n, n_fresh), dtype)
        all_ok = jnp.asarray(True)
        Y = jnp.concatenate(
            [B_act, jnp.asarray(matvec(fresh))], axis=1
        )
        for _ in range(n_iter + 2):
            Y = Y - Q_lock @ (Q_lock.T @ Y)
            Qa, ok = _cholqr2(Y)
            all_ok = all_ok & ok
            Y = None  # see cold path: frees (n, w) across the sweep
            Y = jnp.asarray(matvec(Qa))
        Y = Y - Q_lock @ (Q_lock.T @ Y)
        Qa, ok = _cholqr2(Y)
        all_ok = all_ok & ok
        Y = None
        Ba = jnp.asarray(matvec(Qa))
        Q = jnp.concatenate([Q_lock, Qa], axis=1)
        Bn = jnp.concatenate([B_lock, Ba], axis=1)
        T = Q.T @ Bn
        return Q, Bn, all_ok, 0.5 * (T + T.T)

    def extra_round(Q, B):
        if fused is not None:
            return fused[2](matvec.operands, B)
        Q2, ok = _cholqr2(B)
        B2 = jnp.asarray(matvec(Q2))
        T = Q2.T @ B2
        return Q2, B2, ok, 0.5 * (T + T.T)

    k = min(n, k0)
    # `locked` carries the previous stage's Ritz pairs into the next
    # widening, split by MEASURED residuals: (Q_lock, B_lock) the
    # converged leading prefix (frozen: deflation), B_act the action of
    # the still-inaccurate pairs (warm start for re-iteration). None =
    # cold first stage.
    Q = None
    B = None
    locked = None
    use_lock = n >= _LOCK_MIN_N
    while True:
        width = min(n, k + oversample)
        if width >= n:
            # subspace is the whole space: be exact
            A = jnp.asarray(matvec(jnp.eye(n, dtype=dtype)))
            w, V = np.linalg.eigh(np.asarray(A))
            w = w[::-1]
            V = V[:, ::-1].copy()
            r = accept(w)
            r = n if r is None else r
            return w, jnp.asarray(V[:, :r]), r

        key, sub = jax.random.split(key)
        Q, B, all_ok, T = run_stage(sub, width, locked)

        rounds = 0
        while True:
            # ONE host sync resolves T and every validity flag so far
            T_host, ok_host = np.asarray(T), bool(np.asarray(all_ok))
            if not ok_host:
                key, sub = jax.random.split(key)
                Q, B = _householder_iterate(
                    matvec, sub, n, width, n_iter, dtype
                )
                all_ok = jnp.asarray(True)
                T = Q.T @ B
                T_host = np.asarray(0.5 * (T + T.T))
            theta, U = np.linalg.eigh(T_host)
            order = np.argsort(theta)[::-1]
            w = theta[order]
            r = accept(w)

            if r is not None and r <= k:
                # pad the SHAPES to rank_multiple so every downstream
                # program (residual, Q@U, normalise, solvers) compiles
                # once across runs whose rank jitters at the boundary
                rp = min(width, -(-r // rank_multiple) * rank_multiple)
                U_r = jnp.asarray(U[:, order[:rp]].copy())
                theta_r = jnp.asarray(w[:rp], U_r.dtype)
                if r <= k // 2:  # structural gate
                    logger.info(
                        "adaptive eigh: structural accept r=%d at "
                        "width=%d (round %d)", r, width, rounds,
                    )
                    return w, Q @ U_r, r
                mask = jnp.asarray(
                    (np.arange(rp) < r).astype(np.float32), U_r.dtype
                )
                resid_max, V = _resid_and_vectors(
                    Q, B, U_r, theta_r, mask
                )
                scale = max(abs(float(w[0])), np.finfo(np.float32).tiny)
                rel = float(resid_max) / scale
                logger.info(
                    "adaptive eigh: width=%d r=%d round=%d "
                    "max_resid/theta1=%.3e (tol %.1e)",
                    width, r, rounds, rel, tol,
                )
                if rel <= tol:
                    return w, V, r  # residual gate
            if r is None or r > k or rounds >= extra_rounds:
                break  # deeper head needed, or sharpening exhausted
            # sharpen the same block: one more power iteration
            rounds += 1
            Q, B, ok, T = extra_round(Q, B)
            all_ok = all_ok & ok

        if k >= min(n, max_rank):
            raise PartialSpectrumError(
                "Partial-spectrum solve did not converge within "
                f"max_rank={max_rank} eigenpairs — the spectrum is too "
                "flat for a low-rank clip; lower the target or use "
                "spectrum='full'."
            )
        # Widening warm-start flavour (see _LOCK_MIN_N). Ritz locking
        # trades (a) extra acceptance rounds — the active block starts
        # less converged than a jointly re-iterated one — against (b)
        # sweeps at the active width instead of the full width. (b)
        # only wins when a sweep is expensive (streamed operators at
        # large n: locking cut the 259k repair 38-42 s -> 27-30 s);
        # for cheap sweeps the joint path's round-0 acceptance wins.
        align = max(1, rank_multiple)
        scale = max(abs(float(w[0])), np.finfo(np.float32).tiny)
        if use_lock:
            # lock the converged leading prefix (aligned DOWN so no
            # unconverged pair is ever frozen), carry the rest's
            # action as the re-iteration warm start. ~2 (n, w) matmuls
            # — pure matmuls, no operator sweep.
            U_sorted = jnp.asarray(U[:, order.copy()])
            theta_sorted = jnp.asarray(w, U_sorted.dtype)
            QU, BU, rn = _rotate_ritz(Q, B, U_sorted, theta_sorted)
            conv = np.asarray(rn) / scale <= tol
            n_conv = (
                int(np.argmin(conv)) if not conv.all() else len(conv)
            )
            n_lock = n_conv - n_conv % align
            locked = (QU[:, :n_lock], BU[:, :n_lock], BU[:, n_lock:])
        else:
            # joint re-iteration: carry the whole block's action, lock
            # nothing (round-3 behaviour; no rotation, no U upload).
            # The predict hook still needs the MEASURED-converged
            # prefix — feeding it the full unconverged head is exactly
            # the biased-extrapolation failure documented below — so
            # when a prediction is wanted, pay the two (n, w) residual
            # matmuls (no operator sweep) to find it.
            if predict is not None:
                _, _, rn = _rotate_ritz(
                    Q, B,
                    jnp.asarray(U[:, order.copy()]),
                    jnp.asarray(w, Q.dtype),
                )
                conv = np.asarray(rn) / scale <= tol
                n_conv = (
                    int(np.argmin(conv)) if not conv.all() else len(conv)
                )
            else:
                n_conv = len(w)
            n_lock = 0
            locked = (Q[:, :0], B[:, :0], B)

        cap = min(n, max_rank)
        k_next = min(cap, 2 * k)
        if predict is not None:
            # extrapolate ONLY from the measured-converged prefix:
            # unconverged tail Ritz values are biased and an
            # extrapolation from them over- or under-shoots wildly
            # (measured at 16k: a full-head prediction widened 512 ->
            # 1536 where the true need was ~650, and the CholQR cost
            # at the inflated width dominated the clip)
            p = predict(w[:n_conv], k)
            if p is not None:
                step = max(oversample, rank_multiple)
                p = int(1.1 * p) + oversample
                p = -(-p // align) * align
                # a prediction may only NARROW the widening (a doubling
                # that overshoots a rank just past k pays CholQR and
                # sweep cost quadratic/linear in the excess width).
                # Skipping AHEAD of the doubling schedule is banned:
                # real spectra decay faster than a local geometric fit
                # (measured at 16k: a trusted extrapolation widened
                # 512 -> 1536 for a true need of ~650 and the CholQR
                # at the inflated width dominated the clip), and with
                # Ritz locking an extra stage is cheap — only the
                # unconverged tail re-iterates.
                k_next = min(cap, max(k + step, min(p, 2 * k)))
        logger.info(
            "adaptive eigh: widening %d -> %d (doubling %d), locking "
            "%d of %d computed pairs",
            k, k_next, min(cap, 2 * k), n_lock, len(w),
        )
        k = k_next


def topk_from_callable(
    kernel_matvec: Callable,
    n: int,
    k: int,
    **kwargs,
) -> tuple[np.ndarray, jax.Array]:
    """Convenience alias of :func:`topk_eigh` for streamed operators."""
    return topk_eigh(kernel_matvec, k, n, **kwargs)
