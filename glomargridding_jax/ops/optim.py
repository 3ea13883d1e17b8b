r"""Batched bounded Nelder-Mead in pure JAX.

The reference fits one ellipse per grid point with
``scipy.optimize.minimize(method="Nelder-Mead")`` inside a sequential
Python loop (its dominant cost: 58 s for a 5-degree global ocean grid).
Here the same simplex algorithm is written with ``lax.while_loop`` and
static shapes so a single ``jax.vmap`` fits EVERY grid point at once —
one device program, thousands of simplexes marching in lock-step.

Semantics follow scipy's implementation: same initial-simplex rule
(1.05x nonzero / 0.00025 for zero entries), same reflect / expand /
contract / shrink coefficients (1, 2, 0.5, 0.5), same termination test
(max |f_i - f_0| <= fatol AND max |x_i - x_0| <= xatol), same default
``maxiter = 200 * n``, and bounds handled by clipping candidate points
into the box. Results are not bit-identical to scipy (branch arithmetic
is vectorised) but converge to the same optima within test tolerances —
the reference's own round-trip tests are the oracle.
"""

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class NMResult(NamedTuple):
    """Result of a Nelder-Mead minimisation."""

    x: jax.Array  # (d,) best point
    fun: jax.Array  # scalar best value
    nit: jax.Array  # iterations executed
    success: jax.Array  # bool: converged within maxiter


def _initial_simplex(x0, lo, hi):
    """scipy-style initial simplex, clipped into bounds."""
    d = x0.shape[0]
    nonzdelt = 0.05
    zdelt = 0.00025
    base = jnp.broadcast_to(x0, (d, d))
    step = jnp.where(x0 == 0.0, zdelt, nonzdelt * x0)
    pts = base + jnp.diag(step)
    simplex = jnp.concatenate([x0[None, :], pts], axis=0)
    return jnp.clip(simplex, lo, hi)


def nelder_mead(
    fun: Callable,
    x0,
    bounds: tuple | None = None,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
    maxiter: int | None = None,
) -> NMResult:
    """Minimise `fun(x)` (scalar) from `x0` with bounded Nelder-Mead.

    Fully traceable: wrap in ``jax.vmap`` to run a batch of independent
    problems, or ``jax.jit`` for a single one. `bounds` is a
    (lower, upper) pair of length-d arrays (or None for unbounded).
    """
    x0 = jnp.asarray(x0)
    d = x0.shape[0]
    if maxiter is None:
        maxiter = 200 * d
    if bounds is None:
        lo = jnp.full((d,), -jnp.inf, x0.dtype)
        hi = jnp.full((d,), jnp.inf, x0.dtype)
    else:
        lo = jnp.asarray(bounds[0], x0.dtype)
        hi = jnp.asarray(bounds[1], x0.dtype)

    simplex = _initial_simplex(x0, lo, hi)
    fvals = jax.vmap(fun)(simplex)

    def cond(state):
        simplex, fvals, nit = state
        order = jnp.argsort(fvals)
        fs = fvals[order]
        xs = simplex[order]
        f_spread = jnp.max(jnp.abs(fs[1:] - fs[0]))
        x_spread = jnp.max(jnp.abs(xs[1:] - xs[0]))
        converged = (f_spread <= fatol) & (x_spread <= xatol)
        return (~converged) & (nit < maxiter)

    def body(state):
        simplex, fvals, nit = state
        order = jnp.argsort(fvals)
        simplex = simplex[order]
        fvals = fvals[order]

        centroid = jnp.mean(simplex[:-1], axis=0)
        xw = simplex[-1]
        fw = fvals[-1]
        fb = fvals[0]
        fsw = fvals[-2]
        direction = centroid - xw

        xr = jnp.clip(centroid + direction, lo, hi)
        xe = jnp.clip(centroid + 2.0 * direction, lo, hi)
        xoc = jnp.clip(centroid + 0.5 * direction, lo, hi)
        xic = jnp.clip(centroid - 0.5 * direction, lo, hi)
        fr = fun(xr)
        fe = fun(xe)
        foc = fun(xoc)
        fic = fun(xic)

        # scipy decision tree, arithmetic form
        take_expand = (fr < fb) & (fe < fr)
        take_reflect = ((fr < fb) & ~(fe < fr)) | (
            (fr >= fb) & (fr < fsw)
        )
        outside = (fr >= fsw) & (fr < fw)
        take_oc = outside & (foc <= fr)
        inside = fr >= fw
        take_ic = inside & (fic < fw)
        shrink = (outside & ~(foc <= fr)) | (inside & ~(fic < fw))

        cand_x = jnp.where(
            take_expand,
            xe,
            jnp.where(
                take_reflect, xr, jnp.where(take_oc, xoc, xic)
            ),
        )
        cand_f = jnp.where(
            take_expand,
            fe,
            jnp.where(
                take_reflect, fr, jnp.where(take_oc, foc, fic)
            ),
        )

        replaced_simplex = simplex.at[-1].set(cand_x)
        replaced_fvals = fvals.at[-1].set(cand_f)

        shrunk_simplex = jnp.clip(
            simplex[0][None, :] + 0.5 * (simplex - simplex[0][None, :]),
            lo,
            hi,
        )
        shrunk_fvals = jax.vmap(fun)(shrunk_simplex)

        new_simplex = jnp.where(shrink, shrunk_simplex, replaced_simplex)
        new_fvals = jnp.where(shrink, shrunk_fvals, replaced_fvals)
        return new_simplex, new_fvals, nit + 1

    simplex, fvals, nit = lax.while_loop(
        cond, body, (simplex, fvals, jnp.asarray(0))
    )
    best = jnp.argmin(fvals)
    order = jnp.argsort(fvals)
    fs = fvals[order]
    xs = simplex[order]
    f_spread = jnp.max(jnp.abs(fs[1:] - fs[0]))
    x_spread = jnp.max(jnp.abs(xs[1:] - xs[0]))
    success = (f_spread <= fatol) & (x_spread <= xatol)
    return NMResult(simplex[best], fvals[best], nit, success)


def _sigmoid_to_box(u, lo, hi):
    return lo + (hi - lo) * jax.nn.sigmoid(u)


def _box_to_sigmoid(x, lo, hi):
    frac = jnp.clip((x - lo) / (hi - lo), 1e-3, 1.0 - 1e-3)
    return jnp.log(frac) - jnp.log1p(-frac)


def lbfgs_minimize(
    fun: Callable,
    x0,
    bounds: tuple,
    maxiter: int = 200,
    tol: float = 1e-6,
) -> NMResult:
    """Bounded L-BFGS via a sigmoid box reparametrisation (optax).

    Gradient-based alternative to Nelder-Mead — usable here because the
    whole likelihood (including the Matern K_nu) is differentiable JAX;
    the reference cannot offer this ("autograd does not work with
    scipy's Bessel functions", reference ``model.py:540``). Converges in
    far fewer iterations than the simplex, though each costs a
    linesearch (several value+grad evaluations) and vmapped batches
    synchronise on the slowest lane — prefer NM for batched throughput,
    L-BFGS for single fits, gradient access, and Hessian standard
    errors. Traceable/vmappable; returns the same NMResult structure.
    """
    import optax

    x0 = jnp.asarray(x0)
    lo = jnp.asarray(bounds[0], x0.dtype)
    hi = jnp.asarray(bounds[1], x0.dtype)

    def fun_u(u):
        return fun(_sigmoid_to_box(u, lo, hi))

    opt = optax.lbfgs()
    u0 = _box_to_sigmoid(x0, lo, hi)
    value_and_grad = optax.value_and_grad_from_state(fun_u)
    state0 = opt.init(u0)

    def cond(carry):
        _, state, nit, gnorm = carry
        return (gnorm > tol) & (nit < maxiter)

    def body(carry):
        u, state, nit, _ = carry
        value, grad = value_and_grad(u, state=state)
        updates, state = opt.update(
            grad, state, u, value=value, grad=grad, value_fn=fun_u
        )
        u = optax.apply_updates(u, updates)
        return u, state, nit + 1, jnp.linalg.norm(grad)

    u, state, nit, gnorm = jax.lax.while_loop(
        cond, body, (u0, state0, jnp.asarray(0), jnp.asarray(jnp.inf))
    )
    x = _sigmoid_to_box(u, lo, hi)
    return NMResult(x, fun(x), nit, gnorm <= tol)


@partial(jax.jit, static_argnames=("fun", "maxiter", "tol"))
def batched_lbfgs(fun, x0, args, bounds, maxiter: int = 200,
                  tol: float = 1e-6) -> NMResult:
    """vmapped bounded L-BFGS over a batch of problems (see
    batched_nelder_mead for the calling convention)."""

    def solve_one(x0_i, *args_i):
        return lbfgs_minimize(
            lambda x: fun(x, *args_i),
            x0_i,
            bounds=bounds,
            maxiter=maxiter,
            tol=tol,
        )

    return jax.vmap(solve_one)(x0, *args)


@partial(jax.jit, static_argnames=("fun", "xatol", "fatol", "maxiter"))
def batched_nelder_mead(
    fun,
    x0,
    args,
    bounds,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
    maxiter: int | None = None,
) -> NMResult:
    """Natively batched Nelder-Mead over independent problems.

    `fun(x, *args_i)` is minimised per batch element; `x0` is (B, d) and
    each element of `args` has leading batch dimension B. `bounds` is a
    (lo, hi) pair of (d,) arrays shared across the batch.

    Same algorithm as ``nelder_mead`` (scipy decision tree, clip-to-box
    bounds, per-lane termination with frozen finished lanes), but the
    batch axis is explicit rather than ``vmap``-derived, which buys two
    things a vmapped ``while_loop`` cannot express:

    - the four candidate evaluations (reflect/expand/contractions) run
      as ONE stacked call, so the training data — the dominant HBM
      traffic when `args` holds a (B, N, ...) design — streams once per
      iteration instead of four times;
    - the shrink-simplex evaluation (d+1 more full passes) sits behind a
      scalar ``lax.cond`` and only runs on iterations where some ACTIVE
      lane actually shrinks. Under ``vmap`` the untaken branch is
      select-merged and every lane paid it every iteration.

    Together these cut per-iteration objective passes from 4 + (d+1)
    to 4 + rare shrinks, with the four survivors sharing one read of
    the training arrays. (The 1-degree whole-grid ellipse fit's stage
    wall is dominated by the per-chunk training-data build rather than
    the solve, so there the rewrite mainly buys headroom for larger
    ``max_train_cols``.)
    """
    x0 = jnp.asarray(x0)
    B, d = x0.shape
    if maxiter is None:
        maxiter = 200 * d
    if bounds is None:
        lo = jnp.full((d,), -jnp.inf, x0.dtype)
        hi = jnp.full((d,), jnp.inf, x0.dtype)
    else:
        lo = jnp.asarray(bounds[0], x0.dtype)
        hi = jnp.asarray(bounds[1], x0.dtype)

    vf = jax.vmap(fun)  # (B, d) + per-lane args -> (B,)
    in_axes = (0,) + tuple(None for _ in args)
    vfk = jax.vmap(vf, in_axes=in_axes)  # (K, B, d) -> (K, B)

    # scipy-style initial simplex per lane: (B, d+1, d)
    nonzdelt = 0.05
    zdelt = 0.00025
    step = jnp.where(x0 == 0.0, zdelt, nonzdelt * x0)  # (B, d)
    pts = x0[:, None, :] + jnp.eye(d, dtype=x0.dtype)[None] * step[
        :, None, :
    ]
    simplex = jnp.clip(
        jnp.concatenate([x0[:, None, :], pts], axis=1), lo, hi
    )
    fvals = vfk(jnp.swapaxes(simplex, 0, 1), *args).T  # (B, d+1)

    def _lane_convergence(simplex, fvals):
        order = jnp.argsort(fvals, axis=1)
        fs = jnp.take_along_axis(fvals, order, axis=1)
        xs = jnp.take_along_axis(simplex, order[:, :, None], axis=1)
        f_spread = jnp.max(jnp.abs(fs[:, 1:] - fs[:, :1]), axis=1)
        x_spread = jnp.max(
            jnp.abs(xs[:, 1:] - xs[:, :1]), axis=(1, 2)
        )
        return (f_spread <= fatol) & (x_spread <= xatol)

    def cond(state):
        simplex, fvals, nit = state
        converged = _lane_convergence(simplex, fvals)
        return jnp.any((~converged) & (nit < maxiter))

    def body(state):
        simplex, fvals, nit = state
        converged = _lane_convergence(simplex, fvals)
        active = (~converged) & (nit < maxiter)  # (B,)

        order = jnp.argsort(fvals, axis=1)
        sorted_simplex = jnp.take_along_axis(
            simplex, order[:, :, None], axis=1
        )
        sorted_fvals = jnp.take_along_axis(fvals, order, axis=1)

        centroid = jnp.mean(sorted_simplex[:, :-1], axis=1)  # (B, d)
        xw = sorted_simplex[:, -1]
        fw = sorted_fvals[:, -1]
        fb = sorted_fvals[:, 0]
        fsw = sorted_fvals[:, -2]
        direction = centroid - xw

        cands = jnp.clip(
            jnp.stack(
                [
                    centroid + direction,
                    centroid + 2.0 * direction,
                    centroid + 0.5 * direction,
                    centroid - 0.5 * direction,
                ]
            ),
            lo,
            hi,
        )  # (4, B, d)
        fr, fe, foc, fic = vfk(cands, *args)
        xr, xe, xoc, xic = cands

        # scipy decision tree, arithmetic form (per lane)
        take_expand = (fr < fb) & (fe < fr)
        take_reflect = ((fr < fb) & ~(fe < fr)) | (
            (fr >= fb) & (fr < fsw)
        )
        outside = (fr >= fsw) & (fr < fw)
        take_oc = outside & (foc <= fr)
        inside = fr >= fw
        take_ic = inside & (fic < fw)
        shrink = (outside & ~(foc <= fr)) | (inside & ~(fic < fw))
        del take_ic  # the final where-default; kept for readability

        cand_x = jnp.where(
            take_expand[:, None],
            xe,
            jnp.where(
                take_reflect[:, None],
                xr,
                jnp.where(take_oc[:, None], xoc, xic),
            ),
        )
        cand_f = jnp.where(
            take_expand,
            fe,
            jnp.where(take_reflect, fr, jnp.where(take_oc, foc, fic)),
        )

        replaced_simplex = sorted_simplex.at[:, -1].set(cand_x)
        replaced_fvals = sorted_fvals.at[:, -1].set(cand_f)

        best = sorted_simplex[:, :1]
        shrunk_simplex = jnp.clip(
            best + 0.5 * (sorted_simplex - best), lo, hi
        )
        # d+1 full objective passes — only pay them on the (rare)
        # iterations where an active lane actually shrinks
        shrunk_fvals = lax.cond(
            jnp.any(shrink & active),
            lambda s: vfk(jnp.swapaxes(s, 0, 1), *args).T,
            lambda s: jnp.full_like(sorted_fvals, jnp.inf),
            shrunk_simplex,
        )

        new_simplex = jnp.where(
            shrink[:, None, None], shrunk_simplex, replaced_simplex
        )
        new_fvals = jnp.where(
            shrink[:, None], shrunk_fvals, replaced_fvals
        )

        # frozen lanes keep their state (vmapped-while semantics)
        out_simplex = jnp.where(active[:, None, None], new_simplex, simplex)
        out_fvals = jnp.where(active[:, None], new_fvals, fvals)
        return out_simplex, out_fvals, nit + active

    simplex, fvals, nit = lax.while_loop(
        cond, body, (simplex, fvals, jnp.zeros((B,), jnp.int32))
    )

    best = jnp.argmin(fvals, axis=1)
    x_best = jnp.take_along_axis(
        simplex, best[:, None, None], axis=1
    )[:, 0]
    f_best = jnp.take_along_axis(fvals, best[:, None], axis=1)[:, 0]
    success = _lane_convergence(simplex, fvals)
    return NMResult(x_best, f_best, nit, success)


# ===========================================================================
# Batched Levenberg-Marquardt (least-squares MLE lane)
# ===========================================================================
@partial(
    jax.jit,
    static_argnames=("res_fun", "maxiter", "ftol", "xtol"),
)
def batched_levenberg_marquardt(
    res_fun,
    x0,
    args,
    bounds,
    maxiter: int = 100,
    ftol: float = 1e-9,
    xtol: float = 1e-8,
) -> NMResult:
    r"""Batched damped Gauss-Newton over independent least-squares fits.

    The ellipse NLL is exactly weighted least squares in Fisher-z space
    (``EllipseModel._residuals_fit``), so instead of a derivative-free
    simplex walking ~10^2-10^3 evaluations per fit, each iteration
    solves the local quadratic model from one forward-mode Jacobian
    (d ~ 3 passes) plus one trial evaluation — typically ~20 iterations
    to the same optimum. The loop is written DIRECTLY over the batch
    dimension (no vmap-of-while): per-lane damping and per-lane
    freezing are plain elementwise selects, so nothing lockstep-stalls
    on a slow linesearch lane (the failure mode that made the vmapped
    L-BFGS slower than NM on whole grids).

    ``res_fun(x_i, *args_i) -> (m,)`` residual vector of one problem;
    minimises ``0.5 * sum(res^2)`` per lane. `x0` is (B, d); each
    element of `args` has leading batch dim B; `bounds` is a shared
    (lo, hi) pair of (d,) arrays — trial steps are clipped into the box
    (same semantics as the batched Nelder-Mead). Returns NMResult with
    ``fun = 0.5 * sse``, per-lane ``nit`` (accepted+rejected steps) and
    ``success`` (converged before maxiter).

    Levenberg damping uses Fletcher's diagonal scaling
    ``(J'J + lam * diag(J'J)) delta = -J'r`` so the step is invariant
    to parameter scaling (km-scale ranges vs radian-scale angles in one
    solve). Lanes converge successfully when an accepted step improves
    the SSE by < ftol relatively or moves < xtol relatively, or when
    damping saturates while the proposed step is already negligible
    (a lane that started at its optimum). Damping saturation with a
    non-trivial rejected step (NaN objective, no descent direction)
    stops the lane with ``success=False`` — those fits get qc_code 9,
    matching the Nelder-Mead lane.
    """
    x0 = jnp.asarray(x0)
    B, d = x0.shape
    lo = jnp.asarray(bounds[0], x0.dtype)
    hi = jnp.asarray(bounds[1], x0.dtype)

    def sse_one(x, *a):
        r = res_fun(x, *a)
        return 0.5 * jnp.sum(r * r)

    def rj_one(x, *a):
        return res_fun(x, *a), jax.jacfwd(res_fun)(x, *a)

    sse_all = jax.vmap(sse_one)
    rj_all = jax.vmap(rj_one)

    tiny = jnp.asarray(jnp.finfo(x0.dtype).tiny, x0.dtype)
    lam_max = jnp.asarray(1e10, x0.dtype)

    def cond(state):
        _, _, _, conv, _, _, n_any = state
        return (~jnp.all(conv)) & (n_any < maxiter)

    def body(state):
        x, sse, lam, conv, ok, nit, n_any = state
        r, J = rj_all(x, *args)  # (B, m), (B, m, d)
        g = jnp.einsum("bmd,bm->bd", J, r)
        A = jnp.einsum("bmd,bme->bde", J, J)
        diagA = jnp.diagonal(A, axis1=1, axis2=2)
        # scale floor keeps zero-data lanes (all-masked residuals)
        # solvable: delta collapses to 0 and the lane converges
        scale = jnp.maximum(diagA, 1e-12)
        M = A + (lam[:, None] * scale)[:, None, :] * jnp.eye(d, dtype=x.dtype)
        delta = -jnp.linalg.solve(M, g[..., None])[..., 0]
        x_trial = jnp.clip(x + delta, lo, hi)
        sse_trial = sse_all(x_trial, *args)

        better = sse_trial < sse
        accept = better & ~conv
        step = x_trial - x
        rel_impr = (sse - sse_trial) / jnp.maximum(sse, tiny)
        step_small = (
            jnp.max(
                jnp.abs(step) / jnp.maximum(jnp.abs(x), 1.0), axis=1
            )
            < xtol
        )
        # Converged-for-real: an accepted step whose improvement or
        # size dropped below tolerance, OR damping saturated while the
        # PROPOSED step was already negligible (a lane that started at
        # its optimum: delta ~ 0 never strictly improves, so it rides
        # the damping ratchet — but it IS at a stationary point).
        # Saturation with a non-trivial rejected step (NaN data, no
        # descent direction found) exits the loop as a FAILED lane —
        # reporting success there gave stuck fits qc_code 0 where the
        # Nelder-Mead lane correctly marks them 9.
        stuck = (~better) & (lam >= lam_max) & ~conv
        conv_good = (accept & ((rel_impr < ftol) | step_small)) | (
            stuck & step_small
        )
        newly_conv = conv_good | stuck

        new_x = jnp.where(accept[:, None], x_trial, x)
        new_sse = jnp.where(accept, sse_trial, sse)
        new_lam = jnp.where(
            conv,
            lam,
            jnp.clip(
                jnp.where(better, lam / 3.0, lam * 4.0), 1e-12, lam_max
            ),
        )
        return (
            new_x,
            new_sse,
            new_lam,
            conv | newly_conv,
            ok | conv_good,
            nit + (~conv).astype(nit.dtype),
            n_any + 1,
        )

    sse0 = sse_all(x0, *args)
    lam0 = jnp.full((B,), 1e-3, x0.dtype)
    conv0 = jnp.zeros((B,), bool)
    ok0 = jnp.zeros((B,), bool)
    nit0 = jnp.zeros((B,), jnp.int32)
    x, sse, lam, conv, ok, nit, _ = lax.while_loop(
        cond,
        body,
        (x0, sse0, lam0, conv0, ok0, nit0, jnp.asarray(0)),
    )
    return NMResult(x, sse, nit, ok)
