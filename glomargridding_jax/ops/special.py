r"""Modified Bessel function of the second kind K_nu, natively in JAX.

The stationary Matern variogram and the non-stationary Paciorek-Schervish
ellipse kernel both need :math:`K_\nu(x)` for arbitrary order (the reference
uses ``scipy.special.kv``, which has no JAX counterpart). Three code paths:

1. **Half-integer orders** (0.5, 1.5, 2.5, ...): exact closed forms
   :math:`K_{n+1/2}(x) = \sqrt{\pi/(2x)}\,e^{-x}\sum_k
   \frac{(n+k)!}{k!(n-k)!}(2x)^{-k}` — these cover the orders used by
   HadSST4 (0.5) and HadCRUT5 (1.5), fully fused, differentiable, and fast
   elementwise.
2. **General order, small x** (x <= 2): Temme's series with upward
   recurrence in the order.
3. **General order, large x** (x > 2): Steed's continued fraction (CF2)
   with upward recurrence.

Paths 2/3 run with fixed iteration counts (traceable under jit; no
data-dependent control flow) and are blended with a ``where`` on x.
The order ``v`` must be a static Python float — it always is in practice:
variogram/ellipse models carry a fixed shape parameter.

Accuracy: validated against scipy.special.kv in the test-suite (f64 rtol
~1e-12 half-integer, ~1e-10 general; f32 limited by dtype resolution).
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

_EULER_GAMMA = 0.5772156649015328606


def _kv_half_integer(n: int, x):
    """K_{n+1/2}(x) closed form; n >= 0 integer (static)."""
    pref = jnp.sqrt(jnp.pi / (2.0 * x)) * jnp.exp(-x)
    inv2x = 1.0 / (2.0 * x)
    total = jnp.ones_like(x)
    coeff = 1.0
    term = jnp.ones_like(x)
    for k in range(1, n + 1):
        # (n+k)! / (k! (n-k)!) built up iteratively:
        coeff = coeff * (n + k) * (n - k + 1) / k
        term = term * inv2x
        total = total + coeff * term
    return pref * total


def _kv_temme_small(v_mu: float, x, max_iter: int = 50):
    """Temme series for (K_mu, K_{mu+1}) with |mu| <= 1/2, for x <= 2."""
    mu = v_mu
    mu2 = mu * mu
    # Host-side constants (mu is static)
    gampl = 1.0 / math.gamma(1.0 + mu)  # 1/Gamma(1+mu)
    gammi = 1.0 / math.gamma(1.0 - mu)  # 1/Gamma(1-mu)
    if abs(mu) < 1e-12:
        gam1 = -_EULER_GAMMA
    else:
        gam1 = (gammi - gampl) / (2.0 * mu)
    gam2 = (gammi + gampl) / 2.0
    pimu = math.pi * mu
    fact = 1.0 if abs(pimu) < 1e-12 else pimu / math.sin(pimu)

    x2 = x * x / 4.0
    d_log = -jnp.log(x / 2.0)
    e = mu * d_log
    # safe-denominator form keeps the gradient finite at e == 0 (a bare
    # where() with sinh(e)/e in the untaken branch leaks NaN cotangents)
    e_safe = jnp.where(jnp.abs(e) < 1e-12, jnp.ones_like(e), e)
    fact2 = jnp.where(
        jnp.abs(e) < 1e-12, jnp.ones_like(e), jnp.sinh(e_safe) / e_safe
    )
    ff0 = fact * (gam1 * jnp.cosh(e) + gam2 * fact2 * d_log)
    ee = jnp.exp(e)
    p0 = 0.5 * ee / gampl
    q0 = 0.5 / (ee * gammi)

    def body(i, carry):
        ff, c, p, q, s0, s1 = carry
        fi = i.astype(x.dtype)
        ff = (fi * ff + p + q) / (fi * fi - mu2)
        c = c * x2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        s0 = s0 + c * ff
        s1 = s1 + c * (p - fi * ff)
        return ff, c, p, q, s0, s1

    init = (ff0, jnp.ones_like(x), p0, q0, ff0, p0)
    _, _, _, _, sum0, sum1 = lax.fori_loop(1, max_iter + 1, body, init)
    k_mu = sum0
    k_mu1 = sum1 * (2.0 / x)
    return k_mu, k_mu1


def _kv_steed_large(v_mu: float, x, max_iter: int = 60):
    """Steed's CF2 for (K_mu, K_{mu+1}) with |mu| <= 1/2, for x > 2."""
    mu = v_mu
    a1 = 0.25 - mu * mu

    b0 = 2.0 * (1.0 + x)
    d0 = 1.0 / b0
    h0 = d0
    delh0 = d0
    q10 = jnp.zeros_like(x)
    q20 = jnp.ones_like(x)
    c0 = jnp.full_like(x, a1)
    q0 = c0
    a0 = jnp.full_like(x, -a1)
    s0 = 1.0 + q0 * delh0

    eps = jnp.finfo(x.dtype).eps

    # `c` grows ~factorially and q1/q2 decay reciprocally (only the products
    # c*qnew matter). Periodic joint rescaling keeps both in range so the
    # fixed-trip-count loop can't overflow even in f32 — the power-of-two
    # factor is exact, so results are bit-identical to the unscaled run.
    big = jnp.asarray(
        2.0 ** (0.5 * jnp.finfo(x.dtype).maxexp), x.dtype
    )
    rescale_factor = jnp.asarray(2.0, x.dtype) ** (
        -jnp.finfo(x.dtype).maxexp // 4
    )

    def body(i, carry):
        # The continued-fraction auxiliaries grow without bound once the
        # fraction has converged (NR breaks out early); since jit needs a
        # fixed trip count we latch a per-element `done` flag and freeze the
        # carry instead.
        a, b, c, d, h, delh, q1, q2, q, s, done = carry
        fi = i.astype(x.dtype)
        a_n = a - 2.0 * (fi - 1.0)
        c_n = -a_n * c / fi
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = q_n * delh_n
        s_n = s + dels
        done_n = done | (jnp.abs(dels / s_n) <= eps)
        # Joint rescale of (c, q1, q2): c shrinks, q's grow reciprocally,
        # so the next iteration's product c*qnew is unchanged.
        r = jnp.where(jnp.abs(c_n) > big, rescale_factor, jnp.ones_like(c_n))
        c_n = c_n * r
        q1_n = q2 / r
        q2_n = qnew / r

        def keep(new, old):
            return jnp.where(done, old, new)

        return (
            keep(a_n, a),
            keep(b_n, b),
            keep(c_n, c),
            keep(d_n, d),
            keep(h_n, h),
            keep(delh_n, delh),
            keep(q1_n, q1),
            keep(q2_n, q2),
            keep(q_n, q),
            keep(s_n, s),
            done_n,
        )

    init = (
        a0,
        b0,
        c0,
        d0,
        h0,
        delh0,
        q10,
        q20,
        q0,
        s0,
        jnp.zeros_like(x, dtype=bool),
    )
    out = lax.fori_loop(2, max_iter + 2, body, init)
    h, s = out[4], out[9]
    h = a1 * h
    k_mu = jnp.sqrt(jnp.pi / (2.0 * x)) * jnp.exp(-x) / s
    k_mu1 = k_mu * (mu + x + 0.5 - h) / x
    return k_mu, k_mu1


def _kv_general(v: float, x, series_iters: int = 50, cf_iters: int = 60):
    """K_v(x) for general static order v > 0, elementwise in x."""
    n = int(v + 0.5)
    mu = v - n  # |mu| <= 1/2

    # where-based clamping (not min/max): jnp.minimum splits gradients
    # 50/50 at the exact tie x == 2, halving dK/dx at the branch switch.
    use_small = x <= 2.0
    x_small = jnp.where(use_small, x, 2.0)
    x_large = jnp.where(use_small, 2.0, x)
    ks_mu, ks_mu1 = _kv_temme_small(mu, x_small, series_iters)
    kl_mu, kl_mu1 = _kv_steed_large(mu, x_large, cf_iters)
    k_mu = jnp.where(use_small, ks_mu, kl_mu)
    k_mu1 = jnp.where(use_small, ks_mu1, kl_mu1)

    # Upward recurrence K_{mu+i+1} = 2(mu+i)/x * K_{mu+i} + K_{mu+i-1}
    k_prev, k_cur = k_mu, k_mu1
    for i in range(1, n + 1):
        k_next = 2.0 * (mu + i) / x * k_cur + k_prev
        k_prev, k_cur = k_cur, k_next
    return k_prev  # K_{mu+n} = K_v


def _is_half_integer(v: float) -> bool:
    return abs(2.0 * v - round(2.0 * v)) < 1e-12 and (round(2.0 * v) % 2 == 1)


@partial(jax.jit, static_argnums=(0,))
def kv(v: float, x):
    """Modified Bessel function of the second kind, static order `v` > 0.

    Matches scipy.special.kv semantics on the positive real line; returns
    +inf at x == 0 and NaN for x < 0.
    """
    if v < 0:
        v = -v  # K_{-v} == K_v
    x = jnp.asarray(x)
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    x_safe = jnp.maximum(x, tiny)
    if _is_half_integer(v):
        out = _kv_half_integer(int(round(v - 0.5)), x_safe)
    else:
        out = _kv_general(float(v), x_safe)
    out = jnp.where(x == 0.0, jnp.inf, out)
    out = jnp.where(x < 0.0, jnp.nan, out)
    return out


def kv_nan_guard(v: float, x):
    """kv with inf mapped to NaN (parity: reference ``variogram.py:29-30``)."""
    out = kv(v, x)
    return jnp.where(jnp.isinf(out), jnp.nan, out)


def xv_kv_half_integer(v: float, x):
    r"""``x**v * K_v(x)`` for static half-integer ``v``, as ONE exp.

    For :math:`\nu = n + 1/2`,

    .. math::
        x^\nu K_\nu(x) = \sqrt{\pi/2}\; e^{-x}
            \sum_{k=0}^{n} \frac{(n+k)!}{k!\,(n-k)!\,2^k}\, x^{n-k},

    an exp times a degree-n polynomial. Evaluating the PRODUCT this way
    replaces the generic ``pow(x, v) * kv(v, x)`` chain (a log-exp pow,
    plus the sqrt/exp/divide of the half-integer K_v) with a single
    ``exp`` and a Horner polynomial — the Matern likelihood's inner
    loop is transcendental-bound, so the whole-grid ellipse
    fit sees this directly.

    Limit semantics match the generic product: at ``x == 0`` the
    generic path is ``0 * inf -> nan`` (callers sanitise via
    ``nan_to_num``), and NaN is returned here too; ``x < 0`` is NaN.
    """
    if not _is_half_integer(v):
        raise ValueError(f"v={v} is not half-integer")
    n = int(round(v - 0.5))
    x = jnp.asarray(x)
    x_safe = jnp.where(x > 0.0, x, jnp.ones_like(x))
    # c_k = (n+k)! / (k! (n-k)! 2^k), built iteratively; Horner from x^n
    coeffs = [1.0]
    for k in range(1, n + 1):
        coeffs.append(coeffs[-1] * (n + k) * (n - k + 1) / (2.0 * k))
    total = jnp.full_like(x_safe, coeffs[0])
    for c in coeffs[1:]:
        total = total * x_safe + c
    out = math.sqrt(math.pi / 2.0) * jnp.exp(-x_safe) * total
    return jnp.where(x > 0.0, out, jnp.nan)


def xv_kv(v: float, x):
    """``x**v * K_v(x)`` with the NaN-guarded generic-product semantics.

    Dispatches to the fused exp-polynomial for static half-integer
    orders (``xv_kv_half_integer`` — the production Matern smoothness
    values 0.5/1.5/2.5) and to ``pow(x, v) * kv_nan_guard(v, x)``
    otherwise. Both Matern hot paths (the ellipse NLL and the variogram
    kernels) call this, so the half-integer speedup is shared.
    """
    if _is_half_integer(v):
        return xv_kv_half_integer(v, x)
    return jnp.power(x, v) * kv_nan_guard(v, x)


def gamma_fn(v: float) -> float:
    """Gamma(v) for a static Python float order."""
    return math.gamma(v)
