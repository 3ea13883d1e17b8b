r"""Spherical-harmonic sampling of stationary Gaussian fields.

Simulated-state draws for stochastic kriging need :math:`z \sim N(0, C)`
with C built from an isotropic correlation on the sphere. Factorising C
densely is O(M^3) and ~17 GB at the 1-degree scale; Chebyshev matvecs
need O(sqrt(kappa)) iterations and long-range kernels are terribly
conditioned (kappa ~ 1e5). For STATIONARY kernels there is an exact
spectral route: an isotropic correlation diagonalises in spherical
harmonics,

.. math::
    corr(\gamma) = \sum_l \frac{2l+1}{4\pi} \hat c_l P_l(\cos\gamma),

so a field with iid coefficients :math:`a_{lm} \sim N(0, \hat c_l)` over
an orthonormal real harmonic basis has covariance exactly
:math:`corr(\gamma(x, y))` by the addition theorem. Synthesis on a
regular lat-lon grid is one (members x l x m) x (l x m x lat) einsum
plus a dense real-DFT matmul over longitude, independent of the
kernel's correlation range.

Truncation at l_max discards the spectrum tail; the retained variance
fraction is reported (``truncation_fraction``) and the remaining
variance can be folded into the nugget. The angular power is computed by
Gauss-Legendre quadrature of the correlation function — any isotropic
correlation works (Matern of any smoothness included).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def angular_power(corr_fn, l_max: int, n_quad: int = 2048) -> np.ndarray:
    r"""Angular power spectrum \hat c_l of an isotropic correlation.

    `corr_fn(gamma)` takes central angles in radians (vectorised numpy).
    Returns \hat c_l for l = 0..l_max via Gauss-Legendre quadrature:
    \hat c_l = 2 pi \int_{-1}^{1} corr(acos t) P_l(t) dt.
    """
    try:  # scipy's Newton-iteration nodes are ~16x faster than
        # numpy's companion-matrix eigensolve at n_quad ~ 4096
        # (measured 0.6 s vs 10.2 s; nodes agree to 1e-16)
        from scipy.special import roots_legendre

        t, w = roots_legendre(n_quad)
    except ImportError:  # scipy is optional at runtime
        t, w = np.polynomial.legendre.leggauss(n_quad)
    gamma = np.arccos(np.clip(t, -1.0, 1.0))
    f = np.asarray(corr_fn(gamma), dtype=np.float64)

    # Legendre recurrence over quadrature nodes
    c = np.empty(l_max + 1)
    p_prev = np.ones_like(t)
    p_cur = t.copy()
    c[0] = 2.0 * np.pi * np.sum(w * f * p_prev)
    if l_max >= 1:
        c[1] = 2.0 * np.pi * np.sum(w * f * p_cur)
    for l in range(2, l_max + 1):
        p_next = ((2 * l - 1) * t * p_cur - (l - 1) * p_prev) / l
        c[l] = 2.0 * np.pi * np.sum(w * f * p_next)
        p_prev, p_cur = p_cur, p_next
    # tiny negative values from quadrature noise
    return np.maximum(c, 0.0)


def legendre_table(l_max: int, lats_deg) -> np.ndarray:
    r"""Orthonormal associated Legendre functions at given latitudes.

    Returns (l_max+1, l_max+1, n_lat) with entry [l, m, j] =
    :math:`\tilde P_l^m(\sin(lat_j))`, normalised so the real harmonics
    {P̃_l0, sqrt(2) P̃_lm cos(m lam), sqrt(2) P̃_lm sin(m lam)} are
    orthonormal on the sphere. Stable diagonal-then-upward recurrence,
    computed in f64.
    """
    x = np.sin(np.radians(np.asarray(lats_deg, dtype=np.float64)))
    sx = np.sqrt(np.maximum(1.0 - x * x, 0.0))  # cos(lat)
    n_lat = x.shape[0]
    P = np.zeros((l_max + 1, l_max + 1, n_lat))
    P[0, 0] = np.sqrt(1.0 / (4.0 * np.pi))
    for m in range(1, l_max + 1):
        P[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * sx * P[m - 1, m - 1]
    for m in range(0, l_max):
        P[m + 1, m] = x * np.sqrt(2 * m + 3.0) * P[m, m]
    # upward recurrence in l, vectorised over all valid m at once
    for l in range(2, l_max + 1):
        m = np.arange(0, l - 1)
        a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))[:, None]
        b = np.sqrt(
            ((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0)
        )[:, None]
        P[l, : l - 1] = a * (
            x[None, :] * P[l - 1, : l - 1] - b * P[l - 2, : l - 1]
        )
    return P


@partial(jax.jit, static_argnames=("l_max",))
def _legendre_table_device(x, l_max: int):
    r"""Orthonormal P̃_l^m table computed ON DEVICE (f32-safe).

    Same values as :func:`legendre_table` (host f64 oracle), built with
    a ``lax.scan`` over l so the (l_max+1, l_max+1, n_lat) table never
    crosses the host-device link — at 1 degree the f32 table is 47 MB
    and at 0.25 degree it would be 1.5 GB, while the only input here is
    the (n_lat,) sin(lat) vector.

    Two f32 hazards shape the implementation:

    1. *Underflow.* P̃_m^m ~ cos(lat)^m dives below the f32 minimum
       long before the upward recurrence regrows O(1) values at
       l >> m, so each (m, lat) lane carries a mantissa pair
       (p_prev, p_cur) plus an INTEGER count k of exact 2^40 rescales;
       the represented value is p * 2^(40 k).
    2. *Approximate transcendentals.* XLA's f32 exp/log are polynomial
       approximations (measured: log abs error up to 1e-4) — a
       log-space carry seeded with ``m * log cos(lat)`` amplifies that
       error by m (4e-3 relative by m ~ 50, measured). Hence NOTHING
       approximate touches the carried state: rescales multiply by the
       exact constants 2^±40 and bump k, and the only approximate op is
       the one-shot ``exp2(40 k)`` in each emitted row (~5e-6, never
       fed back).
    """
    dtype = x.dtype
    L = l_max
    J = x.shape[0]
    m_arr = jnp.arange(L + 1, dtype=dtype)
    sx = jnp.sqrt(jnp.clip(1.0 - x * x, 0.0))  # cos(lat), (J,)
    up = jnp.asarray(2.0**40, dtype)
    dn = jnp.asarray(2.0**-40, dtype)

    # diagonal seeds P̃_m^m = prod_k -sqrt((2k+1)/(2k)) cos(lat), as an
    # exact-rescaled product chain (value = d_p * 2^(40 d_k))
    def diag_step(carry, m):
        pd, kd = carry
        mf = m.astype(dtype)
        pd = -jnp.sqrt((2.0 * mf + 1.0) / (2.0 * mf)) * sx * pd
        shrink = jnp.abs(pd) < dn
        pd = jnp.where(shrink, pd * up, pd)
        kd = kd - shrink.astype(jnp.int32)
        return (pd, kd), (pd, kd)

    pd0 = jnp.full((J,), np.sqrt(1.0 / (4.0 * np.pi)), dtype)
    kd0 = jnp.zeros((J,), jnp.int32)
    _, (diag_p, diag_k) = jax.lax.scan(
        diag_step, (pd0, kd0), jnp.arange(1, L + 1)
    )
    diag_p = jnp.concatenate([pd0[None], diag_p])  # (L+1, J)
    diag_k = jnp.concatenate([kd0[None], diag_k])

    def emit(p, k):
        return p * jnp.exp2(40.0 * k.astype(dtype))

    # carry: mantissa rows p_prev = P[l-1], p_cur = P[l] and their
    # SHARED per-(m, lat) rescale count k
    p_prev = jnp.zeros((L + 1, J), dtype)
    p_cur = jnp.zeros((L + 1, J), dtype).at[0].set(pd0)
    k0 = jnp.zeros((L + 1, J), jnp.int32)
    row0 = p_cur  # l = 0 row (k = 0 everywhere; m > 0 lanes are 0)

    def step(carry, l):
        p_prev, p_cur, k = carry
        lf = l.astype(dtype)
        # recurrence coefficients; m >= l lanes produce NaN/inf and are
        # overwritten by the diagonal injection / validity mask below
        a = jnp.sqrt((4.0 * lf * lf - 1.0) / (lf * lf - m_arr * m_arr))
        b = jnp.sqrt(
            ((lf - 1.0) ** 2 - m_arr * m_arr)
            / (4.0 * (lf - 1.0) ** 2 - 1.0)
        )
        p_next = a[:, None] * (x[None, :] * p_cur - b[:, None] * p_prev)
        # inject the diagonal at m == l and zero m > l BEFORE the
        # rescale checks, so the NaN lanes never poison shared state
        is_diag = m_arr[:, None] == lf
        valid = m_arr[:, None] <= lf
        p_next = jnp.where(is_diag, diag_p[l][None, :], p_next)
        p_next = jnp.where(valid, p_next, 0.0)
        p_cur = jnp.where(is_diag, 0.0, p_cur)
        k = jnp.where(is_diag, diag_k[l][None, :], k)
        k = jnp.where(valid, k, 0)
        # exact power-of-two renormalisation of the (p_cur, p_next)
        # pair (shared k): nothing approximate enters the carry
        mag = jnp.maximum(jnp.abs(p_next), jnp.abs(p_cur))
        grow = mag > up
        shrink = (mag > 0.0) & (mag < dn)
        f = jnp.where(grow, dn, jnp.where(shrink, up, 1.0))
        p_next = p_next * f
        p_cur = p_cur * f
        k = k + grow.astype(jnp.int32) - shrink.astype(jnp.int32)
        return (p_cur, p_next, k), emit(p_next, k)

    _, rows = jax.lax.scan(
        step, (p_prev, p_cur, k0), jnp.arange(1, L + 1)
    )
    return jnp.concatenate([row0[None], rows], axis=0)


def dft_tables(l_max: int, lons_deg) -> np.ndarray:
    r"""cos/sin synthesis matrices over the grid longitudes.

    Returns (2, l_max+1, n_lon) f64 with entries cos(m lam_q) and
    sin(m lam_q). The angles m * lam_q are reduced mod 2 pi in f64 ON
    THE HOST — at l_max ~ 700 the raw angle reaches ~5e3 rad, where f32
    argument reduction on device would cost ~1e-4 of accuracy.
    """
    lam = np.radians(np.asarray(lons_deg, dtype=np.float64))
    theta = np.mod(np.arange(l_max + 1)[:, None] * lam[None, :],
                   2.0 * np.pi)
    return np.stack([np.cos(theta), np.sin(theta)])


@partial(jax.jit, static_argnames=("n_members",))
def _synthesize(key, c_l, P_table, trig, n_members: int):
    """Draw coefficients and synthesize fields on the (lat, lon) grid.

    Everything is real f32 matmuls: the longitude synthesis
    f[k, j, q] = sum_m Re(h[k, m, j] e^{i m lam_q}) is evaluated as two
    dense DFT matmuls against the precomputed `trig` table rather than
    a scatter + mixed-radix ``ifft``: the (m, q) contraction is a small
    matmul, while the complex-FFT formulation once compiled into a
    pathologically large program at l_max = 256, n_lon = 360.
    """
    L = c_l.shape[0] - 1
    std = jnp.sqrt(c_l)  # (L+1,)
    kc, ks = jax.random.split(key)
    # a[l, m] cos/sin parts; variance c_l for each real basis function
    a_cos = (
        jax.random.normal(kc, (n_members, L + 1, L + 1), P_table.dtype)
        * std[None, :, None]
    )
    a_sin = (
        jax.random.normal(ks, (n_members, L + 1, L + 1), P_table.dtype)
        * std[None, :, None]
    )
    # zero the unused upper triangle (m > l)
    lm_valid = (
        jnp.arange(L + 1)[:, None] >= jnp.arange(L + 1)[None, :]
    ).astype(P_table.dtype)
    a_cos = a_cos * lm_valid[None]
    a_sin = a_sin * lm_valid[None]

    # h[member, m, lat] = sum_l coeff * P̃_lm(lat)
    h_cos = jnp.einsum("klm,lmj->kmj", a_cos, P_table)
    h_sin = jnp.einsum("klm,lmj->kmj", a_sin, P_table)
    sqrt2 = jnp.asarray(np.sqrt(2.0), P_table.dtype)
    # m = 0 term with unit weight; m > 0 with sqrt(2) (real-harmonic
    # orthonormalisation)
    weights = jnp.concatenate(
        [jnp.ones((1,), P_table.dtype), jnp.full((L,), sqrt2)]
    )[None, :, None]
    # f[k, j, q] = sum_m w_m (h_cos cos(m lam_q) + h_sin sin(m lam_q))
    f = jnp.einsum("kmj,mq->kjq", h_cos * weights, trig[0]) + jnp.einsum(
        "kmj,mq->kjq", h_sin * weights, trig[1]
    )
    return f  # (members, lat, lon)


class SphericalHarmonicSampler:
    """Exact stationary-field sampler on a regular lat-lon grid.

    Parameters
    ----------
    corr_fn : callable
        Isotropic correlation as a function of central angle (radians),
        numpy-vectorised; corr_fn(0) should be 1.
    variance : float
        Point variance (psill) scaling the field.
    lats_deg, lons_deg : array
        Regular grid axes (longitudes equally spaced over the circle).
    l_max : int | None
        Spectral truncation; default min(3 * n_lat, 720).
    nugget : float
        Independent white-noise variance added per grid point.
    member_batch : int
        Member-count granularity. ``draw`` rounds the requested count
        up to a multiple of this and slices the excess, so every count
        up to ``member_batch`` shares ONE compiled program — drawing a
        60-state training cube and then a single truth state costs one
        XLA compile, not two. The synthesis program is large (the
        (members, l, m) einsum at l_max ~ 256 compiles in seconds), so
        per-count recompiles were the dominant cost of small draws.
    table : str
        "device" (default) builds the Legendre table on device via the
        scaled-scan recurrence (no bulk host->device transfer); "host"
        computes it in f64 numpy (the oracle path) and transfers it.
    """

    def __init__(
        self,
        corr_fn,
        variance: float,
        lats_deg,
        lons_deg,
        l_max: int | None = None,
        nugget: float = 0.0,
        n_quad: int = 4096,
        dtype=jnp.float32,
        member_batch: int = 64,
        table: str = "device",
    ):
        lats_deg = np.asarray(lats_deg)
        lons_deg = np.asarray(lons_deg)
        self.n_lat = len(lats_deg)
        self.n_lon = len(lons_deg)
        if l_max is None:
            l_max = min(3 * self.n_lat, 720)
        self.l_max = l_max
        self.variance = float(variance)
        self.nugget = float(nugget)

        c_l = angular_power(corr_fn, l_max, n_quad)
        total = np.sum((2 * np.arange(l_max + 1) + 1) * c_l) / (4 * np.pi)
        # corr_fn(0) is the full variance of the continuum process; the
        # truncated series reproduces `total` of it.
        self.truncation_fraction = float(total / corr_fn(np.zeros(1))[0])
        self.c_l = jnp.asarray(variance * c_l, dtype)
        if table == "device":
            # build the (l, m, lat) table in HBM from the (n_lat,)
            # sin(lat) vector: the f32 table is 47 MB at 1 degree /
            # 1.5 GB at 0.25 degree, and host->device bandwidth is the
            # least reliable resource in the pipeline
            x = jnp.asarray(np.sin(np.radians(lats_deg)), dtype)
            self.P_table = _legendre_table_device(x, l_max)
        else:  # "host": f64 oracle recurrence, then one bulk transfer
            self.P_table = jnp.asarray(
                legendre_table(l_max, lats_deg), dtype
            )
        self.trig = jnp.asarray(dft_tables(l_max, lons_deg), dtype)
        self._dtype = dtype
        self.member_batch = int(member_batch)

    def draw(self, key, n_members: int):
        """(n_members, n_lat * n_lon) stationary field draws."""
        if self.nugget > 0.0:
            key, kn = jax.random.split(key)
        # synthesize a multiple of `member_batch` members in ONE
        # dispatch and slice the excess: every count <= member_batch
        # shares a single compiled program (a 1-state truth draw after
        # a 60-state training cube costs zero new compiles), and larger
        # counts collapse to ceil(n / B) distinct programs whose compile
        # is amortised over the draw itself. A per-batch host loop is
        # NOT used — its ~10 ms/dispatch overhead dominates at small
        # grid sizes. The waste is bounded by one batch of members.
        B = self.member_batch
        n_eff = B * (-(-n_members // B))
        flat = _synthesize(
            key, self.c_l, self.P_table, self.trig, n_eff
        ).reshape(n_eff, self.n_lat * self.n_lon)[:n_members]
        if self.nugget > 0.0:
            flat = flat + jnp.sqrt(
                jnp.asarray(self.nugget, self._dtype)
            ) * jax.random.normal(kn, flat.shape, self._dtype)
        return flat


def matern_correlation(nu: float, range_km: float, radius_km: float = 6371.0):
    """Isotropic Matern correlation of the central angle (sklearn form).

    Returns a numpy-vectorised gamma -> corr function for use with
    ``SphericalHarmonicSampler`` (great-circle distance = radius * gamma).
    """
    from scipy.special import gamma as sgamma
    from scipy.special import kv as skv

    def corr(gamma):
        d = radius_km * np.asarray(gamma, dtype=np.float64)
        inner = np.sqrt(2.0 * nu) * d / range_km
        with np.errstate(invalid="ignore", over="ignore"):
            out = (
                (2.0 ** (1.0 - nu) / sgamma(nu))
                * np.power(inner, nu)
                * skv(nu, inner)
            )
        out = np.where(inner == 0.0, 1.0, out)
        return np.nan_to_num(out, nan=0.0)

    return corr
