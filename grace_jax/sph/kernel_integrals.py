"""SPH cubic-spline (M4) kernel line integrals.

Behavioral analog of the reference's 51-entry double-precision lookup table of
the dimensionless cubic-spline line integral vs normalized impact parameter
(ref: include/grace/cuda/trace_sph.cuh:22-50). Instead of shipping opaque
constants, this module *derives* the table:

The 3D cubic spline with support radius 1 is
    w(q) = (8/pi) * (1 - 6 q^2 + 6 q^3)   for 0   <= q <= 1/2
    w(q) = (8/pi) * 2 (1 - q)^3           for 1/2 <  q <= 1
and the dimensionless line integral at normalized impact parameter beta is
    F(beta) = Integral_{-z1}^{z1} w(sqrt(beta^2 + z^2)) dz,  z1 = sqrt(1-beta^2).

For a particle with smoothing length h, the physical line integral is
F(b/h) / h^2 — the 1/h^2 scale applied by the reference's OnHit functors
(ref: cuda/functors/trace.cuh:163-193). F(0) = 6/pi = 1.90986..., matching
the reference table's first entry.

Two evaluation paths are provided:
  * ``KERNEL_INTEGRAL_TABLE`` (numpy f64, computed once at import by
    Gauss-Legendre quadrature) + ``lerp`` — bit-for-bit the reference's
    table-lookup scheme, used by the non-differentiable fast path.
  * ``cubic_spline_line_integral`` — closed-form antiderivative in jnp,
    smooth and differentiable, used by the gradient path and by kernels where
    transcendentals beat a table gather.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

N_TABLE = 51  # ref: trace_sph.cuh:22 (N_table = 51)
_SIGMA = 8.0 / np.pi

# -- on-disk coefficient cache ------------------------------------------------
# Every fit below is DERIVED (thousands of quadrature evaluations), which
# costs seconds-to-a-minute per process at import; the derived coefficients
# are cached in a committed .npz next to this module so imports are instant.
# The derivation code stays authoritative: tests/unit/test_kernel_integrals.py
# re-derives and compares against the cache (no opaque constants).
import os as _os

_COEFF_CACHE_PATH = _os.path.join(_os.path.dirname(__file__),
                                  "_horner_cache.npz")


def _cached_fit_multi(keys, fit_fn):
    """Load arrays ``keys`` from the cache, or run ``fit_fn`` (returning a
    tuple of arrays matching ``keys``) and persist them. Returns a tuple."""
    data = {}
    if _os.path.exists(_COEFF_CACHE_PATH):
        with np.load(_COEFF_CACHE_PATH) as z:
            data = {k: z[k] for k in z.files}
    if not all(k in data for k in keys):
        vals = fit_fn()
        for k, v in zip(keys, vals):
            data[k] = np.asarray(v)
        try:
            np.savez(_COEFF_CACHE_PATH, **data)
        except OSError:
            pass                      # read-only checkout: derive per run
    return tuple(data[k] for k in keys)


def _cached_fit(key, fit_fn):
    return _cached_fit_multi([key], lambda: (fit_fn(),))[0]



def _w_dimensionless(q):
    """Cubic spline w(q) with support radius 1 (numpy, f64)."""
    q = np.asarray(q, np.float64)
    inner = 1.0 - 6.0 * q * q + 6.0 * q * q * q
    outer = 2.0 * (1.0 - q) ** 3
    return _SIGMA * np.where(q <= 0.5, inner, np.where(q <= 1.0, outer, 0.0))


def _line_integral_quadrature(beta: float, order: int = 96) -> float:
    """F(beta) by piecewise Gauss-Legendre quadrature (f64)."""
    beta = float(beta)
    if beta >= 1.0:
        return 0.0
    z1 = np.sqrt(1.0 - beta * beta)
    zs = np.sqrt(max(0.25 - beta * beta, 0.0))
    x, w = np.polynomial.legendre.leggauss(order)

    def seg(a, b):
        if b <= a:
            return 0.0
        z = 0.5 * (b - a) * x + 0.5 * (b + a)
        q = np.sqrt(beta * beta + z * z)
        return 0.5 * (b - a) * np.sum(w * _w_dimensionless(q))

    return 2.0 * (seg(0.0, zs) + seg(zs, z1))


def make_kernel_integral_table(n: int = N_TABLE) -> np.ndarray:
    """Table of F(i / (n-1)) for i in [0, n) (f64 numpy)."""
    betas = np.linspace(0.0, 1.0, n)
    return np.array([_line_integral_quadrature(b) for b in betas])


KERNEL_INTEGRAL_TABLE = make_kernel_integral_table()

def _fit_chebyshev_pieces():
    """Piecewise Chebyshev fit of F for gather-free in-kernel evaluation.

    Piece 1: F as a function of x = beta^2 on [0, 1/4] (F is a function of
    beta^2 only). Piece 2: F = v^{7/2} * P(v) with v = 1 - beta^2 on
    [1/4, 1), which factors out the (1 - beta)^{7/2} vanishing at the kernel
    edge. Clenshaw evaluation keeps f32 error < 6e-6 (monomial conversion
    would blow up to ~2e-3).
    """
    b1 = np.linspace(0.0, 0.5, 2001)
    f1 = np.array([_line_integral_quadrature(b) for b in b1])
    c1 = np.polynomial.chebyshev.Chebyshev.fit(b1 * b1, f1, 14)
    b2g = np.linspace(0.5, 1.0, 2001)[:-1]
    f2 = np.array([_line_integral_quadrature(b) for b in b2g])
    v = 1.0 - b2g * b2g
    c2 = np.polynomial.chebyshev.Chebyshev.fit(v, f2 / v**3.5, 10)
    # Short variants for the hot Pallas kernel: max error ~6e-5, well inside
    # the 5e-4 physics tolerance, at half the Clenshaw iteration count.
    c1s = np.polynomial.chebyshev.Chebyshev.fit(b1 * b1, f1, 8)
    c2s = np.polynomial.chebyshev.Chebyshev.fit(v, f2 / v**3.5, 6)
    return (c1.coef, c1.domain), (c2.coef, c2.domain), (c1s.coef, c2s.coef)


_CHEB1, _CHEB1_DOM, _CHEB2, _CHEB2_DOM, _CHEB1_SHORT, _CHEB2_SHORT = (
    _cached_fit_multi(
        ['cheb1', 'cheb1_dom', 'cheb2', 'cheb2_dom', 'cheb1s', 'cheb2s'],
        lambda: sum(_fit_chebyshev_pieces(), ())))


def _fit_unified_horner(deg: int = 10):
    """Monomial coefficients for the unified select-Horner evaluation.

    Both pieces are fit as degree-``deg`` monomials in a scaled variable
    t in [-1, 1] that is LINEAR IN u = beta^2 for either piece:
      piece 1 (u <= 1/4):  F(u)            with t = u / 0.125 - 1
      piece 2 (u >  1/4):  F / v^{7/2}     with t = v / 0.375 - 1, v = 1 - u
    so a trace kernel evaluates ONE Horner recurrence with per-lane
    coefficient selects — ~2 ops per degree instead of the two full
    Clenshaw evaluations of `cubic_spline_line_integral_poly`. Clamping
    v to 0 makes the v^3 sqrt(v) prefactor vanish for u >= 1, so no
    separate in-support mask is needed. Max |error| at deg 10: ~5e-5
    (within the 5e-4 physics tolerance, ref: tests/integrate/integrate.cu).
    """
    u1 = np.linspace(0.0, 0.25, 3001)
    f1 = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u1])
    t1 = u1 / 0.125 - 1.0
    c1 = np.polynomial.chebyshev.Chebyshev.fit(t1, f1, deg, domain=[-1, 1])
    c1 = c1.convert(kind=np.polynomial.Polynomial).coef

    u2 = np.concatenate(
        [np.linspace(0.25, 1.0, 4001)[:-1], 1.0 - np.geomspace(1e-7, 0.05, 400)]
    )
    u2 = np.unique(u2)
    f2 = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u2])
    v2 = 1.0 - u2
    t2 = v2 / 0.375 - 1.0
    c2 = np.polynomial.chebyshev.Chebyshev.fit(t2, f2 / v2**3.5, deg, domain=[-1, 1])
    c2 = c2.convert(kind=np.polynomial.Polynomial).coef
    return np.asarray(c1, np.float64), np.asarray(c2, np.float64)


HORNER_DEG = 10
_HORNER_C1, _HORNER_C2 = _cached_fit_multi(
    [f'uh{HORNER_DEG}_1', f'uh{HORNER_DEG}_2'],
    lambda: _fit_unified_horner(HORNER_DEG))


def _fit_single_horner(deg: int = 14):
    """Monomial coefficients for the SINGLE-piece Horner evaluation.

    One fit of g(u) = F / v^{7/2} (v = 1 - u, u = beta^2) over the whole
    support u in [0, 1], in t = 2u - 1. Unlike the two-piece select-Horner
    form this needs NO per-coefficient selects — that trades ~12 select
    ops per evaluation for a few extra FMAs, the difference between ~50 and
    ~38 ops per (ray, prim) pair in the fused trace kernels.

    The least-squares fit is WEIGHTED by v^{7/2} so it minimizes error in F
    itself rather than in the divergently-scaled g (r1 advisor note: the
    unweighted deg-12 fit's ~1.4e-4 error consumed a third of the 5e-4
    physics-tolerance budget). Measured max |F_fit - F| / max F at deg 14
    weighted: ~2.1e-5 — 20x inside the 5e-4 gate.
    """
    u = np.concatenate(
        [np.linspace(0.0, 1.0, 6001)[:-1], 1.0 - np.geomspace(1e-7, 0.05, 500)]
    )
    u = np.unique(u)
    f = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u])
    v = 1.0 - u
    t = 2.0 * u - 1.0
    c = np.polynomial.chebyshev.Chebyshev.fit(t, f / v**3.5, deg,
                                              domain=[-1, 1], w=v**3.5)
    return np.asarray(c.convert(kind=np.polynomial.Polynomial).coef, np.float64)


HORNER1_DEG = 14

_HORNER1_C = _cached_fit(f"h{HORNER1_DEG}",
                         lambda: _fit_single_horner(HORNER1_DEG))
_HORNER1_CACHE = {HORNER1_DEG: _HORNER1_C}


def horner1_coeffs(deg: int) -> np.ndarray:
    """Cached weighted-fit coefficients for a given Horner degree.

    Measured max |F_fit - F| / max F: deg 14 ~2.1e-5 (the exact-path
    default), deg 8 ~8.1e-5 (the fast-trace option — 6 fewer FMAs per
    pair, still 6x inside the 5e-4 physics gate)."""
    if deg not in _HORNER1_CACHE:
        _HORNER1_CACHE[deg] = _cached_fit(
            f"h{deg}", lambda: _fit_single_horner(deg))
    return _HORNER1_CACHE[deg]


_DIRECT_CACHE = {}


def direct_coeffs(deg: int) -> np.ndarray:
    """Cached coefficients of a DIRECT polynomial fit of F over u in
    [0, 1] (no v^3 sqrt(v) prefactor). Max |fit - F| / max F: deg 12
    ~9.9e-5 — the same accuracy class as the deg-8 prefactor form but
    with NO sqrt, the expensive op of the prefactor (hardware ablation,
    benchmarks/results/r4_hw_notes.md)."""
    if deg not in _DIRECT_CACHE:

        def fit():
            u = np.concatenate([np.linspace(0.0, 1.0, 6001),
                                1.0 - np.geomspace(1e-7, 0.05, 500)])
            u = np.unique(u)
            f = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u])
            c = np.polynomial.chebyshev.Chebyshev.fit(2.0 * u - 1.0, f, deg,
                                                      domain=[-1, 1])
            return np.asarray(
                c.convert(kind=np.polynomial.Polynomial).coef, np.float64)

        _DIRECT_CACHE[deg] = _cached_fit(f"d{deg}", fit)
    return _DIRECT_CACHE[deg]


def cubic_spline_line_integral_direct_raw(u, deg: int):
    """UNMASKED direct-fit Horner: poly(min(u, 1)) of degree ``deg`` with
    NO out-of-support zeroing — for callers that already hold a validity
    mask and fuse the u < 1 test into their own select (the fused trace
    kernels' per-pair hot loop, _seg_compute). Equivalent to
    ``cubic_spline_line_integral_horner1(u, -deg)`` wherever u < 1."""
    u = jnp.asarray(u, jnp.float32)
    coeffs = direct_coeffs(deg)
    t = 2.0 * jnp.minimum(u, 1.0) - 1.0
    acc = jnp.float32(coeffs[deg])
    for k in range(deg - 1, -1, -1):
        acc = acc * t + jnp.float32(coeffs[k])
    return acc


def cubic_spline_line_integral_horner1(u, deg: int = HORNER1_DEG):
    """F(beta) from u = beta^2 via a single-piece Horner form.

    The hot-kernel form (pallas_kernel.py). ``deg`` selects the flavor:

      deg > 0   weighted fit of F / v^3.5 times the v^3 sqrt(v) prefactor:
                ``deg + 1`` FMAs + prefactor (includes a sqrt), zero
                selects. The prefactor vanishes for u >= 1 so no mask is
                needed; the clamp of u at 1 keeps far-away primitives
                (u ~ 1e5) from overflowing the powers into inf.
      deg < 0   sqrt-FREE direct fit of F of degree |deg|: ``|deg| + 1``
                FMAs + one select (the fit does not vanish at u >= 1, so
                out-of-support lanes are explicitly zeroed). deg = -12
                matches the deg-8 prefactor form's ~1e-4 accuracy and is
                the fast-trace option.
    """
    u = jnp.asarray(u, jnp.float32)
    if deg < 0:
        d = -deg
        coeffs = direct_coeffs(d)
        uc = jnp.minimum(u, 1.0)
        t = 2.0 * uc - 1.0
        acc = jnp.float32(coeffs[d])
        for k in range(d - 1, -1, -1):
            acc = acc * t + jnp.float32(coeffs[k])
        return jnp.where(u < 1.0, acc, 0.0)
    coeffs = horner1_coeffs(deg)
    u = jnp.minimum(u, 1.0)
    t = 2.0 * u - 1.0
    acc = jnp.float32(coeffs[deg])
    for k in range(deg - 1, -1, -1):
        acc = acc * t + jnp.float32(coeffs[k])
    v = jnp.maximum(1.0 - u, 0.0)
    return acc * ((v * v) * (v * jnp.sqrt(v)))


def cubic_spline_line_integral_horner(u):
    """F(beta) from u = beta^2 via the unified select-Horner form.

    The exact op sequence the hot Pallas kernels use (pallas_kernel.py), so
    tests of this function cover the in-kernel math. Returns 0 for u >= 1
    without any explicit mask (the clamped v^3 sqrt(v) prefactor vanishes).
    """
    # Clamp: F = 0 for u >= 1 (the prefactor vanishes at u = 1), and an
    # unclamped u from a far-away primitive (u ~ 1e5) would overflow the
    # Horner powers to inf, poisoning the masked select with inf * 0 = NaN.
    u = jnp.minimum(jnp.asarray(u, jnp.float32), 1.0)
    piece1 = u <= 0.25
    a = jnp.where(piece1, jnp.float32(1.0 / 0.125), jnp.float32(-1.0 / 0.375))
    b = jnp.where(piece1, jnp.float32(-1.0), jnp.float32(0.625 / 0.375))
    t = a * u + b
    acc = jnp.where(piece1, jnp.float32(_HORNER_C1[HORNER_DEG]),
                    jnp.float32(_HORNER_C2[HORNER_DEG]))
    for k in range(HORNER_DEG - 1, -1, -1):
        ck = jnp.where(piece1, jnp.float32(_HORNER_C1[k]),
                       jnp.float32(_HORNER_C2[k]))
        acc = acc * t + ck
    v = jnp.maximum(1.0 - u, 0.0)
    pref = (v * v) * (v * jnp.sqrt(v))
    return jnp.where(piece1, acc, acc * pref)


def _clenshaw(coefs, t):
    b_kp1 = jnp.zeros_like(t)
    b_kp2 = jnp.zeros_like(t)
    for c in coefs[:0:-1]:
        b_kp1, b_kp2 = 2.0 * t * b_kp1 - b_kp2 + jnp.float32(c), b_kp1
    return t * b_kp1 - b_kp2 + jnp.float32(coefs[0])


def cubic_spline_line_integral_poly(b2, fast: bool = False):
    """F(beta) from beta^2, as pure f32 polynomial math (no gathers/logs).

    The Pallas trace kernels use this form: b2 comes straight out of the
    ray-sphere test as (b/h)^2, Clenshaw needs only fused multiply-adds,
    and max abs error vs quadrature is < 6e-6 (< 7e-5 with
    ``fast=True``, the half-length fit used in the hot kernels).
    """
    c1 = _CHEB1_SHORT if fast else _CHEB1
    c2 = _CHEB2_SHORT if fast else _CHEB2
    b2 = jnp.asarray(b2, jnp.float32)
    lo1, hi1 = _CHEB1_DOM
    t1 = jnp.clip((2.0 * b2 - (lo1 + hi1)) / (hi1 - lo1), -1.0, 1.0)
    f_in = _clenshaw(c1, t1.astype(jnp.float32))
    v = jnp.maximum(1.0 - b2, 0.0)
    lo2, hi2 = _CHEB2_DOM
    t2 = jnp.clip((2.0 * v - (lo2 + hi2)) / (hi2 - lo2), -1.0, 1.0)
    f_out = _clenshaw(c2, t2.astype(jnp.float32)) * (v * v * v * jnp.sqrt(v))
    return jnp.where(b2 <= 0.25, f_in, jnp.where(b2 < 1.0, f_out, 0.0))


def cubic_spline_line_integral_poly_grad(b2, fast: bool = False):
    """dF/d(beta^2) of the fitted polynomial form — the exact derivative of
    the interpolant used by ``cubic_spline_line_integral_poly`` (so fused
    backward kernels match autodiff of the fused forward bit-for-bit up to
    op ordering).

    Piece 1: Clenshaw of the derivative Chebyshev series (chain rule with the
    domain map). Piece 2: F = v^{7/2} P(v) with v = 1 - b2, so
    dF/db2 = -(3.5 v^{5/2} P(v) + v^{7/2} P'(v)).
    """
    c1 = _CHEB1_SHORT if fast else _CHEB1
    c2 = _CHEB2_SHORT if fast else _CHEB2
    d1 = np.polynomial.chebyshev.chebder(c1)
    d2 = np.polynomial.chebyshev.chebder(c2)
    b2 = jnp.asarray(b2, jnp.float32)

    lo1, hi1 = _CHEB1_DOM
    scale1 = 2.0 / (hi1 - lo1)
    t1 = jnp.clip((2.0 * b2 - (lo1 + hi1)) / (hi1 - lo1), -1.0, 1.0)
    g_in = _clenshaw(d1, t1.astype(jnp.float32)) * jnp.float32(scale1)

    v = jnp.maximum(1.0 - b2, 0.0)
    lo2, hi2 = _CHEB2_DOM
    scale2 = 2.0 / (hi2 - lo2)
    t2 = jnp.clip((2.0 * v - (lo2 + hi2)) / (hi2 - lo2), -1.0, 1.0)
    p_v = _clenshaw(c2, t2.astype(jnp.float32))
    dp_v = _clenshaw(d2, t2.astype(jnp.float32)) * jnp.float32(scale2)
    v2 = v * v
    sq = jnp.sqrt(v)
    g_out = -(3.5 * v2 * sq * p_v + v2 * v * sq * dp_v)

    return jnp.where(b2 <= 0.25, g_in, jnp.where(b2 < 1.0, g_out, 0.0))


# Dense table for the differentiable f32 path. The closed form below is exact
# in f64 but suffers ~1e-3 cancellation error in f32 (the device path is
# f32, README "Precision"), so gradients/fast-path use this 2048-entry derived table + lerp: forward
# error ~1e-6 and the interpolant's analytic derivative is its own exact
# finite-difference limit.
N_DENSE = 2048
DENSE_KERNEL_INTEGRAL_TABLE = make_kernel_integral_table(N_DENSE)


def cubic_spline_line_integral(beta):
    """Closed-form F(beta), differentiable, for jnp arrays beta >= 0.

    Antiderivatives used (s = sqrt(z^2 + beta^2)):
      I0 = z
      I1 = Int s   dz = (z s + beta^2 log(z + s)) / 2
      I2 = Int s^2 dz = beta^2 z + z^3 / 3
      I3 = Int s^3 dz = z s^3 / 4 + (3 beta^2 / 8)(z s + beta^2 log(z + s))
    Inner piece integrand  (q <= 1/2): I0 - 6 I2 + 6 I3
    Outer piece integrand  (q >  1/2): 2 (I0 - 3 I1 + 3 I2 - I3)
    """
    beta = jnp.asarray(beta)
    dt = beta.dtype
    b2 = beta * beta
    # Guarded log argument: coefficients beta^2 / beta^4 kill the log blowup
    # as beta -> 0; the epsilon only avoids log(0) NaNs at exactly beta = 0.
    eps = jnp.asarray(1e-20, dt)

    # The eps floor keeps sqrt away from 0 where the outer max clamps, so
    # autodiff sees grad(max) = 0 rather than 0 * sqrt'(0) = NaN; forward
    # error is O(sqrt(eps)) ~ 1e-15.
    z1 = jnp.sqrt(jnp.maximum(1.0 - b2, eps))
    zs = jnp.sqrt(jnp.maximum(0.25 - b2, eps))

    def log_zps(z):
        s = jnp.sqrt(z * z + b2)
        return jnp.log(jnp.maximum(z + s, eps))

    def I1(z):
        s = jnp.sqrt(z * z + b2)
        return 0.5 * (z * s + b2 * log_zps(z))

    def I2(z):
        return b2 * z + z * z * z / 3.0

    def I3(z):
        s = jnp.sqrt(z * z + b2)
        s3 = s * s * s
        return 0.25 * z * s3 + 0.375 * b2 * (z * s + b2 * log_zps(z))

    def g_inner(z):
        return z - 6.0 * I2(z) + 6.0 * I3(z)

    def g_outer(z):
        return 2.0 * (z - 3.0 * I1(z) + 3.0 * I2(z) - I3(z))

    sigma = jnp.asarray(_SIGMA, dt)
    val = 2.0 * sigma * (
        (g_inner(zs) - g_inner(jnp.zeros_like(zs)))
        + (g_outer(z1) - g_outer(zs))
    )
    return jnp.where(beta < 1.0, val, jnp.zeros_like(val))


SPLAT_RANK = 5
SPLAT_DEG = 10


def fit_splat_basis(rank: int = SPLAT_RANK, deg: int = SPLAT_DEG, n: int = 1024):
    """Separable low-rank basis for the splatting renderer (trace/splat.py).

    For parallel-projection rendering the per-pixel kernel footprint
    G(x, y) = F(sqrt(x^2 + y^2)) (x, y = pixel offsets / h) factorizes as

        G(x, y) ~= sum_k  a_k(t_x) * b_k(t_y),   t = clamp(x^2, 0, 1)
        a_k(t) = (1 - t) * sign(l_k) sqrt(|l_k|) q_k(t)
        b_k(t) = (1 - t) *           sqrt(|l_k|) q_k(t)

    where (l_k, q_k) come from the eigendecomposition of the symmetric
    kernel matrix Q(t_x, t_y) = G / ((1-t_x)(1-t_y)) (signed eigenvalues —
    an SVD would silently flip the negative-eigenvalue terms) and q_k is a
    degree-``deg`` polynomial fit of the k-th eigenvector, weighted by
    (1 - t) so fit error is minimized where it actually enters the product.

    The explicit (1 - t) factor (with t clamped to [0, 1]) makes every
    basis function EXACTLY zero for |x| >= 1: pixels outside a particle's
    support contribute exactly 0, so far-away pairs inside a pixel tile
    cannot bias the accumulated image no matter how many there are.

    Measured max |model - F| at (5, 10): ~2e-4 absolute = ~1.0e-4 relative
    to F(0) — inside the 5e-4 physics tolerance
    (ref: tests/integrate/integrate.cu:53).

    Returns (a_coeffs, b_coeffs), each float64 [rank, deg + 1], monomial
    coefficients in t for Horner evaluation.
    """
    x = np.linspace(-1.0, 1.0, n + 1)[:-1] + 1.0 / (n + 1)
    t = x * x
    # F via the dense derived table (error ~1e-6, far below the fit target).
    beta2 = t[:, None] + t[None, :]
    beta = np.sqrt(beta2)
    xi = np.clip(beta, 0.0, 1.0) * (N_DENSE - 1)
    i0 = np.minimum(xi.astype(int), N_DENSE - 2)
    fr = xi - i0
    G = np.where(
        beta2 >= 1.0,
        0.0,
        DENSE_KERNEL_INTEGRAL_TABLE[i0] * (1.0 - fr)
        + DENSE_KERNEL_INTEGRAL_TABLE[i0 + 1] * fr,
    )
    m = 1.0 - t
    Q = G / (m[:, None] * m[None, :])
    lam, V = np.linalg.eigh(Q)
    order = np.argsort(-np.abs(lam))
    lam, V = lam[order[:rank]], V[:, order[:rank]]
    a = np.zeros((rank, deg + 1))
    b = np.zeros((rank, deg + 1))
    for k in range(rank):
        c = np.polynomial.chebyshev.Chebyshev.fit(t, V[:, k], deg, w=m)
        q = c.convert(kind=np.polynomial.Polynomial).coef
        q = np.pad(q, (0, deg + 1 - q.size))
        root = np.sqrt(np.abs(lam[k]))
        a[k] = q * root * np.sign(lam[k])
        b[k] = q * root
    return a, b


SPLAT_A_COEFFS, SPLAT_B_COEFFS = _cached_fit_multi(
    ['splat_a', 'splat_b'], fit_splat_basis)


def fit_splat_basis_joint(rank: int = SPLAT_RANK, deg: int = 8,
                          n: int = 1024, n_irls: int = 8):
    """JOINTLY optimal rank-r polynomial-separable fit of the footprint.

    ``fit_splat_basis`` fits each eigenvector of the kernel matrix by its
    own polynomial, which wastes degrees of freedom; here the best
    rank-``rank`` matrix X minimizing ||G - U X U^T||_F over the
    polynomial span U = diag(1-t) @ Vandermonde(t) is found in closed form
    (QR of U, project G, truncated eigendecomposition in the Q-metric),
    with a few IRLS reweighting rounds pushing Frobenius-optimal toward
    minimax. Measured max |model - F|: rank 5 deg 8 ~3.1e-4 relative
    (vs 1.0e-4 for the deg-10 per-eigenvector fit) at 20% less factor
    work per instance — the speed/accuracy trade is the caller's.

    Returns (a_coeffs, b_coeffs) float64 [rank, deg + 1] like
    ``fit_splat_basis``.
    """
    x = np.linspace(-1.0, 1.0, n + 1)[:-1] + 1.0 / (n + 1)
    t = x * x
    beta2 = t[:, None] + t[None, :]
    beta = np.sqrt(beta2)
    xi = np.clip(beta, 0.0, 1.0) * (N_DENSE - 1)
    i0 = np.minimum(xi.astype(int), N_DENSE - 2)
    fr = xi - i0
    G = np.where(
        beta2 >= 1.0,
        0.0,
        DENSE_KERNEL_INTEGRAL_TABLE[i0] * (1.0 - fr)
        + DENSE_KERNEL_INTEGRAL_TABLE[i0 + 1] * fr,
    )
    P = np.vander(t, deg + 1, increasing=True)
    U0 = (1.0 - t)[:, None] * P
    w = np.ones(n)
    best = None
    for _ in range(n_irls):
        Uw = w[:, None] * U0
        Gw = w[:, None] * G * w[None, :]
        Q, R = np.linalg.qr(Uw)
        Y = Q.T @ Gw @ Q
        Y = 0.5 * (Y + Y.T)
        lam, V = np.linalg.eigh(Y)
        order = np.argsort(-np.abs(lam))[:rank]
        lam, V = lam[order], V[:, order]
        Rinv = np.linalg.inv(R)
        Ca = Rinv @ V * (np.sign(lam) * np.sqrt(np.abs(lam)))[None, :]
        Cb = Rinv @ V * np.sqrt(np.abs(lam))[None, :]
        err = np.abs((U0 @ Ca) @ (U0 @ Cb).T - G)
        e = err.max()
        if best is None or e < best[0]:
            best = (e, Ca.T.copy(), Cb.T.copy())
        rowerr = err.max(axis=1)
        w = w * (0.25 + rowerr / (rowerr.mean() + 1e-30)) ** 0.5
        w /= w.mean()
    return best[1], best[2]


SPLAT_DEG8 = 8
SPLAT_A8_COEFFS, SPLAT_B8_COEFFS = _cached_fit_multi(
    ['splat_a8', 'splat_b8'],
    lambda: fit_splat_basis_joint(SPLAT_RANK, SPLAT_DEG8))


def splat_basis_reference(x, y):
    """Reference (numpy f64) evaluation of the fitted separable model at
    pixel offsets (x, y) — for tests bounding |model - F|."""
    def side(coeffs, t):
        t = np.clip(np.asarray(t, np.float64) ** 2, 0.0, 1.0)
        vals = [np.polynomial.polynomial.polyval(t, c) * (1.0 - t)
                for c in coeffs]
        return np.stack(vals, axis=-1)

    return np.sum(side(SPLAT_A_COEFFS, x) * side(SPLAT_B_COEFFS, y), axis=-1)
