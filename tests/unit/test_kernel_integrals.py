"""SPH kernel line-integral table tests: agreement with the reference's
committed constants (ref: cuda/trace_sph.cuh:31-49) within the reference
table's own accuracy (~2.5e-6 — entry 0 should be exactly 6/pi), internal
consistency of the closed form, and normalization."""

import numpy as np
import jax.numpy as jnp

from grace_jax.sph.kernel_integrals import (
    DENSE_KERNEL_INTEGRAL_TABLE,
    KERNEL_INTEGRAL_TABLE,
    N_TABLE,
    cubic_spline_line_integral,
    make_kernel_integral_table,
)

# Spot values from the reference table (data constants cited for parity).
REF_SAMPLES = {
    0: 1.90986019771937,
    1: 1.90563449910964,
    18: 0.924475767210246,
    25: 0.444144023534733,
    35: 8.432088120445191e-02,
    49: 7.387919939044624e-06,
    50: 0.0,
}


def test_table_matches_reference_constants():
    assert len(KERNEL_INTEGRAL_TABLE) == N_TABLE
    for i, v in REF_SAMPLES.items():
        assert abs(KERNEL_INTEGRAL_TABLE[i] - v) < 3e-6, (i, KERNEL_INTEGRAL_TABLE[i], v)


def test_table_first_entry_is_exact():
    assert abs(KERNEL_INTEGRAL_TABLE[0] - 6.0 / np.pi) < 1e-12


def test_closed_form_matches_quadrature_f64():
    import jax
    with jax.enable_x64(True):
        betas = jnp.linspace(0.0, 1.0, 101, dtype=jnp.float64)
        cf = np.array(cubic_spline_line_integral(betas))
    quad = make_kernel_integral_table(101)
    # atol 1e-8: the NaN-guard eps floor inside the sqrt clamps perturbs the
    # closed form by ~sqrt(1e-20) = 1e-10 near the support edges.
    np.testing.assert_allclose(cf, quad, atol=1e-8)


def test_plane_normalization():
    # Integral of F(b) over the plane must be 1: 2*pi Int_0^1 b F(b) db = 1.
    b = np.linspace(0, 1, 20001)
    f = make_kernel_integral_table(20001)
    total = 2 * np.pi * np.trapezoid(b * f, b)
    assert abs(total - 1.0) < 1e-6


def test_dense_table_monotone_decreasing():
    t = DENSE_KERNEL_INTEGRAL_TABLE
    assert np.all(np.diff(t) <= 0)
    assert t[0] > 1.9 and t[-1] == 0.0


def test_unified_horner_matches_quadrature():
    """The select-Horner form used by the hot Pallas kernels: <= 6e-5 abs
    error over the support, exactly 0 outside, no NaN/inf for huge u."""
    from grace_jax.sph.kernel_integrals import cubic_spline_line_integral_horner

    b = np.linspace(0.0, 1.0, 4001)
    quad = make_kernel_integral_table(4001)
    got = np.asarray(cubic_spline_line_integral_horner((b * b).astype(np.float32)))
    np.testing.assert_allclose(got, quad, atol=6e-5)
    far = np.asarray(
        cubic_spline_line_integral_horner(np.array([1.0, 2.0, 1e6, np.inf], np.float32))
    )
    assert np.array_equal(far, np.zeros(4)), far


def test_single_horner_matches_quadrature():
    """The single-piece Horner form (the one the hot Pallas kernels use):
    <= 5e-5 abs error over the support (deg-14 weighted fit, 20x inside the
    5e-4 physics gate), exactly 0 outside, no NaN/inf for huge u."""
    from grace_jax.sph.kernel_integrals import cubic_spline_line_integral_horner1

    b = np.linspace(0.0, 1.0, 4001)
    quad = make_kernel_integral_table(4001)
    got = np.asarray(cubic_spline_line_integral_horner1((b * b).astype(np.float32)))
    np.testing.assert_allclose(got, quad, atol=5e-5)
    far = np.asarray(
        cubic_spline_line_integral_horner1(np.array([1.0, 2.0, 1e6, np.inf], np.float32))
    )
    assert np.array_equal(far, np.zeros(4)), far


def test_coefficient_cache_matches_fresh_derivation():
    """The committed coefficient cache (_horner_cache.npz) must be exactly
    what the derivation code produces — the constants stay derived, the
    cache is only an import-time accelerator."""
    from grace_jax.sph.kernel_integrals import (
        _fit_single_horner, direct_coeffs, horner1_coeffs)

    np.testing.assert_array_equal(horner1_coeffs(14), _fit_single_horner(14))
    # the direct (sqrt-free) fit: re-derive inline
    from grace_jax.sph.kernel_integrals import _line_integral_quadrature
    u = np.concatenate([np.linspace(0.0, 1.0, 6001),
                        1.0 - np.geomspace(1e-7, 0.05, 500)])
    u = np.unique(u)
    f = np.array([_line_integral_quadrature(np.sqrt(x)) for x in u])
    c = np.polynomial.chebyshev.Chebyshev.fit(2.0 * u - 1.0, f, 12,
                                              domain=[-1, 1])
    fresh = np.asarray(c.convert(kind=np.polynomial.Polynomial).coef)
    np.testing.assert_array_equal(direct_coeffs(12), fresh)


def test_direct_raw_matches_masked_form():
    """The unmasked direct-fit Horner (for callers fusing the u < 1
    support test into their own select — the r5 trace hot loop) must be
    bitwise-equal to the masked horner1 flavor inside the support and is
    simply unmasked outside it."""
    import jax.numpy as jnp

    from grace_jax.sph.kernel_integrals import (
        cubic_spline_line_integral_direct_raw,
        cubic_spline_line_integral_horner1,
    )

    u = jnp.asarray(np.concatenate([
        np.linspace(0.0, 0.9999, 301), [1.0, 1.5, 10.0, 1e6]
    ]).astype(np.float32))
    for d in (10, 12):
        raw = np.asarray(cubic_spline_line_integral_direct_raw(u, d))
        masked = np.asarray(cubic_spline_line_integral_horner1(u, -d))
        inside = np.asarray(u) < 1.0
        assert np.array_equal(raw[inside], masked[inside])
        assert np.all(masked[~inside] == 0.0)
        assert np.all(np.isfinite(raw))
