"""Sphere-intersection exactness vs arbitrary-precision rational arithmetic —
analog of ref tests/sphere_intersection/sphere_intersection.cu:41-147, which
checks the float sphere_hit against a GMP mpq_class oracle and tolerates
disagreement only within a 1e-8 fractional band of the b^2 = R^2 boundary.
Python's fractions module replaces GMP."""

from fractions import Fraction

import numpy as np
import jax.numpy as jnp

from grace_jax.ops.intersect import sphere_hit

BOUNDARY_TOL = 1e-8  # ref sphere_intersection.cu:47


def exact_b2_over_r2(o, d, s):
    """Exact (b^2 / R^2, dot_p sign info) with rational arithmetic.

    All inputs are float32 values interpreted exactly (binary floats are
    rationals), mirroring the reference's exact-oracle idiom.
    """
    o = [Fraction(float(x)) for x in o]
    d = [Fraction(float(x)) for x in d]
    c = [Fraction(float(x)) for x in s[:3]]
    r = Fraction(float(s[3]))
    p = [c[i] - o[i] for i in range(3)]
    # direction is float-normalized, not exactly unit; use the exact formula
    # b^2 = |p|^2 - (p.d)^2 / |d|^2 so the oracle is exact for the given floats.
    dd = sum(x * x for x in d)
    pd = sum(p[i] * d[i] for i in range(3))
    pp = sum(x * x for x in p)
    b2 = pp - pd * pd / dd
    return b2 / (r * r), pd


def test_sphere_hit_vs_rational_oracle(rng):
    n = 3000
    # Spheres displaced away from the origin region to avoid inside-origin
    # edge cases (ref sphere_intersection.cu:79-84).
    centers = (rng.random((n, 3)) * 2 + 1.5).astype(np.float32)
    radii = (0.1 + 0.4 * rng.random(n)).astype(np.float32)
    spheres = np.concatenate([centers, radii[:, None]], 1)

    o = np.zeros(3, np.float32)
    d = np.array([1.0, 1.0, 1.0], np.float32)
    d = (d / np.linalg.norm(d)).astype(np.float32)
    length = np.float32(100.0)

    hit, b2, dotp = sphere_hit(
        jnp.asarray(o)[None, :], jnp.asarray(d)[None, :],
        jnp.asarray(length)[None], jnp.asarray(spheres))
    hit = np.array(hit)
    b2 = np.array(b2)

    mismatches = 0
    for i in range(n):
        frac, pd = exact_b2_over_r2(o, d, spheres[i])
        exact_hit = (frac < 1) and (pd > 0)  # dot_p < length always here
        if bool(hit[i]) != exact_hit:
            # Allowed only within the grazing boundary band
            # (ref sphere_intersection.cu:106-110).
            assert abs(float(frac) - 1.0) < BOUNDARY_TOL, (
                i, float(frac), bool(hit[i]), exact_hit)
            mismatches += 1
    # Grazing cases should be rare.
    assert mismatches <= 5
