"""Statistical isotropy tests of ray generation — analog of
ref tests/isotropic_ray_stats/ (Rayleigh z, Beran An, Gine Gn/Fn against
tabulated critical values; uniformity must NOT be rejected for isotropic
generators, and MUST be rejected for deliberately anisotropic ones)."""

import numpy as np
import jax

from grace_jax.core.types import Octants
from grace_jax.rays.gen import uniform_random_rays, uniform_random_rays_single_octant
from grace_jax.rays.healpix import healpix_rays
from grace_jax.rays.statistics import (
    BERAN_AN_CRIT,
    GINE_FN_CRIT,
    GINE_GN_CRIT,
    RAYLEIGH_Z_CRIT,
    beran_gine_statistics,
    rayleigh_z,
)

N = 4096


def test_uniform_rays_pass_uniformity():
    rays = uniform_random_rays(jax.random.key(0), N, (0, 0, 0), 1.0)
    d = np.array(rays.directions)
    z = float(rayleigh_z(d))
    assert z < RAYLEIGH_Z_CRIT[0.01], z
    bg = {k: float(v) for k, v in beran_gine_statistics(d).items()}
    assert bg["An"] < BERAN_AN_CRIT[0.01], bg
    assert bg["Gn"] < GINE_GN_CRIT[0.01], bg
    assert bg["Fn"] < GINE_FN_CRIT[0.01], bg


def test_healpix_directions_pass_uniformity():
    rays = healpix_rays(jax.random.key(1), 16, (0, 0, 0), 1.0)
    d = np.array(rays.directions)
    # HEALPix is a deterministic equal-area grid: far more uniform than random.
    assert float(rayleigh_z(d)) < RAYLEIGH_Z_CRIT[0.01]
    bg = beran_gine_statistics(d)
    assert float(bg["Fn"]) < GINE_FN_CRIT[0.01]


def test_single_octant_rays_fail_uniformity():
    rays = uniform_random_rays_single_octant(
        jax.random.key(2), N, (0, 0, 0), 1.0, Octants.PPP)
    d = np.array(rays.directions)
    # One-sided data: Rayleigh z must reject decisively.
    assert float(rayleigh_z(d)) > RAYLEIGH_Z_CRIT[0.01] * 10
    bg = beran_gine_statistics(d)
    assert float(bg["An"]) > BERAN_AN_CRIT[0.01]


def test_antipodal_bimodal_detected_by_gn_not_z():
    # Diametrically bimodal data defeats Rayleigh's z but not Gine's Gn
    # (ref: isotropic_stats.md:14-17) — the documented blind spot.
    rng = np.random.default_rng(0)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2]) * np.where(np.arange(N) % 2 == 0, 1, -1)
    d[:, 0] *= 0.2
    d[:, 1] *= 0.2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    assert float(rayleigh_z(d)) < RAYLEIGH_Z_CRIT[0.05] * 3
    assert float(beran_gine_statistics(d)["Gn"]) > GINE_GN_CRIT[0.01]


def test_ripley_k_matches_uniform_expectation():
    from grace_jax.rays.statistics import ripley_k_sphere, ripley_k_uniform

    rays = uniform_random_rays(jax.random.key(5), 3000, (0, 0, 0), 1.0)
    angles = np.array([0.3, 0.8, 1.5708, 2.4], np.float32)
    k = np.array(ripley_k_sphere(rays.directions, angles))
    k0 = np.array(ripley_k_uniform(angles))
    assert np.max(np.abs(k - k0) / k0) < 0.05
    # Clustered directions must inflate K at small angles.
    d = np.array(rays.directions)
    d[:, :2] *= 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k_c = np.array(ripley_k_sphere(d, angles))
    assert k_c[0] > 3 * k0[0]
