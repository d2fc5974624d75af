"""SPH kernel-normalization physics test — analog of
ref tests/integrate/integrate.cu:45-102: a plane-parallel ray field through
isolated particles must integrate to (number of particles) x (per-ray area
weighting), i.e. sum(integrals) * area / N == 1 within 5e-4, because each
SPH kernel integrates to 1 over the plane."""

import numpy as np
import jax
import jax.numpy as jnp

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import make_spheres
from grace_jax.rays.gen import plane_parallel_random_rays
from grace_jax.trace.render import render_column_density
from grace_jax.trace.sph import trace_cumulative_sph

TOL = 5e-4  # ref integrate.cu:53


def _integrate(spheres, side, base, w, h, res=512, key=0, mpl=4):
    sorted_spheres, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, mpl)
    rays = plane_parallel_random_rays(jax.random.key(key), res, res, base, w, h, length=20.0)
    integrals = trace_cumulative_sph(rays, sorted_spheres, tree)
    area_per_ray = (side / res) ** 2
    return float(jnp.sum(integrals)) * area_per_ray


def test_plane_integral_normalization(rng):
    # The reference geometry (integrate.cu:70-84): box [-1,1]^3, radius 0.2,
    # two spheres at (-+0.5, -+0.5, -+0.5). Smaller radii under-sample the
    # kernel per jittered cell and blow past the 5e-4 MC budget.
    spheres = make_spheres(
        np.array([[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]], np.float32),
        np.array([0.2, 0.2], np.float32),
    )
    side = 2.0
    total = _integrate(
        spheres, side,
        base=(-1.0, -1.0, -5.0), w=(side, 0, 0), h=(0, side, 0),
        mpl=1,  # "DO NOT CHANGE. There are only two spheres." (integrate.cu:50)
    )
    assert abs(total / 2.0 - 1.0) < TOL, total


def test_plane_integral_normalization_many(rng):
    n = 50
    pos = (rng.random((n, 3)) * 1.2 - 0.6).astype(np.float32)
    hs = (0.1 + 0.1 * rng.random(n)).astype(np.float32)
    spheres = make_spheres(pos, hs)
    side = 2.0
    total = _integrate(
        spheres, side,
        base=(-1.0, -1.0, -5.0), w=(side, 0, 0), h=(0, side, 0), res=1024,
    )
    assert abs(total / n - 1.0) < TOL, total


def test_differentiable_render_matches_cumulative(rng):
    n = 200
    spheres = make_spheres((0.2 + 0.6 * rng.random((n, 3))).astype(np.float32),
                           (0.02 + 0.04 * rng.random(n)).astype(np.float32))
    sorted_spheres, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, 8)
    rays = plane_parallel_random_rays(
        jax.random.key(5), 64, 64, (0, 0, -3.0), (1, 0, 0), (0, 1, 0), length=10.0)
    fast = np.array(trace_cumulative_sph(rays, sorted_spheres, tree))
    diff = np.array(render_column_density(rays, sorted_spheres, tree, capacity=1 << 16))
    np.testing.assert_allclose(diff, fast, rtol=2e-5, atol=1e-6)


def test_pallas_kernel_passes_physics_gate(rng):
    """The fused kernel's polynomial integral must pass the same 5e-4
    normalization gate as the table path (interpret mode)."""
    from grace_jax.trace.pallas_kernel import pallas_trace_sph

    spheres = make_spheres(
        np.array([[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]], np.float32),
        np.array([0.2, 0.2], np.float32),
    )
    sorted_spheres, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, 1)
    res = 512  # the reference's resolution; MC noise fits the 5e-4 gate
    rays = plane_parallel_random_rays(
        jax.random.key(0), res, res, (-1.0, -1.0, -5.0), (2.0, 0, 0), (0, 2.0, 0),
        length=20.0)
    vals, ovf = pallas_trace_sph(rays, sorted_spheres, tile=128,
                                 max_chunks=8, interpret=True)
    assert not bool(np.array(ovf).any())
    total = float(jnp.sum(vals)) * (2.0 / res) ** 2
    assert abs(total / 2.0 - 1.0) < TOL, total
