"""Gradient correctness for the differentiable render path (the north-star
capability): jax.grad of the column-density render vs central finite
differences of the same forward."""

import numpy as np
import jax
import jax.numpy as jnp

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import Rays, make_spheres
from grace_jax.rays.gen import plane_parallel_random_rays
from grace_jax.trace.render import find_hits, integrate_hits


def setup(rng, n=60):
    spheres = make_spheres((0.25 + 0.5 * rng.random((n, 3))).astype(np.float32),
                           (0.05 + 0.05 * rng.random(n)).astype(np.float32))
    sorted_spheres, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, 4)
    rays = plane_parallel_random_rays(
        jax.random.key(9), 48, 48, (0, 0, -3.0), (1, 0, 0), (0, 1, 0), length=10.0)
    records = find_hits(rays, sorted_spheres, tree, capacity=1 << 15)
    return sorted_spheres, rays, records


def test_grad_matches_finite_differences(rng):
    spheres, rays, records = setup(rng)
    n = spheres.shape[0]
    weights = jnp.ones((n,), jnp.float32)
    target = jax.random.normal(jax.random.key(0), (rays.n_rays,), jnp.float32)

    def loss(spheres64, weights64):
        # Closed-form kernel evaluation: smooth, so FD and autodiff agree
        # tightly (the table interpolant's knees limit agreement to ~5e-4).
        img = integrate_hits(records, rays, spheres64, rays.n_rays, weights64,
                             use_closed_form=True)
        return jnp.sum(img * target)

    # f64 on CPU for a tight FD comparison.
    with jax.enable_x64(True):
        s64 = jnp.asarray(np.array(spheres), jnp.float64)
        w64 = jnp.asarray(np.array(weights), jnp.float64)
        g_s, g_w = jax.grad(loss, argnums=(0, 1))(s64, w64)
        g_s, g_w = np.array(g_s), np.array(g_w)

        eps = 1e-6
        # spot-check a handful of coordinates with central differences
        idx = [(0, 0), (3, 1), (7, 2), (11, 3), (20, 3), (33, 0)]
        for (i, c) in idx:
            sp = np.array(s64)
            sp[i, c] += eps
            fp = float(loss(jnp.asarray(sp), w64))
            sp[i, c] -= 2 * eps
            fm = float(loss(jnp.asarray(sp), w64))
            fd = (fp - fm) / (2 * eps)
            assert abs(fd - g_s[i, c]) <= 1e-4 * max(1.0, abs(fd)), (i, c, fd, g_s[i, c])

        for i in [0, 5, 17]:
            wp = np.array(w64)
            wp[i] += eps
            fp = float(loss(s64, jnp.asarray(wp)))
            wp[i] -= 2 * eps
            fm = float(loss(s64, jnp.asarray(wp)))
            fd = (fp - fm) / (2 * eps)
            assert abs(fd - g_w[i]) <= 1e-5 * max(1.0, abs(fd)), (i, fd, g_w[i])


def test_grad_nonzero_and_finite(rng):
    spheres, rays, records = setup(rng)

    def loss(s):
        img = integrate_hits(records, rays, s, rays.n_rays)
        return jnp.sum(img ** 2)

    g = np.array(jax.grad(loss)(spheres))
    assert np.all(np.isfinite(g))
    assert np.any(g != 0)
