"""Triangle-mesh path tests (analog of ref tests/render_triangle usage):
Möller-Trumbore semantics incl. back-face culling, closest-hit correctness
vs brute force, and an end-to-end shaded render."""

import numpy as np
import jax.numpy as jnp

from grace_jax.core.types import Rays
from grace_jax.models.triangle import clip_rays_to_aabb


def test_clip_rays_to_aabb_edges():
    """Mesh-AABB ray clipping (r5): axis-parallel rays, origins inside the
    box, rays missing the box, and rays shorter than the box exit."""
    bmin = jnp.asarray([0.0, 0.0, 0.0])
    bmax = jnp.asarray([1.0, 1.0, 1.0])
    o = np.array([
        [0.5, 0.5, -1.0],   # enters front, exits back: exit t = 2
        [0.5, 0.5, 0.5],    # inside: exit t = 0.5
        [2.0, 0.5, 0.5],    # points away: miss
        [0.5, 2.0, -1.0],   # passes above: miss
        [0.5, 0.5, -1.0],   # shorter than exit: length kept
    ], np.float32)
    d = np.array([
        [0, 0, 1], [0, 0, 1], [1, 0, 0], [0, 0, 1], [0, 0, 1],
    ], np.float32)
    ln = np.array([10.0, 10.0, 10.0, 10.0, 1.5], np.float32)
    out = clip_rays_to_aabb(Rays(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(ln)), bmin, bmax)
    got = np.asarray(out.lengths)
    np.testing.assert_allclose(got, [2.0, 0.5, 0.0, 0.0, 1.5], atol=1e-6)
import jax
import jax.numpy as jnp

from grace_jax.core.types import Rays
from grace_jax.models.triangle import (
    build_triangle_tree,
    intersect_triangle,
    render_triangles,
    trace_any_hit,
    trace_closest_hit,
)


def test_moller_trumbore_semantics():
    # Front face (counter-clockwise seen against the ray direction +z).
    tri_front = jnp.asarray([[[0, 0, 1], [0, 1, 1], [1, 0, 1]]], jnp.float32)
    o = jnp.asarray([[0.2, 0.2, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    ln = jnp.asarray([10.0])
    hit, t = intersect_triangle(o, d, ln, tri_front[0][None])
    assert bool(hit[0]) and abs(float(t[0]) - 1.0) < 1e-6
    # Opposite winding is culled (ref triangle.cuh back-face culling).
    tri_back = tri_front[:, [0, 2, 1], :]
    hit, _ = intersect_triangle(o, d, ln, tri_back[0][None])
    assert not bool(hit[0])
    # Outside the triangle.
    o2 = jnp.asarray([[0.9, 0.9, 0.0]])
    hit, _ = intersect_triangle(o2, d, ln, tri_front[0][None])
    assert not bool(hit[0])


def random_mesh(rng, n=300):
    c = rng.random((n, 1, 3)).astype(np.float32)
    v = c + 0.08 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    return v


def test_closest_hit_matches_bruteforce(rng):
    tris = random_mesh(rng)
    sorted_tris, tree, _ = build_triangle_tree(jnp.asarray(tris), max_per_leaf=4)
    r = 256
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(
        jnp.asarray((rng.random((r, 3)) * 0.2 - 0.5).astype(np.float32)),
        jnp.asarray(d),
        jnp.full((r,), 5.0, jnp.float32),
    )
    res = trace_closest_hit(rays, sorted_tris, tree)
    # Brute force closest hit.
    hit, t = intersect_triangle(
        rays.origins[:, None, :], rays.directions[:, None, :],
        rays.lengths[:, None], sorted_tris[None])
    t = np.where(np.array(hit), np.array(t), np.inf)
    t_ref = t.min(axis=1)
    tri_ref = np.where(np.isfinite(t_ref), t.argmin(axis=1), -1)
    np.testing.assert_allclose(
        np.where(np.isfinite(np.array(res.t)), np.array(res.t), 1e30),
        np.where(np.isfinite(t_ref), t_ref, 1e30), rtol=1e-5)
    assert np.array_equal(np.array(res.tri), tri_ref)

    # any-hit agrees with (closest-hit exists)
    occ = np.array(trace_any_hit(rays, sorted_tris, tree))
    assert np.array_equal(occ, np.isfinite(t_ref))


def test_render_produces_shaded_image(rng):
    tris = random_mesh(rng, n=150)
    img = np.array(render_triangles(tris, resolution=64))
    assert img.shape == (64, 64)
    assert (img > 0).sum() > 50          # object visible
    assert img.max() <= 1.0 + 1e-5
    assert len(np.unique(np.round(img, 3))) > 10  # actual shading variation
